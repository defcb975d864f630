"""Count the tensor operations of a served forward, block by block, on the
CPU: a prediction of the kernel launches a step costs on the card, where
each operation is one launch or more (views are not counted; they launch
nothing).  The counts depend on the block kinds and the depth, not on the
widths, so a reduced-width model gives the full model's counts.

    PYTHONPATH=src python -m repro_torch.launch.op_count \\
        --arch zamba2-7b --prompt 512 --slots 2

Prints, for a prefill of ``--prompt`` tokens (one slot) and a decode step
of ``--slots`` rows, the operations of each block kind and the total over
the architecture's own depth (embedding and head included); for an
encoder (hubert-xlarge), which has no prefill or decode, the train-mode
forward of one sequence of ``--prompt`` frames instead.  A vlm's cross
blocks attend to ``n_image_tokens`` random image embeddings.
``--q-chunk`` / ``--kv-chunk`` set ``flash_attention``'s chunks (the
``RunConfig`` default, 512, unless given): at 8,192 tokens the chunks of
64 that the reference's engine runs cost 8,256 chunk pairs a layer where
512 cost 136."""
import argparse
import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

VIEWS = frozenset({
    "aten.view", "aten._unsafe_view", "aten.slice", "aten.select",
    "aten.expand", "aten.t", "aten.transpose", "aten.permute",
    "aten.unsqueeze", "aten.squeeze", "aten.alias", "aten.detach",
    "aten._reshape_alias", "aten.as_strided", "aten.split", "aten.unbind",
    "aten.lift_fresh"})


class OpCounter(TorchDispatchMode):
    """Counts every dispatched operation that is not a view."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func.overloadpacket) not in VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    counter = OpCounter()
    with torch.no_grad(), counter:
        fn()
    return counter.n


def main(argv=None):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import (RunConfig, apply_block, forward,
                                       init_cache, init_params, layer_kinds)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--q-chunk", type=int, default=RunConfig().q_chunk)
    ap.add_argument("--kv-chunk", type=int, default=RunConfig().kv_chunk)
    args = ap.parse_args(argv)
    full = get_config(args.arch)
    kinds = layer_kinds(full)
    # reduced widths; the depth, the group layout and the image length stay
    # the full model's
    cfg = reduced(full, layers=full.n_layers).replace(
        attn_every=full.attn_every, cross_attn_every=full.cross_attn_every,
        n_image_tokens=full.n_image_tokens)
    model = init_params(cfg, 0, device="cpu")
    rc = RunConfig(q_chunk=args.q_chunk, kv_chunk=args.kv_chunk)
    out = {}
    modes = ((("train", 1, args.prompt),) if cfg.encoder_only else
             (("prefill", 1, args.prompt), ("decode", args.slots, 1)))
    for mode, B, S in modes:
        cache = (None if mode == "train" else
                 init_cache(cfg, B, args.prompt + 2, device="cpu"))
        pos = torch.full((B,), args.prompt, dtype=torch.int32)
        positions = pos[:, None] if mode == "decode" else torch.arange(S)
        x = torch.randn(B, S, cfg.d_model)
        img = torch.randn(B, cfg.n_image_tokens, cfg.d_model)
        batch = ({"features": x} if cfg.encoder_only else
                 {"tokens": torch.zeros((B, S), dtype=torch.long)})
        if cfg.cross_attn_every:
            batch["image_embeds"] = img
        per_kind = {}
        for i, blk in enumerate(model.layers):
            if blk.kind not in per_kind:
                per_kind[blk.kind] = count(lambda: apply_block(
                    blk, x, cfg, rc, positions=positions, mode=mode,
                    cache=None if cache is None else cache[i],
                    cache_pos=pos if mode == "decode" else None,
                    image_embeds=img))
        total = count(lambda: forward(
            model, cfg, rc, batch, mode=mode, cache=cache,
            pos=pos if mode == "decode" else None))
        out[mode] = total
        n = collections.Counter(kinds)
        print(f"{full.name} {mode} ({B} x {S} tokens, chunks of "
              f"{rc.q_chunk} x {rc.kv_chunk}): "
              + ", ".join(f"{k} {v} a block x {n[k]}"
                          for k, v in per_kind.items())
              + f"; the whole forward {total} operations")
    return out


if __name__ == "__main__":
    main()
