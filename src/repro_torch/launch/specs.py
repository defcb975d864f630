"""Fake stand-ins for every dry-run cell (counterpart of
``repro.launch.specs``).

``cell_inputs`` returns what one rank's step of a cell needs, built under
the caller's ``FakeTensorMode`` so that nothing is allocated: parameters
(``init_params`` at full size), optimizer state, batch and cache, each
this rank's block on the grid, and the step function over them.

- train: the trainer's state (``train.step.init_train_state``'s model and
  moments), on a grid of more than one rank cut to this rank's blocks by
  ``weights.shard_train_state`` (``distributed/sharding.py``'s fsdp
  specs); the batch (accum, B/accum, S), cut by ``local_batch``; the step
  ``make_train_step(accum_steps=..., grid=...)``.
- prefill / decode: the served path as the launcher's ``--distributed``
  runs it: every rank holds the non-expert weights whole and its
  ``E / model`` experts (``weights.shard_model``; under ``rc.quant`` then
  compressed by ``quantization.quantize_model``, as the engine does at
  load, on the fake tensors too), serves its share of the
  batch (the rows over the data axes) with the MoE layers over the
  'model' group (``rc.ep``), over a contiguous cache of ``seq_len``
  positions a row; decode writes and reads position ``seq_len - 1``.
- the encoder's forward (hubert at ``prefill_32k``): the train-mode
  forward's hidden states under ``torch.no_grad``.

``dryrun_runconfig`` follows the reference's, on the ``cuda`` executor
(``launch/dryrun.py``'s ``--executor`` replaces it): bf16 compute, remat for
train, chunks of 1024 / 1024 (queries whole but for the recurrent
families), ``loss_chunk`` 512, capacity factor 2.0, EP on for a MoE model
on a grid whose 'model' axis has more than one rank, decode's EP layout
``sharded_static`` (prefill's is the forward's own, ``sharded``: both
size their buffers from shapes alone).  Parameters are bf16 for serving
and fp32 for training: the port's AdamW keeps fp32 master weights
(``optim/adamw.py``), where the reference's dry run lowered bf16 ones.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs import ModelConfig, ShapeConfig, get_config
from repro_torch.models.lm import RunConfig

# per-shape grad-accumulation microbatch counts (the reference's)
ACCUM = {
    "train_4k": 4,
}
# memory-driven overrides (param + moment footprint)
ACCUM_OVERRIDES = {
    ("deepseek-v2-236b", "train_4k"): 2,
}


def dryrun_runconfig(cfg: ModelConfig, shape: ShapeConfig, *,
                     ep: bool = True) -> RunConfig:
    """Execution policy of a dry-run cell (see the module docstring)."""
    is_seq_model = cfg.family in ("ssm", "hybrid")
    train = shape.kind == "train"
    return RunConfig(
        compute_dtype=torch.bfloat16,
        param_dtype=torch.float32 if train else torch.bfloat16,
        executor="cuda",
        ep=bool(cfg.is_moe and ep),
        ep_decode_layout="sharded_static",
        remat=train,
        q_chunk=(1024 if is_seq_model else 0),
        kv_chunk=1024,
        loss_chunk=512,
        capacity_factor=2.0,
    )


def accum_steps(arch: str, shape: ShapeConfig) -> int:
    return ACCUM_OVERRIDES.get((arch, shape.name),
                               ACCUM.get(shape.name, 1))


def fake_batch(cfg: ModelConfig, shape: ShapeConfig, accum: int = 1,
               device="cpu") -> Dict[str, torch.Tensor]:
    """The cell's whole batch (zeros), with a leading (accum,) axis when
    ``accum > 1``: the data pipeline's keys and dtypes."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        S = 1
    lead = ()
    if accum > 1:
        if B % accum:
            raise ValueError(f"batch {B} does not divide into {accum} "
                             "microbatches")
        lead, B = (accum,), B // accum
    kw = dict(device=device)
    batch = {}
    if cfg.encoder_only:
        batch["features"] = torch.zeros(lead + (B, S, cfg.d_model),
                                        dtype=torch.float32, **kw)
        batch["labels"] = torch.zeros(lead + (B, S), dtype=torch.int32, **kw)
        batch["mask"] = torch.zeros(lead + (B, S), dtype=torch.bool, **kw)
    else:
        batch["tokens"] = torch.zeros(lead + (B, S), dtype=torch.int32, **kw)
    if cfg.cross_attn_every and shape.kind != "decode":
        batch["image_embeds"] = torch.zeros(
            lead + (B, cfg.n_image_tokens, cfg.d_model), dtype=torch.float32,
            **kw)
    return batch


class CellInputs(NamedTuple):
    step_fn: Any                # step_fn(*args) runs one rank's step
    args: tuple
    arguments: Dict[str, Any]   # params / opt / batch / cache, for bytes
    rc: RunConfig
    meta: Dict[str, Any]


def _serve_rows(grid, B: int) -> int:
    """Rows of a served batch of ``B`` a rank: cut over the data axes
    (pod, data) where they divide it, else whole."""
    n = grid.sizes["pod"] * grid.sizes["data"]
    return B // n if B % n == 0 else B


def cell_inputs(arch: str, shape: ShapeConfig, grid,
                rc: Optional[RunConfig] = None, *,
                accum: Optional[int] = None,
                cfg: Optional[ModelConfig] = None,
                optimizer: bool = True, device="cpu") -> CellInputs:
    """One rank's step of ``arch`` x ``shape`` on ``grid``: call under a
    ``FakeTensorMode`` (or with real tensors, at a reduced ``cfg``, for
    the comparisons of the tests).  ``optimizer=False`` makes a train
    cell one forward and backward on one device, every parameter's
    gradient and no AdamW state or step (a step whose state would not fit
    the card)."""
    from repro_torch.models.lm import forward, init_cache, init_params
    cfg = cfg or get_config(arch)
    M = grid.sizes["model"]
    rc = rc or dryrun_runconfig(cfg, shape, ep=M > 1)
    meta: Dict[str, Any] = {"ep": M if (cfg.is_moe and M > 1) else 1,
                            "layout": "fsdp"}

    if shape.kind == "train":
        from repro_torch.data.pipeline import local_batch
        from repro_torch.distributed.sharding import batch_specs
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.train.step import init_train_state, make_train_step
        A = accum if accum is not None else accum_steps(arch, shape)
        if not optimizer:
            return _fwd_bwd_inputs(cfg, shape, rc, meta, device)
        sharded = grid.world.size > 1
        state = init_train_state(cfg, 0, rc, device=device,
                                 grid=grid if sharded else None)
        batch = fake_batch(cfg, shape, A, device)
        if sharded:
            bspecs = batch_specs(cfg, grid, "train", shape.global_batch // A,
                                 microbatched=A > 1)
            batch = local_batch(batch, grid, bspecs, cfg)
        step = make_train_step(cfg, rc, OptConfig(), accum_steps=A,
                               grid=grid if sharded else None)
        meta.update(accum=A, mode="train")
        return CellInputs(step, (state, batch),
                          {"params": state["params"], "opt": state["opt"],
                           "batch": batch}, rc, meta)

    model = init_params(cfg, 0, param_dtype=rc.param_dtype, device=device)
    if rc.ep:
        from repro_torch.weights import shard_model
        shard_model(model, grid.coords["model"], M)
        meta["layout"] = "ep_serve"
    if rc.quant != "none" and cfg.is_moe:
        # the engine's load-time transform, after the EP split as there
        from repro_torch.quantization import quantize_model
        quantize_model(model, rc.quant)
        meta["quant"] = rc.quant
    B = _serve_rows(grid, shape.global_batch)
    whole = fake_batch(cfg, shape, device=device)
    batch = {k: v[:B] for k, v in whole.items()}
    if cfg.encoder_only:
        def encode(model, batch):
            with torch.no_grad():
                return forward(model, cfg, rc, batch, mode="train")[0]
        meta["mode"] = "encode"
        return CellInputs(encode, (model, batch),
                          {"params": model, "batch": batch}, rc, meta)

    cache = init_cache(cfg, B, shape.seq_len, torch.bfloat16, device)
    if shape.kind == "prefill":
        def prefill(model, batch, cache):
            return forward(model, cfg, rc, batch, mode="prefill",
                           cache=cache)[:2]
        meta["mode"] = "prefill"
        return CellInputs(prefill, (model, batch, cache),
                          {"params": model, "batch": batch, "cache": cache},
                          rc, meta)

    pos = shape.seq_len - 1

    def decode(model, batch, cache):
        logits, cache, _ = forward(model, cfg, rc, batch, mode="decode",
                                   cache=cache, pos=pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    meta["mode"] = "decode"
    return CellInputs(decode, (model, batch, cache),
                      {"params": model, "batch": batch, "cache": cache}, rc,
                      meta)


def _fwd_bwd_inputs(cfg: ModelConfig, shape: ShapeConfig, rc: RunConfig,
                    meta: dict, device) -> CellInputs:
    """One forward and backward, every parameter's gradient, no optimizer:
    the trainer's parameters and a whole batch on one device."""
    from repro_torch.models.lm import init_params, loss_fn
    model = init_params(cfg, 0, param_dtype=rc.param_dtype,
                        device=device).requires_grad_(True)
    batch = fake_batch(cfg, shape, 1, device)

    def fwd_bwd(model, batch):
        params = list(model.parameters())
        loss, _ = loss_fn(model, cfg, rc, batch)
        return loss.detach(), torch.autograd.grad(loss, params)
    meta.update(accum=1, mode="fwd_bwd")
    return CellInputs(fwd_bwd, (model, batch),
                      {"params": model, "batch": batch}, rc, meta)
