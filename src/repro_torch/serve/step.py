"""Serving steps, greedy (counterpart of the slot and paged steps in
``repro.serve.step``).

* ``slot_prefill`` zeroes slot ``slot``'s cache rows, prefills one prompt
  into them and takes the first token's argmax on the device.
* ``slot_decode`` advances the active-slot prefix [0, n) by one token in
  one forward (every MoE layer dispatches the n decode tokens together);
  argmax and the EOS comparison stay on the device.
* ``paged_step`` runs one forward over a paged step's token rows (decode
  tokens and prompt-chunk tokens together, each at its own position through
  its slot's block-table row), with the same on-device argmax and EOS
  comparison.

None copies anything to the host: the engine makes one transfer per
step."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (LM, RunConfig, forward, slice_cache_slots,
                                   update_cache_slots)


def slot_prefill(model: LM, cfg: ModelConfig, rc: RunConfig, cache,
                 tokens: torch.Tensor, slot: int):
    """tokens: (1, P) int -> (tok (1,) int32 on the device, cache, aux)."""
    sub = slice_cache_slots(cache, slot, 1)
    for layer in sub:
        for t in layer.values():
            t.zero_()
    logits, sub, aux = forward(model, cfg, rc, {"tokens": tokens},
                               mode="prefill", cache=sub)
    update_cache_slots(cache, sub, slot)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return tok, cache, aux


def slot_decode(model: LM, cfg: ModelConfig, rc: RunConfig, cache,
                tokens: torch.Tensor, pos: torch.Tensor, eos: torch.Tensor):
    """tokens: (n, 1); pos, eos: (n,) int32 (eos -1 = none) ->
    (tok (n,), eos_hit (n,), cache, aux), all on the device."""
    n = tokens.shape[0]
    sub = slice_cache_slots(cache, 0, n)
    logits, sub, aux = forward(model, cfg, rc, {"tokens": tokens},
                               mode="decode", cache=sub, pos=pos)
    update_cache_slots(cache, sub, 0)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return tok, tok == eos, cache, aux


def paged_step(model: LM, cfg: ModelConfig, rc: RunConfig, pools,
               tokens: torch.Tensor, pos: torch.Tensor, tables: torch.Tensor,
               eos: torch.Tensor):
    """tokens: (T, 1); pos, eos: (T,) int32; tables: (T, nb) int32 ->
    (tok (T,), eos_hit (T,), pools, aux), all on the device.  Every MoE
    layer builds one dispatch plan over all T rows."""
    logits, pools, aux = forward(model, cfg, rc, {"tokens": tokens},
                                 mode="decode", cache=pools, pos=pos,
                                 block_tables=tables)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return tok, tok == eos, pools, aux
