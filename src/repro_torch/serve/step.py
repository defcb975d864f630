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
step.

Observability: each step takes an ``Observability`` bundle and the set of
shapes its engine has run (``shapes``).  The first run of a step kind at a
static shape (``tokens`` for the paged step, ``prompt_tokens`` for the
prefill, ``active_slots`` for the decode step: the reference's static
arguments) calls ``obs.on_trace``, the eager counterpart of the
reference's jit trace, and counts the plans built inside it
(``moe/plans_traced``).  It adds no device work."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (LM, RunConfig, forward, slice_cache_slots,
                                   update_cache_slots)
from repro_torch.obs import NOOP


def _first_run(obs, shapes: Optional[set], kind: str, **static):
    """``obs.new_shape(kind, **static)`` the first time ``kind`` runs at
    ``static`` in ``shapes``; a null context otherwise."""
    key = (kind, *sorted(static.items()))
    if shapes is None or key in shapes:
        return contextlib.nullcontext()
    shapes.add(key)
    if not obs.enabled:
        return contextlib.nullcontext()
    return obs.new_shape(kind, **static)


def slot_prefill(model: LM, cfg: ModelConfig, rc: RunConfig, cache,
                 tokens: torch.Tensor, slot: int, *, obs=NOOP,
                 shapes: Optional[set] = None):
    """tokens: (1, P) int -> (tok (1,) int32 on the device, cache, aux)."""
    with _first_run(obs, shapes, "prefill_step",
                    prompt_tokens=int(tokens.shape[-1])):
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
                tokens: torch.Tensor, pos: torch.Tensor, eos: torch.Tensor,
                *, obs=NOOP, shapes: Optional[set] = None):
    """tokens: (n, 1); pos, eos: (n,) int32 (eos -1 = none) ->
    (tok (n,), eos_hit (n,), cache, aux), all on the device."""
    n = tokens.shape[0]
    with _first_run(obs, shapes, "decode_step", active_slots=int(n)):
        sub = slice_cache_slots(cache, 0, n)
        logits, sub, aux = forward(model, cfg, rc, {"tokens": tokens},
                                   mode="decode", cache=sub, pos=pos)
        update_cache_slots(cache, sub, 0)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return tok, tok == eos, cache, aux


def paged_step(model: LM, cfg: ModelConfig, rc: RunConfig, pools,
               tokens: torch.Tensor, pos: torch.Tensor, tables: torch.Tensor,
               eos: torch.Tensor, *, obs=NOOP, shapes: Optional[set] = None):
    """tokens: (T, 1); pos, eos: (T,) int32; tables: (T, nb) int32 ->
    (tok (T,), eos_hit (T,), pools, aux), all on the device.  Every MoE
    layer builds one dispatch plan over all T rows."""
    with _first_run(obs, shapes, "paged_step", tokens=int(tokens.shape[0])):
        logits, pools, aux = forward(model, cfg, rc, {"tokens": tokens},
                                     mode="decode", cache=pools, pos=pos,
                                     block_tables=tables)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return tok, tok == eos, pools, aux
