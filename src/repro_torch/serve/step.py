"""Serving steps (counterpart of the slot, paged and speculative steps in
``repro.serve.step``).

* ``slot_prefill`` zeroes slot ``slot``'s cache rows, prefills one prompt
  into them and picks the first token on the device.
* ``slot_decode`` advances the active-slot prefix [0, n) by one token in
  one forward (every MoE layer dispatches the n decode tokens together);
  the token pick and the EOS comparison stay on the device.
* ``paged_step`` runs one forward over a paged step's token rows (decode
  tokens and prompt-chunk tokens together, each at its own position through
  its slot's block-table row), with the same on-device pick and EOS
  comparison.
* ``spec_draft_step`` is one draft proposal per slot over the draft's
  pool, with the draft distribution q it was drawn from.
* ``spec_verify_step`` scores every slot's last token and its k proposals
  (n * (k + 1) rows, each at its own position through its slot's table
  row) in one target forward, so every MoE layer builds one plan for the
  whole sweep, and runs the accept/reject arithmetic on the device.

**Token pick.**  Each step takes a ``SamplingConfig`` (``sampling``,
greedy by default) with per-row ``seeds`` and ``counters`` (the output
index a row produces) and picks with ``sample_rows``: greedy is the
literal argmax and never reads seeds or counters; the other methods draw
a keyed categorical (``repro_torch.sampling``).

None copies anything to the host: the engine makes one transfer per
step.

Observability: each step takes an ``Observability`` bundle and the set of
shapes its engine has run (``shapes``).  The first run of a step kind at a
static shape (``tokens`` for the paged, draft and verify steps,
``prompt_tokens`` for the prefill, ``active_slots`` for the decode step:
the reference's static arguments) calls ``obs.on_trace``, the eager
counterpart of the reference's jit trace, and counts the plans built
inside it (``moe/plans_traced``).  It adds no device work."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (LM, RunConfig, forward, slice_cache_slots,
                                   update_cache_slots)
from repro_torch.obs import NOOP
from repro_torch.sampling import (ROLE_DRAFT, ROLE_RESIDUAL, ROLE_SAMPLE,
                                  SamplingConfig, process_logits, row_key,
                                  sample_rows, uniform_rows)
from repro_torch.sampling import threefry

GREEDY = SamplingConfig()


def serve_batch(cfg: ModelConfig, tokens: torch.Tensor) -> dict:
    """A step's batch: ``tokens`` and, for a model with cross blocks, fp32
    zero ``image_embeds`` of (rows, n_image_tokens, d_model), as the
    reference engine's ``_batch`` feeds them (the engine serves no image:
    with no QKV bias the cached image K/V are zeros)."""
    b = {"tokens": tokens}
    if cfg.cross_attn_every:
        b["image_embeds"] = torch.zeros(
            (tokens.shape[0], cfg.n_image_tokens, cfg.d_model),
            dtype=torch.float32, device=tokens.device)
    return b


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
                 tokens: torch.Tensor, slot: int, *, seeds=None,
                 counters=None, sampling: SamplingConfig = GREEDY, obs=NOOP,
                 shapes: Optional[set] = None):
    """tokens: (1, P) int; seeds, counters: (1,) int (sampling only; the
    prefill's logits give output index 0) -> (tok (1,) int32 on the
    device, cache, aux)."""
    with _first_run(obs, shapes, "prefill_step",
                    prompt_tokens=int(tokens.shape[-1])):
        sub = slice_cache_slots(cache, slot, 1)
        for layer in sub:
            for t in layer.values():
                t.zero_()
        logits, sub, aux = forward(model, cfg, rc, serve_batch(cfg, tokens),
                                   mode="prefill", cache=sub)
        update_cache_slots(cache, sub, slot)
        tok = sample_rows(logits, sampling, seeds, counters)
    return tok, cache, aux


def slot_decode(model: LM, cfg: ModelConfig, rc: RunConfig, cache,
                tokens: torch.Tensor, pos: torch.Tensor, eos: torch.Tensor,
                *, seeds=None, counters=None,
                sampling: SamplingConfig = GREEDY, obs=NOOP,
                shapes: Optional[set] = None):
    """tokens: (n, 1); pos, eos: (n,) int32 (eos -1 = none); seeds,
    counters: (n,) int (sampling only) -> (tok (n,), eos_hit (n,), cache,
    aux), all on the device."""
    n = tokens.shape[0]
    with _first_run(obs, shapes, "decode_step", active_slots=int(n)):
        sub = slice_cache_slots(cache, 0, n)
        logits, sub, aux = forward(model, cfg, rc, serve_batch(cfg, tokens),
                                   mode="decode", cache=sub, pos=pos)
        update_cache_slots(cache, sub, 0)
        tok = sample_rows(logits, sampling, seeds, counters)
    return tok, tok == eos, cache, aux


def paged_step(model: LM, cfg: ModelConfig, rc: RunConfig, pools,
               tokens: torch.Tensor, pos: torch.Tensor, tables: torch.Tensor,
               eos: torch.Tensor, *, seeds=None, counters=None,
               sampling: SamplingConfig = GREEDY, obs=NOOP,
               shapes: Optional[set] = None):
    """tokens: (T, 1); pos, eos: (T,) int32; tables: (T, nb) int32; seeds,
    counters: (T,) int (sampling only) -> (tok (T,), eos_hit (T,), pools,
    aux), all on the device.  Every MoE layer builds one dispatch plan over
    all T rows."""
    with _first_run(obs, shapes, "paged_step", tokens=int(tokens.shape[0])):
        logits, pools, aux = forward(model, cfg, rc, {"tokens": tokens},
                                     mode="decode", cache=pools, pos=pos,
                                     block_tables=tables)
        tok = sample_rows(logits, sampling, seeds, counters)
    return tok, tok == eos, pools, aux


# ----------------------------------------------------------------------
# Speculative decoding (repro_torch.spec drives these)
# ----------------------------------------------------------------------
def spec_draft_step(model: LM, cfg: ModelConfig, rc: RunConfig, pools,
                    tokens: torch.Tensor, pos: torch.Tensor,
                    tables: torch.Tensor, seeds, counters, *,
                    sampling: SamplingConfig = GREEDY, obs=NOOP,
                    shapes: Optional[set] = None):
    """One draft proposal a slot: tokens (n, 1), pos (n,), tables (n, nb)
    -> (tok (n,) int32, q (n, V) or None, pools, aux).  ``q`` is the
    softmax of the processed draft logits, what ``tok`` was drawn from
    (``ROLE_DRAFT`` keys); greedy proposes the argmax and returns no q (its
    verify compares token ids only)."""
    with _first_run(obs, shapes, "spec_draft_step",
                    tokens=int(tokens.shape[0])):
        logits, pools, aux = forward(model, cfg, rc, {"tokens": tokens},
                                     mode="decode", cache=pools, pos=pos,
                                     block_tables=tables)
        if sampling.method == "greedy":
            return sample_rows(logits, sampling, None, None), None, pools, aux
        q = torch.softmax(process_logits(logits, sampling), dim=-1)
        tok = sample_rows(logits, sampling, seeds, counters, role=ROLE_DRAFT)
    return tok, q, pools, aux


def _categorical(seeds, counters, role, probs):
    """Keyed draws from probabilities (n, V) through their logs, as the
    reference's ``categorical(key, log(max(p, 1e-20)))``."""
    return threefry.categorical(row_key(seeds, counters, role),
                                torch.log(torch.clamp_min(probs, 1e-20)))


def spec_verify_step(model: LM, cfg: ModelConfig, rc: RunConfig, pools,
                     tokens: torch.Tensor, pos: torch.Tensor,
                     tables: torch.Tensor, draft_tok: torch.Tensor,
                     draft_q: Optional[torch.Tensor], seeds, counters, *,
                     k: int, sampling: SamplingConfig = GREEDY, obs=NOOP,
                     shapes: Optional[set] = None):
    """Verify every slot's k proposals in one target forward.

    tokens (n * (k + 1), 1): slot s's last emitted token, then its k
    proposals, at positions pos_s .. pos_s + k, all through slot s's table
    row; draft_tok (n, k); draft_q (n, k, V) (sampling only); seeds,
    counters (n,): the slot's seed and the output index of its first
    verify row.  Returns (emitted (n, k + 1) int32, n_emit (n,), pools,
    aux): the accepted proposals, then the bonus or residual token, then
    zeros; ``n_emit`` = accepted + 1.

    * greedy: accept_j = (draft_j == argmax p_j); the accepted prefix is
      the run of leading accepts (cumprod); the bonus is the argmax at the
      first rejection (or after the last proposal).
    * stochastic: accept_j while u_j * q_j(d_j) <= p_j(d_j), u_j the
      ``ROLE_ACCEPT`` uniform of output index counter + j; at the first
      rejection a resample from norm(max(p_a - q_a, 0)) (``ROLE_RESIDUAL``,
      p_a when the residual has no mass); with all k accepted a
      ``ROLE_SAMPLE`` draw from p_k."""
    n = draft_tok.shape[0]
    with _first_run(obs, shapes, "spec_verify_step",
                    tokens=int(tokens.shape[0]), k=k):
        logits, pools, aux = forward(model, cfg, rc, {"tokens": tokens},
                                     mode="decode", cache=pools, pos=pos,
                                     block_tables=tables)
        L = logits.reshape(n, k + 1, -1)                    # (n, k+1, V)
        draft_tok = draft_tok.to(torch.int64)
        if sampling.method == "greedy":
            tgt = torch.argmax(L, dim=-1)                   # (n, k+1)
            accept = (draft_tok == tgt[:, :k]).to(torch.int64)
            a = torch.cumprod(accept, dim=1).sum(dim=1)     # (n,)
            bonus = tgt.gather(1, a[:, None])[:, 0]
        else:
            p = torch.softmax(process_logits(L, sampling), dim=-1)
            u = uniform_rows(seeds, counters, k)            # (n, k)
            p_d = p[:, :k].gather(2, draft_tok[..., None])[..., 0]
            q_d = draft_q.gather(2, draft_tok[..., None])[..., 0]
            accept = (u * q_d <= p_d).to(torch.int64)
            a = torch.cumprod(accept, dim=1).sum(dim=1)     # (n,)
            V = p.shape[-1]
            p_a = p.gather(1, a[:, None, None].expand(n, 1, V))[:, 0]
            q_pad = torch.cat([draft_q, torch.zeros_like(draft_q[:, :1])],
                              dim=1)
            q_a = q_pad.gather(1, a[:, None, None].expand(n, 1, V))[:, 0]
            res = torch.clamp_min(p_a - q_a, 0.0)
            mass = res.sum(dim=-1, keepdim=True)
            res = torch.where(mass > 0.0, res / torch.clamp_min(mass, 1e-20),
                              p_a)
            counters = counters.to(torch.int64)
            tok_res = _categorical(seeds, counters + a, ROLE_RESIDUAL, res)
            bonus_full = _categorical(seeds, counters + k, ROLE_SAMPLE,
                                      p[:, k])
            bonus = torch.where(a == k, bonus_full, tok_res)
        dpad = torch.cat([draft_tok, torch.zeros_like(draft_tok[:, :1])],
                         dim=1)
        idx = torch.arange(k + 1, device=dpad.device)[None, :]
        emitted = torch.where(idx < a[:, None], dpad,
                              torch.where(idx == a[:, None], bonus[:, None],
                                          torch.zeros_like(dpad)))
    return emitted.to(torch.int32), a + 1, pools, aux
