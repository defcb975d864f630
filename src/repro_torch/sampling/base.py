"""Seeded sampling: logits processors and keyed per-row draws (counterpart
of ``repro.sampling.base``).

A sampler is a logits processor ``fn(logits, cfg) -> processed logits``
registered under a name:

* ``greedy``: identity; ``sample_rows`` keeps the literal ``argmax`` and
  never reads seeds or counters, so greedy tokens are those of the greedy
  engine.
* ``temperature``: logits / T.
* ``top_k``: temperature, then all but the k largest logits set to -inf.
* ``top_p``: temperature, then the nucleus: a token is kept while the
  probability mass before it (descending order) is below p, so the top-1
  token is always kept.

**Keys.**  The draw that gives a request's output token ``i`` is keyed by
``fold_in(fold_in(PRNGKey(seed), i), role)``: a pure function of the
request's seed, the output index and the role, so a request's tokens do
not depend on its batch, its slot or a preemption.  The keys and draws are
the reference's bit for bit (``sampling/threefry.py``): the same seed gives
the reference's token.  ``role`` separates the streams one output index
can consume: the target's sample, the draft's proposal, the accept
uniform and the residual resample of speculative verification.

Everything here runs on the logits' device on (T, V) row batches, with no
host transfer: the engine keeps one transfer a step."""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.sampling import threefry

ROLE_SAMPLE = 0        # the target's sample (also the speculative bonus)
ROLE_DRAFT = 1         # the draft model's proposal
ROLE_ACCEPT = 2        # the rejection test's uniform
ROLE_RESIDUAL = 3      # the residual resample after a rejection


class SamplingConfig(NamedTuple):
    """The engine's sampling method and parameters; ``seed`` is the base
    from which a request without its own seed derives one (seed + rid)."""
    method: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0                 # 0 = no top-k cut
    top_p: float = 1.0             # 1.0 = no nucleus cut
    seed: int = 0


Sampler = Callable[[torch.Tensor, SamplingConfig], torch.Tensor]

_SAMPLERS: Dict[str, Sampler] = {}


def register_sampler(name: str):
    def deco(fn: Sampler) -> Sampler:
        _SAMPLERS[name] = fn
        return fn
    return deco


def get_sampler(name: str) -> Sampler:
    if name not in _SAMPLERS:
        raise ValueError(f"unknown sampling method {name!r}; "
                         f"registered: {sorted(_SAMPLERS)}")
    return _SAMPLERS[name]


def available_samplers():
    return sorted(_SAMPLERS)


# ----------------------------------------------------------------------
# Processors
# ----------------------------------------------------------------------
def _scale(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    t = max(float(cfg.temperature), 1e-6)
    return logits if t == 1.0 else logits / t


@register_sampler("greedy")
def greedy(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    return logits


@register_sampler("temperature")
def temperature(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    return _scale(logits, cfg)


@register_sampler("top_k")
def top_k(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    logits = _scale(logits, cfg)
    k = int(cfg.top_k)
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


@register_sampler("top_p")
def top_p(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    logits = _scale(logits, cfg)
    p = float(cfg.top_p)
    if p >= 1.0:
        return logits
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    # exclusive cumulative mass: a token is kept while the mass before it
    # is below p (the top-1 token always is)
    cum = torch.cumsum(probs, dim=-1) - probs
    thr = torch.where(cum < p, srt, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(logits < thr, float("-inf"), logits)


def process_logits(logits: torch.Tensor,
                   cfg: SamplingConfig) -> torch.Tensor:
    """The configured method's processed logits (greedy: unchanged)."""
    return get_sampler(cfg.method)(logits, cfg)


# ----------------------------------------------------------------------
# Keyed per-row draws
# ----------------------------------------------------------------------
def row_key(seeds, counters, role: int) -> threefry.Key:
    """The draw key of output index ``counters`` of the requests seeded
    ``seeds`` under ``role`` (ints, or int tensors that broadcast)."""
    device = next((t.device for t in (seeds, counters)
                   if isinstance(t, torch.Tensor)), None)
    k = threefry.prng_key(seeds, device)
    k = threefry.fold_in(k, counters)
    return threefry.fold_in(k, role)


def sample_rows(logits: torch.Tensor, cfg: SamplingConfig,
                seeds: torch.Tensor, counters: torch.Tensor,
                role: int = ROLE_SAMPLE) -> torch.Tensor:
    """One int32 token a row of ``logits`` (T, V).  Greedy is the literal
    argmax (``seeds`` and ``counters`` are never read); every other method
    draws from the processed logits under the row's (seed, counter, role)
    key."""
    if cfg.method == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    proc = process_logits(logits, cfg)
    key = row_key(seeds, counters, role)
    return threefry.categorical(key, proc).to(torch.int32)


def uniform_rows(seeds: torch.Tensor, counters: torch.Tensor, k: int,
                 role: int = ROLE_ACCEPT) -> torch.Tensor:
    """(T, k) float32 uniforms: column i of row t is drawn under key
    (seeds[t], counters[t] + i, role), the accept stream of speculative
    verification, aligned with the output index each column decides."""
    cols = torch.arange(k, dtype=torch.int64, device=counters.device)
    key = row_key(seeds[:, None], counters[:, None].to(torch.int64) + cols,
                  role)
    return threefry.uniform(key)
