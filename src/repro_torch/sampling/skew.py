"""Synthetic expert assignments for skew studies: uniform or Zipfian
routing at a fixed per-row budget (counterpart of the reference's
``benchmarks/common.py`` ``zipf_assignments``).

The draw is ``jax.random.choice(key, E, shape=(T, k), p=probs)`` ported:
the cumulative probabilities, ``p_cuml[-1] * (1 - u)`` with ``u`` the
threefry uniforms of ``sampling/threefry.py`` at the same key, and a
left-sided ``searchsorted``: the reference's indices at the same key
(held integer-equal in ``tests/test_torch_examples.py``)."""
from __future__ import annotations

import torch

from repro_torch.sampling.threefry import Key, prng_key, uniform


def choice(key: Key, n: int, shape: tuple, p: torch.Tensor) -> torch.Tensor:
    """``shape`` draws from ``range(n)`` with probabilities ``p`` (n,),
    with replacement, as ``jax.random.choice(key, n, shape, p=p)``."""
    p_cuml = torch.cumsum(p.float(), dim=0)
    count = 1
    for s in shape:
        count *= s
    u = uniform(key, count).reshape(shape)
    r = p_cuml[-1] * (1 - u)
    return torch.searchsorted(p_cuml, r.contiguous())


def zipf_probs(E: int, alpha: float, device=None) -> torch.Tensor:
    """Uniform (``alpha <= 0``) or Zipf(``alpha``) expert probabilities,
    in float32."""
    if alpha <= 0:
        return torch.ones((E,), dtype=torch.float32, device=device) / E
    w = (torch.arange(E, dtype=torch.float32, device=device) + 1.0) \
        ** (-alpha)
    return w / w.sum()


def zipf_assignments(seed: int, T: int, k: int, E: int, alpha: float,
                     device=None):
    """(weights (T, k) f32 = 1/k, indices (T, k) int32): the reference's
    ``zipf_assignments(jax.random.key(seed), T, k, E, alpha)``.  Uniform
    1/k gating isolates the load imbalance (the paper's §4.7)."""
    key = prng_key(seed, device=device)
    idx = choice(key, E, (T, k), zipf_probs(E, alpha, device))
    weights = torch.full((T, k), 1.0 / k, dtype=torch.float32, device=device)
    return weights, idx.to(torch.int32)
