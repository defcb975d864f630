"""Threefry-2x32 counter-based random bits in torch, bit for bit those of
the reference's PRNG (``jax.random`` with its default ``threefry2x32``
implementation and ``jax_threefry_partitionable`` on), so that a seeded
draw gives the reference's token.

torch has no uint32 arithmetic: every word is an int64 tensor holding a
value in [0, 2**32), and each sum is masked back to 32 bits.  Shifts stay
below 2**62, so nothing overflows.  All functions broadcast, run on the
device of their inputs, and never leave it.

* ``prng_key(seed)``: the key of an integer seed, ``(hi, lo)`` words.  A
  32-bit seed (the reference's engines pass int32 seeds) has ``hi = 0``
  and ``lo = seed mod 2**32``.
* ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``, both output
  words.
* ``random_bits(key, n)``: 32-bit words for positions ``0 .. n-1`` of the
  last axis, the partitionable layout: the 64-bit iota split into
  (high, low) counter words, hashed, the two output words xor-ed.
* ``uniform``: the 23 high bits as a mantissa of [1, 2), minus 1, then
  ``max(minval, f * (maxval - minval) + minval)`` in float32.
* ``gumbel``: ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)`` (the
  reference's default "low" mode).
* ``categorical``: ``argmax(gumbel + logits)`` along the last axis."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counter words ``(x0, x1)`` under key
    ``(k0, k1)``: 20 rounds, a key injection every 4.  Arguments are int64
    tensors (or ints) of 32-bit values; the result broadcasts them."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _words(v):
    """32-bit words of an int tensor, or of a Python int (kept on the
    host: a scalar operand needs no copy to the device)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK
    return int(v) & MASK


def prng_key(seed, device=None) -> Key:
    """The key of a 32-bit integer seed (a tensor of seeds gives a key a
    seed): ``(0, seed mod 2**32)``."""
    lo = _words(seed)
    if not isinstance(lo, torch.Tensor):
        lo = torch.full((), lo, dtype=torch.int64, device=device)
    return torch.zeros_like(lo), lo


def fold_in(key: Key, data) -> Key:
    """A new key from ``key`` and the 32-bit ``data`` (int or tensor)."""
    k0, k1 = key
    return threefry2x32(k0, k1, torch.zeros_like(k0), _words(data))


def random_bits(key: Key, n: int) -> torch.Tensor:
    """32-bit words, shape ``key.shape + (n,)``; ``n = 0`` means a scalar
    draw (counter words (0, 0)), shape ``key.shape``."""
    k0, k1 = key
    if n == 0:
        b0, b1 = threefry2x32(k0, k1, 0, 0)
    else:
        iota = torch.arange(n, dtype=torch.int64, device=k0.device)
        b0, b1 = threefry2x32(k0[..., None], k1[..., None], 0, iota)
    return b0 ^ b1


def uniform(key: Key, n: int = 0, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms on ``[minval, maxval)``, the reference's bit
    recipe."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference rounded to float32 on the host, as
    # the reference converts them before it scales
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * span + lo, lo)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """Standard Gumbel float32 draws, shape ``key.shape + (n,)``."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """One index per row of ``logits`` (..., V) float32, drawn by the
    Gumbel-max trick under the row's key (int64)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
