"""``QuantTensor``: a compressed expert-weight stack (counterpart of
``repro.quantization.tensor``).

A plain class over two torch tensors, with no pytree registration:

* ``q``: the stored payload, whose layout the scheme owns, e.g.
  ``(E, K, N) int8`` or two nibbles per byte, ``(E, K//2, N) int8``;
* ``s``: the fp32 scales, ``(E, 1, 1)`` per expert or ``(E, 1, N)`` per
  output channel;
* ``dtype``: the dequantization target (a ``torch.dtype``), ``scheme``: the
  registered scheme's name, ``meta``: the scheme's static layout tags as a
  ``(key, value)`` tuple (``int4_packed``'s ``("pad_k", 1)`` marks an odd
  logical K stored with one zero pad row).

It stands in for the dense ``(E, K, N)`` stack it compresses: ``shape`` is
the logical shape, ``w[idx]`` gathers the compressed blocks and their scales
and dequantizes them, ``materialize()`` expands the whole stack.  The
kernels never call either: they take ``q`` and the scales as operands and
dequantize each weight tile on chip (``kernels/ops.py``).  Inside an
``nn.Module`` the tensors are registered buffers and the module rebuilds the
``QuantTensor`` around them (``models/lm.py``), so ``.to()`` and
``state_dict`` see them."""
from __future__ import annotations

import torch


class QuantTensor:
    """Scheme-tagged compressed weight stack (see module docstring)."""

    __slots__ = ("q", "s", "dtype", "scheme", "meta")

    def __init__(self, q: torch.Tensor, s: torch.Tensor, dtype,
                 scheme: str, meta: tuple = ()):
        self.q = q
        self.s = s
        self.dtype = dtype
        self.scheme = scheme
        self.meta = tuple(meta)

    @property
    def _scheme(self):
        from repro_torch.quantization.base import get_scheme
        return get_scheme(self.scheme)

    @property
    def _pad_k(self) -> int:
        return dict(self.meta).get("pad_k", 0)

    def _strip(self, w: torch.Tensor) -> torch.Tensor:
        """Drop stored pad rows (packed schemes with an odd logical K)."""
        return w[..., :w.shape[-2] - self._pad_k, :] if self._pad_k else w

    @property
    def shape(self) -> tuple:
        """The LOGICAL shape of the dense stack (pad rows excluded)."""
        shp = list(self._scheme.logical_shape(tuple(self.q.shape)))
        shp[-2] -= self._pad_k
        return tuple(shp)

    @property
    def nbytes(self) -> int:
        """Stored payload and scale bytes: what a weight read moves."""
        return (self.q.numel() * self.q.element_size()
                + self.s.numel() * self.s.element_size())

    def __getitem__(self, idx) -> torch.Tensor:
        """Gather along the leading axes, then dequantize (the trailing
        (K, N) block stays whole, so pad rows strip cleanly)."""
        return self._strip(
            self._scheme.dequantize(self.q[idx], self.s[idx], self.dtype))

    def materialize(self) -> torch.Tensor:
        """The whole dense stack in ``dtype``."""
        return self._strip(
            self._scheme.dequantize(self.q, self.s, self.dtype))

    def with_dtype(self, dtype) -> "QuantTensor":
        """The same payload with another dequantization target (the layer
        applies its compute dtype at dispatch time)."""
        if dtype == self.dtype:
            return self
        return QuantTensor(self.q, self.s, dtype, self.scheme, self.meta)

    def __repr__(self) -> str:
        meta = f", meta={self.meta}" if self.meta else ""
        return (f"QuantTensor(scheme={self.scheme!r}, shape={self.shape}, "
                f"stored={tuple(self.q.shape)}:{self.q.dtype}, "
                f"dtype={self.dtype}{meta})")
