"""The built-in schemes: ``none``, ``int8_expert``, ``int8_channel`` and
``int4_packed`` (counterpart of ``repro.quantization.schemes``: the same
scale formulas in fp32, round half to even, clip, and the same packing, so
payloads and scales are bitwise equal to the reference's).

Every quantizer reduces and packs over the trailing ``(K, N)`` of each
expert block, so a stacked ``(G, E, K, N)`` input quantizes in one call and
one gathered block dequantizes with the code the whole stack uses.

* ``int8_expert``: one scale per expert matrix, ``max|w| / 127 + 1e-12``;
  declared layer error 5 %.
* ``int8_channel``: one scale per (expert, output channel), ``max|w[:, n]|
  / 127 + 1e-12``, scales ``(..., E, 1, N)``; declared 4 %.
* ``int4_packed``: one scale per expert, ``max|w| / 7 + 1e-12``, values in
  [-7, 7], two nibbles per byte along K (byte r holds logical rows 2r in
  the low and 2r+1 in the high nibble); declared 60 %.  An odd K is stored
  with one zero pad row, tagged ``("pad_k", 1)``."""
from __future__ import annotations

import torch

from repro_torch.quantization.base import QuantScheme, register_scheme
from repro_torch.quantization.tensor import QuantTensor


def pack_int4(q4: torch.Tensor) -> torch.Tensor:
    """(..., K, N) integers in [-8, 7] -> (..., K//2, N) int8; byte r packs
    logical rows (2r, 2r+1) as (low, high) nibbles."""
    K = q4.shape[-2]
    if K % 2:
        raise ValueError(f"int4 packing needs an even K axis, got {K}")
    q = q4.to(torch.int32).reshape(*q4.shape[:-2], K // 2, 2, q4.shape[-1])
    byte = (q[..., 0, :] & 0xF) | ((q[..., 1, :] & 0xF) << 4)
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) int8 -> (..., K, N) int32 in [-8, 7] (sign-extended
    nibbles, rows interleaved back to logical order)."""
    qi = packed.to(torch.int32)
    lo = qi & 0xF
    lo = lo - ((lo & 0x8) << 1)
    hi = (qi >> 4) & 0xF
    hi = hi - ((hi & 0x8) << 1)
    pairs = torch.stack([lo, hi], dim=-2)            # (..., K//2, 2, N)
    return pairs.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                         packed.shape[-1])


def _absmax(w: torch.Tensor, dims) -> torch.Tensor:
    """fp32 max |w| over ``dims`` (kept).  abs and max are exact in w's own
    dtype, so no fp32 copy of the stack is made for them."""
    return w.abs().amax(dim=dims, keepdim=True).float()


def _round_clip(w: torch.Tensor, s: torch.Tensor, lim: int) -> torch.Tensor:
    """round-half-even(w / s) clipped to [-lim, lim], in fp32."""
    return (w.float() / s).round_().clamp_(-lim, lim)


@register_scheme("none")
class NoneScheme(QuantScheme):
    """Identity: the params stay dense tensors."""
    bits = 32
    rel_error_bound = 0.0
    kernel_format = "dense"

    def quantize(self, w):
        return w

    def dequantize(self, q, s, dtype):
        raise TypeError("the 'none' scheme never produces a QuantTensor")


@register_scheme("int8_expert")
class Int8ExpertScheme(QuantScheme):
    """Per-expert symmetric int8 (scale = max|W_e| / 127)."""
    bits = 8
    rel_error_bound = 0.05
    kernel_format = "int8"

    def quantize(self, w):
        s = _absmax(w, (-2, -1)) / 127.0 + 1e-12
        q = _round_clip(w, s, 127).to(torch.int8)
        return QuantTensor(q, s, w.dtype, self.name)

    def dequantize(self, q, s, dtype):
        return (q.float() * s).to(dtype)


@register_scheme("int8_channel")
class Int8ChannelScheme(QuantScheme):
    """Per-(expert, output channel) symmetric int8: scales (..., E, 1, N)."""
    bits = 8
    rel_error_bound = 0.04
    kernel_format = "int8"

    def quantize(self, w):
        s = _absmax(w, -2) / 127.0 + 1e-12               # (..., 1, N)
        q = _round_clip(w, s, 127).to(torch.int8)
        return QuantTensor(q, s, w.dtype, self.name)

    def dequantize(self, q, s, dtype):
        return (q.float() * s).to(dtype)


@register_scheme("int4_packed")
class Int4PackedScheme(QuantScheme):
    """Per-expert symmetric int4, two nibbles per byte along K (scale =
    max|W_e| / 7, range [-7, 7]).  An odd K is stored with one zero pad row
    and tagged ``("pad_k", 1)``; dequantization strips it.  The kernels
    take the padless layout only (``kernels/ops.py`` materializes a padded
    one, as the reference does)."""
    bits = 4
    rel_error_bound = 0.6
    kernel_format = "int4"

    def quantize(self, w):
        s = _absmax(w, (-2, -1)) / 7.0 + 1e-12
        q4 = _round_clip(w, s, 7)
        pad = w.shape[-2] % 2
        if pad:
            q4 = torch.cat([q4, q4.new_zeros((*q4.shape[:-2], 1,
                                              q4.shape[-1]))], dim=-2)
        return QuantTensor(pack_int4(q4), s, w.dtype, self.name,
                           (("pad_k", 1),) if pad else ())

    def dequantize(self, q, s, dtype):
        return (unpack_int4(q).float() * s).to(dtype)

    def logical_shape(self, q_shape):
        return tuple(q_shape[:-2]) + (2 * q_shape[-2], q_shape[-1])
