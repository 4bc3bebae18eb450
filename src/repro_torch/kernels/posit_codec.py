"""Posit codec and element-wise multipliers: the wrappers of the CUDA
kernels K3 and K4.

Port of the Pallas TPU kernels in ``repro/kernels/posit_codec.py``:

* K3, ``posit_encode / posit_decode / posit_quantize`` as
  ``csrc/posit_codec.cu``: element-wise f32/bf16 -> pattern (RNE on the
  pattern, saturating, never to zero or NaR), pattern -> f32, and
  decode . encode.
* K4, ``plam_mul_elementwise / exact_mul_elementwise`` as
  ``csrc/posit_mul.cu``: pattern x pattern -> pattern, the PLAM product
  and the exact product with RNE (the conformance oracles' multipliers).

The kernels are bit-identical to their plain versions, the
``repro_torch.numerics`` functions, which these wrappers take for CPU
tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.numerics import (
    P16,
    PositSpec,
    decode,
    encode,
    exact_mul,
    pack16,
    plam_mul,
    unpack16,
)
from repro_torch.numerics.plam import exact_mul_supported

from . import _lib

_FLOATS = (torch.float32, torch.bfloat16)
_PATTERNS = (torch.int32, torch.int16)


def encode_plain(x: torch.Tensor, spec: PositSpec, out_dtype=torch.int32):
    bits = encode(x, spec)
    return pack16(bits) if out_dtype == torch.int16 else bits


def decode_plain(bits: torch.Tensor, spec: PositSpec):
    return decode(unpack16(bits) if bits.dtype == torch.int16 else bits, spec)


def quantize_plain(x: torch.Tensor, spec: PositSpec):
    return decode(encode(x, spec), spec)


def posit_encode(
    x: torch.Tensor,
    spec: PositSpec = P16,
    *,
    out_dtype: torch.dtype = torch.int32,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """float32/bfloat16 -> posit patterns, int32 or (n <= 16) int16."""
    if out_dtype not in _PATTERNS:
        raise TypeError(f"patterns are stored as int32 or int16, not {out_dtype}")
    if out_dtype == torch.int16 and spec.n > 16:
        raise ValueError("int16 patterns hold posits of at most 16 bits")
    if not _lib.wants_kernel(x, use_kernel):
        return encode_plain(x, spec, out_dtype)
    _lib.require(x, "x", _FLOATS)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel():
        err = _lib.library().posit_encode_launch(
            x.data_ptr(), _lib.DTYPE_CODES[x.dtype], out.data_ptr(),
            _lib.DTYPE_CODES[out_dtype], x.numel(), spec.n, spec.es, _lib.stream_ptr(x))
        _lib.check_launch("posit_codec", err)
    return out


def posit_decode(
    bits: torch.Tensor, spec: PositSpec = P16, *, use_kernel: Optional[bool] = None
) -> torch.Tensor:
    """int32/int16 posit patterns -> float32 values."""
    if not _lib.wants_kernel(bits, use_kernel):
        return decode_plain(bits, spec)
    _lib.require(bits, "bits", _PATTERNS)
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    if bits.numel():
        err = _lib.library().posit_decode_launch(
            bits.data_ptr(), _lib.DTYPE_CODES[bits.dtype], out.data_ptr(), bits.numel(),
            spec.n, spec.es, _lib.stream_ptr(bits))
        _lib.check_launch("posit_codec", err)
    return out


def posit_quantize(
    x: torch.Tensor, spec: PositSpec = P16, *, use_kernel: Optional[bool] = None
) -> torch.Tensor:
    """Project float32/bfloat16 onto the posit grid -> float32."""
    if not _lib.wants_kernel(x, use_kernel):
        return quantize_plain(x, spec)
    _lib.require(x, "x", _FLOATS)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel():
        err = _lib.library().posit_quantize_launch(
            x.data_ptr(), _lib.DTYPE_CODES[x.dtype], out.data_ptr(), x.numel(),
            spec.n, spec.es, _lib.stream_ptr(x))
        _lib.check_launch("posit_codec", err)
    return out


def _posit_mul(a_bits, b_bits, spec, use_kernel, exact: bool):
    if a_bits.shape != b_bits.shape:
        raise ValueError(f"operand shapes differ: {tuple(a_bits.shape)} vs "
                         f"{tuple(b_bits.shape)}")
    if exact and not exact_mul_supported(spec):
        raise ValueError("exact_mul supports n <= 16")
    if not _lib.wants_kernel(a_bits, use_kernel):
        return (exact_mul if exact else plam_mul)(a_bits, b_bits, spec)
    _lib.require(a_bits, "a_bits", (torch.int32,))
    _lib.require(b_bits, "b_bits", (torch.int32,))
    if b_bits.device != a_bits.device:
        raise ValueError("a_bits and b_bits lie on different devices")
    out = torch.empty(a_bits.shape, dtype=torch.int32, device=a_bits.device)
    if a_bits.numel():
        err = _lib.library().posit_mul_launch(
            a_bits.data_ptr(), b_bits.data_ptr(), out.data_ptr(), a_bits.numel(), spec.n,
            spec.es, int(exact), _lib.stream_ptr(a_bits))
        _lib.check_launch("posit_mul", err)
    return out


def plam_mul_elementwise(
    a_bits: torch.Tensor, b_bits: torch.Tensor, spec: PositSpec = P16, *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Element-wise PLAM pattern product: two int32 pattern tensors of one
    shape -> int32 patterns."""
    return _posit_mul(a_bits, b_bits, spec, use_kernel, exact=False)


def exact_mul_elementwise(
    a_bits: torch.Tensor, b_bits: torch.Tensor, spec: PositSpec = P16, *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Element-wise exact posit pattern product with RNE (n <= 16)."""
    return _posit_mul(a_bits, b_bits, spec, use_kernel, exact=True)
