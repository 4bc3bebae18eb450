"""Posit codec: the wrappers of the CUDA codec kernels (K3).

Port of the Pallas TPU kernels ``repro/kernels/posit_codec.py::
posit_encode / posit_decode / posit_quantize`` as ``csrc/posit_codec.cu``:
element-wise f32/bf16 -> pattern (RNE on the pattern, saturating, never
to zero or NaR), pattern -> f32, and decode . encode.  The kernels are
bit-identical to their plain versions, the ``repro_torch.numerics``
codec, which these wrappers take for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.numerics import P16, PositSpec, decode, encode, pack16, unpack16

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
