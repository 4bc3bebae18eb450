"""Posit codec and element-wise multipliers: the wrappers of the CUDA
kernels K3 and K4.

Port of the Pallas TPU kernels in ``repro/kernels/posit_codec.py``:

* K3, ``posit_encode / posit_decode / posit_quantize`` as
  ``csrc/posit_codec.cu``: element-wise f32/bf16 -> pattern (RNE on the
  pattern, saturating, never to zero or NaR), pattern -> f32, and
  decode . encode.  Encode and quantize take one of two paths by one rule
  (:func:`encode_path`): a bf16 tensor of at least
  TABLE_MIN_NUMEL lanes looks each lane up in a table of the 32,768
  non-negative bf16 patterns in shared memory (:func:`bf16_table`,
  :func:`quantize_table`), the rest computes each lane's fields; decode
  always computes.
* K4, ``plam_mul_elementwise / exact_mul_elementwise`` as
  ``csrc/posit_mul.cu``: pattern x pattern -> pattern, the PLAM product
  and the exact product with RNE (the conformance oracles' multipliers).

The kernels are bit-identical to their plain versions, the
``repro_torch.numerics`` functions, which these wrappers take for CPU
tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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

#: lanes from which a bf16 encode or quantize takes the table path (every
#: weight of the serving models, a training batch's activations); fewer
#: (decode-step activations, conformance vectors) compute
TABLE_MIN_NUMEL = 1 << 20
#: the non-negative bf16 patterns, whose posits give all 65,536 by sign
TABLE_ENTRIES = 1 << 15

# (kind, n, es, device type, device index) -> the card's table (or the
# meta device's), built once
_tables: Dict[Tuple[str, int, int, str, Optional[int]], torch.Tensor] = {}


def _by_slices(fn, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``fn`` over at most PLAIN_LANES lanes of ``x`` at a time, into one
    ``out_dtype`` tensor of ``x``'s shape: the plain codec's int64
    temporaries over a full-width weight (1.25 G lanes for qwen2-vl-72b's
    unembed) would need tens of GB at once."""
    from .ref import PLAIN_LANES

    if x.numel() <= PLAIN_LANES:
        return fn(x)
    flat = x.reshape(-1)
    out = torch.empty(flat.shape, dtype=out_dtype, device=x.device)
    for i in range(0, flat.numel(), PLAIN_LANES):
        out[i:i + PLAIN_LANES] = fn(flat[i:i + PLAIN_LANES])
    return out.reshape(x.shape)


def encode_plain(x: torch.Tensor, spec: PositSpec, out_dtype=torch.int32):
    """The plain encode, by slices (:func:`_by_slices`)."""
    def fn(part):
        bits = encode(part, spec)
        return pack16(bits) if out_dtype == torch.int16 else bits

    return _by_slices(fn, x, out_dtype)


def decode_plain(bits: torch.Tensor, spec: PositSpec):
    return decode(unpack16(bits) if bits.dtype == torch.int16 else bits, spec)


def quantize_plain(x: torch.Tensor, spec: PositSpec):
    """The plain quantize (decode . encode), by slices (:func:`_by_slices`)."""
    return _by_slices(lambda part: decode(encode(part, spec), spec), x, torch.float32)


def encode_path(x_dtype: torch.dtype, numel: int, spec: PositSpec) -> str:
    """The kernel path that encodes or quantizes ``numel`` lanes of
    ``x_dtype`` at ``spec``, for every output type: ``"table"`` for bf16
    with n <= 16 from TABLE_MIN_NUMEL lanes, ``"computed"`` otherwise."""
    if x_dtype == torch.bfloat16 and spec.n <= 16 and numel >= TABLE_MIN_NUMEL:
        return "table"
    return "computed"


def _magnitudes(device=None) -> torch.Tensor:
    """The 32,768 non-negative bf16 patterns, in order."""
    return torch.arange(TABLE_ENTRIES, dtype=torch.int16, device=device).view(torch.bfloat16)


def _card_table(kind: str, spec: PositSpec, device, build) -> torch.Tensor:
    """The ``kind`` table at ``spec`` on ``device``, made by ``build(device)``
    on first use and cached per (kind, spec, device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (kind, spec.n, spec.es, device.type, device.index)
    table = _tables.get(key)
    if table is None:
        table = _tables[key] = build(device)
    return table


def bf16_table_plain(spec: PositSpec) -> torch.Tensor:
    """The table path's table, plain: the Posit<n,es> patterns of the
    32,768 non-negative bf16 patterns (entry ``bits & 0x7FFF``), int16
    holding the uint16 patterns."""
    return pack16(encode(_magnitudes(), spec))


def bf16_table(spec: PositSpec, device: torch.device) -> torch.Tensor:
    """The table path's table on ``device``: built once per (spec,
    device) by the computed path over the 32,768 non-negative bf16
    patterns (counted as ``posit_codec_table``), then cached."""
    def build(dev):
        table = torch.empty(TABLE_ENTRIES, dtype=torch.int16, device=dev)
        _encode_launch(_magnitudes(dev), table, spec, None, "posit_codec_table")
        return table

    return _card_table("encode", spec, device, build)


def quantize_table_plain(spec: PositSpec) -> torch.Tensor:
    """The quantize's table path's table, plain: the bf16 bits of
    decode(encode(x)) for the 32,768 non-negative bf16 patterns x (entry
    ``bits & 0x7FFF``), the high 16 bits of each f32 as int16.  A negative
    x gives its entry with the sign bit set, except where the entry is +0
    or NaN (``0x7FC0``)."""
    q = decode(encode(_magnitudes(), spec), spec)
    return (q.view(torch.int32) >> 16).to(torch.int16)


def quantize_table(spec: PositSpec, device: torch.device) -> torch.Tensor:
    """The quantize's table on ``device``: built once per (spec, device) by
    the computed quantize over the 32,768 non-negative bf16 patterns
    (counted as ``posit_codec_quant_table``), its f32 results' high 16 bits
    kept; raises where a result is not a bf16 value (low 16 bits set)."""
    def build(dev):
        q = torch.empty(TABLE_ENTRIES, dtype=torch.float32, device=dev)
        _quantize_launch(_magnitudes(dev), q, spec, None, "posit_codec_quant_table")
        bits = q.view(torch.int32)
        inexact = 0 if q.is_meta else int(torch.count_nonzero(bits & 0xFFFF))
        if inexact:
            raise ValueError(f"{spec}: {inexact} quantized bf16 magnitudes are not bf16 "
                             "values; the quantize table cannot hold them")
        return (bits >> 16).to(torch.int16)

    return _card_table("quantize", spec, device, build)


def _encode_launch(x, out, spec, table, counter):
    _lib.launch(counter, out, lambda: _lib.library().posit_encode_launch(
        x.data_ptr(), _lib.DTYPE_CODES[x.dtype], out.data_ptr(), _lib.DTYPE_CODES[out.dtype],
        x.numel(), spec.n, spec.es, None if table is None else table.data_ptr(),
        _lib.stream_ptr(x)), inputs=(x,), int_ops=x.numel())  # one operation a lane


def _quantize_launch(x, out, spec, table, counter):
    _lib.launch(counter, out, lambda: _lib.library().posit_quantize_launch(
        x.data_ptr(), _lib.DTYPE_CODES[x.dtype], out.data_ptr(), x.numel(), spec.n, spec.es,
        None if table is None else table.data_ptr(), _lib.stream_ptr(x)),
        inputs=(x,), int_ops=x.numel())


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
        table = (bf16_table(spec, x.device)
                 if encode_path(x.dtype, x.numel(), spec) == "table" else None)
        _encode_launch(x, out, spec, table, "posit_codec")
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
        _lib.launch("posit_codec", out, lambda: _lib.library().posit_decode_launch(
            bits.data_ptr(), _lib.DTYPE_CODES[bits.dtype], out.data_ptr(), bits.numel(),
            spec.n, spec.es, _lib.stream_ptr(bits)), inputs=(bits,), int_ops=bits.numel())
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
        table = (quantize_table(spec, x.device)
                 if encode_path(x.dtype, x.numel(), spec) == "table" else None)
        _quantize_launch(x, out, spec, table, "posit_codec")
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
        per_lane = _lib.source_constant(
            "posit_mul.cu", "kExactMulAluOpsPerLane" if exact else "kPlamMulAluOpsPerLane")
        _lib.launch("posit_mul", out, lambda: _lib.library().posit_mul_launch(
            a_bits.data_ptr(), b_bits.data_ptr(), out.data_ptr(), a_bits.numel(), spec.n,
            spec.es, int(exact), _lib.stream_ptr(a_bits)),
            inputs=(a_bits, b_bits), int_ops=per_lane * a_bits.numel())
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
