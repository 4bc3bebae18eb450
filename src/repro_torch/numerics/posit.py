"""Vectorized Posit<n,es> codec in PyTorch.

Port of ``repro/numerics/posit.py``.  Patterns are carried in ``int32``
tensors at the interface (one posit per lane; unused high bits zero).
Torch has few ``uint32`` operations and no clz or popcount, so the
field arithmetic runs in ``int64`` holding values masked to 32 bits:
right shifts of non-negative values are then logical, left shifts are
masked back to 32 bits, and ``_shl``/``_shr`` return 0 for shifts
outside ``[0, 32)`` exactly as the reference's do.  ``decode`` and
``encode`` are bit-identical to the reference for every spec with
n <= 24 (and follow its extra RNE step for wider posits).
"""
from __future__ import annotations

import dataclasses

import torch

MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PositSpec:
    """Static description of a Posit<n,es> format."""

    n: int = 16
    es: int = 1

    def __post_init__(self):
        if not 4 <= self.n <= 32:
            raise ValueError("posit width must be in [4, 32]")
        if not 0 <= self.es <= 3:
            raise ValueError("posit es must be in [0, 3]")
        if self.fbmax < 1:
            raise ValueError(f"Posit<{self.n},{self.es}> has no fraction bits")
        # decode-to-f32 requires the scale range to fit the f32 exponent
        if (self.n - 2) * (1 << self.es) > 126:
            raise ValueError(f"Posit<{self.n},{self.es}> scale exceeds f32")

    @property
    def useed_exp(self) -> int:  # log2(useed) = 2^es
        return 1 << self.es

    @property
    def fbmax(self) -> int:
        # sign + minimal 2-bit regime + es exponent bits
        return self.n - 3 - self.es

    @property
    def mask_n(self) -> int:
        return (1 << self.n) - 1 if self.n < 32 else MASK32

    @property
    def nar(self) -> int:
        return 1 << (self.n - 1)

    @property
    def nar_i32(self) -> int:
        """The NaR pattern as a signed int32 value."""
        return self.nar - (1 << 32) if self.n == 32 else self.nar

    @property
    def maxpos_body(self) -> int:
        return (1 << (self.n - 1)) - 1

    @property
    def max_scale(self) -> int:  # scale of maxpos
        return (self.n - 2) * self.useed_exp


P16 = PositSpec(16, 1)
P8 = PositSpec(8, 0)
P32 = PositSpec(32, 2)


def u32(bits: torch.Tensor) -> torch.Tensor:
    """Reinterpret integer patterns as uint32 values held in int64."""
    return bits.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same 32 bits."""
    return ((x & MASK32) ^ 0x80000000) - 0x80000000


def bits_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding f32 bits -> float32 tensor (a bitcast)."""
    return to_i32(x).to(torch.int32).view(torch.float32)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values (in int64) by a 5-step binary search."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - s))  # the top s bits are all zero
        n = n + small.to(torch.int64) * s
        x = torch.where(small, (x << s) & MASK32, x)
    return n + (x == 0).to(torch.int64)


def _as_shift(s, like: torch.Tensor) -> torch.Tensor:
    if isinstance(s, torch.Tensor):
        return s.to(torch.int64)
    return torch.full_like(like, int(s), dtype=torch.int64)


def _shl(x: torch.Tensor, s) -> torch.Tensor:
    """Safe variable left shift of uint32 values: 0 when s >= 32 or s < 0."""
    s = _as_shift(s, x)
    ok = (s >= 0) & (s < 32)
    sc = s.clamp(0, 31)
    return torch.where(ok, (x << sc) & MASK32, torch.zeros_like(x))


def _shr(x: torch.Tensor, s) -> torch.Tensor:
    """Safe variable logical right shift: 0 when s >= 32 or s < 0."""
    s = _as_shift(s, x)
    ok = (s >= 0) & (s < 32)
    sc = s.clamp(0, 31)
    return torch.where(ok, x >> sc, torch.zeros_like(x))


def decode_fields(bits: torch.Tensor, spec: PositSpec):
    """Unpack patterns -> (sign, scale, frac, is_zero, is_nar).

    ``sign``, ``scale`` and ``frac`` are int64 tensors: sign 0 or 1,
    scale = k * 2^es + e, and frac in [0, 2^fbmax) left-aligned to
    ``spec.fbmax`` fractional bits, so that
    value = (-1)^s 2^scale (1 + frac/2^fbmax).  Zero, NaR and the sign
    are classified from the raw bits.
    """
    n, es, fb = spec.n, spec.es, spec.fbmax
    u = u32(bits) & spec.mask_n
    is_zero = u == 0
    is_nar = u == spec.nar
    sign = (u >> (n - 1)) & 1
    mag = torch.where(sign == 1, (-u) & spec.mask_n, u)
    body = mag & spec.maxpos_body
    # left-align the n-1 body bits so the first regime bit is bit 31
    v = (body << (33 - n)) & MASK32
    r0 = v >> 31
    pad = (1 << (33 - n)) - 1
    w = torch.where(r0 == 1, (~v) & MASK32, v) | pad
    m = _clz32(w)  # regime run length, in [1, n-1]
    k = torch.where(r0 == 1, m - 1, -m)
    rest = _shl(v, m + 1)  # exponent+fraction bits, left-aligned at bit 31
    e = rest >> (32 - es) if es > 0 else torch.zeros_like(k)
    frac = ((rest << es) & MASK32) >> (32 - fb)
    scale = k * (1 << es) + e
    return sign, scale, frac, is_zero, is_nar


def encode_fields(sign, scale, frac, fbits, spec: PositSpec) -> torch.Tensor:
    """Pack (sign, scale, fraction) -> int32 posit pattern with RNE.

    ``frac`` holds ``fbits`` fractional bits (value = frac / 2^fbits in
    [0, 1)); ``fbits`` is a Python int or a per-element tensor.  Pattern
    space round-to-nearest-even (SoftPosit's rule): the carry rolls
    fraction -> exponent -> regime, results saturate at +-maxpos and a
    non-zero value never rounds to zero or NaR.
    """
    n, es = spec.n, spec.es
    scale = scale.to(torch.int64)
    frac = frac.to(torch.int64) & MASK32
    fbits = _as_shift(fbits, scale)
    if es > 0:
        k = scale >> es  # arithmetic shift == floor division
        e = scale & ((1 << es) - 1)
    else:
        k = scale
        e = torch.zeros_like(scale)

    too_big = k >= n - 2
    too_small = k <= -(n - 1)
    kc = k.clamp(-(n - 2), n - 3)
    m = torch.where(kc >= 0, kc + 2, 1 - kc)  # regime width incl. terminator
    avail = (n - 1) - m  # bits left for exponent + fraction
    ones = torch.ones_like(kc)
    regime = torch.where(kc >= 0, (_shl(ones, kc + 2) - 2) & MASK32, ones)

    combined = _shl(e, fbits) | frac  # es + fbits significant bits
    shift_out = es + fbits - avail
    kept = torch.where(
        shift_out > 0, _shr(combined, shift_out), _shl(combined, -shift_out)
    )
    round_bit = torch.where(
        shift_out > 0, _shr(combined, shift_out - 1) & 1, torch.zeros_like(combined)
    )
    sticky_mask = torch.where(
        shift_out > 1,
        (_shl(torch.ones_like(combined), shift_out - 1) - 1) & MASK32,
        torch.zeros_like(combined),
    )
    sticky = (combined & sticky_mask) != 0
    # ties-to-even on the FULL pattern (regime included)
    body_pre = (_shl(regime, avail) + kept) & MASK32
    inc = round_bit & (sticky | ((body_pre & 1) == 1)).to(torch.int64)
    body = (body_pre + inc) & MASK32
    body = body.clamp(max=spec.maxpos_body)  # carry past maxpos saturates
    body = torch.where(too_big, torch.full_like(body, spec.maxpos_body), body)
    body = torch.where(too_small, torch.ones_like(body), body)  # minpos

    pattern = torch.where(sign.to(torch.int64) == 1, (-body) & spec.mask_n, body)
    return to_i32(pattern).to(torch.int32)


def decode(bits: torch.Tensor, spec: PositSpec) -> torch.Tensor:
    """Posit patterns -> float32 values (bit-exact for n <= 24)."""
    fb = spec.fbmax
    sign, scale, frac, is_zero, is_nar = decode_fields(bits, spec)
    if fb <= 23:
        mant = frac << (23 - fb)
    else:  # one extra RNE step into the f32 mantissa
        sh = fb - 23
        lower = frac & ((1 << sh) - 1)
        half = 1 << (sh - 1)
        mant_hi = frac >> sh
        rnd = (lower > half) | ((lower == half) & ((mant_hi & 1) == 1))
        mant = mant_hi + rnd.to(torch.int64)
        scale = scale + (mant >> 23)  # mantissa carry into the exponent
        mant = mant & 0x7FFFFF
    f32 = (sign << 31) | ((((scale + 127) & MASK32) << 23) & MASK32) | mant
    val = bits_to_f32(f32)
    val = torch.where(is_zero, torch.zeros_like(val), val)
    return torch.where(is_nar, torch.full_like(val, float("nan")), val)


def encode(x: torch.Tensor, spec: PositSpec) -> torch.Tensor:
    """float values -> int32 posit patterns (RNE, saturating).

    The input is read as raw f32 bits, so f32 subnormals encode to
    +-minpos (their scale -127 clamps), never to zero.
    """
    b = u32(x.to(torch.float32).view(torch.int32))
    sign = b >> 31
    raw_e = (b >> 23) & 0xFF
    mant = b & 0x7FFFFF
    is_zero = (b & 0x7FFFFFFF) == 0
    is_nar = raw_e == 255  # inf/nan -> NaR
    bits = encode_fields(sign, raw_e - 127, mant, 23, spec)
    bits = torch.where(is_zero, torch.zeros_like(bits), bits)
    return torch.where(is_nar, torch.full_like(bits, spec.nar_i32), bits)


class _Quantize(torch.autograd.Function):
    """decode(encode(x)) with a straight-through gradient."""

    @staticmethod
    def forward(ctx, x, spec):
        return decode(encode(x, spec), spec).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def quantize(x: torch.Tensor, spec: PositSpec) -> torch.Tensor:
    """Project x onto the Posit<n,es> grid (straight-through gradient)."""
    return _Quantize.apply(x, spec)


def pack16(bits: torch.Tensor) -> torch.Tensor:
    """int32 posit16 patterns -> int16 storage (the low 16 bits)."""
    b = bits.to(torch.int32) & 0xFFFF
    return ((b ^ 0x8000) - 0x8000).to(torch.int16)


def unpack16(stored: torch.Tensor) -> torch.Tensor:
    """int16 storage -> int32 patterns."""
    return stored.to(torch.int32) & 0xFFFF
