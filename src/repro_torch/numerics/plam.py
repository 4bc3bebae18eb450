"""PLAM — Posit Logarithm-Approximate Multiplication (port of
``repro/numerics/plam.py``).

The paper's multiplier in three equivalent forms, plus the exact posit
multiplier it replaces, over int32 pattern tensors:

* :func:`plam_mul`         — field-equation path, eqs. (14)-(21).
* :func:`plam_mul_logfix`  — the Fig. 4 hardware path: one fixed-point
  log word per operand, one integer add, re-encode.
* :func:`plam_product_f32` — the PLAM product decoded straight to
  linear float32 (no re-encode), the product the PLAM matmul
  accumulates: Mitchell's antilogarithm is the f32 bit layout, so the
  product is one integer add and a bitcast.
* :func:`exact_mul`        — eqs. (3)-(10), bit-exact RNE for n <= 16.

:func:`mitchell_mul_f32` is the float-domain Mitchell baseline and
:func:`plam_relative_error` the analytic error of eq. (24).  Field
arithmetic runs in int64 holding 32-bit values (see ``posit.py``); every
function is bit-identical to the reference.
"""
from __future__ import annotations

import torch

from .posit import MASK32, PositSpec, _shl, bits_to_f32, decode_fields, encode_fields, u32

__all__ = [
    "plam_mul",
    "plam_mul_logfix",
    "plam_product_f32",
    "exact_mul",
    "mitchell_mul_f32",
    "plam_relative_error",
]


def _special(cand, spec, az, an, bz, bn):
    """Fold zero/NaR handling into a computed pattern (NaR wins)."""
    out = torch.where(az | bz, torch.zeros_like(cand), cand)
    return torch.where(an | bn, torch.full_like(out, spec.nar_i32), out)


def plam_mul(a_bits: torch.Tensor, b_bits: torch.Tensor, spec: PositSpec):
    """PLAM product of two posit patterns -> int32 posit pattern (eqs. 14-21)."""
    fb = spec.fbmax
    sa, ca, fa, az, an = decode_fields(a_bits, spec)
    sb, cb, fbr, bz, bn = decode_fields(b_bits, spec)
    fsum = fa + fbr                               # eq. (17): product -> sum
    carry = fsum >> fb                            # eqs. (19)-(21) overflow
    frac = fsum & ((1 << fb) - 1)
    cand = encode_fields(sa ^ sb, ca + cb + carry, frac, fb, spec)
    return _special(cand, spec, az, an, bz, bn)


def plam_mul_logfix(a_bits: torch.Tensor, b_bits: torch.Tensor, spec: PositSpec):
    """PLAM via the Fig. 4 datapath: log2|X| ~= (scale << fb) | frac as one
    fixed-point word; the multiplication is ONE add of these words and the
    fraction's carry rolls into exponent and regime by itself."""
    fb = spec.fbmax
    # the scale range times 2^fb must fit the reference's int32 word
    if not (2 * spec.max_scale + 2) < (1 << (30 - fb)):
        raise ValueError(f"logfix word overflow for Posit<{spec.n},{spec.es}>")
    sa, ca, fa, az, an = decode_fields(a_bits, spec)
    sb, cb, fbr, bz, bn = decode_fields(b_bits, spec)
    lsum = ((ca << fb) | fa) + ((cb << fb) | fbr)  # the whole multiplier
    scale = lsum >> fb                             # arithmetic shift: floor
    frac = lsum & ((1 << fb) - 1)
    cand = encode_fields(sa ^ sb, scale, frac, fb, spec)
    return _special(cand, spec, az, an, bz, bn)


def plam_product_f32(a_bits: torch.Tensor, b_bits: torch.Tensor, spec: PositSpec):
    """PLAM product of two pattern tensors (broadcasting) -> float32.

    Lanes where either operand is zero or NaR give +0.0.
    """
    fb = spec.fbmax
    sa, ca, fa, az, an = decode_fields(a_bits, spec)
    sb, cb, fbr, bz, bn = decode_fields(b_bits, spec)
    s = sa ^ sb
    fsum = fa + fbr
    carry = fsum >> fb
    frac = fsum & ((1 << fb) - 1)
    scale = (ca + cb + carry).clamp(-126, 127)  # posit32 tails saturate
    mant = frac << (23 - fb) if fb <= 23 else frac >> (fb - 23)
    val = bits_to_f32((s << 31) | ((scale + 127) << 23) | mant)
    return torch.where(az | bz | an | bn, torch.zeros_like(val), val)


def exact_mul_supported(spec: PositSpec) -> bool:
    """The exact product word (2*fbmax + 1 fraction bits + es) fits 30 bits:
    every spec with n <= 16."""
    return 2 * spec.fbmax + 1 + spec.es <= 30


def exact_mul(a_bits: torch.Tensor, b_bits: torch.Tensor, spec: PositSpec):
    """Exact posit multiplication (eqs. 3-10), bit-exact RNE, n <= 16.

    The fraction product (1+fa)(1+fb) needs 2*fbmax+2 bits; with the es
    bits of the rounding word it must fit 32 bits, which holds for n <= 16.
    """
    fb = spec.fbmax
    if not exact_mul_supported(spec):
        raise ValueError("exact_mul supports n <= 16")
    sa, ca, fa, az, an = decode_fields(a_bits, spec)
    sb, cb, fbr, bz, bn = decode_fields(b_bits, spec)
    one = 1 << fb
    prod = (one | fa) * (one | fbr)               # eq. (6), in [2^2fb, 2^(2fb+2))
    ovf = (prod >> (2 * fb + 1)) & 1              # product >= 2 ?
    scale = ca + cb + ovf                         # eqs. (4),(5),(8),(9)
    # a uniform 2fb+1-bit fraction (hidden bit stripped); the no-overflow
    # case gains a zero low bit, which keeps its value
    frac = torch.where(ovf == 1, prod - (1 << (2 * fb + 1)),
                       _shl(prod - (1 << (2 * fb)), 1))
    cand = encode_fields(sa ^ sb, scale, frac, 2 * fb + 1, spec)
    return _special(cand, spec, az, an, bz, bn)


def mitchell_mul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float-domain Mitchell multiplier (the Cheng et al. [20] baseline).

    The f32 exponent|mantissa bits read as a fixed-point log2: the product
    is (bits_a - BIAS) + (bits_b - BIAS) + BIAS, bitcast back, sign by XOR.
    """
    bias = 127 << 23
    ba = u32(a.to(torch.float32).view(torch.int32))
    bb = u32(b.to(torch.float32).view(torch.int32))
    s = (ba ^ bb) & 0x80000000
    la = ba & 0x7FFFFFFF
    lb = bb & 0x7FFFFFFF
    lc = (la + lb - bias) & MASK32
    out = bits_to_f32(s | lc)
    return torch.where((la == 0) | (lb == 0), torch.zeros_like(out), out)


def plam_relative_error(a_bits: torch.Tensor, b_bits: torch.Tensor, spec: PositSpec):
    """Analytic relative error of PLAM, eq. (24): depends only on fractions."""
    fb = spec.fbmax
    _, _, fa, _, _ = decode_fields(a_bits, spec)
    _, _, fbr, _, _ = decode_fields(b_bits, spec)
    fa = fa.to(torch.float32) / (1 << fb)
    fbv = fbr.to(torch.float32) / (1 << fb)
    no_carry = fa + fbv < 1.0
    return torch.where(
        no_carry,
        fa * fbv / ((1 + fa) * (1 + fbv)),
        (1 - fa) * (1 - fbv) / ((1 + fa) * (1 + fbv)),
    )
