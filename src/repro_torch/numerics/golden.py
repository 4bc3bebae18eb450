"""Pure-Python golden reference for Posit<n,es> arithmetic.

The port's own copy of ``repro/numerics/golden.py``: string and bit
manipulation over Python ints and floats (exact for n <= 32 via
float64), independent of the vectorized PyTorch codec in ``posit.py``.
It is the oracle the port's codec, the exhaustive lookup tables, the
multipliers and the CUDA kernels are validated against.

Conventions
-----------
* A posit is an ``n``-bit pattern held in a Python int ``0 <= p < 2**n``.
* ``0`` is zero, ``1 << (n-1)`` is NaR (mapped to float ``nan``).
* Values follow eq. (1) of the paper:
  ``X = (-1)^s * (2^(2^es))^k * 2^e * (1 + f)``.
"""
from __future__ import annotations

import bisect
import math
from functools import lru_cache

__all__ = [
    "decode_py",
    "encode_py",
    "plam_mul_py",
    "exact_mul_py",
    "decode_fields_py",
    "all_values",
    "thresholds",
]


def decode_fields_py(p: int, n: int, es: int):
    """Return (sign, k, e, f) for a non-zero, non-NaR pattern."""
    s = (p >> (n - 1)) & 1
    if s:
        p = ((1 << n) - p) & ((1 << n) - 1)
    body = p & ((1 << (n - 1)) - 1)
    bits = format(body, f"0{n - 1}b")
    r0 = bits[0]
    run = len(bits) - len(bits.lstrip(r0))
    k = run - 1 if r0 == "1" else -run
    rest = bits[run + 1:]  # after the terminator bit (may be empty)
    ebits = rest[:es].ljust(es, "0")  # missing low exponent bits are 0
    e = int(ebits, 2) if es else 0
    fbits = rest[es:]
    f = int(fbits, 2) / (1 << len(fbits)) if fbits else 0.0
    return s, k, e, f


def decode_py(p: int, n: int, es: int) -> float:
    """Decode an n-bit posit pattern to float64 (exact for n <= 32)."""
    p &= (1 << n) - 1
    if p == 0:
        return 0.0
    if p == 1 << (n - 1):
        return math.nan
    s, k, e, f = decode_fields_py(p, n, es)
    return (-1.0) ** s * 2.0 ** (k * (1 << es) + e) * (1.0 + f)


@lru_cache(maxsize=8)
def all_values(n: int, es: int):
    """Values of all positive patterns 1 .. 2^(n-1)-1 (monotone)."""
    return [decode_py(p, n, es) for p in range(1, 1 << (n - 1))]


@lru_cache(maxsize=8)
def thresholds(n: int, es: int):
    """Pattern-RNE rounding thresholds between consecutive n-bit posits.

    SoftPosit (and the 2022 standard) round the assembled *bit pattern*
    to nearest-even.  The threshold between bodies j and j+1 is exactly
    the value of the odd (n+1)-bit posit pattern 2j+1 that sits between
    them (append one bit: round-bit set, sticky clear).  Within a
    binade this equals the arithmetic midpoint; across multi-binade
    regime gaps (near minpos/maxpos) it is the geometric-ish pattern
    midpoint — which is where naive value-nearest rounding diverges.
    """
    vals_wide = all_values(n + 1, es)
    # body t between n-bit bodies j, j+1 is t = 2j+1 -> index 2j in vals_wide
    return [vals_wide[2 * j] for j in range(1, (1 << (n - 1)) - 1)]


def encode_py(x: float, n: int, es: int) -> int:
    """Round float -> posit pattern (SoftPosit pattern-space RNE).

    Saturates at +-maxpos; magnitudes below minpos round to minpos
    (posits never round a non-zero value to zero or NaR).
    """
    if math.isnan(x) or math.isinf(x):
        return 1 << (n - 1)
    if x == 0.0:
        return 0
    s = x < 0
    a = abs(x)
    ths = thresholds(n, es)
    i = bisect.bisect_left(ths, a)  # ths[i-1] < a <= ths[i]
    body = i + 1
    if i < len(ths) and a == ths[i]:  # exact tie -> even pattern
        if body % 2 == 1:
            body += 1
    body = min(body, (1 << (n - 1)) - 1)
    p = body
    if s:
        p = ((1 << n) - p) & ((1 << n) - 1)
    return p


def plam_mul_py(pa: int, pb: int, n: int, es: int) -> int:
    """PLAM multiplication, eqs. (14)-(21): fraction product -> sum."""
    nar = 1 << (n - 1)
    pa &= (1 << n) - 1
    pb &= (1 << n) - 1
    if pa == nar or pb == nar:
        return nar
    if pa == 0 or pb == 0:
        return 0
    sa, ka, ea, fa = decode_fields_py(pa, n, es)
    sb, kb, eb, fb = decode_fields_py(pb, n, es)
    s = sa ^ sb
    f = fa + fb  # eq. (17): log-approximate fraction "product"
    scale = (ka + kb) * (1 << es) + (ea + eb)
    if f >= 1.0:  # eqs. (19)-(21): carry folds into exponent/regime
        f -= 1.0
        scale += 1
    val = 2.0 ** scale * (1.0 + f)
    return encode_py(-val if s else val, n, es)


def exact_mul_py(pa: int, pb: int, n: int, es: int) -> int:
    """Exact posit multiplication, eqs. (3)-(10), via float64.

    Exact for n <= 16 (fraction product <= 26 significant bits << 53).
    """
    nar = 1 << (n - 1)
    pa &= (1 << n) - 1
    pb &= (1 << n) - 1
    if pa == nar or pb == nar:
        return nar
    if pa == 0 or pb == 0:
        return 0
    va = decode_py(pa, n, es)
    vb = decode_py(pb, n, es)
    return encode_py(va * vb, n, es)
