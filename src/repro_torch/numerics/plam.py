"""PLAM product decoded to linear float32 (port of ``repro/numerics/plam.py``).

Only :func:`plam_product_f32` is ported so far: the EMAC-style product
the PLAM matmul accumulates.  Mitchell's antilogarithm of the summed
log-fixed word is the f32 bit layout, so the product is one integer
add and a bitcast.  The pattern-to-pattern multipliers (``plam_mul``,
``exact_mul``) come with the conformance slice.
"""
from __future__ import annotations

import torch

from .posit import PositSpec, bits_to_f32, decode_fields


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
