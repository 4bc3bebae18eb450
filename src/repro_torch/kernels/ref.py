"""Plain PyTorch references for the kernels (port of ``repro/kernels/ref.py``).

:func:`plam_matmul_seqref` is the plain version of the PLAM matmul
kernel: bit-identical to it and to the reference package's
``plam_matmul_seqref`` on any shape, because all three accumulate the
same f32 products with k strictly ascending from +0.0.  It loops over k
on [M, N] tiles, so it runs at full width on the card too (slowly).  Over
a stack of experts ([E, M, K] x [E, K, N]) it is the same loop on
[E, M, N] tiles: one k loop for all experts, not one per expert.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import PositSpec, unpack16
from repro_torch.numerics.posit import decode_fields, to_i32

BIAS = 127 << 23


def log_words(bits: torch.Tensor, spec: PositSpec):
    """Posit patterns -> (sign << 31, f32-aligned log magnitude, valid).

    The log magnitude is ``(scale + 127) << 23 | mantissa23``, the PLAM
    operand of the Pallas kernel's ``_log_words``; zero and NaR are
    invalid (their products contribute +0.0) and carry word 0.  Words
    are int32 tensors holding the 32 bits.
    """
    fb = spec.fbmax
    sign, scale, frac, is_zero, is_nar = decode_fields(bits, spec)
    mant = frac << (23 - fb) if fb <= 23 else frac >> (fb - 23)
    valid = ~(is_zero | is_nar)
    lmag = torch.where(valid, ((scale + 127) << 23) | mant, torch.zeros_like(mant))
    s31 = torch.where(valid, sign << 31, torch.zeros_like(sign))
    return to_i32(s31).to(torch.int32), lmag.to(torch.int32), valid


def _patterns(bits: torch.Tensor) -> torch.Tensor:
    return unpack16(bits) if bits.dtype == torch.int16 else bits


def plam_matmul_seqref(a_bits: torch.Tensor, b_bits: torch.Tensor, spec: PositSpec):
    """Sequential-k PLAM matmul: a int32 [M, K], b int32/int16 [K, N] -> f32
    [M, N]; or a stack of experts, a [E, M, K] and b [E, K, N] -> [E, M, N].

    Each product is ``bitcast(sign_a ^ sign_b | (la - bias + lb))``, which
    is ``numerics.plam_product_f32`` bit for bit, and the sum walks k in
    ascending order.
    """
    sa, la, va = log_words(a_bits, spec)
    sb, lb, vb = log_words(_patterns(b_bits), spec)
    la_pre = torch.where(va, la - BIAS, torch.zeros_like(la))
    k = a_bits.shape[-1]
    n = b_bits.shape[-1]
    acc = torch.zeros((*a_bits.shape[:-1], n), dtype=torch.float32, device=a_bits.device)
    zero = torch.zeros((), dtype=torch.float32, device=a_bits.device)
    for i in range(k):
        word = ((la_pre[..., i, None] + lb[..., None, i, :])
                | (sa[..., i, None] ^ sb[..., None, i, :]))
        ok = va[..., i, None] & vb[..., None, i, :]
        acc = acc + torch.where(ok, word.view(torch.float32), zero)
    return acc

