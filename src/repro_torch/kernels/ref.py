"""Plain PyTorch references for the kernels (port of ``repro/kernels/ref.py``).

:func:`plam_matmul_seqref` is the plain version of the PLAM matmul
kernel: bit-identical to it and to the reference package's
``plam_matmul_seqref`` on any shape, because all three accumulate the
same f32 products with k strictly ascending from +0.0.  It forms the
products of up to PLAIN_KB consecutive k at once and adds them to its
[M, N] sums one k at a time, B's log words formed for at most
PLAIN_LANES of its lanes at a time (a slice of its columns, which are
independent), so it runs at full width on the card too (slowly).  Over
a stack of experts ([E, M, K] x [E, K, N]) it is the same loop on
[E, M, N] tiles: one k loop for all experts, not one per expert.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import PositSpec, unpack16
from repro_torch.numerics.posit import decode_fields, to_i32

BIAS = 127 << 23
#: B lanes whose log words the plain loop holds at once (a few int32 and
#: int64 temporaries of this many lanes, 512 MB each); the plain encode
#: takes as many lanes at a time
PLAIN_LANES = 1 << 26
#: consecutive k whose [M, N] products are formed at once (as many lanes
#: at most as PLAIN_LANES)
PLAIN_KB = 16


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
    k = a_bits.shape[-1]
    n = b_bits.shape[-1]
    cols = max(1, PLAIN_LANES // max(k, 1))
    if n > cols:
        return torch.cat([plam_matmul_seqref(a_bits, b_bits[..., c0:c0 + cols], spec)
                          for c0 in range(0, n, cols)], dim=-1)
    sa, la, va = log_words(a_bits, spec)
    sb, lb, vb = log_words(_patterns(b_bits), spec)
    la_pre = torch.where(va, la - BIAS, torch.zeros_like(la))
    acc = torch.zeros((*a_bits.shape[:-1], n), dtype=torch.float32, device=a_bits.device)
    zero = torch.zeros((), dtype=torch.float32, device=a_bits.device)
    kb = max(1, min(PLAIN_KB, PLAIN_LANES // max(1, acc.numel())))
    for k0 in range(0, k, kb):
        ks = slice(k0, min(k, k0 + kb))
        # [..., M, kb, N]: the products of k0 .. k0 + kb - 1
        word = ((la_pre[..., ks, None] + lb[..., None, ks, :])
                | (sa[..., ks, None] ^ sb[..., None, ks, :]))
        ok = va[..., ks, None] & vb[..., None, ks, :]
        prods = torch.where(ok, word.view(torch.float32), zero)
        for i in range(prods.shape[-2]):
            acc = acc + prods[..., i, :]
    return acc

