"""Exhaustive-table Posit codec for n <= 16 (port of ``repro/numerics/table.py``).

Independent of the bit-field codec in ``posit.py``: the tables come from
the pure-Python golden decoder, and rounding is a value-space search over
the pattern-RNE thresholds with ties to the even pattern.  For posits the
two formulations coincide, which the conformance suite asserts.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .golden import all_values, thresholds
from .posit import PositSpec, to_i32, u32

__all__ = ["decode_table", "encode_table", "tables"]


@lru_cache(maxsize=8)
def tables(n: int, es: int):
    """(values f32, rounding thresholds f32) for positive bodies 1..maxpos.

    Thresholds are the pattern-RNE boundaries (odd (n+1)-bit posits),
    exact in f32 since they carry <= n-1 significand bits.
    """
    if n > 16:
        raise ValueError("exhaustive tables are for n <= 16")
    vals = np.asarray(all_values(n, es), dtype=np.float64)
    mids = np.asarray(thresholds(n, es), dtype=np.float64)
    return vals.astype(np.float32), mids.astype(np.float32)


def decode_table(bits: torch.Tensor, spec: PositSpec) -> torch.Tensor:
    """Posit patterns -> float32 through the value table."""
    vals = torch.from_numpy(tables(spec.n, spec.es)[0]).to(bits.device)
    u = u32(bits) & spec.mask_n
    sign = (u >> (spec.n - 1)) != 0
    mag = torch.where(sign, (-u) & spec.mask_n, u)
    body = mag & spec.maxpos_body
    v = vals[(body - 1).clamp(0, vals.shape[0] - 1)]
    v = torch.where(sign, -v, v)
    v = torch.where(u == 0, torch.zeros_like(v), v)
    return torch.where(u == spec.nar, torch.full_like(v, float("nan")), v)


def encode_table(x: torch.Tensor, spec: PositSpec) -> torch.Tensor:
    """float32 -> int32 posit pattern via the threshold search.

    Zero, NaR and the sign come from the raw bits, and the searched |x| is
    rebuilt from the magnitude bits, as in the reference, so an f32
    subnormal lands on body 1 (minpos) and never on zero.
    """
    mids = torch.from_numpy(tables(spec.n, spec.es)[1]).to(x.device)
    bits = u32(x.to(torch.float32).view(torch.int32))
    sign = (bits >> 31) != 0
    is_zero = (bits & 0x7FFFFFFF) == 0
    is_nar = ((bits >> 23) & 0xFF) == 0xFF
    a = to_i32(bits & 0x7FFFFFFF).to(torch.int32).view(torch.float32)
    j = torch.searchsorted(mids, a.contiguous(), right=False)  # side="left"
    # mids[j-1] < a <= mids[j] -> candidate body j+1; an exact tie
    # a == mids[j] -> the even pattern of bodies {j+1, j+2}
    tie = a == mids[j.clamp(0, mids.shape[0] - 1)]
    body = j + 1
    body = torch.where(tie & (body % 2 == 1), body + 1, body)
    body = body.clamp(1, spec.maxpos_body)
    pat = torch.where(sign, (-body) & spec.mask_n, body)
    pat = torch.where(is_zero, torch.zeros_like(pat), pat)
    pat = torch.where(is_nar, torch.full_like(pat, spec.nar), pat)
    return pat.to(torch.int32)
