"""Numerics-aware dense layer (port of ``repro/core/dense.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel.sharding import reduce_model

from .modes import NumericsConfig, matmul_sums, nmatmul, round_sums


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               device: torch.device, dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """A [d_in, d_out] weight drawn from N(0, scale^2) (scale d_in^-0.5)."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def dense(x, w, ncfg: NumericsConfig, bias=None, use_kernel: Optional[bool] = None,
          reduce: bool = False):
    """y = x @ w (+ bias), multiplying per the configured numerics mode.

    ``reduce``: ``w`` is this rank's K block of a row-parallel weight
    (``parallel/sharding.py``), so the f32 sums are added over the mesh's
    model axis before the mode's rounding and the cast to x's dtype (a
    sum of rounded partials would not be what one rank computes; the f32
    sum differs from it only in the order of one addition)."""
    if reduce:
        sums = reduce_model(matmul_sums(x, w, ncfg, use_kernel=use_kernel))
        y = round_sums(sums, ncfg, x.dtype)
    else:
        y = nmatmul(x, w, ncfg, out_dtype=x.dtype, use_kernel=use_kernel)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
