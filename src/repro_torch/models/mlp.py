"""Gated / plain MLP blocks, numerics-aware (sites ``mlp.{up,gate,down}``).

Port of ``repro/models/mlp.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dense import dense, dense_init
from repro_torch.core.modes import matmul_sums
from repro_torch.core.policy import SiteNumerics, site
from repro_torch.parallel.sharding import copy_model

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


class MLP(nn.Module):
    """Weights ``wu`` [d, d_ff], ``wd`` [d_ff, d] and, gated, ``wg``.

    Under tensor parallelism (``parallel/sharding.py``) a rank holds its
    block of d_ff: ``wu``/``wg`` columns and ``wd`` rows
    (``row_parallel``)."""

    row_parallel = False

    def __init__(self, d: int, d_ff: int, glu: bool, *, generator, device,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wu = nn.Parameter(dense_init(d, d_ff, **kw), requires_grad=False)
        self.wd = nn.Parameter(dense_init(d_ff, d, **kw), requires_grad=False)
        if glu:
            self.wg = nn.Parameter(dense_init(d, d_ff, **kw), requires_grad=False)
        else:
            self.wg = None


def mlp_apply(p: MLP, x, ncfg: SiteNumerics, act: str = "silu", role: str = "mlp",
              use_kernel: Optional[bool] = None, partial: bool = False):
    """The MLP of x.  A ``row_parallel`` ``wd``'s partial sums are added
    over the ranks (and x enters the cut ``wu``/``wg`` through
    ``copy_model``); with ``partial`` the f32 sums of ``wd`` come back as
    they are (unreduced and unrounded), for the caller to add to others
    before its one reduction, and x as the caller passed it (a MoE
    layer's shared experts)."""
    fn = ACTS[act]
    if p.row_parallel and not partial:
        x = copy_model(x)
    up = dense(x, p.wu, site(ncfg, f"{role}.up"), use_kernel=use_kernel)
    if p.wg is not None:
        up = fn(dense(x, p.wg, site(ncfg, f"{role}.gate"), use_kernel=use_kernel)) * up
    else:
        up = fn(up)
    down = site(ncfg, f"{role}.down")
    if partial:
        return matmul_sums(up, p.wd, down, use_kernel=use_kernel)
    return dense(up, p.wd, down, use_kernel=use_kernel, reduce=p.row_parallel)
