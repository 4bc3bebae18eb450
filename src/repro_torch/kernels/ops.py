"""Public wrappers over the kernels (port of ``repro/kernels/ops.py``).

Each takes ``use_kernel``: ``None`` (the default) runs the CUDA kernel
for CUDA tensors and the plain version for CPU tensors; ``False`` runs
the plain version on any device (the reference the tests and the chip
smoke compare with); ``True`` insists on the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.numerics import P16, PositSpec

from .plam_matmul import plam_matmul, plam_matmul_float
from .posit_codec import (  # noqa: F401
    exact_mul_elementwise,
    plam_mul_elementwise,
    posit_decode,
    posit_encode,
    posit_quantize,
)


def plam_matmul_bits(
    a_bits: torch.Tensor,
    b_bits: torch.Tensor,
    spec: PositSpec = P16,
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """PLAM matmul over posit patterns -> f32."""
    return plam_matmul(a_bits, b_bits, spec, use_kernel=use_kernel)


def plam_dense(
    x: torch.Tensor,
    w_bits: torch.Tensor,
    spec: PositSpec = P16,
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """float activations x posit-pattern weights via the PLAM kernel.

    Activations (f32, or bf16, whose values f32 holds exactly) are
    encoded inside the PLAM kernel's A loader, one launch a call;
    weights are stored pre-encoded (int32, or int16 for n <= 16), the
    deployment layout for posit inference.  Leading batch dims of x are
    flattened into M.  Returns f32 [..., N].

    A stack of expert weights, w_bits [E, K, N] with x [E, C, K], gives
    f32 [E, C, N], row block e times weight e (the reference's
    ``jax.vmap`` over experts), in one launch over all experts.
    """
    if w_bits.dim() == 3:
        if x.dim() != 3:
            raise ValueError(f"a stack of experts takes x [E, C, K], got {tuple(x.shape)}")
        x3 = x if x.dtype in (torch.float32, torch.bfloat16) else x.to(torch.float32)
        return plam_matmul_float(x3.contiguous(), w_bits, spec, use_kernel=use_kernel)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.to(torch.float32)
    out = plam_matmul_float(x2.contiguous(), w_bits, spec, use_kernel=use_kernel)
    return out.reshape(*lead, w_bits.shape[-1])
