"""PLAM matrix multiplier: the wrapper of the CUDA kernel (K1).

Port of the Pallas TPU kernel ``repro/kernels/plam_matmul.py::plam_matmul``
as ``csrc/plam_matmul.cuh``.  C[M, N] = sum_k PLAM(A[m, k], B[k, n]) over
posit patterns, each product one integer add of f32-aligned log words
and a bitcast, accumulated in f32 with k strictly ascending.  The kernel
is bit-identical to its plain version, ``ref.plam_matmul_seqref``.

B may be int16 patterns (prequantized Posit<16,*> weights), which the
kernel unpacks in registers, so the weight is never widened in memory.

:func:`plam_matmul_float` takes A as float activations (f32 or bf16) and
encodes them inside the same kernel's A loader (``csrc/plam_dense.cu``):
one launch where an encode and a matmul were two, bit-identical to its
plain version ``plam_matmul_seqref(encode(x), B)``.

Both take a stack of experts too, A [E, M, K] against B [E, K, N] giving
[E, M, N]: what the reference's ``jax.vmap`` over the MoE layer's
experts computes.  It is one launch over all E experts (the expert in
the kernel's grid), each expert's block bit-identical to a launch of its
own, and it counts once under ``plam_matmul`` and once under
``plam_matmul_grouped``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.numerics import P16, PositSpec, encode

from . import _lib
from .ref import plam_matmul_seqref


def _check_spec(spec: PositSpec) -> None:
    if spec.max_scale * 2 + 127 > 254:
        raise ValueError(f"Posit<{spec.n},{spec.es}> product scale must fit f32")


def _check_operands(a: torch.Tensor, b_bits: torch.Tensor, spec: PositSpec) -> None:
    """[M, K] x [K, N], or a stack of experts [E, M, K] x [E, K, N]."""
    _check_spec(spec)
    rank = a.dim()
    if (rank not in (2, 3) or b_bits.dim() != rank or a.shape[-1] != b_bits.shape[-2]
            or a.shape[:-2] != b_bits.shape[:-2]):
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b_bits.shape)}")
    if b_bits.dtype == torch.int16 and spec.n > 16:
        raise ValueError("int16 patterns hold posits of at most 16 bits")


def _launch(entry, a: torch.Tensor, a_args, b_bits: torch.Tensor, spec: PositSpec):
    """One launch of a K1 entry point on CUDA operands -> f32 [M, N], or
    [E, M, N] over a stack of E experts (the expert in the grid)."""
    _lib.require(b_bits, "b_bits", (torch.int32, torch.int16), a.dim())
    if b_bits.device != a.device:
        raise ValueError("A and b_bits must be on one device")
    grouped = a.dim() == 3
    e = a.shape[0] if grouped else 1
    m, k = a.shape[-2:]
    n = b_bits.shape[-1]
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    _lib.launch(
        "plam_matmul", out, lambda: getattr(_lib.library(), entry)(
            a.data_ptr(), *a_args, b_bits.data_ptr(), int(b_bits.dtype == torch.int16),
            out.data_ptr(), m, n, k, e, m * k, k * n, m * n, spec.n, spec.es,
            _lib.stream_ptr(a)),
        inputs=(a, b_bits), int_ops=e * m * n * k)  # one integer add a product
    if grouped:
        _lib.launches["plam_matmul_grouped"] += 1
    return out


def plam_matmul(
    a_bits: torch.Tensor,
    b_bits: torch.Tensor,
    spec: PositSpec = P16,
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """C = A (x)_PLAM B with linear-f32 accumulation.

    a_bits: int32 [M, K] patterns; b_bits: int32 or int16 [K, N] (or
    [E, M, K] and [E, K, N]).  Returns f32 [M, N] ([E, M, N]).
    ``use_kernel`` as in ``_lib.wants_kernel``.
    """
    _check_operands(a_bits, b_bits, spec)
    if not _lib.wants_kernel(a_bits, use_kernel):
        return plam_matmul_seqref(a_bits, b_bits, spec)
    _lib.require(a_bits, "a_bits", (torch.int32,), a_bits.dim())
    return _launch("plam_matmul_launch", a_bits, (), b_bits, spec)


def plam_matmul_float(
    x: torch.Tensor,
    b_bits: torch.Tensor,
    spec: PositSpec = P16,
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """C = encode(x) (x)_PLAM B with the encode inside the kernel.

    x: f32 or bf16 [M, K] activations; b_bits: int32 or int16 [K, N] (or
    [E, M, K] and [E, K, N]).  Returns f32 [M, N] ([E, M, N]), the bits of
    ``plam_matmul(encode(x), b_bits)``.  ``use_kernel`` as in
    ``_lib.wants_kernel``.
    """
    _check_operands(x, b_bits, spec)
    if not _lib.wants_kernel(x, use_kernel):
        return plam_matmul_seqref(encode(x, spec), b_bits, spec)
    _lib.require(x, "x", (torch.float32, torch.bfloat16), x.dim())
    return _launch("plam_dense_launch", x, (_lib.DTYPE_CODES[x.dtype],), b_bits, spec)
