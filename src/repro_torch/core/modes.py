"""Numerics modes: how every matmul multiplies (port of ``repro/core/modes.py``).

* ``f32`` / ``bf16``   — exact matmul (baselines).
* ``posit_quant``      — operands projected onto the Posit<n,es> grid by
  the codec kernel's quantize (straight-through gradients), exact f32
  multiply; f32 or bf16 carrier.
* ``plam_sim``         — every scalar product is the paper's
  logarithm-approximate multiplication, antilogged to linear f32 and
  accumulated.  The weight goes through the codec kernel to the
  patterns ``quantize_params`` would store (int16 for n <= 16), a bf16
  weight straight from its bits, with no f32 copy; the activations are
  encoded inside the PLAM matmul kernel, which sums the products
  (``repro_torch.kernels``).  Prequantized weights skip the weight
  encode.
* ``mitchell_f32``     — float-domain Mitchell (Cheng et al. [20]): each
  product the f32 bit patterns added as fixed-point logs, K-chunked and
  summed in f32 as the reference's jnp path does; plain torch (the
  reference has no kernel for it either).

``nmatmul`` also takes a stack of expert weights, w [E, K, N] with x
[E, C, K], giving [E, C, N]: row block e times weight e, what the
reference computes as ``jax.vmap`` over the MoE layer's experts.  Under
``plam_sim`` the stack goes through the codec kernel and the PLAM
kernel in one launch each.

``use_kernel`` selects kernel or plain version as in
``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.numerics import PositSpec, mitchell_mul_f32

MODES = ("f32", "bf16", "posit_quant", "plam_sim", "mitchell_f32")


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    mode: str = "bf16"
    n: int = 16
    es: int = 1
    quantize_acts: bool = True  # posit-quantize activations too (not just weights)
    plam_chunk: int = 64  # K-chunk of the reference's jnp plam_sim path
    # weights already sit on the posit grid, so the per-matmul weight
    # codec is skipped (value-identical to quantize-on-read)
    prequantized_weights: bool = False
    # carrier dtype for posit_quant: "f32" keeps the posit grid exactly;
    # "bf16" re-rounds to bf16 (double quantization)
    carrier: str = "f32"

    def __post_init__(self):
        assert self.mode in MODES, self.mode

    @property
    def spec(self) -> PositSpec:
        return PositSpec(self.n, self.es)


EXACT_BF16 = NumericsConfig(mode="bf16")
POSIT16_QUANT = NumericsConfig(mode="posit_quant", n=16, es=1)
PLAM16 = NumericsConfig(mode="plam_sim", n=16, es=1)


class _PositQuantize(torch.autograd.Function):
    """Posit-grid projection through K3's ``posit_quantize`` (its plain
    version for a CPU tensor) with a straight-through gradient: the
    reference's STE ``quantize``.  The result is cast to the carrier
    dtype, and the cotangent is cast through the carrier dtype back to the
    input's dtype, as the reference's casts around its STE boundary
    transpose (a bf16 carrier keeps cotangents bf16)."""

    @staticmethod
    def forward(ctx, x, spec, carrier, use_kernel):
        from repro_torch.kernels.posit_codec import posit_quantize

        ctx.in_dtype, ctx.carrier = x.dtype, carrier
        # f32 and bf16 go into the kernel as they are (bf16 -> f32 is exact)
        q = posit_quantize(_codec_float(x).contiguous(), spec, use_kernel=use_kernel)
        return q.to(carrier)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.carrier).to(ctx.in_dtype), None, None, None


def posit_quantize_ste(x: torch.Tensor, spec: PositSpec, carrier=torch.float32,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x projected onto the Posit<n,es> grid, in the ``carrier`` dtype,
    with a straight-through gradient (K3 on a CUDA tensor)."""
    return _PositQuantize.apply(x, spec, carrier, use_kernel)


def _plam_matmul(x, w, spec: PositSpec, use_kernel: Optional[bool]):
    """PLAM matmul of f32 or bf16 operands: the weight through the codec
    kernel to int16 patterns where n <= 16 (int32 otherwise), then
    ``plam_dense``, which encodes the activations inside the PLAM kernel.
    A bf16 value is its f32 value exactly, and the PLAM kernel gives the
    same bits over int16 and int32 patterns, so the result is that of f32
    operands and int32 patterns.

    The reference sums each K-chunk with ``jnp.sum``, so the two agree to
    f32 rounding, not bit for bit.
    """
    from repro_torch.kernels.ops import plam_dense, posit_encode

    out_dtype = torch.int16 if spec.n <= 16 else torch.int32
    wb = posit_encode(w.contiguous(), spec, out_dtype=out_dtype, use_kernel=use_kernel)
    return plam_dense(x, wb, spec, use_kernel=use_kernel)


def _mitchell_matmul(x, w, chunk: int):
    """Float-domain Mitchell matmul, K-chunked (the reference's
    ``_mitchell_matmul_jnp``): K is zero-padded to a multiple of the chunk
    (a zero operand gives a +0.0 product), each chunk's products are summed
    in f32 and added to an f32 accumulator.  w [K, N] with x [..., K], or a
    stack w [E, K, N] with x [E, C, K], whose experts' rows are chunked each
    on their own, as under the reference's vmap."""
    f32 = torch.float32
    k, n = x.shape[-1], w.shape[-1]
    lead = x.shape[:-1]
    groups = w.shape[0] if w.dim() == 3 else 1
    x3 = x.to(f32).reshape(groups, -1, k)  # [G, M, K]
    w3 = w.to(f32).reshape(groups, k, n)  # [G, K, N]
    chunk = min(chunk, k)
    pad = (-k) % chunk
    if pad:
        x3 = F.pad(x3, (0, pad))
        w3 = F.pad(w3, (0, 0, 0, pad))
    acc = torch.zeros((groups, x3.shape[1], n), dtype=f32, device=x.device)
    for c0 in range(0, k + pad, chunk):
        prods = mitchell_mul_f32(x3[:, :, c0:c0 + chunk, None], w3[:, None, c0:c0 + chunk, :])
        acc = acc + torch.sum(prods, dim=2, dtype=f32)
    return acc.reshape(*lead, n)


def _codec_float(t: torch.Tensor) -> torch.Tensor:
    """t as the codec and the PLAM kernel take it: f32 and bf16 as they
    are, other floats cast to f32."""
    return t if t.dtype in (torch.float32, torch.bfloat16) else t.to(torch.float32)


def _pattern_matmul(x, w_pat, ncfg: NumericsConfig, use_kernel):
    """The f32 sums of x @ w where w arrived as pre-encoded posit patterns.

    For ``plam_sim`` the patterns feed ``kernels.ops.plam_dense``
    directly (int16 patterns are read as they are, never widened);
    every other mode decodes them with the codec kernel (its plain version
    on the CPU) to their exact posit-grid f32 values and reuses the
    linear-weight path with the weight codec skipped.
    """
    spec = ncfg.spec
    if ncfg.mode == "plam_sim":
        from repro_torch.kernels.ops import plam_dense

        return plam_dense(x, w_pat, spec, use_kernel=use_kernel)
    from repro_torch.kernels.posit_codec import posit_decode

    bits = w_pat if w_pat.dtype in (torch.int16, torch.int32) else w_pat.to(torch.int32)
    w_lin = posit_decode(bits.contiguous(), spec, use_kernel=use_kernel)
    ncfg_pq = dataclasses.replace(ncfg, prequantized_weights=True)
    return matmul_sums(x, w_lin, ncfg_pq, use_kernel=use_kernel)


def matmul_sums(x, w, ncfg: NumericsConfig, use_kernel: Optional[bool] = None):
    """The f32 sums of :func:`nmatmul` (x @ w under ``ncfg``) before the
    mode's rounding and the output cast: what a row-parallel projection
    sums over the ranks (``core/dense.py``)."""
    if w.dim() == 3 and (x.dim() != 3 or x.shape[0] != w.shape[0]):
        raise ValueError(f"a stack of {w.shape[0]} experts takes x [E, C, K], "
                         f"got {tuple(x.shape)}")
    if not w.is_floating_point():
        return _pattern_matmul(x, w, ncfg, use_kernel)
    f32, bf16 = torch.float32, torch.bfloat16
    if ncfg.mode == "f32":
        return torch.matmul(x.to(f32), w.to(f32))
    if ncfg.mode == "bf16":
        # bf16 operands, f32 products and sums (preferred_element_type=f32)
        return torch.matmul(x.to(bf16).to(f32), w.to(bf16).to(f32))
    if ncfg.mode == "posit_quant":
        # bf16 carrier: bf16 operands, cotangents and product, the product
        # summed in f32 and rounded once (round_sums; the reference's bf16
        # dot; torch's bf16 matmul on the CPU does not always round once);
        # f32: the posit grid exactly
        spec, carrier = ncfg.spec, _carrier(ncfg)
        xq = (posit_quantize_ste(x, spec, carrier, use_kernel) if ncfg.quantize_acts
              else x.to(carrier))
        wq = (w.to(carrier) if ncfg.prequantized_weights
              else posit_quantize_ste(w, spec, carrier, use_kernel))
        return torch.matmul(xq.to(f32), wq.to(f32))
    if ncfg.mode == "plam_sim":
        return _plam_matmul(_codec_float(x), _codec_float(w), ncfg.spec, use_kernel)
    if ncfg.mode == "mitchell_f32":
        return _mitchell_matmul(x, w, ncfg.plam_chunk)
    raise ValueError(ncfg.mode)  # pragma: no cover


def _carrier(ncfg: NumericsConfig):
    return torch.bfloat16 if ncfg.carrier == "bf16" else torch.float32


def round_sums(sums, ncfg: NumericsConfig, out_dtype):
    """f32 sums as :func:`nmatmul` returns them: ``posit_quant`` rounds
    to its carrier dtype, then every mode casts to ``out_dtype``."""
    if ncfg.mode == "posit_quant":
        sums = sums.to(_carrier(ncfg))
    return sums.to(out_dtype)


def nmatmul(x, w, ncfg: NumericsConfig, out_dtype=None,
            use_kernel: Optional[bool] = None):
    """Numerics-aware x @ w; x: [..., K], w: [K, N]; or a stack of experts,
    x: [E, C, K], w: [E, K, N] -> [E, C, N].

    Integer-dtype ``w`` is read as pre-encoded Posit<n,es> patterns
    (prequantized weight storage).
    """
    return round_sums(matmul_sums(x, w, ncfg, use_kernel), ncfg, out_dtype or x.dtype)


def nquant_weight(w: torch.Tensor, ncfg: NumericsConfig,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Posit-quantize a weight for storage/serving, when the mode asks
    (K3's quantize on a CUDA tensor), in the weight's own dtype."""
    if ncfg.mode in ("posit_quant", "plam_sim"):
        return posit_quantize_ste(w, ncfg.spec, torch.float32, use_kernel).to(w.dtype)
    return w
