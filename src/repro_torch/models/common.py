"""Shared model components: norms, rotary embeddings, positions, masks and
the walk over policy segments (port of ``repro/models/common.py``)."""
from __future__ import annotations

from typing import Iterator, Tuple

import torch
from torch import nn

from repro_torch.core.policy import SiteNumerics, layer_segments


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self, x)


class _RMSNorm(torch.autograd.Function):
    """RMS norm with the reference's own backward (``_rmsnorm_bwd``): f32
    math, dx cast to the activation dtype and dscale to the scale dtype,
    so that the cotangents between layers stay in the activation dtype."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        x, scale = ctx.saved_tensors
        xf = x.to(torch.float32)
        g = ct.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        inv = torch.rsqrt(var + ctx.eps)
        sg = g * scale.to(torch.float32)
        dx = inv * sg - xf * (inv ** 3) * torch.mean(sg * xf, dim=-1, keepdim=True)
        dscale = torch.sum(g * xf * inv, dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, cast back to the activation dtype."""
    return _RMSNorm.apply(x, p.scale, eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections=None) -> torch.Tensor:
    """Rotary embedding.  x: [B, S, H, hd]; positions: [B, S] integers, or
    [3, B, S] for M-RoPE with ``sections`` = 3 half-dim section sizes
    (temporal, height, width), as in Qwen2-VL: section i of the half-dim
    frequencies turns by position row i."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # [half]
    if sections is None:
        ang = positions.to(torch.float32)[..., None] * inv  # [B, S, half]
    else:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
        parts, start = [], 0
        for i, sec in enumerate(sections):
            parts.append(positions[i].to(torch.float32)[..., None] * inv[start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]  # [B, S, 1, half]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def multi_token_positions(lengths: torch.Tensor, width: int, mrope: bool = False) -> torch.Tensor:
    """Positions of a ``width``-token span starting at each sequence's
    cache length: [B] -> [B, W] (token j at ``lengths[b] + j``), or [3, B,
    W] with the one row broadcast for text-only M-RoPE."""
    span = torch.arange(width, dtype=torch.int32, device=lengths.device)
    pos = lengths.to(torch.int32)[:, None] + span
    return pos.expand(3, *pos.shape) if mrope else pos


def decode_positions(lengths: torch.Tensor, mrope: bool = False) -> torch.Tensor:
    """Single-token special case of :func:`multi_token_positions`."""
    return multi_token_positions(lengths, 1, mrope)


def causal_mask(s_q: int, s_k: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """[s_q, s_k] bool mask; True = attend."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_k, device=device)[None, :]
    return ki <= qi


def iter_layers(numerics, n_layers: int) -> Iterator[Tuple[int, SiteNumerics]]:
    """(layer index, bound site numerics) for every layer, in order.

    The reference scans policy-uniform segments of a stacked layer
    array (``scan_policy_segments``); the port walks its ``ModuleList``
    and binds each layer to its segment's numerics.
    """
    for start, size, nsite in layer_segments(numerics, n_layers):
        for i in range(start, start + size):
            yield i, nsite
