"""Mamba2 (state space duality) block with the chunked SSD scan.

Port of ``repro/models/ssm.py``.  The SSD recurrence
S_t = a_t S_{t-1} + dt_t (B_t ⊗ x_t), y_t = C_t^T S_t + D x_t is
evaluated with the Mamba2 paper's chunked algorithm for a prefill
(within a chunk a masked, decayed attention-like product; across chunks
a short loop carries the [ds, hd] state) and with the O(1) recurrence
for a one-token decode step.

Numerics sites: the input projection is ``ssm.proj.in`` and the output
projection ``ssm.proj.out``, which run K1 under ``plam_sim``.  The
convolution and the scan stay exact f32, as in the reference, where
they are jnp outside any Pallas kernel: plain torch here.  The scan's
f32 products run with TF32 off, and the convolution is ``K`` shifted
f32 multiply-adds (a cuDNN convolution may round f32 operands to TF32).

Under tensor parallelism (``parallel/sharding.py``) a rank runs its
block of SSD heads: ``in_proj`` holds its z, x, B, C and dt columns
(``ssm_in_columns``), entered through ``copy_model``; the depthwise
convolution runs on its own channels (local); the convolved B and C are
gathered over ``model`` (one all-gather of [B, T, 2 ds / tp]: every head
reads all of them, ngroups = 1); the scan or the one-token recurrence
runs on its heads; the gated norm's f32 sum of squares over di is summed
over ``model`` (:class:`_ShardedRMSNorm`); ``out_proj``'s rows are the
rank's channels and its partial sums are added over ``model``.  The
caches hold the rank's heads (``h`` [B, H / tp, ds, hd]) and channels
(``conv`` [B, K-1, conv_dim / tp]).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from repro_torch.core.dense import dense, dense_init
from repro_torch.core.policy import SiteNumerics, site
from repro_torch.parallel.sharding import copy_model, current_mesh, gather_model_summed

from .common import RMSNorm, rmsnorm


def mamba2_dims(d_model: int, expand: int, head_dim: int, d_state: int):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    return d_inner, n_heads


class Mamba2(nn.Module):
    """Parameters in the reference's layout: ``in_proj`` [d, 2di + 2ds +
    nh] (columns z, x, B, C, dt), ``conv_w`` [K, di + 2ds], ``conv_b``,
    ``A_log``/``D``/``dt_bias`` [nh] (f32 whatever the parameter dtype),
    ``norm`` and ``out_proj`` [di, d].  ``row_parallel``: cut for a mesh
    (``parallel/sharding.py``: in_proj's columns and out_proj's rows are
    the rank's; the other leaves stay whole)."""

    row_parallel = False

    def __init__(self, d_model: int, *, expand: int, head_dim: int, d_state: int,
                 d_conv: int, generator, device, dtype=torch.float32):
        super().__init__()
        di, nh = mamba2_dims(d_model, expand, head_dim, d_state)
        conv_dim = di + 2 * d_state
        kw = dict(generator=generator, device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)

        def frozen(t):
            return nn.Parameter(t, requires_grad=False)

        self.in_proj = frozen(dense_init(d_model, 2 * di + 2 * d_state + nh, **kw))
        self.conv_w = frozen(
            (torch.randn((d_conv, conv_dim), generator=generator, **f32)
             * d_conv ** -0.5).to(dtype))
        self.conv_b = frozen(torch.zeros((conv_dim,), device=device, dtype=dtype))
        self.A_log = frozen(torch.zeros((nh,), **f32))  # A = -exp(A_log) = -1
        self.D = frozen(torch.ones((nh,), **f32))
        self.dt_bias = frozen(torch.full((nh,), -2.0, **f32))  # softplus(-2) ~ 0.13
        self.norm = RMSNorm(di, device=device, dtype=dtype)
        self.norm.scale.requires_grad_(False)
        self.out_proj = frozen(dense_init(di, d_model, **kw))


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls and einsums on the card without TF32 inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _silu(x):
    return x * torch.sigmoid(x)


class _ShardedRMSNorm(torch.autograd.Function):
    """The gated RMS norm over di when each model rank holds di / tp of the
    channels: the f32 sum of squares summed over ``model`` in the forward,
    and in the backward the f32 sum of (gradient x scale x input) that the
    mean term needs (``common.py::_RMSNorm``'s math over the whole width)."""

    @staticmethod
    def forward(ctx, x, scale, eps, width, mesh):
        xf = x.to(torch.float32)
        var = mesh.all_reduce(torch.sum(xf * xf, dim=-1, keepdim=True)) / width
        ctx.save_for_backward(x, scale, var)
        ctx.eps, ctx.width, ctx.mesh = eps, width, mesh
        return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        x, scale, var = ctx.saved_tensors
        xf, g = x.to(torch.float32), ct.to(torch.float32)
        inv = torch.rsqrt(var + ctx.eps)
        sg = g * scale.to(torch.float32)
        dot = ctx.mesh.all_reduce(torch.sum(sg * xf, dim=-1, keepdim=True)) / ctx.width
        dx = inv * sg - xf * (inv ** 3) * dot
        dscale = torch.sum(g * xf * inv, dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None, None, None


def _local_leaves(p: Mamba2, di: int, d_state: int, nh: int, mesh):
    """The mixer's whole leaves as a model rank reads them: (conv_w,
    conv_b over its x, B and C channels; A_log, D, dt_bias over its
    heads; the norm's scale over its di channels).  Slices of the
    parameters, so that their gradients land in the rank's part of each."""
    leaves = (p.conv_w, p.conv_b, p.A_log, p.D, p.dt_bias, p.norm.scale)
    if mesh is None or not p.row_parallel:
        return leaves
    tp, r = mesh.model_size, mesh.model_rank
    di_l, ds_l, nh_l = di // tp, d_state // tp, nh // tp
    chans = torch.cat([torch.arange(r * di_l, (r + 1) * di_l),
                       di + torch.arange(r * ds_l, (r + 1) * ds_l),
                       di + d_state + torch.arange(r * ds_l, (r + 1) * ds_l)]).to(p.conv_w.device)
    return (p.conv_w.index_select(1, chans), p.conv_b.index_select(0, chans),
            p.A_log.narrow(0, r * nh_l, nh_l), p.D.narrow(0, r * nh_l, nh_l),
            p.dt_bias.narrow(0, r * nh_l, nh_l), p.norm.scale.narrow(0, r * di_l, di_l))


def _causal_dwconv(x, w, b):
    """Depthwise causal conv1d: x [B, S, C], w [K, C], b [C], as K shifted
    f32 multiply-adds; the result in x's dtype."""
    k = w.shape[0]
    s = x.shape[1]
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, 0, k - 1, 0))
    wf = w.to(torch.float32)
    out = xp[:, 0:s] * wf[0]
    for j in range(1, k):
        out = out + xp[:, j:j + s] * wf[j]
    return (out + b.to(torch.float32)).to(x.dtype)


def _ssd_chunked(xh, bs, cs, dt, a_log, chunk: int):
    """Chunked SSD scan.

    xh: [B, S, H, hd] head-split inner activations; bs, cs: [B, S, ds]
    (shared across heads, one group); dt: [B, S, H] f32 after softplus.
    Returns y [B, S, H, hd] f32 and the final state [B, H, ds, hd] f32.
    """
    b, s, h, hd = xh.shape
    ds = bs.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    f32 = torch.float32
    if pad:
        # dt = 0 padding is exact: a = exp(0) = 1 keeps the state and
        # dt * x = 0 adds nothing; padded outputs are sliced off below
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        bs = torch.nn.functional.pad(bs, (0, 0, 0, pad))
        cs = torch.nn.functional.pad(cs, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    nc = (s + pad) // q

    with exact_f32():
        loga = -torch.exp(a_log)[None, None, :] * dt  # [B, S, H] log a_t
        dtx = xh.to(f32) * dt[..., None]

        def r(x):  # [B, S_pad, ...] -> [nc, B, q, ...]
            return x.reshape(b, nc, q, *x.shape[2:]).transpose(0, 1)

        la_c = r(loga)  # [nc, B, q, H]
        dtx_c = r(dtx)  # [nc, B, q, H, hd]
        b_c = r(bs.to(f32))  # [nc, B, q, ds]
        c_c = r(cs.to(f32))

        cum = torch.cumsum(la_c, dim=2)  # inclusive cumsum of log a within a chunk

        # intra-chunk: the masked, decayed attention-like term
        g = torch.einsum("nbqs,nbks->nbqk", c_c, b_c)  # [nc, B, q, q]
        dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [nc, B, q, k, H]
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
        m = torch.where(mask[None, None, :, :, None], torch.exp(dec),
                        torch.zeros((), dtype=f32, device=xh.device))
        y_intra = torch.einsum("nbqk,nbqkh,nbkhd->nbqhd", g, m, dtx_c)

        # chunk summaries: each chunk's contribution to the state
        dec_end = torch.exp(cum[:, :, -1:, :] - cum)  # decay from k to the chunk's end
        s_chunk = torch.einsum("nbks,nbkh,nbkhd->nbhsd", b_c, dec_end, dtx_c)
        a_chunk = torch.exp(cum[:, :, -1, :])  # [nc, B, H] the chunk's whole decay

        hstate = torch.zeros((b, h, ds, hd), dtype=f32, device=xh.device)
        y_inter = []
        for n in range(nc):
            # the carried state's part of each position, then the state on
            dec_in = torch.exp(cum[n])  # [B, q, H] decay from the chunk's start
            y_inter.append(torch.einsum("bqs,bhsd,bqh->bqhd", c_c[n], hstate, dec_in))
            hstate = a_chunk[n][..., None, None] * hstate + s_chunk[n]

        y = y_intra + torch.stack(y_inter)  # [nc, B, q, H, hd]
    y = y.transpose(0, 1).reshape(b, s + pad, h, hd)
    return y[:, :s], hstate


def mamba2_apply(p: Mamba2, x, ncfg: SiteNumerics, *, expand: int, head_dim: int,
                 d_state: int, chunk: int, cache=None, use_kernel: Optional[bool] = None):
    """x: [B, S, d].  A prefill (or training) forward when ``cache`` is None
    or S > 1; otherwise a one-token decode step over cache = {"h": [B, H,
    ds, hd] f32, "conv": [B, K-1, conv_dim]}.  Returns (out [B, S, d],
    {"h": the final state f32, "conv": the last K-1 conv inputs}).  A
    mixer cut for the current mesh runs its rank's heads and channels
    (the module docstring).

    A decode step after a prompt shorter than K - 1 tokens raises
    ``ValueError``, as the reference's does (its conv tail is short)."""
    bsz, s, d_model = x.shape
    di, nh = mamba2_dims(d_model, expand, head_dim, d_state)
    mesh = current_mesh() if p.row_parallel else None
    tp = 1 if mesh is None else mesh.model_size
    di_l, ds_l, nh_l = di // tp, d_state // tp, nh // tp
    conv_w, conv_b, a_log, d_skip, dt_bias, scale = _local_leaves(p, di, d_state, nh, mesh)
    f32 = torch.float32
    proj = dense(x if mesh is None else copy_model(x), p.in_proj, site(ncfg, "ssm.proj.in"),
                 use_kernel=use_kernel)
    z, xin, bsv, csv, dt = torch.split(proj, [di_l, di_l, ds_l, ds_l, nh_l], dim=-1)
    conv_in = torch.cat([xin, bsv, csv], dim=-1)
    k = conv_w.shape[0]

    # the one-token recurrence only when decoding (S == 1 with a cache); a
    # prefill (S > 1) always runs the chunked scan from a fresh state
    decode_1 = cache is not None and s == 1
    if not decode_1:
        conv_out = _causal_dwconv(conv_in, conv_w, conv_b)
        conv_tail = conv_in[:, max(0, s - (k - 1)):, :]
    else:
        if cache["conv"].shape[1] != k - 1:
            raise ValueError(
                f"a decode step needs the last {k - 1} conv inputs, the cache holds "
                f"{cache['conv'].shape[1]}: the prompt was shorter than ssm_conv - 1")
        dt_hist = torch.promote_types(cache["conv"].dtype, conv_in.dtype)
        hist = torch.cat([cache["conv"].to(dt_hist), conv_in.to(dt_hist)], dim=1)  # [B, K, cd]
        with exact_f32():
            conv_out = torch.einsum("bkc,kc->bc", hist.to(f32), conv_w.to(f32))
        conv_out = (conv_out[:, None, :] + conv_b.to(f32)).to(x.dtype)
        conv_tail = hist[:, 1:, :]

    conv_out = _silu(conv_out)
    xc, bc, cc = torch.split(conv_out, [di_l, ds_l, ds_l], dim=-1)
    if mesh is not None:
        # every head reads all of B and C: the ranks' blocks, in rank order
        both = gather_model_summed(torch.cat([bc, cc], dim=-1), -1)
        both = both.reshape(*both.shape[:-1], tp, 2, ds_l)
        bc = both[..., 0, :].reshape(*both.shape[:-3], d_state)
        cc = both[..., 1, :].reshape(*both.shape[:-3], d_state)
    xh = xc.reshape(bsz, -1, nh_l, head_dim)
    dt = torch.logaddexp(dt.to(f32) + dt_bias, torch.zeros((), dtype=f32, device=x.device))

    if not decode_1:
        y, hfin = _ssd_chunked(xh, bc, cc, dt, a_log, chunk)
    else:
        with exact_f32():
            a = torch.exp(-torch.exp(a_log)[None, :] * dt[:, 0, :])  # [B, H]
            dbx = torch.einsum("bs,bhd->bhsd", bc[:, 0].to(f32),
                               xh[:, 0].to(f32) * dt[:, 0, :, None])
            hfin = a[..., None, None] * cache["h"] + dbx
            y = torch.einsum("bs,bhsd->bhd", cc[:, 0].to(f32), hfin)[:, None]

    y = y + xh.to(f32) * d_skip[None, None, :, None]
    y = y.reshape(bsz, s, di_l).to(x.dtype)
    if mesh is None:
        y = rmsnorm(p.norm, y * _silu(z))
    else:
        y = _ShardedRMSNorm.apply(y * _silu(z), scale, 1e-6, di, mesh)
    out = dense(y, p.out_proj, site(ncfg, "ssm.proj.out"), use_kernel=use_kernel,
                reduce=mesh is not None)
    return out, {"h": hfin, "conv": conv_tail}


def mamba2_cache_init(batch: int, d_model: int, *, expand: int, head_dim: int,
                      d_state: int, d_conv: int, dtype=torch.float32, device=None, tp: int = 1):
    """Zero caches of one mixer; ``tp``: a model rank's heads and channels."""
    di, nh = mamba2_dims(d_model, expand, head_dim, d_state)
    return {
        "h": torch.zeros((batch, nh // tp, d_state, head_dim), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, d_conv - 1, (di + 2 * d_state) // tp), dtype=dtype,
                            device=device),
    }
