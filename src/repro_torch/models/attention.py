"""Grouped-query attention with KV cache, numerics-aware projections.

Port of ``repro/models/attention.py``.  The q/k/v projections resolve
the ``attn.qkv`` site and the output projection ``attn.out``, and the
enc-dec cross-attention's ``attn.cross.qkv`` and ``attn.cross.out``;
PLAM applies to these linear layers.  The attention core keeps the
reference's operation order (einsum, then scale, then f32 softmax,
weights cast to the value dtype); it does not use a fused attention
kernel.  With ``flash_block`` a training or prefill forward without a
cache runs :func:`attn_core_blockwise`, the reference's online softmax
over KV blocks, in f32 torch as the reference computes it in jnp.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.dense import dense, dense_init
from repro_torch.core.policy import SiteNumerics, site
from repro_torch.parallel.sharding import copy_model, current_mesh

from .common import apply_rope, causal_mask, decode_positions


class Attention(nn.Module):
    """Weights ``wq`` [d, H*hd], ``wk``/``wv`` [d, kv*hd], ``wo`` [H*hd, d].

    Under tensor parallelism (``parallel/sharding.py``) a rank holds its
    H/tp q heads' columns of ``wq`` and rows of ``wo`` (``row_parallel``:
    the output projection's partial sums are added over the ranks) and
    the kv heads those q heads read; the forward takes its head counts
    from the weights it holds."""

    row_parallel = False

    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int, *,
                 generator, device, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wq = nn.Parameter(dense_init(d, n_heads * head_dim, **kw), requires_grad=False)
        self.wk = nn.Parameter(dense_init(d, n_kv * head_dim, **kw), requires_grad=False)
        self.wv = nn.Parameter(dense_init(d, n_kv * head_dim, **kw), requires_grad=False)
        self.wo = nn.Parameter(dense_init(n_heads * head_dim, d, **kw), requires_grad=False)


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def attn_core(q, k, v, mask, softcap=None):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,Kv,hd]; mask: [Sq,Sk] or [B,1,Sq,Sk]."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, sq, kv, group, hd).to(dt)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(dt)).to(torch.float32)
    logits = logits * hd ** -0.5
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    if mask.dim() == 2:
        mask_b = mask[None, None, None, :, :]
    else:
        mask_b = mask[:, :, None, :, :]
    neg = torch.tensor(-1e30, dtype=torch.float32, device=logits.device)
    logits = torch.where(mask_b, logits, neg)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(b, sq, h, hd)


class _BlockwiseAttention(torch.autograd.Function):
    """The online softmax over KV blocks, with a backward of its own that
    walks the same blocks again from the saved log-sum-exp (the
    FlashAttention-2 backward): neither pass holds more than one block of
    [Sq, block] scores, where autograd through the loop would keep every
    block's.  f32 throughout; the output is cast to q's dtype and each
    gradient to its input's."""

    @staticmethod
    def _scores(qg, kc, blk, block, causal, softcap):
        """One block's scores [B, kv, g, Sq, block] (and tanh of the
        softcapped logits, for the backward)."""
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kc)
        t = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = t * softcap
        if causal:
            sq = qg.shape[1]
            k_idx = blk * block + torch.arange(block, device=qg.device)
            msk = k_idx[None, :] <= torch.arange(sq, device=qg.device)[:, None]
            s = torch.where(msk, s, torch.tensor(-1e30, dtype=s.dtype, device=s.device))
        return s, t

    @staticmethod
    def forward(ctx, q, k, v, causal, block, softcap):
        b, sq, h, hd = q.shape
        kv = k.shape[2]
        group = h // kv
        f32 = torch.float32
        qg = q.reshape(b, sq, kv, group, hd).to(f32) * hd ** -0.5
        nb = k.shape[1] // block
        m = torch.full((b, kv, group, sq), -torch.inf, dtype=f32, device=q.device)
        l = torch.zeros((b, kv, group, sq), dtype=f32, device=q.device)
        acc = torch.zeros((b, kv, group, sq, hd), dtype=f32, device=q.device)
        for j in range(nb):
            kc = k[:, j * block:(j + 1) * block].to(f32)
            vc = v[:, j * block:(j + 1) * block].to(f32)
            s, _ = _BlockwiseAttention._scores(qg, kc, j, block, causal, softcap)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(dim=-1)
            acc = acc * scale[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vc)
            m = m_new
        out = acc / l[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.cfg = (causal, block, softcap)
        # [B, kv, g, Sq, hd] -> [B, Sq, H, hd]
        return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block, softcap = ctx.cfg
        b, sq, h, hd = q.shape
        kv = k.shape[2]
        group = h // kv
        f32 = torch.float32
        qg = q.reshape(b, sq, kv, group, hd).to(f32) * hd ** -0.5
        d_out = dout.to(f32).reshape(b, sq, kv, group, hd).permute(0, 2, 3, 1, 4)
        delta = torch.sum(d_out * out, dim=-1)  # [B, kv, g, Sq]
        dqg = torch.zeros_like(out)
        dk = torch.empty(k.shape, dtype=f32, device=k.device)
        dv = torch.empty(v.shape, dtype=f32, device=v.device)
        for j in range(k.shape[1] // block):
            sl = slice(j * block, (j + 1) * block)
            kc, vc = k[:, sl].to(f32), v[:, sl].to(f32)
            s, t = _BlockwiseAttention._scores(qg, kc, j, block, causal, softcap)
            p = torch.exp(s - lse[..., None])  # masked keys: exactly 0
            dv[:, sl] = torch.einsum("bkgqs,bkgqh->bskh", p, d_out)
            ds = p * (torch.einsum("bkgqh,bskh->bkgqs", d_out, vc) - delta[..., None])
            if t is not None:
                ds = ds * (1 - t * t)
            dqg += torch.einsum("bkgqs,bskh->bkgqh", ds, kc)
            dk[:, sl] = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
        dq = (dqg * hd ** -0.5).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def attn_core_blockwise(q, k, v, *, causal: bool, block: int, softcap=None):
    """Flash-style blockwise attention (the training and prefill path):
    q [B, Sq, H, hd] over k, v [B, Sk, kv, hd] in KV blocks of ``block``
    keys with a running (max, sum, accumulator) online softmax, so that
    one block of scores lives at a time, in the backward pass too.  The
    reference's math (q scaled before its product; a causal mask by
    absolute position; -1e30 for masked scores), equal to
    :func:`attn_core` to f32 rounding."""
    block = min(block, k.shape[1])
    if k.shape[1] % block:
        raise ValueError(f"{k.shape[1]} keys are not a multiple of the block {block}")
    return _BlockwiseAttention.apply(q, k, v, causal, block, softcap)


def _project_qkv(p: Attention, x, ncfg, head_dim, use_kernel):
    """q, k, v [B, S, heads, hd] of the heads this rank holds (all of
    them without tensor parallelism; x enters the cut weights through
    ``copy_model``)."""
    n_heads, n_kv = p.wq.shape[-1] // head_dim, p.wk.shape[-1] // head_dim
    if p.row_parallel:
        x = copy_model(x)
    qkv_cfg = site(ncfg, "attn.qkv")
    q = _split_heads(dense(x, p.wq, qkv_cfg, use_kernel=use_kernel), n_heads, head_dim)
    k = _split_heads(dense(x, p.wk, qkv_cfg, use_kernel=use_kernel), n_kv, head_dim)
    v = _split_heads(dense(x, p.wv, qkv_cfg, use_kernel=use_kernel), n_kv, head_dim)
    return q, k, v


def attn_apply(
    p: Attention,
    x,
    ncfg: SiteNumerics,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    positions,
    rope_theta: float = 10_000.0,
    mrope_sections=None,
    kv_cache=None,
    cache_len=None,
    mask="causal",
    softcap=None,
    flash_block: int = 0,
    use_kernel: Optional[bool] = None,
    seq_parallel: bool = False,
):
    """Returns (out [B,S,d], kv): the cache (if one was passed) with the
    span written at ``cache_len`` in place, or the fresh (k, v).

    ``positions`` are [B, S], or [3, B, S] under ``mrope_sections``
    (M-RoPE).  Without a cache, ``mask`` is ``"causal"``, ``"full"``
    (the bidirectional encoder) or a boolean [S, S] tensor; with one,
    attention is causal over the cache prefix, as in the reference.

    ``cache_len`` is an int (one offset shared by the batch) or an
    integer tensor [B] (multi-token paged scoring: every slot writes its
    span at its own offset and attends causally over its own prefix,
    under a [B, 1, Sq, Sk] mask).  In both cases, as the reference's
    ``dynamic_update_slice`` does, a write offset past ``Sk - S`` is
    clamped so that the span stays inside the cache; the mask keeps the
    unclamped query positions (so a decode step past the end of a
    prompt-sized cache overwrites its last slot and attends to every
    key, as the reference's hybrid decode does).

    Without a cache, a ``flash_block`` that divides S and a string
    ``mask`` select :func:`attn_core_blockwise`, as in the reference.

    ``seq_parallel`` (a one-token decode step with an int ``cache_len``
    under a mesh): the cache holds this data rank's block of positions
    (:func:`attn_core_seq_parallel`)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, ncfg, head_dim, use_kernel)
    q = apply_rope(q, positions, rope_theta, mrope_sections)
    k = apply_rope(k, positions, rope_theta, mrope_sections)

    if kv_cache is not None and torch.is_tensor(cache_len):
        # every slot at its own offset
        ck, cv = kv_cache
        s_k = ck.shape[1]
        span = torch.arange(s, device=x.device)
        rows = cache_len.to(torch.long).clamp(0, s_k - s)[:, None] + span  # [B, S]
        bidx = torch.arange(b, device=x.device)[:, None]
        ck.index_put_((bidx, rows), k.to(ck.dtype))
        cv.index_put_((bidx, rows), v.to(cv.dtype))
        qi = cache_len.to(torch.long)[:, None] + span  # [B, Sq]
        ki = torch.arange(s_k, device=x.device)
        m = (ki[None, None, :] <= qi[:, :, None])[:, None]  # [B, 1, Sq, Sk]
        out = attn_core(q, ck, cv, m, softcap)
        new_kv = (ck, cv)
    elif kv_cache is not None and seq_parallel:
        out = attn_core_seq_parallel(q, k, v, kv_cache, int(cache_len), current_mesh(), softcap)
        new_kv = kv_cache
    elif kv_cache is not None:
        # write the span at cache_len (clamped as dynamic_update_slice
        # clamps it), attend causally over the cache prefix at the
        # unclamped query positions
        ck, cv = kv_cache
        at = max(0, min(int(cache_len), ck.shape[1] - s))
        ck[:, at:at + s] = k.to(ck.dtype)
        cv[:, at:at + s] = v.to(cv.dtype)
        m = causal_mask(s, ck.shape[1], cache_len, device=x.device)
        out = attn_core(q, ck, cv, m, softcap)
        new_kv = (ck, cv)
    elif flash_block and isinstance(mask, str) and s % flash_block == 0:
        out = attn_core_blockwise(q, k, v, causal=(mask == "causal"), block=flash_block,
                                  softcap=softcap)
        new_kv = (k, v)
    else:
        if isinstance(mask, str):
            m = (causal_mask(s, s, device=x.device) if mask == "causal"
                 else torch.ones((s, s), dtype=torch.bool, device=x.device))
        else:
            m = mask
        out = attn_core(q, k, v, m, softcap)
        new_kv = (k, v)

    out = dense(out.reshape(b, s, q.shape[2] * head_dim), p.wo, site(ncfg, "attn.out"),
                use_kernel=use_kernel, reduce=p.row_parallel)
    return out, new_kv


def attn_core_seq_parallel(q, k, v, kv_cache, cache_len: int, mesh, softcap=None):
    """One-token decode attention over a cache whose positions are cut over
    the mesh's data axis (the reference's ``seq`` sharding of a global
    batch of 1): this rank holds positions [r S_l, (r + 1) S_l) of S =
    data x S_l.  The new K/V (q, k, v [B, 1, heads, hd]) are written on
    the rank that owns position ``cache_len`` (clamped to S - 1, as
    :func:`attn_apply` clamps it); each rank computes its partial softmax
    over its keys at or before ``cache_len`` (f32: the running max, the
    sum of exponentials and the weighted values), the partials are
    gathered over ``data`` (one all-gather) and merged by log-sum-exp.
    Returns [B, 1, H, hd] in the cache's dtype."""
    ck, cv = kv_cache
    b, sq, h, hd = q.shape
    if sq != 1:
        raise ValueError("sequence-parallel attention is a one-token decode path")
    s_l = ck.shape[1]
    start = mesh.data_rank * s_l
    at = max(0, min(cache_len, s_l * mesh.data_size - 1))
    if start <= at < start + s_l:
        ck[:, at - start:at - start + 1] = k.to(ck.dtype)
        cv[:, at - start:at - start + 1] = v.to(cv.dtype)
    kv = ck.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, 1, kv, h // kv, hd).to(f32)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, ck.to(f32)) * hd ** -0.5
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    live = (start + torch.arange(s_l, device=q.device)) <= cache_len
    logits = torch.where(live, logits, torch.tensor(-1e30, dtype=f32, device=q.device))
    m = logits.amax(dim=-1, keepdim=True)  # [B, kv, g, 1, 1]
    p = torch.exp(logits - m)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, cv.to(f32))
    part = torch.cat([o, p.sum(dim=-1, keepdim=True), m], dim=-1)  # [B, kv, g, 1, hd + 2]
    parts = torch.stack(mesh.all_gather(part, "data"))
    top = parts[..., -1:].amax(dim=0)
    w = torch.exp(parts[..., -1:] - top)
    out = (w * parts[..., :hd]).sum(dim=0) / (w * parts[..., hd:hd + 1]).sum(dim=0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(cv.dtype)


def paged_write(lengths, block_tables, block_size: int):
    """Where a decode step writes each row's new K/V, the same for every
    layer: (block, slot, source row).  Idle slots all write the scratch
    block's first key and read it back; under MoE their K/V differ (the
    capacity drops differ by rank), so every row writes the K/V of the
    last row with its destination: the reference's last-wins result,
    which ``index_put_`` leaves undefined for a duplicate index on the
    card."""
    bidx = torch.arange(lengths.shape[0], device=lengths.device)
    lens = lengths.to(torch.long)
    blk = block_tables[bidx, lens // block_size].to(torch.long)
    slot = lens % block_size
    dest = blk * block_size + slot
    return blk, slot, torch.where(dest[:, None] == dest[None, :], bidx, -1).amax(dim=1)


def attn_apply_paged(
    p: Attention,
    x,
    ncfg: SiteNumerics,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    lengths,
    k_pages,
    v_pages,
    block_tables,
    write,
    rope_theta: float = 10_000.0,
    softcap=None,
    use_kernel: Optional[bool] = None,
):
    """Single-token decode attention over a paged KV cache.

    x: [B, 1, d]; k_pages/v_pages: [num_blocks, block_size, kv, hd] pool
    views for this layer; block_tables: int32 [B, max_blk]; lengths:
    int32 [B] tokens already cached per sequence; write: the step's
    :func:`paged_write`.  The new token's K/V are written into each
    sequence's tail block in place, then attention reads through the
    block table (``repro_torch.kernels``).  Returns (out [B, 1, d],
    (k_pages, v_pages)).
    """
    from repro_torch.kernels.decode_attention import paged_decode_attention

    b, s, _ = x.shape
    if s != 1:
        raise ValueError("paged attention is a single-token decode path")
    if softcap is not None:
        raise NotImplementedError("paged decode does not support logit softcap")
    q, k, v = _project_qkv(p, x, ncfg, head_dim, use_kernel)
    positions = decode_positions(lengths)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    # write the new token into each sequence's tail block
    blk, slot, src = write
    k_pages.index_put_((blk, slot), k[src, 0].to(k_pages.dtype))
    v_pages.index_put_((blk, slot), v[src, 0].to(v_pages.dtype))

    out = paged_decode_attention(
        q[:, 0].contiguous(), k_pages, v_pages, block_tables, lengths + 1,
        use_kernel=use_kernel)
    out = dense(out.reshape(b, 1, q.shape[2] * head_dim), p.wo, site(ncfg, "attn.out"),
                use_kernel=use_kernel, reduce=p.row_parallel)
    return out, (k_pages, v_pages)


def cross_attn_apply(p: Attention, x, enc_kv, ncfg: SiteNumerics, *, n_heads: int,
                     n_kv: int, head_dim: int, use_kernel: Optional[bool] = None):
    """Decoder cross-attention over the encoder's (k, v) [B, S_src, kv, hd]:
    no rope, every query attends to every encoder position.  Under tensor
    parallelism the heads are the rank's (from the weights it holds), x
    enters ``wq`` through ``copy_model`` and ``wo``'s f32 partial sums are
    added over the ranks before their rounding, as in :func:`attn_apply`."""
    b, s, _ = x.shape
    heads = p.wq.shape[-1] // head_dim
    if p.row_parallel:
        x = copy_model(x)
    q = _split_heads(dense(x, p.wq, site(ncfg, "attn.cross.qkv"), use_kernel=use_kernel),
                     heads, head_dim)
    k, v = enc_kv
    m = torch.ones((s, k.shape[1]), dtype=torch.bool, device=x.device)
    out = attn_core(q, k, v, m)
    return dense(out.reshape(b, s, heads * head_dim), p.wo, site(ncfg, "attn.cross.out"),
                 use_kernel=use_kernel, reduce=p.row_parallel)


def encode_cross_kv(p: Attention, enc_out, ncfg: SiteNumerics, *, n_kv: int, head_dim: int,
                    use_kernel: Optional[bool] = None):
    """The cross-attention's (k, v) of the encoder output [B, S_src, d], of
    the kv heads this rank holds (all of them without tensor parallelism).
    ``enc_out`` enters the cut ``wk``/``wv`` as it is: the decoder puts it
    through ``copy_model`` once for all its layers."""
    kv = p.wk.shape[-1] // head_dim
    qkv_cfg = site(ncfg, "attn.cross.qkv")
    k = _split_heads(dense(enc_out, p.wk, qkv_cfg, use_kernel=use_kernel), kv, head_dim)
    v = _split_heads(dense(enc_out, p.wv, qkv_cfg, use_kernel=use_kernel), kv, head_dim)
    return k, v
