"""Paged single-token GQA decode attention (K2) and its plain version.

Port of ``repro/kernels/decode_attention.py``: the Pallas TPU kernel
``paged_decode_attention_kernel`` becomes ``csrc/paged_decode_attention.cu``,
which reads each sequence's block table inside the kernel and keeps the
online softmax in f32.  ``paged_decode_attention_ref`` (gather, then
attend in ``attn_core``'s operation order) is its plain version, the
path the reference engine runs off the TPU.  ``paged_decode_attention``
dispatches between them.

The two agree to within rounding, not bit for bit: the kernel keeps
scores and probabilities in f32 to the end, while the plain version
rounds the scores to the operands' dtype and the softmax weights to
the value dtype (bf16 in serving) before the weighted sum.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib

_FLOATS = (torch.float32, torch.bfloat16)


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[num_blocks, bs, kv, hd] pool + [B, max_blk] table ->
    contiguous [B, max_blk * bs, kv, hd] per-sequence cache view."""
    b, max_blk = block_tables.shape
    bs, kv, hd = pool.shape[1:]
    pages = pool.index_select(0, block_tables.reshape(-1).to(torch.long))
    return pages.reshape(b, max_blk * bs, kv, hd)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths):
    """Gather-then-attend plain version.

    Matches ``models.attention.attn_core``'s operation order (einsum
    then scale, f32 softmax, weights cast to the value dtype) so paged
    decode is token-identical to the monolithic-cache path under greedy
    decode.
    """
    b, h, hd = q.shape
    kv = k_pool.shape[2]
    group = h // kv
    k = gather_pages(k_pool, block_tables)  # [B, S, kv, hd]
    v = gather_pages(v_pool, block_tables)
    s = k.shape[1]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, 1, kv, group, hd).to(dt)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(dt)).to(torch.float32)
    logits = logits * hd ** -0.5
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None].to(q.device)
    logits = torch.where(mask[:, None, None, None, :], logits,
                         torch.tensor(-1e30, dtype=torch.float32, device=q.device))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(b, h, hd)


def paged_decode_attention_kernel(q, k_pool, v_pool, block_tables, lengths):
    """The CUDA kernel.  q: [B, H, hd]; k_pool, v_pool: [num_blocks, bs,
    kv, hd]; block_tables: int32 [B, max_blk] pool indices (rows padded
    with any valid block id); lengths: int32 [B] valid keys per sequence,
    each at least 1.  Returns [B, H, hd] in q's dtype."""
    _lib.require(q, "q", _FLOATS, 3)
    _lib.require(k_pool, "k_pool", _FLOATS, 4)
    _lib.require(v_pool, "v_pool", (k_pool.dtype,), 4)
    _lib.require(block_tables, "block_tables", (torch.int32,), 2)
    _lib.require(lengths, "lengths", (torch.int32,), 1)
    b, h, hd = q.shape
    nb, bs, kv, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd or h % kv:
        raise ValueError(
            f"q {tuple(q.shape)} does not fit pools {tuple(k_pool.shape)}")
    if block_tables.shape[0] != b or lengths.shape[0] != b:
        raise ValueError("block_tables and lengths need one row per sequence")
    out = torch.empty_like(q)
    err = _lib.library().paged_decode_attention_launch(
        q.data_ptr(), _lib.DTYPE_CODES[q.dtype], k_pool.data_ptr(), v_pool.data_ptr(),
        _lib.DTYPE_CODES[k_pool.dtype], block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, kv, hd, bs, block_tables.shape[1], hd ** -0.5,
        _lib.stream_ptr(q))
    _lib.check_launch("paged_decode_attention", err)
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           *, use_kernel: Optional[bool] = None):
    """Paged decode attention: the kernel for CUDA tensors, the plain
    version for CPU tensors (or anywhere under ``use_kernel=False``)."""
    if _lib.wants_kernel(q, use_kernel):
        return paged_decode_attention_kernel(q, k_pool, v_pool, block_tables, lengths)
    return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths)
