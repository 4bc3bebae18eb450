"""Single-token GQA decode attention: paged (K2) and contiguous (K5).

Port of ``repro/kernels/decode_attention.py``:

* K2, the Pallas TPU kernel ``paged_decode_attention_kernel``, becomes
  ``csrc/paged_decode_attention.cu``, which reads each sequence's block
  table inside the kernel and keeps the online softmax in f32.
  ``paged_decode_attention_ref`` (gather, then attend in ``attn_core``'s
  operation order) is its plain version, the path the reference engine
  runs off the TPU.  ``paged_decode_attention`` dispatches between them.
  The two agree to within rounding, not bit for bit: the kernel keeps
  scores and probabilities in f32 to the end, while the plain version
  rounds the scores to the operands' dtype and the softmax weights to
  the value dtype (bf16 in serving) before the weighted sum.
* K5, the Pallas TPU kernel ``decode_attention`` over a contiguous
  cache, becomes ``csrc/decode_attention.cu``, which splits the keys
  into chunks across blocks and combines the chunks' softmax states in a
  second kernel.  ``decode_attention_ref`` is its plain version (all in
  f32, as the reference's oracle), and ``decode_attention`` dispatches.
  No serving path of either package calls it; it is a public kernel.
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


# Keys per thread block of K5 (the reference's ``blk``): 128 keys give
# the 16 (sequence, kv head) pairs of a yi-6b-width cache 32 blocks each
# at S = 4096, enough to fill the card.  On an H100 80GB HBM3 (700 W) at
# chip_smoke.py's K5 shape in bf16, 64 keys took 76.6 us, 128 took 72.1,
# 256 took 95.9 and 512 took 144.8 (PERF.md, K5).
DEFAULT_BLOCK = 128


def decode_attention_ref(q, k, v, lengths):
    """Plain version of K5, the reference's oracle: everything in f32, q
    scaled by hd^-0.5 before the dot, keys >= length masked with -1e30,
    output in q's dtype."""
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.to(torch.float32).reshape(b, kv, group, hd) * hd ** -0.5
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.to(torch.float32))
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None].to(q.device)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.tensor(-1e30, dtype=torch.float32, device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w, v.to(torch.float32))
    return out.reshape(b, h, hd).to(q.dtype)


def decode_attention_kernel(q, k, v, lengths, *, blk: int = DEFAULT_BLOCK):
    """The CUDA kernel.  q: [B, H, hd]; k, v: [B, S, kv, hd], all f32 or all
    bf16; lengths: int32 [B] valid keys per sequence.  Returns [B, H, hd]
    in q's dtype."""
    _lib.require(q, "q", _FLOATS, 3)
    _lib.require(k, "k", (q.dtype,), 4)
    _lib.require(v, "v", (q.dtype,), 4)
    _lib.require(lengths, "lengths", (torch.int32,), 1)
    b, h, hd = q.shape
    b_k, s, kv, hd_k = k.shape
    if v.shape != k.shape or b_k != b or hd_k != hd or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if lengths.shape[0] != b:
        raise ValueError("lengths needs one entry per sequence")
    if blk <= 0:
        raise ValueError(f"blk must be positive, got {blk}")
    chunks = -(-s // blk)
    m_part = torch.empty((b, h, chunks), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, h, chunks, hd), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = _lib.library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _lib.DTYPE_CODES[q.dtype],
        lengths.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), b, h, kv, hd, s, blk, hd ** -0.5, _lib.stream_ptr(q))
    _lib.check_launch("decode_attention", err)
    return out


def decode_attention(q, k, v, lengths, *, blk: int = DEFAULT_BLOCK,
                     use_kernel: Optional[bool] = None):
    """Contiguous-cache decode attention: the kernel for CUDA tensors, the
    plain version for CPU tensors (or anywhere under ``use_kernel=False``).
    ``blk`` is the kernel's keys per thread block; the plain version has
    no blocks."""
    if _lib.wants_kernel(q, use_kernel):
        return decode_attention_kernel(q, k, v, lengths, blk=blk)
    return decode_attention_ref(q, k, v, lengths)
