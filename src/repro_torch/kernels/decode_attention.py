"""Single-token GQA decode attention: paged (K2) and contiguous (K5).

Port of ``repro/kernels/decode_attention.py``.  Both CUDA kernels run
one shared split-key core, ``csrc/decode_attention.cuh``: one thread
block per (key split, kv head, sequence); eight warps a block, each an
online softmax in f32 over its own tiles of keys, fed by a two-stage
``cp.async`` ring of 16-byte copies; Q.K^T on the tensor cores when q
and the cache are bf16 (f32 FMAs otherwise); P.V in f32 on the FMA
pipes.  A sequence with one live split writes its output directly; with
several, the last split of each (sequence, kv head) to finish combines
their softmax states.  :func:`split_plan` picks the split from the
cache's capacity and the card's SMs.

* K2, the Pallas TPU kernel ``paged_decode_attention_kernel``, becomes
  ``csrc/paged_decode_attention.cu``: the core reads each split's slice
  of the block-table row itself.  ``paged_decode_attention_ref`` (gather,
  then attend in ``attn_core``'s operation order) is its plain version,
  the path the reference engine runs off the TPU.
  ``paged_decode_attention`` dispatches between them.  The two agree to
  within rounding, not bit for bit: the kernel keeps scores and
  probabilities in f32 to the end, while the plain version rounds the
  scores to the operands' dtype and the softmax weights to the value
  dtype (bf16 in serving) before the weighted sum.
* K5, the Pallas TPU kernel ``decode_attention`` over a contiguous
  cache, becomes ``csrc/decode_attention.cu``.  ``decode_attention_ref``
  is its plain version (all in f32, as the reference's oracle), and
  ``decode_attention`` dispatches.  No serving path of either package
  calls it; it is a public kernel.

A sequence of length 0 has every key masked: as in the reference, its
weights are uniform over every key the cache holds (``max_blk *
block_size`` paged, ``S`` contiguous).

On meta tensors (the dry run, ``launch/dryrun.py``) the kernels plan
their splits for an H100's SMs and count as their work every key the
cache holds: a meta run has no lengths to read.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.parallel.sharding import current_mesh

from . import _lib

_FLOATS = (torch.float32, torch.bfloat16)
#: head dims the core is compiled for (csrc/decode_attention.cuh)
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16

# The split plan.  A block runs eight warps over 16-key tiles (at hd 128
# in bf16), so a split is a whole number of 128-key rounds, at least
# MIN_SPLIT_KEYS: at the tens of keys a serving step holds, one split
# covers a sequence and no combine runs.  Longer caches get about one
# block per SM of the card over all (sequence, kv head) pairs (one block
# fills an SM's shared memory), at most MAX_SPLIT_KEYS keys a split (which
# also bounds the block-table slice a paged block holds in shared memory).
# At chip_smoke.py's K5 shape (4 sequences, 4096-key cache, bf16) on an
# H100 (132 SMs) this gives 512 keys a block; chip_smoke.py's split sweep
# there times 128, 256, 512 and 1024 keys a block (PERF.md records it).
ROUND_KEYS = 128
MIN_SPLIT_KEYS = 256
MAX_SPLIT_KEYS = 4096


@functools.lru_cache(maxsize=None)
def card_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(q: torch.Tensor) -> int:
    """The SMs a launch on ``q``'s device plans for: the card's, or on the
    meta device an H100 SXM's."""
    if q.is_meta:
        from repro_torch.launch.roofline import SMS

        return SMS
    return card_sms(q.device.index)


def _attention_work(q: torch.Tensor, kv_bytes: float, keys: int) -> dict:
    """``_lib.launch``'s work of a decode attention launch over ``keys``
    keys a sequence: two f32 FLOPs a multiply-add of Q.K^T and P.V."""
    b, h, hd = q.shape
    return dict(flops=4 * b * h * keys * hd,
                moved=2 * q.numel() * q.element_size() + kv_bytes)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """``n_splits`` blocks of ``split_keys`` keys per (sequence, kv head).
    Split c covers keys [c * split_keys, (c + 1) * split_keys) below the
    sequence's active keys (its length capped at the capacity, or the whole
    capacity at length 0); splits past them exit at once."""

    n_splits: int
    split_keys: int


@functools.lru_cache(maxsize=256)
def split_plan(batch: int, kv: int, capacity: int, sms: int,
               split_keys: Optional[int] = None) -> SplitPlan:
    """Split of a cache of ``capacity`` keys per sequence over blocks on a
    card of ``sms`` SMs.  ``split_keys`` given: that many keys a block;
    else chosen from the shape (module constants above)."""
    if split_keys is None:
        want = max(1, -(-sms // (batch * kv)))
        split_keys = -(-capacity // want)
        split_keys = -(-split_keys // ROUND_KEYS) * ROUND_KEYS
        split_keys = min(max(split_keys, MIN_SPLIT_KEYS), MAX_SPLIT_KEYS)
    if split_keys <= 0:
        raise ValueError(f"split_keys must be positive, got {split_keys}")
    return SplitPlan(-(-capacity // split_keys), split_keys)


# Counters of the last-arriving split, one per (sequence, kv head): zeroed
# once, allocated once per (device, stream) and grown as needed; every
# launch leaves them zero.  Keyed by stream, since two launches that run
# at once must not share them.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _scratch(q: torch.Tensor, batch: int, kv: int, hd: int, plan: SplitPlan):
    """(partials, counters) pointers for a launch: none for one split;
    else f32 partials allocated per call (the caching allocator makes it
    cheap) and the stream's shared counters."""
    if plan.n_splits == 1:
        return None, 0, 0
    h = q.shape[1]
    partials = torch.empty(batch * h * plan.n_splits * (hd + 2), dtype=torch.float32,
                           device=q.device)
    if q.is_meta:  # the counters are the card's, once per stream
        return partials, 0, 0
    key = (q.device.index, _lib.stream_ptr(q))
    counters = _counters.get(key)
    if counters is None or counters.numel() < batch * kv:
        counters = torch.zeros(batch * kv, dtype=torch.int32, device=q.device)
        _counters[key] = counters
    return partials, partials.data_ptr(), counters.data_ptr()


def _check_core_shape(q: torch.Tensor, kv: int, tensors) -> None:
    b, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not compiled in; the kernel takes {HEAD_DIMS}")
    if h // kv > MAX_GROUP:
        raise ValueError(f"{h // kv} q heads per kv head; the kernel takes at most {MAX_GROUP}")
    if b > 65535 or kv > 65535:
        raise ValueError(f"batch {b} or kv heads {kv} exceed the grid's 65535")
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


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
    with any valid block id); lengths: int32 [B] valid keys per sequence
    (0: every key masked, uniform weights over all max_blk * bs keys).
    hd in HEAD_DIMS, at most MAX_GROUP q heads per kv head.  Returns
    [B, H, hd] in q's dtype."""
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
    _check_core_shape(q, kv, [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)])
    max_blk = block_tables.shape[1]
    plan = split_plan(b, kv, max_blk * bs, _sms(q))
    _keep, partials, counters = _scratch(q, b, kv, hd, plan)
    out = torch.empty_like(q)
    keys = max_blk * bs  # every key the table rows name
    kv_bytes = 2 * b * keys * kv * hd * k_pool.element_size() + (
        block_tables.numel() + lengths.numel()) * 4
    return _lib.launch(
        "paged_decode_attention", out, lambda: _lib.library().paged_decode_attention_launch(
            q.data_ptr(), _lib.DTYPE_CODES[q.dtype], k_pool.data_ptr(), v_pool.data_ptr(),
            _lib.DTYPE_CODES[k_pool.dtype], block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), partials, counters, b, h, kv, hd, bs, max_blk, plan.n_splits,
            plan.split_keys, hd ** -0.5, _lib.stream_ptr(q)),
        inputs=(q, k_pool, v_pool, block_tables, lengths), **_attention_work(q, kv_bytes, keys))


def paged_decode_attention_tp(q, k_pool, v_pool, block_tables, lengths,
                              *, use_kernel: Optional[bool] = None):
    """Head-sharded paged decode attention under tensor parallelism (K6).

    The reference's ``shard_map`` over the ``model`` axis runs K2 on each
    device's kv-head slice of the pool and the matching q heads.  Here
    each rank is its own process and holds only its slice
    (``parallel/sharding.py``): q [B, H/tp, hd] its q heads, the pools its
    kv heads (``kv_heads_for_rank``: its block of kv/tp heads, or, where
    the kv heads do not divide tp, the heads its q heads read, replicated
    across ranks).  GQA groups q heads contiguously by kv head, so the
    rank's q heads attend exactly its kv heads: K2 (its plain version on
    the CPU) runs unchanged on the slice, with no collective.  Block
    tables and lengths are the same on every rank."""
    if _lib.wants_kernel(q, use_kernel):
        return paged_decode_attention_kernel(q, k_pool, v_pool, block_tables, lengths)
    return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           *, use_kernel: Optional[bool] = None):
    """Paged decode attention: the kernel for CUDA tensors, the plain
    version for CPU tensors (or anywhere under ``use_kernel=False``).
    Under a mesh of more than one rank it is the head-sharded
    :func:`paged_decode_attention_tp`, as the reference dispatches."""
    mesh = current_mesh()
    if mesh is not None and mesh.model_size > 1:
        return paged_decode_attention_tp(q, k_pool, v_pool, block_tables, lengths,
                                         use_kernel=use_kernel)
    if _lib.wants_kernel(q, use_kernel):
        return paged_decode_attention_kernel(q, k_pool, v_pool, block_tables, lengths)
    return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths)


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


def decode_attention_kernel(q, k, v, lengths, *, blk: Optional[int] = None):
    """The CUDA kernel.  q: [B, H, hd]; k, v: [B, S, kv, hd], all f32 or all
    bf16; lengths: int32 [B] valid keys per sequence (0: uniform weights
    over all S keys).  hd in HEAD_DIMS, at most MAX_GROUP q heads per kv
    head.  ``blk`` (the reference's keys per block) is the keys each
    thread block covers; ``None`` takes :func:`split_plan`'s choice.
    Returns [B, H, hd] in q's dtype."""
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
    if blk is not None and blk <= 0:
        raise ValueError(f"blk must be positive, got {blk}")
    _check_core_shape(q, kv, [("q", q), ("k", k), ("v", v)])
    plan = split_plan(b, kv, s, _sms(q), blk)
    _keep, partials, counters = _scratch(q, b, kv, hd, plan)
    out = torch.empty_like(q)
    kv_bytes = 2 * k.numel() * k.element_size() + lengths.numel() * 4
    return _lib.launch(
        "decode_attention", out, lambda: _lib.library().decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _lib.DTYPE_CODES[q.dtype],
            lengths.data_ptr(), partials, counters, out.data_ptr(), b, h, kv, hd, s,
            plan.n_splits, plan.split_keys, hd ** -0.5, _lib.stream_ptr(q)),
        inputs=(q, k, v, lengths), **_attention_work(q, kv_bytes, s))


def decode_attention(q, k, v, lengths, *, blk: Optional[int] = None,
                     use_kernel: Optional[bool] = None):
    """Contiguous-cache decode attention: the kernel for CUDA tensors, the
    plain version for CPU tensors (or anywhere under ``use_kernel=False``).
    ``blk`` is the kernel's keys per thread block (``None``: chosen from
    the shape); the plain version has no blocks."""
    if _lib.wants_kernel(q, use_kernel):
        return decode_attention_kernel(q, k, v, lengths, blk=blk)
    return decode_attention_ref(q, k, v, lengths)
