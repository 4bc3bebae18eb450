"""Paged KV cache: fixed-size blocks + a free-list allocator.

A copy of ``repro/serving/kv_cache.py`` (host-side bookkeeping, no JAX),
kept in the port so the port imports nothing of the JAX package.

Replaces the monolithic per-prompt [L, B, S_max, kv, hd] caches with a
single shared pool of [L, num_blocks, block_size, kv, hd] and a block
table per sequence, vLLM-style:

* no per-request padding to a global max length — a sequence holds
  exactly ceil(len / block_size) blocks;
* admission control becomes arithmetic on the free list, so the
  scheduler can decide "does this request fit?" without touching
  device memory;
* retiring a sequence is O(1): return its blocks to the free list.

Block 0 is reserved as a scratch block: inactive batch slots in the
batched decode step point their block tables at it, so their (masked,
ignored) writes never corrupt a live sequence.

Prefix caching (``prefix_cache=True``) makes the allocator
content-addressed on top of the free list: every full block a prefill
writes can be *registered* under the chain hash of its token prefix
(``hash(parent_hash, block_tokens)``), per-block refcounts track how
many live sequences share a block, and blocks whose refcount drops to
zero while registered are parked on an LRU list instead of freed —
still valid cache, reclaimed (evicted, then scrubbed by the engine,
then freed) only under pool pressure.  Admission walks a new prompt's
full blocks through the hash map and reuses every leading hit, so only
the miss suffix is prefilled.  Three rules keep the pool sound:

* a block is never scrubbed while its refcount is > 0;
* a sequence never writes into a block it shares (refcount > 1) — the
  one case where a hit block must absorb writes (a fully-cached,
  block-aligned prompt still has to recompute its last token for
  logits) is resolved by copy-on-write into a private block;
* eviction strictly precedes reuse: an evicted block is unregistered,
  reported via ``drain_evicted`` for scrubbing, and only then eligible
  for reallocation.

Device storage lives in the engine as a pair of tensors returned by
`ModelAPI.paged_pool_init`; this module is the host-side bookkeeping.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence


SCRATCH_BLOCK = 0  # pool index never handed out by the allocator


class OutOfBlocksError(RuntimeError):
    """Raised on allocation from an exhausted pool (callers that want
    to wait instead should check `can_allocate` first)."""


class BlockAllocator:
    """Free-list allocator over pool indices [1, num_blocks).

    Index 0 is the reserved scratch block (see module docstring).
    With ``prefix_cache=True`` the allocator additionally keeps
    per-block refcounts, the chain-hash -> block map and the LRU of
    unreferenced-but-cached blocks; with it off (the default) every
    cache method degenerates to a no-op and ``allocate``/``release``
    behave exactly like the historical allocate/free pair.
    """

    def __init__(self, num_blocks: int, block_size: int, prefix_cache: bool = False):
        assert num_blocks >= 2, "need at least one allocatable block"
        assert block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self._free: deque[int] = deque(range(1, num_blocks))
        # content-addressed state (all empty / zero while prefix_cache
        # is off, so the legacy invariants hold unchanged)
        self._refcount: List[int] = [0] * num_blocks
        self._block_hash: List[Optional[int]] = [None] * num_blocks
        self._hash_to_block: Dict[int, int] = {}
        # refcount-0 registered blocks, oldest-released first (the
        # eviction order); values unused, OrderedDict for O(1) touch
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # evicted blocks not yet scrubbed — the engine drains this and
        # zeroes them before any compute call can touch the pool again
        self._evicted_dirty: List[int] = []
        # hit-rate observability, read live by the engine's metric
        # sources (counts are in BLOCKS except tokens_saved)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_saved = 0
        self.cow_copies = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached_idle(self) -> int:
        """Registered blocks no live sequence references (the LRU) —
        reusable as cache hits, reclaimable via eviction."""
        return len(self._lru)

    @property
    def num_available(self) -> int:
        """Blocks an ``allocate`` call could produce: the free list
        plus everything evictable from the cache LRU."""
        return len(self._free) + len(self._lru)

    @property
    def num_cached(self) -> int:
        """Blocks holding registered prefix-cache content (referenced
        or idle) — the cached-block occupancy gauge."""
        return len(self._hash_to_block)

    @property
    def num_referenced(self) -> int:
        """Blocks held (refcount > 0) by live sequences."""
        return sum(1 for rc in self._refcount if rc > 0)

    @property
    def num_used(self) -> int:
        """Blocks not on the free list (scratch excluded): owned by
        live sequences or parked as idle cache."""
        return self.num_blocks - 1 - len(self._free)

    def refcount(self, block: int) -> int:
        return self._refcount[block]

    def utilization(self) -> float:
        """Fraction of the allocatable pool in use — the occupancy
        gauge the observability layer samples per event/step."""
        allocatable = self.num_blocks - 1
        return self.num_used / allocatable if allocatable else 0.0

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold n_tokens cache entries."""
        return max(1, -(-n_tokens // self.block_size))

    def can_allocate(self, n_blocks: int) -> bool:
        return n_blocks <= self.num_available

    def allocate(self, n_blocks: int) -> List[int]:
        """Pop ``n_blocks`` from the free list, evicting idle cached
        blocks (LRU-first) to cover any shortfall.  Every returned
        block starts with refcount 1 (owned by the caller)."""
        if not self.can_allocate(n_blocks):
            raise OutOfBlocksError(
                f"requested {n_blocks} blocks, {self.num_free} free "
                f"+ {self.num_cached_idle} evictable"
            )
        while len(self._free) < n_blocks:
            self._evict_one()
        out = [self._free.popleft() for _ in range(n_blocks)]
        for b in out:
            self._refcount[b] = 1
        return out

    def _evict_one(self) -> None:
        """Reclaim the least-recently-released idle cached block:
        unregister it, mark it dirty (the engine scrubs it before the
        next compute call) and return it to the free list."""
        block, _ = self._lru.popitem(last=False)
        self._unregister(block)
        self._free.append(block)
        self._evicted_dirty.append(block)
        self.evictions += 1

    def drain_evicted(self) -> List[int]:
        """Evicted-but-unscrubbed blocks since the last drain.  The
        engine folds these into its batched scrub before any compute
        touches the pool (eviction -> scrub -> reuse ordering)."""
        out, self._evicted_dirty = self._evicted_dirty, []
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Force blocks back onto the free list (the raw primitive —
        refcount-aware callers use :meth:`release`).  Rejects
        out-of-range ids, the scratch block, double frees and blocks
        other sequences still share, instead of silently corrupting
        the free list."""
        for b in blocks:
            if not (0 <= b < self.num_blocks):
                raise ValueError(
                    f"free of out-of-range block id {b} "
                    f"(pool blocks are 0..{self.num_blocks - 1})"
                )
            if b == SCRATCH_BLOCK:
                raise ValueError("free of reserved scratch block 0")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            if self._refcount[b] > 1:
                raise ValueError(
                    f"free of shared block {b} (refcount "
                    f"{self._refcount[b]}); use release()"
                )
            if self._block_hash[b] is not None:
                self._unregister(b)
            self._refcount[b] = 0
            self._free.append(b)

    def release(self, blocks: Sequence[int]) -> List[int]:
        """Drop one reference per block.  A block whose refcount hits
        zero is parked on the cache LRU when registered, freed
        otherwise.  Returns the blocks that reached the free list —
        the caller must scrub any of them that were ever written."""
        freed: List[int] = []
        for b in blocks:
            rc = self._refcount[b]
            if rc <= 0:
                raise ValueError(f"release of unreferenced block {b}")
            self._refcount[b] = rc - 1
            if rc > 1:
                continue
            if self._block_hash[b] is not None:
                self._lru[b] = None
                self._lru.move_to_end(b)
            else:
                self._free.append(b)
                freed.append(b)
        return freed

    # -- content addressing ------------------------------------------------

    def _chain_hashes(self, tokens: Sequence[int]) -> List[int]:
        """Chain hash per FULL block of ``tokens``:
        ``h_i = hash((h_{i-1}, block_i_tokens))`` — position-dependent
        by construction, so equal blocks under different prefixes never
        collide into one pool block."""
        out: List[int] = []
        h = 0
        bs = self.block_size
        for i in range(len(tokens) // bs):
            h = hash((h, tuple(tokens[i * bs : (i + 1) * bs])))
            out.append(h)
        return out

    def match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Peek (no refcount change): the cached blocks holding the
        longest full-block prefix of ``tokens``, in logical order."""
        if not self.prefix_cache:
            return []
        out: List[int] = []
        for h in self._chain_hashes(tokens):
            b = self._hash_to_block.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def acquire(self, blocks: Sequence[int]) -> None:
        """Take one reference per (registered) block — a cache hit.
        Idle blocks leave the LRU; they are no longer evictable."""
        for b in blocks:
            if self._refcount[b] == 0:
                assert b in self._lru, f"acquire of unregistered idle block {b}"
                del self._lru[b]
            self._refcount[b] += 1

    def register(self, tokens: Sequence[int], blocks: Sequence[int]) -> None:
        """Publish a prefilled sequence's FULL token blocks into the
        hash map (called once prefill has actually written them — a
        mapping must never race ahead of pool content).  First writer
        wins: hashes already mapped keep their canonical block."""
        if not self.prefix_cache:
            return
        for h, b in zip(self._chain_hashes(tokens), blocks):
            if h in self._hash_to_block:
                continue  # an identical prefix is already canonical
            assert self._block_hash[b] is None, (
                f"block {b} already registered under another hash"
            )
            self._hash_to_block[h] = b
            self._block_hash[b] = h

    def _unregister(self, block: int) -> None:
        h = self._block_hash[block]
        if h is not None:
            del self._hash_to_block[h]
            self._block_hash[block] = None
        self._lru.pop(block, None)


@dataclasses.dataclass
class SequenceAllocation:
    """The blocks one running sequence owns, in logical order: block i
    holds cache positions [i*block_size, (i+1)*block_size)."""

    blocks: List[int]
    block_size: int

    def table_row(self, width: int) -> List[int]:
        """Block table row padded to the engine's static width with the
        scratch block (those entries are masked by the length)."""
        assert len(self.blocks) <= width, (len(self.blocks), width)
        return self.blocks + [SCRATCH_BLOCK] * (width - len(self.blocks))

    def capacity(self) -> int:
        return len(self.blocks) * self.block_size

    def grow(self, blocks: List[int]) -> None:
        """Append freshly-allocated blocks (on-demand growth under
        preemptive scheduling): the new blocks extend the sequence's
        logical position range past the previous capacity."""
        assert SCRATCH_BLOCK not in blocks
        assert not set(blocks) & set(self.blocks), "grow with owned block"
        self.blocks.extend(blocks)

    def blocks_covering(self, start: int, stop: int) -> List[int]:
        """Blocks holding logical positions [start, stop) — the
        truncate/rollback primitive.  Speculative decoding writes k+1
        positions per verify step and then rolls the logical length
        back over the rejected tail; the blocks named here still hold
        that stale (never-committed) K/V and must be scrubbed before
        they are handed to another sequence."""
        if stop <= start:
            return []
        assert stop <= self.capacity(), (start, stop, self.capacity())
        lo = start // self.block_size
        hi = (stop - 1) // self.block_size
        return self.blocks[lo : hi + 1]


def padded_prompt_len(prompt_len: int, block_size: int) -> int:
    """Prompt length right-padded to a whole number of blocks (the
    prefill bucket)."""
    return max(1, -(-prompt_len // block_size)) * block_size
