"""Request lifecycle + admission control for continuous batching.

A copy of ``repro/serving/scheduler.py`` (host-side, no JAX), kept in
the port so the port imports nothing of the JAX package.  The port's
engine runs it under both regimes below, with chunked prefill,
speculative bursts and the prefix cache, as the reference's does.

A `Request` moves WAITING -> RUNNING -> FINISHED, with two extra
terminal/parking states: CANCELLED (deadline expiry or client abort)
and PREEMPTED (evicted under pool pressure, waiting to resume).

Two admission regimes, selected by ``preemption``:

* ``"off"`` (default, the PR 1-4 behavior): admission reserves blocks
  for the WHOLE lifetime up front (prompt + max_new_tokens, plus the
  worst-case speculative burst), so an admitted sequence can never run
  out of cache mid-decode and no preemption machinery runs.
* ``"recompute"``: admission allocates only what prefill needs (the
  block-padded committed context) and sequences grow on demand, one
  block at a time, as they decode.  Under pool pressure the scheduler
  preempts a victim — the least *deserving* running request, i.e.
  lowest ``priority`` first, then latest ``arrival_step``, then
  highest rid — releasing ALL its blocks (the engine scrubs every
  written one) and parking it in ``preempted``.  It resumes later by
  recomputing the K/V of its committed tokens (prompt + generated
  output) through the chunked-prefill path; because that recompute is
  deterministic, a resumed stream is greedy-token-identical to an
  uninterrupted run.

Deservingness is a total order (rid breaks every tie), which is what
rules out livelock: the most deserving unfinished request is never a
victim, always wins growth/admission contention, and therefore always
finishes — then the next one does, and so on.

``Request.deadline_s`` is a wall-clock budget measured from submit
time; the engine sweeps expired requests (waiting, running, preempted)
into CANCELLED at the top of every step.  The clock is injectable so
tests drive deadlines deterministically.

Chunked prefill does not change admission: a request reserves all the
blocks its (padded) prompt needs when admitted, and `prefill_pos`
tracks how much of the prompt has been written.  The scheduler itself
is sharding-agnostic — block tables and the free list are host-side
state, replicated under any mesh.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .kv_cache import BlockAllocator, SequenceAllocation, padded_prompt_len


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    PREEMPTED = "preempted"
    CANCELLED = "cancelled"


# (victim, freed slot, block ids to scrub).  The engine's callback
# zeroes the scrubbed blocks and resets the victim's decode-slot state;
# scheduler-only callers (property tests) may pass None.
PreemptCallback = Callable[["Request", int, List[int]], None]


@dataclasses.dataclass
class Request:
    """One generation request.

    arrival_step: engine step at which the request becomes visible to
    the scheduler (simulates staggered client arrivals; 0 = present
    from the start).  stop_token: optional early-termination token id.
    priority: larger = more deserving (admission order and preemption
    immunity under ``preemption="recompute"``; ignored under FCFS).
    deadline_s: optional wall-clock budget from submit time — once
    exceeded the request is cancelled wherever it is (waiting, running
    or preempted), keeping whatever output it already committed.
    """

    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    arrival_step: int = 0
    stop_token: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    submit_time: float = 0.0  # clock() at submit (engine fills this in)

    # lifecycle (managed by the scheduler/engine)
    state: RequestState = RequestState.WAITING
    output: List[int] = dataclasses.field(default_factory=list)
    alloc: Optional[SequenceAllocation] = None
    slot: int = -1
    admitted_step: int = -1
    finished_step: int = -1
    prefill_pos: int = 0  # prefill tokens already written to the KV pool
    # speculative-decoding length bookkeeping.  verified_len counts the
    # COMMITTED cache positions (what attention masks trust);
    # drafted_len is the high-water mark of positions ever written —
    # prefill padding and rejected draft tails push it past
    # verified_len, and that [verified_len, drafted_len) range is the
    # stale K/V scrubbed at retirement.  Invariant at every step:
    # verified_len <= drafted_len <= alloc.capacity().
    verified_len: int = 0
    drafted_len: int = 0
    # preemption bookkeeping.  resume_ctx freezes the token sequence a
    # resume must recompute (prompt + all committed output but the last
    # token, which is re-fed as the next decode input); it is None for
    # a never-preempted request.
    resume_ctx: Optional[List[int]] = None
    preempt_count: int = 0
    preempted_step: int = -1
    preempted_time: float = 0.0
    # prefix-cache bookkeeping.  cached_len counts the leading prefill
    # positions served from the content-addressed cache at the last
    # activation (prefill starts there instead of 0).  cow_src, when
    # set, names a SHARED cached block whose content the engine must
    # copy into this sequence's private tail block before prefill — the
    # copy-on-write case: a fully-cached block-aligned context still
    # recomputes its final token, and that write may not land in a
    # block other sequences reference.  The scheduler pins cow_src with
    # a reference until the engine copies (or the request is torn down).
    cached_len: int = 0
    cow_src: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def prefill_tokens(self) -> List[int]:
        """The tokens (re)prefill must write: the prompt, or — after a
        preemption — the frozen committed context."""
        return self.prompt if self.resume_ctx is None else self.resume_ctx

    @property
    def prefill_len(self) -> int:
        return len(self.prefill_tokens)

    @property
    def prefill_done(self) -> bool:
        """True once the whole prefill context is cached (the sequence
        may decode)."""
        return self.prefill_pos >= self.prefill_len

    @property
    def committed_len(self) -> int:
        """Committed tokens: prompt plus every generated token.  This
        is the per-request monotone quantity — preemption resets cache
        bookkeeping (verified_len/drafted_len) but NEVER this."""
        return self.prompt_len + len(self.output)

    def is_done(self) -> bool:
        if len(self.output) >= self.max_new_tokens:
            return True
        return (
            self.stop_token is not None
            and len(self.output) > 0
            and self.output[-1] == self.stop_token
        )


class Scheduler:
    """Admission over a fixed slot count and a shared block pool.

    FCFS with whole-lifetime reservation under ``preemption="off"``;
    deserving-ordered admission with on-demand growth and victim
    preemption under ``preemption="recompute"`` (see module docstring).

    spec_k > 0: under "off" it turns on worst-case burst reservation
    (every verify step may write k+1 positions beyond the committed
    length before acceptance is known); under "recompute" the same
    burst is satisfied by `grow` right before each verify step.
    """

    def __init__(
        self,
        allocator: BlockAllocator,
        max_slots: int,
        max_seq_len: int,
        spec_k: int = 0,
        preemption: str = "off",
        clock: Optional[Callable[[], float]] = None,
    ):
        if preemption not in ("off", "recompute"):
            raise ValueError(
                f"preemption={preemption!r}: expected 'off' or 'recompute'"
            )
        self.allocator = allocator
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.spec_k = spec_k
        self.preemption = preemption
        self.clock = clock if clock is not None else time.monotonic
        self.waiting: deque[Request] = deque()
        self.preempted: List[Request] = []
        self.running: Dict[int, Request] = {}  # slot -> request
        self._free_slots = list(range(max_slots - 1, -1, -1))

    # -- bookkeeping -------------------------------------------------------

    @property
    def num_waiting(self) -> int:
        """Queue depth: submitted, not yet admitted (metrics gauge)."""
        return len(self.waiting)

    @property
    def num_preempted(self) -> int:
        """Parked depth: evicted, awaiting recompute-resume."""
        return len(self.preempted)

    @property
    def num_running(self) -> int:
        """Admitted sequences currently holding a decode slot."""
        return len(self.running)

    def submit(self, req: Request) -> None:
        total = req.prompt_len + req.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new={total} exceeds "
                f"engine max_seq_len={self.max_seq_len}"
            )
        # feasibility is always judged against the WORST case, even in
        # recompute mode: a request must be able to run to completion
        # alone in an empty pool, or preemption could never unblock it
        need = self.blocks_needed(req)
        pool = self.allocator.num_blocks - 1  # block 0 is reserved
        if need > pool:
            # reject now: admit() could never satisfy it and the engine
            # loop would spin forever on a permanently-waiting head
            raise ValueError(
                f"request {req.rid}: needs {need} KV blocks but the pool "
                f"only has {pool}; raise num_blocks or shrink the request"
            )
        self.waiting.append(req)

    def blocks_needed(self, req: Request) -> int:
        """Whole-lifetime reservation: padded prompt blocks plus room
        for every decoded token's KV (the last sampled token is never
        written back, hence the -1).

        Burst math under spec_k: the deepest verify starts at committed
        length prompt + max_new - 2 (one more commit would finish the
        request) and writes k+1 positions, so the top written position
        is prompt + max_new - 2 + spec_k — reserve
        prompt + max_new - 1 + spec_k positions.  A max_new == 1
        request finishes at prefill and never verifies, so it carries
        no burst headroom.

        Note the three candidates are alternatives under ONE max, not a
        sum: the prompt's block padding and the decode/burst tail
        overlap (decode overwrites pad slots), so adding them would
        double-count the pad.  `test_admission_exact_fit_during_chunked_prefill`
        pins the exact-fit case, including while another request is
        mid-chunk-prefill (whose own in-flight chunk tail padding lives
        inside its already-owned blocks and must not be charged again).
        """
        bs = self.allocator.block_size
        prompt_pad = padded_prompt_len(req.prompt_len, bs)
        total_positions = max(prompt_pad, req.prompt_len + req.max_new_tokens - 1)
        if self.spec_k and req.max_new_tokens > 1:
            total_positions = max(
                total_positions,
                req.prompt_len + req.max_new_tokens - 1 + self.spec_k,
            )
        return self.allocator.blocks_for(total_positions)

    def blocks_initial(self, req: Request) -> int:
        """Blocks to allocate at admission time.  Whole lifetime under
        "off"; under "recompute" just the (block-padded) prefill
        context — decode capacity arrives later via `grow`."""
        if self.preemption == "off":
            return self.blocks_needed(req)
        bs = self.allocator.block_size
        return self.allocator.blocks_for(padded_prompt_len(req.prefill_len, bs))

    # -- deservingness / victim policy -------------------------------------

    @staticmethod
    def deserving(req: Request) -> Tuple[int, int, int]:
        """Total order on requests; larger = more deserving (kept when
        others are preempted).  Lowest priority loses first, then the
        latest arrival, then the highest rid — rid makes the order
        total, which is what guarantees global progress (the maximum is
        never preempted, so it always finishes)."""
        return (req.priority, -req.arrival_step, -req.rid)

    def _pick_victim(self, beneficiary: Request) -> Optional[Request]:
        """Least deserving running request strictly below the
        beneficiary, or None.  Strictness matters: preempting a peer or
        a better request to feed a worse one would thrash forever."""
        bkey = self.deserving(beneficiary)
        victims = [r for r in self.running.values() if self.deserving(r) < bkey]
        return min(victims, key=self.deserving, default=None)

    def _freeable_below(self, beneficiary: Request) -> int:
        """Blocks that would become allocatable (freed or parked on the
        evictable cache LRU) by preempting every running request
        strictly less deserving than ``beneficiary``.  Shared blocks
        (refcount > 1) are conservatively excluded: releasing one
        victim's reference leaves them referenced."""
        bkey = self.deserving(beneficiary)
        return sum(
            sum(1 for b in r.alloc.blocks if self.allocator.refcount(b) <= 1)
            for r in self.running.values()
            if self.deserving(r) < bkey
        )

    # -- per-step scheduling ----------------------------------------------

    def admit(
        self, step: int, on_preempt: Optional[PreemptCallback] = None
    ) -> List[Request]:
        """Admit pending requests while a slot and blocks are free.

        "off": strict FCFS over the waiting queue — stop at the first
        request that does not fit, so a small late request cannot
        starve a big earlier one.

        "recompute": one pass over waiting + preempted requests in
        deserving order.  A candidate that does not fit may preempt
        strictly-less-deserving running victims (checked feasible
        first, so no victim dies for a candidate that still would not
        fit); the pass stops after any admission that needed a
        preemption (evictions settle for one step before anyone less
        deserving is considered), or at the first candidate that cannot
        be satisfied at all — strictness again, so the head of the
        deserving order is never starved by smaller requests behind it.
        """
        if self.preemption == "off":
            return self._admit_fcfs(step)
        return self._admit_preemptive(step, on_preempt)

    def _admit_fcfs(self, step: int) -> List[Request]:
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            if req.arrival_step > step:
                break  # queue is arrival-ordered
            need = self.blocks_needed(req)
            if not self.allocator.can_allocate(need):
                break
            self.waiting.popleft()
            self._activate(req, need, step)
            admitted.append(req)
        return admitted

    def _admit_preemptive(
        self, step: int, on_preempt: Optional[PreemptCallback]
    ) -> List[Request]:
        admitted = []
        candidates = sorted(
            [r for r in self.preempted if r.arrival_step <= step]
            + [r for r in self.waiting if r.arrival_step <= step],
            key=self.deserving,
            reverse=True,
        )
        for req in candidates:
            need = self.blocks_initial(req)
            need_slot = not self._free_slots
            short = need - self.allocator.num_available
            if not need_slot and short <= 0:
                self._dequeue_pending(req)
                self._activate(req, need, step)
                admitted.append(req)
                continue
            # feasibility before any eviction: every strictly-less-
            # deserving victim freed must cover both the slot and the
            # block shortfall, or no victim dies for nothing
            victims_exist = self._pick_victim(req) is not None
            if (need_slot and not victims_exist) or (
                short > self._freeable_below(req)
            ):
                break  # strict: nobody behind this candidate goes first
            preempted_any = False
            while (not self._free_slots) or not self.allocator.can_allocate(need):
                victim = self._pick_victim(req)
                assert victim is not None, "feasibility check lied"
                self.preempt(victim, step, on_preempt)
                preempted_any = True
            self._dequeue_pending(req)
            self._activate(req, need, step)
            admitted.append(req)
            if preempted_any:
                break  # let evictions settle before admitting anyone else
        return admitted

    def _dequeue_pending(self, req: Request) -> None:
        if req.state is RequestState.PREEMPTED:
            self.preempted.remove(req)
        else:
            self.waiting.remove(req)

    def _activate(self, req: Request, need: int, step: int) -> None:
        """Give ``req`` a slot and ``need`` blocks.  With prefix
        caching on, the leading full blocks of the prefill context are
        served from the content-addressed cache instead of allocated:
        every hit is acquired (refcount++), ``cached_len``/
        ``prefill_pos`` start at the cached boundary, and only the miss
        suffix is allocated fresh.  At least one token is always left
        for the engine to recompute (the first sampled token needs the
        final position's logits); when that cap lands mid-block — a
        fully cached, block-aligned context — the tail hit becomes a
        pinned copy-on-write source and a private block takes its place
        in the table."""
        al = self.allocator
        bs = al.block_size
        toks = req.prefill_tokens
        hits = al.match_prefix(toks)
        cached_len = min(len(hits) * bs, len(toks) - 1)
        n_keep = cached_len // bs
        blocks = list(hits[:n_keep])
        al.acquire(blocks)
        cow_src: Optional[int] = None
        if cached_len > n_keep * bs:
            cand = hits[n_keep]
            # pinning an IDLE hit takes it off the evictable LRU — one
            # block of allocatable capacity the admission check did not
            # charge.  Pin only if the remaining allocation still fits;
            # otherwise forgo the partial-block hit (correctness never
            # depends on COW, it only saves recompute).
            pin_cost = 1 if al.refcount(cand) == 0 else 0
            if al.num_available - pin_cost >= need - n_keep:
                cow_src = cand
                al.acquire([cow_src])  # pinned: eviction may not scrub it
            else:
                cached_len = n_keep * bs
        blocks.extend(al.allocate(need - n_keep))
        if al.prefix_cache:
            n_hit = n_keep + (1 if cow_src is not None else 0)
            al.hits += n_hit
            al.misses += al.blocks_for(len(toks)) - n_hit
            al.tokens_saved += cached_len
            if cow_src is not None:
                al.cow_copies += 1
        req.alloc = SequenceAllocation(blocks, bs)
        req.cached_len = cached_len
        req.cow_src = cow_src
        req.prefill_pos = cached_len
        req.verified_len = cached_len
        req.drafted_len = cached_len
        req.slot = self._free_slots.pop()
        req.state = RequestState.RUNNING
        req.admitted_step = step
        self.running[req.slot] = req

    def _drop_cow_pin(self, req: Request) -> None:
        """Release the copy-on-write source pin if the engine never got
        to copy it (teardown between activation and first prefill)."""
        if req.cow_src is not None:
            self.allocator.release([req.cow_src])
            req.cow_src = None

    def _release_blocks(self, req: Request, start: int, stop: int) -> List[int]:
        """Release every block ``req`` owns and return the subset that
        (a) reached the free list AND (b) holds the dirty position
        range [start, stop) the caller wants scrubbed.  Blocks that
        stay referenced (shared) or parked as idle cache hold valid
        content and are NEVER scrubbed."""
        dirty = req.alloc.blocks_covering(start, stop)
        freed = set(self.allocator.release(req.alloc.blocks))
        self._drop_cow_pin(req)
        return [b for b in dirty if b in freed]

    # -- on-demand growth (recompute mode) ---------------------------------

    def grow(
        self,
        req: Request,
        min_positions: int,
        on_preempt: Optional[PreemptCallback] = None,
        step: int = -1,
    ) -> bool:
        """Ensure ``req`` owns capacity for ``min_positions`` cache
        positions, allocating blocks on demand and preempting strictly
        less deserving victims under pool pressure.  Returns False when
        ``req`` itself had to be preempted instead (insufficient free +
        freeable blocks) — the caller must drop it from this step's
        batch.  Only meaningful under ``preemption="recompute"``."""
        assert self.preemption == "recompute", "grow() needs preemption on"
        assert req.state is RequestState.RUNNING
        need = self.allocator.blocks_for(min_positions) - len(req.alloc.blocks)
        if need <= 0:
            return True
        if need > self.allocator.num_available + self._freeable_below(req):
            # even evicting everyone less deserving would not cover it:
            # park THIS request until more deserving work retires.  The
            # globally most deserving request can never land here (all
            # other owners are below it and its total demand fits the
            # pool by the submit-time guard), so progress is preserved.
            self.preempt(req, step, on_preempt)
            return False
        while not self.allocator.can_allocate(need):
            victim = self._pick_victim(req)
            assert victim is not None, "feasibility check lied"
            self.preempt(victim, step, on_preempt)
        req.alloc.grow(self.allocator.allocate(need))
        return True

    # -- state transitions -------------------------------------------------

    def preempt(
        self,
        req: Request,
        step: int,
        on_preempt: Optional[PreemptCallback] = None,
    ) -> List[int]:
        """Evict a RUNNING request: release every block it owns and
        park it for a later recompute-resume.  Returns the written
        block ids ([0, drafted_len)) that actually reached the free
        list, which the engine's callback must scrub before the
        allocator reuses them.  Without prefix caching that is every
        written block (a preempted sequence's committed K/V is dead:
        the resume recomputes it).  With it, registered blocks instead
        stay valid cache — shared ones keep their other references and
        the victim's own published prefix parks on the LRU, where the
        resume can hit it again; they are scrubbed only if evicted.

        Speculative state needs no special rollback here: `output`
        only ever holds committed tokens (verify commits before the
        step ends), so freezing ``resume_ctx`` from prompt + output IS
        the roll-back to the verified stream; the drafted-but-rejected
        tail dies with the scrub.
        """
        assert req.state is RequestState.RUNNING
        assert self.preemption == "recompute", "preemption is off"
        scrub = self._release_blocks(req, 0, req.drafted_len)
        slot = req.slot
        req.alloc = None
        del self.running[slot]
        self._free_slots.append(slot)
        req.slot = -1
        req.state = RequestState.PREEMPTED
        req.resume_ctx = list(req.prompt) + req.output[:-1]
        req.prefill_pos = 0
        req.verified_len = 0
        req.drafted_len = 0
        req.cached_len = 0
        req.preempt_count += 1
        req.preempted_step = step
        req.preempted_time = self.clock()
        self.preempted.append(req)
        if on_preempt is not None:
            on_preempt(req, slot, scrub)
        return scrub

    def cancel(self, req: Request, step: int) -> List[int]:
        """Cancel a request wherever it lives (deadline expiry or
        client abort), keeping its committed output.  Returns the block
        ids the engine must scrub (non-empty only for RUNNING victims:
        the never-committed [verified_len, drafted_len) range, same as
        retirement)."""
        stale: List[int] = []
        if req.state is RequestState.WAITING:
            self.waiting.remove(req)
        elif req.state is RequestState.PREEMPTED:
            self.preempted.remove(req)
        elif req.state is RequestState.RUNNING:
            stale = self._release_blocks(req, req.verified_len, req.drafted_len)
            req.alloc = None
            del self.running[req.slot]
            self._free_slots.append(req.slot)
            req.slot = -1
        else:  # FINISHED / CANCELLED: nothing to undo
            return stale
        req.state = RequestState.CANCELLED
        req.finished_step = step
        return stale

    def rollback(self, req: Request, committed_len: int) -> None:
        """Roll a sequence's logical length back after a verify step.

        The verify wrote K/V up to req.drafted_len; only
        ``committed_len`` positions were accepted.  The rejected tail's
        blocks stay owned — the next verify re-writes from
        committed_len, so within the sequence stale entries are always
        overwritten before the committed length reaches them — but the
        truncation must be recorded so retirement knows what to scrub.
        """
        assert req.state is RequestState.RUNNING
        assert req.verified_len <= committed_len <= req.drafted_len, (
            req.verified_len,
            committed_len,
            req.drafted_len,
        )
        assert req.drafted_len <= req.alloc.capacity(), (
            req.drafted_len,
            req.alloc.capacity(),
        )
        req.verified_len = committed_len

    def retire(self, req: Request, step: int) -> List[int]:
        """Retire a finished request, returning its blocks to the free
        list.  Returns the block ids still holding stale
        (written-but-never-committed) K/V — draft tails rolled back by
        `rollback`, prefill padding — which the engine must scrub
        before the allocator hands them to another sequence."""
        assert req.state is RequestState.RUNNING
        req.state = RequestState.FINISHED
        req.finished_step = step
        stale = self._release_blocks(req, req.verified_len, req.drafted_len)
        req.alloc = None
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        return stale

    def expired(self, now: float) -> List[Request]:
        """Every live request whose deadline has passed (waiting,
        running or preempted) — the engine cancels these at the top of
        each step."""
        live = list(self.waiting) + self.preempted + list(self.running.values())
        return [
            r
            for r in live
            if r.deadline_s is not None and now - r.submit_time > r.deadline_s
        ]

    def has_work(self) -> bool:
        return bool(self.running) or bool(self.waiting) or bool(self.preempted)
