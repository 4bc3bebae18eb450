"""Continuous-batching serving engine over a paged KV cache.

Port of ``repro/serving/engine.py::ContinuousBatchingEngine``:
admission, whole-prompt and chunked prefill (``prefill_chunk``),
batched decode, speculative decoding (``spec_k``: a drafter from
``serving/spec.py`` proposes k tokens a slot and one batched verify
scores all k + 1), recompute preemption under pool pressure
(``preemption="recompute"``: a victim's blocks are scrubbed and it
resumes by recomputing its committed context through the chunk path),
the content-addressed prefix cache (``prefix_cache``: leading cached
blocks are shared, the miss suffix prefilled through the chunk path, a
shared tail block copied on write), retirement, deadline expiry and
cancellation, and one batched scrub of freed blocks per flush.  The
engine is observable as the reference's is: a typed per-request trace
(``self.trace``, on unless ``trace=False``), a metrics registry wired
with live sources (``self.metrics``), ``stream()``, and, with
``profile=True``, a ``torch.profiler.record_function`` span around
each phase's launches (``serving/observability.py``).  Tensor
parallelism and the static engine are later slices (``ROADMAP.md``,
queue 1).

Unlike the reference, whose arrays are immutable, the port updates its
device state in place: prefill, chunk, verify and decode write K/V into
the pools with ``index_put_``, a scrub zeroes freed blocks with
``index_fill_``, and a copy-on-write copies one block with ``copy_``.
Host-side state (block tables, lengths, last tokens, the scheduler and
the allocator) is numpy and Python, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ModelAPI, build
from repro_torch.models.transformer import torch_dtype

from .kv_cache import SCRATCH_BLOCK, BlockAllocator, padded_prompt_len
from .observability import (
    MetricsRegistry,
    TraceRecorder,
    macs_per_token_by_mode,
    phase_annotation,
)
from .scheduler import Request, RequestState, Scheduler
from .spec import make_drafter


@dataclasses.dataclass
class ServeStats:
    """Padding/utilization/latency accounting (the reference's fields).

    A façade over the engine's metrics registry: once the engine binds
    it (``_registry``), the latency quantiles are computed through the
    registry's ``serve_step_latency_seconds`` histogram, whose live
    source is this object's own ``step_latency_s``.  An unbound
    instance computes them from the list.
    """

    steps: int = 0
    prefills: int = 0  # prefill calls: whole prompts and chunks
    prefill_tokens: int = 0  # real prompt tokens
    prefill_padding: int = 0  # bucket/chunk padding on top of them
    decode_steps: int = 0  # batched decode and verify steps
    active_slot_steps: int = 0  # slot-steps doing useful decode work
    idle_slot_steps: int = 0  # slot-steps wasted (empty slot, step ran)
    generated_tokens: int = 0
    # speculative decoding: per-verify-step draft/accept accounting
    spec_steps: int = 0  # batched verify steps run
    drafted_tokens: int = 0  # k drafts per active slot per verify step
    accepted_tokens: int = 0  # drafts the target model agreed with
    spec_committed_tokens: int = 0  # tokens committed via verify steps
    step_latency_s: List[float] = dataclasses.field(default_factory=list)
    # preemption / deadline accounting (preemption="recompute")
    preemptions: int = 0  # running sequences evicted under pool pressure
    resumes: int = 0  # preempted sequences re-admitted (recompute-resume)
    deadline_cancelled: int = 0  # requests cancelled at deadline expiry
    resume_latency_s: List[float] = dataclasses.field(default_factory=list)
    resume_latency_steps: List[int] = dataclasses.field(default_factory=list)
    # host seconds in prefill (whole prompts and chunks) and in batched
    # decode or verify; each call ends by copying logits to the host, so
    # these include the device's work
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # observability binding (engine-managed)
    _registry: Optional[MetricsRegistry] = dataclasses.field(
        default=None, repr=False, compare=False)

    def padding_waste(self) -> float:
        """Fraction of engine capacity spent on padding/idle slots."""
        spent = (self.prefill_tokens + self.prefill_padding
                 + self.active_slot_steps + self.idle_slot_steps)
        wasted = self.prefill_padding + self.idle_slot_steps
        return wasted / spent if spent else 0.0

    def record_step(self, seconds: float) -> None:
        self.step_latency_s.append(seconds)

    def latency_quantile(self, q: float) -> float:
        if self._registry is not None:
            return self._registry.histogram("serve_step_latency_seconds").quantile(q)
        if not self.step_latency_s:
            return 0.0
        return float(np.quantile(np.asarray(self.step_latency_s), q))

    def latency_p50(self) -> float:
        return self.latency_quantile(0.50)

    def latency_p95(self) -> float:
        return self.latency_quantile(0.95)

    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target model accepted."""
        if not self.drafted_tokens:
            return 0.0
        return self.accepted_tokens / self.drafted_tokens

    def resume_latency_mean_s(self) -> float:
        """Mean wall seconds a preempted request spent parked before its
        recompute-resume was admitted."""
        if not self.resume_latency_s:
            return 0.0
        return float(np.mean(np.asarray(self.resume_latency_s)))

    def tokens_per_verify_step(self) -> float:
        """Mean committed tokens per verify step per active slot (1.0: no
        speedup over one-token decode; k + 1: every draft accepted)."""
        return (self.spec_committed_tokens / self.active_slot_steps
                if self.spec_steps and self.active_slot_steps else 0.0)


@dataclasses.dataclass
class PagedServeConfig:
    """Static capacity of a continuous-batching engine instance.

    block_size: cache positions per KV block.
    num_blocks: pool size (block 0 is reserved scratch).
    max_slots: max sequences decoded per step (the batch width).
    max_seq_len: per-sequence prompt + generated cap; fixes the block
        table width to ceil(max_seq_len / block_size).
    use_kernel: None runs the CUDA kernels on the card and their plain
        versions on the CPU; False runs the plain versions on any
        device (the reference the tests and the chip smoke compare with).
    prequantize: encode policy-selected weights to posit patterns once at
        construction (``core.prequant.quantize_params``); ``plam_sim``
        sites then serve through ``kernels.ops.plam_dense`` with int16
        weight storage.
    prefill_chunk: 0 = whole-prompt prefill (one bucket-padded call per
        request); > 0 = prompts are written ``prefill_chunk`` tokens per
        engine step, interleaved with decode.  A multiple of block_size.
    spec_k: 0 = off; k > 0 drafts k tokens per active slot per step and
        verifies all k + 1 positions in one batched call (greedy only:
        acceptance is exact argmax agreement, so the committed stream is
        the one spec_k = 0 gives).
    spec_draft: "ngram" / "ngram:N", or a drafter instance
        (``serving/spec.py``); "model:<arch>" is not ported yet.
    preemption: "off" reserves whole-lifetime blocks at admission;
        "recompute" allocates the prefill context, grows on demand and,
        under pool pressure, preempts the least deserving request, which
        later resumes by recomputing its committed context.
    prefix_cache: content-addressed sharing of full prompt blocks
        (``kv_cache.BlockAllocator``); hits skip prefill, the miss suffix
        goes through the chunk path.
    trace: record one typed ``TraceEvent`` per request lifecycle
        transition (host-side appends), the source of the per-request
        latency breakdown and of the JSON-lines / Chrome trace exports.
    profile: wrap each engine phase's launches in a
        ``torch.profiler.record_function`` span (meaningful only inside
        a ``torch.profiler`` capture).
    """

    block_size: int = 16
    num_blocks: int = 128
    max_slots: int = 4
    max_seq_len: int = 256
    temperature: float = 0.0
    seed: int = 0
    cache_dtype: str = "bfloat16"
    use_kernel: Optional[bool] = None
    prequantize: bool = False
    prefill_chunk: int = 0
    spec_k: int = 0
    spec_draft: object = "ngram"
    preemption: str = "off"
    prefix_cache: bool = False
    clock: Optional[object] = None  # monotonic seconds; None = time.monotonic
    trace: bool = True
    profile: bool = False


class ContinuousBatchingEngine:
    """Admission-controlled serving over a paged KV cache.

    Each ``step()``:
      1. cancels requests whose deadline passed;
      2. admits waiting (and, under recompute preemption, parked)
         requests while a slot and blocks are free, prefilling each
         whole prompt at admission, or queueing it for chunked prefill
         when ``prefill_chunk`` is set;
      3. feeds at most ONE prompt chunk (head of line) when chunking;
      4. under recompute preemption, grows every decoding sequence by
         the positions this step writes, preempting under pressure;
      5. runs ONE batched decode step over all prefilled slots, or under
         ``spec_k`` ONE batched (k + 1)-position verify step that commits
         each slot's accepted drafts plus the target's own token and
         rolls the rejected tail back;
      6. retires finished sequences; freed blocks holding K/V that must
         not outlive them are zeroed in one batched, in-place scrub
         before the next compute.

    Runs on ``device`` (CUDA unless the caller passes another).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Optional[torch.nn.Module] = None,
        init_seed: int = 0,
        pcfg: PagedServeConfig = PagedServeConfig(),
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.pcfg = pcfg
        if cfg.attn_logit_softcap is not None:
            raise ValueError("paged decode does not support logit softcap")
        if pcfg.prefill_chunk and pcfg.prefill_chunk % pcfg.block_size:
            raise ValueError(
                f"prefill_chunk={pcfg.prefill_chunk} must be a multiple of "
                f"block_size={pcfg.block_size}")
        self.drafter = None
        if pcfg.spec_k:
            if pcfg.temperature > 0:
                raise ValueError(
                    "speculative decoding requires greedy sampling "
                    "(temperature=0): acceptance is exact argmax agreement")
            self.drafter = (make_drafter(pcfg.spec_draft, cfg)
                            if isinstance(pcfg.spec_draft, str) else pcfg.spec_draft)
        self.device = resolve_device(device)
        self.api: ModelAPI = build(cfg)
        if params is None:
            self.model = self.api.init(seed=init_seed, device=self.device)
        else:
            self.model = params.to(self.device)
        self.prequant_meta = {}
        if pcfg.prequantize:
            from repro_torch.core.prequant import quantize_params

            self.model, self.prequant_meta = quantize_params(
                cfg, self.model, use_kernel=pcfg.use_kernel)

        bs, nb = pcfg.block_size, pcfg.num_blocks
        # wide enough for the worst-case speculative burst: a verify step
        # writes spec_k positions past the committed tail before
        # acceptance is known, into the sequence's own reserved blocks
        self.max_blocks_per_seq = -(-(pcfg.max_seq_len + pcfg.spec_k) // bs)
        self._k_pool, self._v_pool = self.api.paged_pool_init(
            nb, bs, torch_dtype(pcfg.cache_dtype), self.device)
        self.allocator = BlockAllocator(nb, bs, prefix_cache=pcfg.prefix_cache)
        self._clock = pcfg.clock if pcfg.clock is not None else time.monotonic
        self.scheduler = Scheduler(
            self.allocator, pcfg.max_slots, pcfg.max_seq_len, spec_k=pcfg.spec_k,
            preemption=pcfg.preemption, clock=self._clock)
        # blocks freed but not yet zeroed: scrubs coalesce into one
        # in-place index_fill_ per pool per flush
        self._scrub_pending: List[int] = []

        m = pcfg.max_slots
        self._tables = np.full((m, self.max_blocks_per_seq), SCRATCH_BLOCK, np.int32)
        self._lengths = np.zeros((m,), np.int32)
        self._last_tok = np.zeros((m,), np.int32)
        self._prefilling: Deque[Request] = deque()
        self._step_no = 0
        self._next_rid = 0
        self.stats = ServeStats()
        # observability: the trace recorder (event timestamps from the
        # engine's clock), the registry wired with live sources, and the
        # opt-in profiler spans
        self._profile = pcfg.profile
        self.trace: Optional[TraceRecorder] = (
            TraceRecorder(clock=self._clock,
                          occupancy=lambda: (self.allocator.num_free,
                                             self.allocator.num_used))
            if pcfg.trace else None)
        self.metrics = MetricsRegistry()
        self._wire_metrics()
        self.stats._registry = self.metrics

    @property
    def current_step(self) -> int:
        """Engine step counter (arrival_step values are absolute)."""
        return self._step_no

    def _wire_metrics(self) -> None:
        """Register every serving metric with a live source over engine
        state: collection reads current values on demand, so the hot path
        pays nothing and an ``eng.stats = ServeStats()`` reset shows at
        once.  The per-numerics-mode MAC counters resolve each matmul site
        through ``repro_torch.core.policy``."""
        m = self.metrics
        counters = {
            "serve_steps_total": ("engine steps run", lambda: self.stats.steps),
            "serve_prefills_total": ("prefill calls (whole-prompt or chunk)",
                                     lambda: self.stats.prefills),
            "serve_prefill_tokens_total": ("real prompt tokens written",
                                           lambda: self.stats.prefill_tokens),
            "serve_prefill_padding_total": ("bucket/chunk padding tokens",
                                            lambda: self.stats.prefill_padding),
            "serve_decode_steps_total": ("batched decode/verify steps",
                                         lambda: self.stats.decode_steps),
            "serve_generated_tokens_total": ("committed output tokens",
                                             lambda: self.stats.generated_tokens),
            "serve_drafted_tokens_total": ("speculative tokens drafted",
                                           lambda: self.stats.drafted_tokens),
            "serve_accepted_tokens_total": ("speculative tokens accepted",
                                            lambda: self.stats.accepted_tokens),
            "serve_preemptions_total": ("running sequences evicted",
                                        lambda: self.stats.preemptions),
            "serve_resumes_total": ("recompute-resume re-admissions",
                                    lambda: self.stats.resumes),
            "serve_deadline_cancelled_total": ("requests cancelled at deadline",
                                               lambda: self.stats.deadline_cancelled),
            "serve_prefix_cache_hits_total": ("prefix-cache block hits at admission",
                                              lambda: self.allocator.hits),
            "serve_prefix_cache_misses_total": ("prefix-cache block misses at admission",
                                                lambda: self.allocator.misses),
            "serve_prefix_cache_evictions_total": (
                "idle cached blocks reclaimed under pool pressure",
                lambda: self.allocator.evictions),
            "serve_prefill_tokens_saved_total": (
                "prompt tokens skipped via prefix-cache hits",
                lambda: self.allocator.tokens_saved),
            "serve_prefix_cache_cow_total": ("copy-on-write block duplications",
                                             lambda: self.allocator.cow_copies),
        }
        for name, (help_, src) in counters.items():
            m.counter(name, help_).set_source(src)
        gauges = {
            "serve_pool_blocks_free": ("KV pool blocks on the free list",
                                       lambda: self.allocator.num_free),
            "serve_pool_blocks_used": ("KV pool blocks owned by live sequences",
                                       lambda: self.allocator.num_used),
            "serve_pool_utilization": ("fraction of allocatable KV pool in use",
                                       self.allocator.utilization),
            "serve_prefix_cached_blocks": (
                "pool blocks holding registered prefix-cache content",
                lambda: self.allocator.num_cached),
            "serve_waiting_requests": ("submitted, not yet admitted",
                                       lambda: self.scheduler.num_waiting),
            "serve_preempted_requests": ("parked awaiting recompute-resume",
                                         lambda: self.scheduler.num_preempted),
            "serve_running_requests": ("admitted sequences holding a slot",
                                       lambda: self.scheduler.num_running),
            "serve_padding_waste": ("capacity fraction lost to padding/idle slots",
                                    lambda: self.stats.padding_waste()),
            "serve_spec_acceptance_rate": ("fraction of drafts the target accepted",
                                           lambda: self.stats.acceptance_rate()),
            "serve_tokens_per_verify_step": ("committed tokens per verify step per slot",
                                             lambda: self.stats.tokens_per_verify_step()),
            "serve_tok_per_s": (
                "generated tokens over summed step wall time",
                lambda: (self.stats.generated_tokens / t
                         if (t := sum(self.stats.step_latency_s)) else 0.0)),
        }
        for name, (help_, src) in gauges.items():
            m.gauge(name, help_).set_source(src)
        m.histogram("serve_step_latency_seconds",
                    "wall seconds per engine step").set_source(
                        lambda: self.stats.step_latency_s)
        try:
            by_mode = macs_per_token_by_mode(self.cfg)
        except Exception:  # exotic family/policy: MAC attribution is best-effort
            by_mode = {}
        for mode, macs in sorted(by_mode.items()):
            m.counter("serve_macs_total", "forward-pass MACs by resolved numerics mode",
                      mode=mode).set_source(
                lambda macs=macs: macs * (self.stats.prefill_tokens
                                          + self.stats.generated_tokens))
        if self.drafter is not None:
            m.counter("serve_draft_proposals_total", "drafter propose() calls").set_source(
                lambda: getattr(self.drafter, "proposals", 0))
            m.counter("serve_draft_proposed_tokens_total",
                      "tokens proposed by drafter").set_source(
                lambda: getattr(self.drafter, "proposed_tokens", 0))

    def _emit(self, etype: str, rid: int, **payload) -> None:
        """Trace hook: record one typed event (no-op when tracing is off)."""
        if self.trace is not None:
            self.trace.emit(etype, rid, self._step_no, **payload)

    # -- request intake ----------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int = 16,
        arrival_step: int = 0,
        stop_token: Optional[int] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
    ) -> "SubmitHandle":
        """Queue a request; returns a :class:`~repro_torch.serving.api.
        SubmitHandle` (``.result()`` / ``.cancel()``, every ``Request``
        attribute delegated).  Requests must be submitted in
        non-decreasing arrival_step order.  ``priority`` orders admission
        and preemption immunity under ``preemption="recompute"`` (larger
        wins; FCFS ignores it)."""
        from .api import SubmitHandle  # local: api imports this module

        req = Request(
            rid=self._next_rid,
            prompt=[int(t) for t in prompt],
            max_new_tokens=max_new_tokens,
            arrival_step=arrival_step,
            stop_token=stop_token,
            priority=priority,
            deadline_s=deadline_s,
            submit_time=self._clock(),
        )
        self._next_rid += 1
        self.scheduler.submit(req)
        self._emit("SUBMIT", req.rid, prompt_len=req.prompt_len,
                   max_new=req.max_new_tokens, priority=req.priority,
                   arrival_step=req.arrival_step)
        return SubmitHandle(self, req)

    def cancel(self, req) -> None:
        """Client-side abort of ``req`` (a ``Request`` or ``SubmitHandle``)
        wherever it is, keeping its committed output."""
        req = getattr(req, "request", req)
        if req.state in (RequestState.FINISHED, RequestState.CANCELLED):
            return
        self._cancel(req, self._step_no)
        self._emit("CANCEL", req.rid, reason="client", out_len=len(req.output))

    # -- engine loop -------------------------------------------------------

    def step(self) -> List[Request]:
        """One engine iteration; returns requests finished this step."""
        t0 = time.perf_counter()
        step = self._step_no
        finished: List[Request] = []

        for req in self.scheduler.expired(self._clock()):
            self._cancel(req, step)
            self.stats.deadline_cancelled += 1
            self._emit("DEADLINE", req.rid, deadline_s=req.deadline_s,
                       out_len=len(req.output))
            finished.append(req)

        for req in self.scheduler.admit(step, on_preempt=self._on_preempt):
            if req.preempted_step >= 0:  # recompute-resume re-admission
                self.stats.resumes += 1
                self.stats.resume_latency_steps.append(step - req.preempted_step)
                self.stats.resume_latency_s.append(self._clock() - req.preempted_time)
                self._emit("RESUME", req.rid, slot=req.slot, blocks=len(req.alloc.blocks),
                           parked_steps=step - req.preempted_step,
                           cached_len=req.cached_len)
                req.preempted_step = -1
            else:
                self._emit("ADMIT", req.rid, slot=req.slot, blocks=len(req.alloc.blocks),
                           cached_len=req.cached_len)
            if self.pcfg.prefill_chunk:
                # blocks and slot reserved; the prompt is fed chunkwise
                self._prefilling.append(req)
            else:
                self._do_prefill(req)
                if req.is_done():  # max_new_tokens == 1: done at prefill
                    self._release(req, step)
                    finished.append(req)

        if self._prefilling:
            req = self._prefilling[0]
            if self._do_prefill_chunk(req):
                self._prefilling.popleft()
                if req.is_done():
                    self._release(req, step)
                    finished.append(req)

        if self.pcfg.preemption == "recompute":
            self._grow_active(step)

        if any(r.prefill_done for r in self.scheduler.running.values()):
            if self.pcfg.spec_k:
                finished.extend(self._do_verify(step))
            else:
                finished.extend(self._do_decode(step))

        # freed blocks never stay dirty across a step boundary
        self._flush_scrubs()
        self.stats.steps += 1
        self._step_no += 1
        self.stats.record_step(time.perf_counter() - t0)
        # the registry's sources read self.stats live, so a swapped-in
        # ServeStats() is already reflected; only the façade's
        # back-pointer needs refreshing
        if self.stats._registry is not self.metrics:
            self.stats._registry = self.metrics
        self.metrics.tick(self._step_no)
        return finished

    def run(self) -> Dict[int, List[int]]:
        """Drive step() until every submitted request has finished.
        Returns {rid: generated tokens}."""
        done: Dict[int, List[int]] = {}
        while self.scheduler.has_work():
            for req in self.step():
                done[req.rid] = req.output
        return done

    def stream(self, prompt: List[int], **submit_kw) -> Iterator[dict]:
        """Submit one prompt and drive the engine, yielding progress as
        dicts: ``{"tokens": [...]}`` for tokens committed since the last
        yield, interleaved (in emission order) with ``{"event":
        TraceEvent}`` for this request's trace events when tracing is on.
        Other queued requests keep making progress.  Ends after the
        request's terminal event (FINISH / CANCEL / DEADLINE)."""
        handle = self.submit(prompt, **submit_kw)
        req = handle.request
        n_tok = 0
        n_evt = 0
        if self.trace is not None:
            for ev in self.trace.request_events(req.rid)[n_evt:]:
                n_evt += 1
                yield {"event": ev}
        while req.state not in (RequestState.FINISHED, RequestState.CANCELLED):
            self.step()
            if self.trace is not None:
                for ev in self.trace.request_events(req.rid)[n_evt:]:
                    n_evt += 1
                    yield {"event": ev}
            if len(req.output) > n_tok:
                new = req.output[n_tok:]
                n_tok = len(req.output)
                yield {"tokens": new}

    # -- internals ---------------------------------------------------------

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)

    def _do_prefill(self, req: Request) -> None:
        """Whole-prompt prefill into the request's blocks, then sample.  A
        recompute-resume (the frozen committed context) and a prefix-cache
        hit (``prefill_pos > 0``, set by admission) go through the chunk
        path instead, as one padded chunk."""
        if req.resume_ctx is not None or req.prefill_pos > 0:
            self._resume_via_chunk(req)
            return
        self._flush_scrubs()
        t0 = time.perf_counter()
        bs = self.pcfg.block_size
        plen = req.prefill_len
        s_pad = padded_prompt_len(plen, bs)
        toks = np.zeros((1, s_pad), np.int32)
        toks[0, :plen] = req.prefill_tokens
        block_ids = self._tensor(np.asarray(req.alloc.blocks[: s_pad // bs], np.int32))
        with phase_annotation("serve.prefill", self._profile):
            logits, _ = self.api.paged_prefill(
                self.model, self._tensor(toks), self._k_pool, self._v_pool, block_ids,
                plen, use_kernel=self.pcfg.use_kernel)
        req.prefill_pos = plen
        req.verified_len = plen
        req.drafted_len = s_pad  # pad positions hold junk K/V until overwritten
        self._finish_prefill(req, logits[0, -1].float().cpu().numpy())
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefills += 1
        self.stats.prefill_tokens += plen
        self.stats.prefill_padding += s_pad - plen
        self._emit("PREFILL_CHUNK", req.rid, start=0, tokens=plen, width=s_pad, done=True,
                   out_len=len(req.output))

    def _prefill_span(self, req: Request, start: int, real: int, width: int) -> np.ndarray:
        """Write ``real`` prefill tokens from ``start`` (padded to ``width``)
        through the chunk path; returns the last real token's logits."""
        toks = np.zeros((1, width), np.int32)
        toks[0, :real] = req.prefill_tokens[start:start + real]
        table_row = self._tensor(
            np.asarray(req.alloc.table_row(self.max_blocks_per_seq), np.int32))
        with phase_annotation("serve.prefill", self._profile):
            logits, _ = self.api.paged_prefill_chunk(
                self.model, self._tensor(toks), self._k_pool, self._v_pool, table_row,
                start, real - 1, use_kernel=self.pcfg.use_kernel)
        req.prefill_pos = start + real
        req.verified_len = start + real
        # padding past capacity lands on the scratch block through the
        # padded table row: only in-capacity positions can be dirty
        req.drafted_len = max(req.drafted_len, min(start + width, req.alloc.capacity()))
        self.stats.prefills += 1
        self.stats.prefill_tokens += real
        self.stats.prefill_padding += width - real
        return logits[0, -1].float().cpu().numpy()

    def _resume_via_chunk(self, req: Request) -> None:
        """Recompute-resume or prefix-cache hit: write the K/V of the
        context from ``prefill_pos`` (0 on a resume, the cached boundary on
        a hit) in ONE padded chunk-path call, attending over the blocks
        before it."""
        if req.cow_src is not None:
            self._apply_cow(req)
        self._flush_scrubs()
        t0 = time.perf_counter()
        start = req.prefill_pos
        remaining = req.prefill_len - start
        width = padded_prompt_len(remaining, self.pcfg.block_size)
        last = self._prefill_span(req, start, remaining, width)
        self._finish_prefill(req, last)
        self.stats.prefill_s += time.perf_counter() - t0
        self._emit("PREFILL_CHUNK", req.rid, start=start, tokens=remaining, width=width,
                   done=True, out_len=len(req.output))

    def _do_prefill_chunk(self, req: Request) -> bool:
        """Write ONE chunk of ``req``'s prefill context into its blocks.
        Returns True once the context is fully cached; the slot is then
        activated for decode.  The chunk width is ``prefill_chunk``; the
        ragged final chunk is padded to a block multiple."""
        if req.cow_src is not None:
            self._apply_cow(req)
        self._flush_scrubs()
        t0 = time.perf_counter()
        bs, chunk = self.pcfg.block_size, self.pcfg.prefill_chunk
        start = req.prefill_pos
        remaining = req.prefill_len - start
        width = chunk if remaining > chunk else padded_prompt_len(remaining, bs)
        real = min(remaining, chunk)
        last = self._prefill_span(req, start, real, width)
        done = req.prefill_done
        if done:
            self._finish_prefill(req, last)
        self.stats.prefill_s += time.perf_counter() - t0
        self._emit("PREFILL_CHUNK", req.rid, start=start, tokens=real, width=width, done=done,
                   out_len=len(req.output))
        return done

    def _finish_prefill(self, req: Request, last_logits: np.ndarray) -> None:
        """Activate a fully prefilled slot.  A fresh request samples its
        first token from the prefill logits; a resumed one already
        committed that token, which is re-fed as the next decode input
        (sampling again would emit it twice)."""
        if req.output:
            tok = req.output[-1]
        else:
            tok = self._pick_one(last_logits, req, len(req.output))
            req.output.append(tok)
            self.stats.generated_tokens += 1
        slot = req.slot
        self._tables[slot] = req.alloc.table_row(self.max_blocks_per_seq)
        self._lengths[slot] = req.prefill_len
        self._last_tok[slot] = tok
        if self.allocator.prefix_cache:
            # publish only now that the K/V is in the pool
            self.allocator.register(req.prefill_tokens, req.alloc.blocks)

    def _active(self):
        return [(slot, req) for slot, req in self.scheduler.running.items()
                if req.prefill_done]

    def _do_decode(self, step: int) -> List[Request]:
        self._flush_scrubs()
        t0 = time.perf_counter()
        with phase_annotation("serve.decode", self._profile):
            logits, _ = self.api.paged_decode_step(
                self.model,
                self._tensor(self._last_tok[:, None]),
                self._k_pool,
                self._v_pool,
                self._tensor(self._tables),
                self._tensor(self._lengths),
                use_kernel=self.pcfg.use_kernel,
            )
        logits = logits[:, 0].float().cpu().numpy()
        self.stats.decode_s += time.perf_counter() - t0

        finished = []
        active = self._active()
        self.stats.decode_steps += 1
        self.stats.active_slot_steps += len(active)
        self.stats.idle_slot_steps += self.pcfg.max_slots - len(active)
        for slot, req in active:
            tok = self._pick_one(logits[slot], req, len(req.output))
            req.output.append(tok)
            self._lengths[slot] += 1
            req.verified_len = int(self._lengths[slot])
            req.drafted_len = max(req.drafted_len, req.verified_len)
            self._last_tok[slot] = tok
            self.stats.generated_tokens += 1
            self._emit("DECODE", req.rid, new_tokens=1, out_len=len(req.output))
            if req.is_done():
                self._release(req, step)
                finished.append(req)
        return finished

    def _do_verify(self, step: int) -> List[Request]:
        """One speculative verify step: draft k tokens per active slot,
        score all k + 1 positions in ONE batched ``paged_score_tokens``
        call, commit the longest agreed prefix plus the target's own next
        token, and roll the logical length back over the rejected tail.
        With targets ``t_i = argmax(logits[:, i])`` and drafts ``d_1..d_k``,
        drafts are accepted while ``d_{i+1} == t_i``; the committed
        ``t_0..t_a`` are what one-token decode would have produced."""
        self._flush_scrubs()
        k = self.pcfg.spec_k
        w = k + 1
        m = self.pcfg.max_slots
        active = self._active()
        tokens = np.zeros((m, w), np.int32)
        tokens[:, 0] = self._last_tok
        drafts: Dict[int, List[int]] = {}
        propose_hist = self.metrics.histogram("serve_draft_propose_seconds")
        for slot, req in active:
            td = time.perf_counter()
            d = [int(t) for t in self.drafter.propose(req, k)]
            propose_hist.observe(time.perf_counter() - td)
            if len(d) != k:
                raise ValueError(f"the drafter proposed {len(d)} tokens, not {k}")
            drafts[slot] = d
            tokens[slot, 1:] = d
        t0 = time.perf_counter()
        with phase_annotation("serve.verify", self._profile):
            logits, _ = self.api.paged_score_tokens(
                self.model, self._tensor(tokens), self._k_pool, self._v_pool,
                self._tensor(self._tables), self._tensor(self._lengths),
                use_kernel=self.pcfg.use_kernel)
        targets = logits.float().argmax(-1).cpu().numpy()  # [m, w]
        self.stats.decode_s += time.perf_counter() - t0

        finished = []
        self.stats.decode_steps += 1
        self.stats.spec_steps += 1
        self.stats.active_slot_steps += len(active)
        self.stats.idle_slot_steps += m - len(active)
        for slot, req in active:
            base = int(self._lengths[slot])
            req.drafted_len = max(req.drafted_len, base + w)
            d = drafts[slot]
            a = 0
            while a < k and d[a] == int(targets[slot, a]):
                a += 1
            self.stats.drafted_tokens += k
            self.stats.accepted_tokens += a
            committed = 0
            for t in targets[slot, : a + 1]:
                req.output.append(int(t))
                committed += 1
                self.stats.generated_tokens += 1
                self.stats.spec_committed_tokens += 1
                if req.is_done():  # stop_token / max_new hit mid-burst
                    break
            self._lengths[slot] = base + committed
            self._last_tok[slot] = req.output[-1]
            self.scheduler.rollback(req, base + committed)
            self._emit("VERIFY", req.rid, k=k, accepted=a, new_tokens=committed,
                       out_len=len(req.output))
            if req.is_done():
                self._release(req, step)
                finished.append(req)
        return finished

    def _grow_active(self, step: int) -> None:
        """On-demand capacity (preemption="recompute"), just before the
        decode or verify call: every prefilled sequence must own blocks
        for the positions this step writes (1, or spec_k + 1).  Growth
        runs most deserving first, so under pressure the victims are the
        least deserving sequences (possibly a grower itself, which is
        then parked and leaves this step's batch)."""
        w = self.pcfg.spec_k + 1 if self.pcfg.spec_k else 1
        active = sorted((r for r in self.scheduler.running.values() if r.prefill_done),
                        key=Scheduler.deserving, reverse=True)
        for req in active:
            if req.state is not RequestState.RUNNING:
                continue  # evicted by a more deserving grower above
            before = len(req.alloc.blocks)
            if self.scheduler.grow(req, req.verified_len + w, self._on_preempt, step):
                self._tables[req.slot] = req.alloc.table_row(self.max_blocks_per_seq)
                after = len(req.alloc.blocks)
                if after != before:
                    self._emit("GROW", req.rid, new_blocks=after - before, blocks=after)

    def _on_preempt(self, req: Request, slot: int, scrub: List[int]) -> None:
        """Scheduler callback: queue every block the victim wrote that
        reached the free list for scrubbing (committed K/V included: the
        resume recomputes it), reset its slot, and tell a stateful
        drafter."""
        self._scrub_pending.extend(scrub)
        self._reset_slot(slot)
        if req in self._prefilling:  # evicted mid-chunk-prefill
            self._prefilling.remove(req)
        hook = getattr(self.drafter, "on_preempt", None)
        if hook is not None:
            hook(req)
        self.stats.preemptions += 1
        self._emit("PREEMPT", req.rid, blocks_freed=len(scrub),
                   preempt_count=req.preempt_count, out_len=len(req.output))

    def _reset_slot(self, slot: int) -> None:
        self._tables[slot] = SCRATCH_BLOCK
        self._lengths[slot] = 0
        self._last_tok[slot] = 0

    def _cancel(self, req: Request, step: int) -> None:
        was_running = req.state is RequestState.RUNNING
        slot = req.slot
        stale = self.scheduler.cancel(req, step)
        if was_running:
            self._scrub_pending.extend(stale)
            self._reset_slot(slot)
            if req in self._prefilling:
                self._prefilling.remove(req)

    def _release(self, req: Request, step: int) -> None:
        slot = req.slot
        self._scrub_pending.extend(self.scheduler.retire(req, step))
        self._reset_slot(slot)
        self._emit("FINISH", req.rid, out_len=len(req.output))

    def _flush_scrubs(self) -> None:
        """Zero every pending freed block (retires, preemptions, cancels,
        rolled-back draft tails, prefix-cache evictions) in all layers of
        both pools, in place, with one ``index_fill_`` per pool."""
        self._scrub_pending.extend(self.allocator.drain_evicted())
        if not self._scrub_pending:
            return
        blocks, self._scrub_pending = self._scrub_pending, []
        with phase_annotation("serve.scrub", self._profile):
            ids = self._tensor(np.asarray(blocks, np.int64))
            self._k_pool.index_fill_(1, ids, 0)
            self._v_pool.index_fill_(1, ids, 0)

    def _apply_cow(self, req: Request) -> None:
        """Copy-on-write before a shared tail block takes writes: the one
        cached block this sequence must write into (its context is cached
        to a block boundary, and the last token is recomputed for its
        logits) is copied, in all layers of both pools, into the private
        block allocated in its place; then the pin on the shared source
        is dropped."""
        src = req.cow_src
        self._flush_scrubs()
        dst = req.alloc.blocks[req.cached_len // self.pcfg.block_size]
        with phase_annotation("serve.cow", self._profile):
            self._k_pool[:, dst].copy_(self._k_pool[:, src])
            self._v_pool[:, dst].copy_(self._v_pool[:, src])
        req.cow_src = None
        self._scrub_pending.extend(self.allocator.release([src]))

    def _pick_one(self, logits_row: np.ndarray, req: Request, token_idx: int) -> int:
        if self.pcfg.temperature <= 0:
            return int(np.argmax(logits_row))
        # one generator per (seed, request, token): a request's samples do
        # not depend on what else the engine serves
        seed = np.random.SeedSequence([self.pcfg.seed, req.rid, token_idx])
        gen = torch.Generator().manual_seed(int(seed.generate_state(1)[0]))
        probs = torch.softmax(
            torch.from_numpy(logits_row).double() / self.pcfg.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))
