"""Continuous-batching serving engine over a paged KV cache.

Port of ``repro/serving/engine.py::ContinuousBatchingEngine`` (the
subset this slice serves): admission, whole-prompt prefill, batched
decode, retirement, deadline expiry and cancellation, and one batched
scrub of freed blocks per step.  Chunked prefill, speculative decoding,
preemption, the prefix cache, tensor parallelism, observability and the
static engine are later slices (``ROADMAP.md``, queue 1).

Unlike the reference, whose arrays are immutable, the port updates its
device state in place: prefill and decode write K/V into the pools with
``index_put_``, and a scrub zeroes freed blocks with ``index_fill_``.
Host-side state (block tables, lengths, last tokens, the scheduler) is
numpy and Python, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ModelAPI, build
from repro_torch.models.transformer import torch_dtype

from .kv_cache import SCRATCH_BLOCK, BlockAllocator, padded_prompt_len
from .scheduler import Request, RequestState, Scheduler


@dataclasses.dataclass
class ServeStats:
    """Padding/utilization/latency accounting (the reference's fields for
    the features this slice serves)."""

    steps: int = 0
    prefills: int = 0
    prefill_tokens: int = 0  # real prompt tokens
    prefill_padding: int = 0  # bucket padding on top of them
    decode_steps: int = 0
    active_slot_steps: int = 0  # slot-steps doing useful decode work
    idle_slot_steps: int = 0  # slot-steps wasted (empty slot, step ran)
    generated_tokens: int = 0
    deadline_cancelled: int = 0  # requests cancelled at deadline expiry
    step_latency_s: List[float] = dataclasses.field(default_factory=list)
    # host seconds in prefill and in batched decode; each phase ends by
    # copying logits to the host, so these include the device's work
    prefill_s: float = 0.0
    decode_s: float = 0.0

    def padding_waste(self) -> float:
        """Fraction of engine capacity spent on padding/idle slots."""
        spent = (self.prefill_tokens + self.prefill_padding
                 + self.active_slot_steps + self.idle_slot_steps)
        wasted = self.prefill_padding + self.idle_slot_steps
        return wasted / spent if spent else 0.0

    def record_step(self, seconds: float) -> None:
        self.step_latency_s.append(seconds)

    def latency_quantile(self, q: float) -> float:
        if not self.step_latency_s:
            return 0.0
        return float(np.quantile(np.asarray(self.step_latency_s), q))

    def latency_p50(self) -> float:
        return self.latency_quantile(0.50)

    def latency_p95(self) -> float:
        return self.latency_quantile(0.95)


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
    clock: Optional[object] = None  # monotonic seconds; None = time.monotonic


class ContinuousBatchingEngine:
    """Admission-controlled serving over a paged KV cache.

    Each ``step()``:
      1. cancels requests whose deadline passed;
      2. admits waiting requests FCFS while a slot and whole-lifetime
         blocks are free, prefilling each whole prompt at admission;
      3. runs ONE batched decode step over all prefilled slots, reading
         per-sequence block tables and lengths;
      4. retires finished sequences, returning blocks to the free list;
         freed blocks holding never-committed K/V (prefill padding) are
         zeroed in one batched, in-place scrub before the next compute.

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
        self.device = resolve_device(device)
        self.api: ModelAPI = build(cfg)
        if cfg.attn_logit_softcap is not None:
            raise ValueError("paged decode does not support logit softcap")
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
        self.max_blocks_per_seq = -(-pcfg.max_seq_len // bs)
        self._k_pool, self._v_pool = self.api.paged_pool_init(
            nb, bs, torch_dtype(pcfg.cache_dtype), self.device)
        self.allocator = BlockAllocator(nb, bs)
        self._clock = pcfg.clock if pcfg.clock is not None else time.monotonic
        self.scheduler = Scheduler(
            self.allocator, pcfg.max_slots, pcfg.max_seq_len, clock=self._clock)
        # blocks freed but not yet zeroed: scrubs coalesce into one
        # in-place index_fill_ per flush
        self._scrub_pending: List[int] = []

        m = pcfg.max_slots
        self._tables = np.full((m, self.max_blocks_per_seq), SCRATCH_BLOCK, np.int32)
        self._lengths = np.zeros((m,), np.int32)
        self._last_tok = np.zeros((m,), np.int32)
        self._step_no = 0
        self._next_rid = 0
        self.stats = ServeStats()

    @property
    def current_step(self) -> int:
        """Engine step counter (arrival_step values are absolute)."""
        return self._step_no

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
        non-decreasing arrival_step order; ``priority`` is accepted and
        ignored under FCFS admission, as in the reference."""
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
        return SubmitHandle(self, req)

    def cancel(self, req) -> None:
        """Client-side abort of ``req`` (a ``Request`` or ``SubmitHandle``)
        wherever it is, keeping its committed output."""
        req = getattr(req, "request", req)
        if req.state in (RequestState.FINISHED, RequestState.CANCELLED):
            return
        self._cancel(req, self._step_no)

    # -- engine loop -------------------------------------------------------

    def step(self) -> List[Request]:
        """One engine iteration; returns requests finished this step."""
        t0 = time.perf_counter()
        step = self._step_no
        finished: List[Request] = []

        for req in self.scheduler.expired(self._clock()):
            self._cancel(req, step)
            self.stats.deadline_cancelled += 1
            finished.append(req)

        for req in self.scheduler.admit(step):
            self._do_prefill(req)
            if req.is_done():  # max_new_tokens == 1: done at prefill
                self._release(req, step)
                finished.append(req)

        if any(r.prefill_done for r in self.scheduler.running.values()):
            finished.extend(self._do_decode(step))

        # freed blocks never stay dirty across a step boundary
        self._flush_scrubs()
        self.stats.steps += 1
        self._step_no += 1
        self.stats.record_step(time.perf_counter() - t0)
        return finished

    def run(self) -> Dict[int, List[int]]:
        """Drive step() until every submitted request has finished.
        Returns {rid: generated tokens}."""
        done: Dict[int, List[int]] = {}
        while self.scheduler.has_work():
            for req in self.step():
                done[req.rid] = req.output
        return done

    # -- internals ---------------------------------------------------------

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)

    def _do_prefill(self, req: Request) -> None:
        """Whole-prompt prefill into the request's blocks, then sample."""
        self._flush_scrubs()
        t0 = time.perf_counter()
        bs = self.pcfg.block_size
        plen = req.prefill_len
        s_pad = padded_prompt_len(plen, bs)
        toks = np.zeros((1, s_pad), np.int32)
        toks[0, :plen] = req.prefill_tokens
        block_ids = self._tensor(np.asarray(req.alloc.blocks[: s_pad // bs], np.int32))
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

    def _finish_prefill(self, req: Request, last_logits: np.ndarray) -> None:
        """Sample the first token and activate the slot for decode."""
        tok = self._pick_one(last_logits, req, len(req.output))
        req.output.append(tok)
        self.stats.generated_tokens += 1
        slot = req.slot
        self._tables[slot] = req.alloc.table_row(self.max_blocks_per_seq)
        self._lengths[slot] = req.prefill_len
        self._last_tok[slot] = tok

    def _do_decode(self, step: int) -> List[Request]:
        self._flush_scrubs()
        t0 = time.perf_counter()
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
        active = [
            (slot, req)
            for slot, req in self.scheduler.running.items()
            if req.prefill_done
        ]
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
            if req.is_done():
                self._release(req, step)
                finished.append(req)
        return finished

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

    def _release(self, req: Request, step: int) -> None:
        slot = req.slot
        self._scrub_pending.extend(self.scheduler.retire(req, step))
        self._reset_slot(slot)

    def _flush_scrubs(self) -> None:
        """Zero every pending freed block in all layers of both pools, in
        place, with one ``index_fill_`` per pool."""
        if not self._scrub_pending:
            return
        ids = self._tensor(np.asarray(self._scrub_pending, np.int64))
        self._scrub_pending = []
        self._k_pool.index_fill_(1, ids, 0)
        self._v_pool.index_fill_(1, ids, 0)

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
