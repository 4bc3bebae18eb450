"""The public serving API: options, engine factory, request handles.

Port of ``repro/serving/api.py``.  :class:`ServeOptions` keeps the
reference's field names and defaults.  Chunked prefill, speculative
decoding (n-gram or draft-model drafts), recompute preemption, the
prefix cache, tracing (on by default), profiler spans and the static
engine are served, and ``tp`` serves tensor-parallel on the continuous
engine, one engine a rank of a ``torch.distributed`` world
(``launch/mesh.py::spawn``); the static engine serves at tp = 1, as the
reference's does.  :func:`build_engine` picks the continuous engine for
the paged families and the static engine for the others (ssm, hybrid,
encdec, vlm), as the reference does.

Typical use::

    from repro_torch.serving import ServeOptions, build_engine

    eng = build_engine(cfg, ServeOptions(prequantize=True, prefill_chunk=32,
                                         spec_k=4, prefix_cache=True))
    handle = eng.submit(prompt, max_new_tokens=16)
    tokens = handle.result()          # drives the engine to completion
    print(handle.breakdown())         # queue/prefill/decode/parked split
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike

from .engine import ContinuousBatchingEngine, Engine, PagedServeConfig, ServeConfig
from .scheduler import Request, RequestState

#: families served by the continuous-batching engine under engine="auto"
PAGED_FAMILIES = ("dense", "moe")


@dataclasses.dataclass
class ServeOptions:
    """Serving options, field for field the reference's."""

    # -- request defaults --------------------------------------------------
    max_new_tokens: int = 16
    stop_token: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None

    # -- sampling ----------------------------------------------------------
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0

    # -- engine (continuous batching) --------------------------------------
    engine: str = "auto"  # "auto" | "continuous" | "static"
    block_size: int = 16
    num_blocks: int = 128
    max_slots: int = 4
    max_seq_len: int = 256
    cache_dtype: str = "bfloat16"
    use_kernel: Optional[bool] = None
    tp: int = 1
    prefill_chunk: int = 0
    prequantize: bool = False
    spec_k: int = 0
    spec_draft: object = "ngram"
    preemption: str = "off"
    prefix_cache: bool = False
    clock: Optional[object] = None

    # -- observability -----------------------------------------------------
    trace: bool = True
    profile: bool = False
    time_steps: bool = False  # static engine only

    def paged(self) -> PagedServeConfig:
        """Project onto the continuous engine's internal config."""
        return PagedServeConfig(
            block_size=self.block_size,
            num_blocks=self.num_blocks,
            max_slots=self.max_slots,
            max_seq_len=self.max_seq_len,
            temperature=self.temperature,
            seed=self.seed,
            cache_dtype=self.cache_dtype,
            use_kernel=self.use_kernel,
            prequantize=self.prequantize,
            prefill_chunk=self.prefill_chunk,
            spec_k=self.spec_k,
            spec_draft=self.spec_draft,
            preemption=self.preemption,
            prefix_cache=self.prefix_cache,
            clock=self.clock,
            trace=self.trace,
            profile=self.profile,
            tp=self.tp,
        )

    def static(self) -> ServeConfig:
        """Project onto the static engine's internal config."""
        return ServeConfig(
            max_new_tokens=self.max_new_tokens,
            temperature=self.temperature,
            seed=self.seed,
            time_steps=self.time_steps,
        )

    def submit_kwargs(self) -> dict:
        """The per-request defaults as ``submit()`` keyword arguments."""
        return dict(
            max_new_tokens=self.max_new_tokens,
            stop_token=self.stop_token,
            priority=self.priority,
            deadline_s=self.deadline_s,
        )


class SubmitHandle:
    """Future-like view of one submitted request.

    Every ``Request`` attribute (``rid``, ``state``, ``output``, ...) is
    delegated; :meth:`result` drives the engine until this request is
    terminal, :meth:`cancel` aborts it, :meth:`trace` gives its trace
    events (empty when tracing is off) and :meth:`breakdown` its
    queue/prefill/decode/parked latency split (None when tracing is off).
    """

    __slots__ = ("_engine", "_request")

    def __init__(self, engine: ContinuousBatchingEngine, request: Request):
        self._engine = engine
        self._request = request

    @property
    def request(self) -> Request:
        """The underlying scheduler Request."""
        return self._request

    def result(self) -> List[int]:
        """Drive ``engine.step()`` until this request finishes or is
        cancelled; returns its committed output tokens."""
        while self._request.state not in (RequestState.FINISHED, RequestState.CANCELLED):
            self._engine.step()
        return self._request.output

    def cancel(self) -> None:
        self._engine.cancel(self._request)

    def trace(self) -> list:
        """This request's TraceEvents, in emission order."""
        if self._engine.trace is None:
            return []
        return self._engine.trace.request_events(self._request.rid)

    def breakdown(self):
        """Latency split (RequestBreakdown) once terminal; None when
        tracing is off."""
        if self._engine.trace is None:
            return None
        return self._engine.trace.breakdown(self._request.rid)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._request, name)

    def __repr__(self) -> str:
        r = self._request
        return (f"SubmitHandle(rid={r.rid}, state={r.state.name}, "
                f"out={len(r.output)}/{r.max_new_tokens})")


def build_engine(
    cfg: ModelConfig,
    opts: Optional[ServeOptions] = None,
    params: Optional[torch.nn.Module] = None,
    init_seed: int = 0,
    device: DeviceLike = None,
):
    """Build the engine for ``cfg`` under ``opts`` on ``device`` (CUDA
    unless the caller passes another): ``engine="continuous"`` the
    continuous-batching engine (paged families only), ``"static"`` the
    static batcher, ``"auto"`` (default) the continuous engine for
    :data:`PAGED_FAMILIES` and the static one otherwise.  ``params`` is a
    model (e.g. from ``repro_torch.convert.params_from_jax``); without
    one the port's own seeded init (``init_seed``) runs on the device.
    The static engine takes ``prequantize`` and ``use_kernel`` from
    ``opts`` and its per-call options from :meth:`ServeOptions.static`;
    the continuous engine's capacity options do not apply to it, and it
    serves at ``tp`` = 1 only.  With ``tp`` > 1 this is called in each
    rank of a world of tp ranks (``launch/mesh.py::spawn``); elsewhere the
    continuous engine raises ``ValueError``."""
    opts = opts or ServeOptions()
    kind = opts.engine
    if kind == "auto":
        kind = "continuous" if cfg.family in PAGED_FAMILIES else "static"
    if kind == "continuous":
        return ContinuousBatchingEngine(
            cfg, params=params, init_seed=init_seed, pcfg=opts.paged(), device=device)
    if kind == "static":
        if opts.tp != 1:
            raise ValueError(f"the static engine serves at tp=1, not tp={opts.tp}; "
                             f"tensor parallelism is the continuous engine's")
        return Engine(cfg, params=params, init_seed=init_seed, prequantize=opts.prequantize,
                      device=device, use_kernel=opts.use_kernel)
    raise ValueError(
        f"unknown engine kind {opts.engine!r}; use 'auto', 'continuous' or 'static'")
