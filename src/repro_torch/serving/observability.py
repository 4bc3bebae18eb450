"""Serving observability: structured tracing, metrics, profiler spans.

Port of ``repro/serving/observability.py``; the events, their payloads,
the metric names, help strings and labels, and both export formats are
the reference's, so each package's checkers accept the other's files.
Three cooperating pieces, all host-side (numpy only; torch only for the
opt-in profiler spans):

* :class:`TraceRecorder` — typed per-request event stream.  The engine
  emits one :class:`TraceEvent` per lifecycle transition (``SUBMIT``,
  ``ADMIT``, ``PREFILL_CHUNK``, ``DECODE``, ``VERIFY``, ``GROW``,
  ``PREEMPT``, ``RESUME``, ``CANCEL``, ``DEADLINE``, ``FINISH``), each
  carrying the request id, the engine step, a monotonic timestamp from
  the engine's injectable clock and the block-pool occupancy at
  emission time.  Every event type has a payload schema
  (:data:`EVENT_SCHEMA`) checked at emission, so an exported trace is
  valid by construction.  Exports: JSON-lines (:meth:`TraceRecorder.
  to_jsonl`) and Chrome ``trace_event`` JSON viewable in Perfetto /
  ``chrome://tracing`` (:meth:`TraceRecorder.to_chrome_trace`).  The
  per-request latency breakdown (``queue_s`` / ``prefill_s`` /
  ``decode_s`` / ``parked_s``) is DERIVED from event timestamps by a
  telescoping walk (:meth:`TraceRecorder.breakdown`), so the four
  buckets sum to the submit->terminal wall time exactly.

* :class:`MetricsRegistry` — counters / gauges / histograms with a
  Prometheus text exporter and periodic snapshot hooks.  Instruments
  may hold a stored value (``inc`` / ``set`` / ``observe``) or a
  *source* callable read at collection time; the engine wires its
  registry with sources over live state (``ServeStats`` fields, the
  allocator free list, per-numerics-mode MAC totals resolved through
  ``repro_torch.core.policy``), which makes metric collection free on
  the hot path and immune to benchmark-style stats resets.

* :func:`phase_annotation` — an opt-in ``torch.profiler.record_function``
  range per engine phase (``serve.prefill``, ``serve.decode``,
  ``serve.verify``, ``serve.scrub``, ``serve.cow``), a null context
  unless profiling is enabled, so engine phases show up as named spans
  in a ``torch.profiler`` capture.

Run ``python -m repro_torch.serving.observability trace.jsonl [--prom
metrics.prom]`` to schema-check an exported trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# typed events
# ---------------------------------------------------------------------------

#: Every event type the engine may emit, with the payload keys an event
#: of that type MUST carry (pool occupancy keys are added to every
#: event by the recorder itself).  ``emit`` rejects unknown types and
#: missing keys, so traces validate at the source.
EVENT_SCHEMA: Dict[str, Tuple[str, ...]] = {
    "SUBMIT": ("prompt_len", "max_new"),
    "ADMIT": ("slot", "blocks", "cached_len"),
    "PREFILL_CHUNK": ("start", "tokens", "width", "done", "out_len"),
    "DECODE": ("new_tokens", "out_len"),
    "VERIFY": ("k", "accepted", "new_tokens", "out_len"),
    "GROW": ("new_blocks", "blocks"),
    "PREEMPT": ("blocks_freed", "preempt_count", "out_len"),
    "RESUME": ("slot", "blocks", "parked_steps"),
    "CANCEL": ("reason", "out_len"),
    "DEADLINE": ("deadline_s", "out_len"),
    "FINISH": ("out_len",),
}

EVENT_TYPES: Tuple[str, ...] = tuple(EVENT_SCHEMA)

#: Exactly one of these ends every request's event sequence.
TERMINAL_EVENTS: Tuple[str, ...] = ("FINISH", "CANCEL", "DEADLINE")

#: Occupancy keys the recorder stamps onto every event.
_OCCUPANCY_KEYS = ("free_blocks", "used_blocks")


class TraceInvariantError(AssertionError):
    """An event stream violated the request-lifecycle grammar."""


@dataclasses.dataclass
class TraceEvent:
    """One typed event: what happened, to which request, when."""

    etype: str
    rid: int
    step: int
    t: float
    payload: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        d = {"etype": self.etype, "rid": self.rid, "step": self.step, "t": self.t}
        d.update(self.payload)
        return d

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "TraceEvent":
        payload = {
            k: v for k, v in d.items() if k not in ("etype", "rid", "step", "t")
        }
        return TraceEvent(
            etype=str(d["etype"]),
            rid=int(d["rid"]),
            step=int(d["step"]),
            t=float(d["t"]),
            payload=payload,
        )


def validate_event(ev: TraceEvent) -> None:
    """Schema check for one event: known type, required payload keys."""
    schema = EVENT_SCHEMA.get(ev.etype)
    if schema is None:
        raise TraceInvariantError(
            f"unknown event type {ev.etype!r}; expected one of {EVENT_TYPES}"
        )
    missing = [k for k in schema if k not in ev.payload]
    if missing:
        raise TraceInvariantError(
            f"{ev.etype} event for rid={ev.rid} is missing payload keys {missing}"
        )


def check_request_events(events: Sequence[TraceEvent]) -> None:
    """Well-formedness of ONE request's event sequence.

    Grammar: SUBMIT first (exactly once); at most one ADMIT, after
    SUBMIT; PREEMPT only while admitted and RESUME only while parked
    (so PREEMPT/RESUME strictly alternate); DECODE/VERIFY/GROW/
    PREFILL_CHUNK only while admitted; exactly one terminal event, in
    last position; timestamps non-decreasing.
    """
    if not events:
        raise TraceInvariantError("empty event sequence")
    rid = events[0].rid
    if events[0].etype != "SUBMIT":
        raise TraceInvariantError(f"rid={rid}: first event is {events[0].etype}")
    admitted = False  # currently holding a slot
    ever_admitted = False
    parked = False
    terminal = False
    last_t = events[0].t
    for ev in events[1:]:
        if ev.rid != rid:
            raise TraceInvariantError(f"rid mixup: {ev.rid} in rid={rid} stream")
        if terminal:
            raise TraceInvariantError(f"rid={rid}: event {ev.etype} after terminal")
        if ev.t < last_t:
            raise TraceInvariantError(
                f"rid={rid}: timestamps regress ({ev.t} < {last_t})"
            )
        last_t = ev.t
        if ev.etype == "SUBMIT":
            raise TraceInvariantError(f"rid={rid}: duplicate SUBMIT")
        elif ev.etype == "ADMIT":
            if ever_admitted:
                raise TraceInvariantError(
                    f"rid={rid}: second ADMIT (resumes emit RESUME)"
                )
            admitted = ever_admitted = True
        elif ev.etype == "RESUME":
            if not parked:
                raise TraceInvariantError(f"rid={rid}: RESUME without PREEMPT")
            parked, admitted = False, True
        elif ev.etype == "PREEMPT":
            if not admitted:
                raise TraceInvariantError(f"rid={rid}: PREEMPT while not admitted")
            admitted, parked = False, True
        elif ev.etype in ("PREFILL_CHUNK", "DECODE", "VERIFY", "GROW"):
            if not admitted:
                raise TraceInvariantError(
                    f"rid={rid}: {ev.etype} while not admitted"
                )
        elif ev.etype in TERMINAL_EVENTS:
            terminal = True
        else:  # pragma: no cover - emit() already rejects unknown types
            raise TraceInvariantError(f"rid={rid}: unknown event {ev.etype}")
    if not terminal:
        raise TraceInvariantError(f"rid={rid}: no terminal event")


# phase each event type transitions INTO, for the breakdown walk
_PHASE_AFTER = {
    "ADMIT": "prefill",
    "RESUME": "prefill",
    "PREEMPT": "parked",
}


@dataclasses.dataclass
class RequestBreakdown:
    """Where one request's wall time went, derived from its events.

    ``queue_s + prefill_s + decode_s + parked_s == total_s`` exactly
    (the derivation is a telescoping sum over event timestamps).
    ``first_token_s`` is submit -> first committed token; None when the
    request never emitted one.
    """

    rid: int
    queue_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    parked_s: float = 0.0
    total_s: float = 0.0
    first_token_s: Optional[float] = None
    terminal: str = ""

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def derive_breakdown(events: Sequence[TraceEvent]) -> RequestBreakdown:
    """Telescoping walk: attribute the delta between consecutive event
    timestamps to the phase the request was in, then switch phases on
    the transition events.  Sums to terminal.t - submit.t exactly."""
    check_request_events(events)
    bd = RequestBreakdown(rid=events[0].rid)
    buckets = {"queue": 0.0, "prefill": 0.0, "decode": 0.0, "parked": 0.0}
    phase = "queue"
    last_t = events[0].t
    for ev in events[1:]:
        buckets[phase] += ev.t - last_t
        last_t = ev.t
        if ev.etype in _PHASE_AFTER:
            phase = _PHASE_AFTER[ev.etype]
        elif ev.etype == "PREFILL_CHUNK" and ev.payload.get("done"):
            phase = "decode"
        if (
            bd.first_token_s is None
            and int(ev.payload.get("out_len", 0) or 0) >= 1
            and ev.etype in ("PREFILL_CHUNK", "DECODE", "VERIFY")
        ):
            bd.first_token_s = ev.t - events[0].t
        if ev.etype in TERMINAL_EVENTS:
            bd.terminal = ev.etype
    bd.queue_s = buckets["queue"]
    bd.prefill_s = buckets["prefill"]
    bd.decode_s = buckets["decode"]
    bd.parked_s = buckets["parked"]
    bd.total_s = events[-1].t - events[0].t
    return bd


class TraceRecorder:
    """Collects typed events; derives latency; exports traces.

    ``clock`` is the engine's injectable monotonic clock (tests use a
    fake); ``occupancy`` returns ``(free_blocks, used_blocks)`` and is
    sampled at every emission so each event carries the pool state the
    moment it happened.
    """

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        occupancy: Optional[Callable[[], Tuple[int, int]]] = None,
    ):
        self.clock = clock if clock is not None else time.monotonic
        self.occupancy = occupancy
        self.events: List[TraceEvent] = []
        self._by_rid: Dict[int, List[TraceEvent]] = {}

    def __len__(self) -> int:
        return len(self.events)

    def clear(self) -> None:
        """Drop recorded events (benchmarks clear after warmup)."""
        self.events.clear()
        self._by_rid.clear()

    def emit(self, etype: str, rid: int, step: int, **payload) -> TraceEvent:
        """Record one event NOW (timestamp from the clock), stamping
        pool occupancy and schema-checking the payload."""
        if self.occupancy is not None:
            free, used = self.occupancy()
            payload.setdefault("free_blocks", int(free))
            payload.setdefault("used_blocks", int(used))
        ev = TraceEvent(
            etype=etype, rid=rid, step=step, t=float(self.clock()), payload=payload
        )
        validate_event(ev)
        self.events.append(ev)
        self._by_rid.setdefault(rid, []).append(ev)
        return ev

    # -- per-request views -------------------------------------------------

    def request_events(self, rid: int) -> List[TraceEvent]:
        return list(self._by_rid.get(rid, ()))

    def rids(self) -> List[int]:
        return sorted(self._by_rid)

    def breakdown(self, rid: int) -> RequestBreakdown:
        return derive_breakdown(self._by_rid[rid])

    def validate(self) -> None:
        """Check every request's event sequence is well-formed.
        Requests without a terminal event yet are skipped (live)."""
        for rid, evs in self._by_rid.items():
            if evs and evs[-1].etype in TERMINAL_EVENTS:
                check_request_events(evs)

    def latency(self, rid: int) -> Tuple[Optional[float], Optional[float]]:
        """(submit -> first token, submit -> terminal) seconds; None
        for whichever has not happened yet."""
        evs = self._by_rid.get(rid, ())
        if not evs or evs[0].etype != "SUBMIT":
            return (None, None)
        t0 = evs[0].t
        first = None
        for ev in evs:
            if (
                ev.etype in ("PREFILL_CHUNK", "DECODE", "VERIFY")
                and int(ev.payload.get("out_len", 0) or 0) >= 1
            ):
                first = ev.t - t0
                break
        total = evs[-1].t - t0 if evs[-1].etype in TERMINAL_EVENTS else None
        return (first, total)

    def latency_summary(self) -> Dict[str, float]:
        """p50/p95 of submit->first-token and submit->finish across
        every request with a terminal event — the per-request numbers
        ``ServeStats`` never had (its resume_latency only counted
        parked time)."""
        firsts, totals = [], []
        for rid in self._by_rid:
            first, total = self.latency(rid)
            if total is not None:
                totals.append(total)
                if first is not None:
                    firsts.append(first)

        def q(xs: List[float], p: float) -> float:
            return float(np.quantile(np.asarray(xs), p)) if xs else 0.0

        return {
            "requests": float(len(totals)),
            "first_token_p50_s": q(firsts, 0.50),
            "first_token_p95_s": q(firsts, 0.95),
            "total_p50_s": q(totals, 0.50),
            "total_p95_s": q(totals, 0.95),
        }

    # -- exporters ---------------------------------------------------------

    def to_jsonl(self, path: str) -> None:
        """One JSON object per line, flat (payload keys inlined)."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev.to_dict()) + "\n")

    def to_chrome_trace(self, path: Optional[str] = None) -> Dict[str, object]:
        """Chrome ``trace_event`` JSON (open in Perfetto or
        ``chrome://tracing``): one track (tid) per request, an ``X``
        (complete) slice per contiguous phase segment, an ``i``
        (instant) mark per raw event.  Returns the trace dict; writes
        it to ``path`` when given."""
        if not self.events:
            trace: Dict[str, object] = {"traceEvents": [], "displayTimeUnit": "ms"}
            if path:
                with open(path, "w") as f:
                    json.dump(trace, f)
            return trace
        t0 = min(ev.t for ev in self.events)
        out: List[Dict[str, object]] = []
        for rid, evs in sorted(self._by_rid.items()):
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": rid,
                    "args": {"name": f"request {rid}"},
                }
            )
            phase = "queue"
            seg_start = evs[0].t
            for ev in evs[1:]:
                next_phase = phase
                if ev.etype in _PHASE_AFTER:
                    next_phase = _PHASE_AFTER[ev.etype]
                elif ev.etype == "PREFILL_CHUNK" and ev.payload.get("done"):
                    next_phase = "decode"
                elif ev.etype in TERMINAL_EVENTS:
                    next_phase = ""
                if next_phase != phase:
                    if ev.t > seg_start:
                        out.append(
                            {
                                "name": phase,
                                "cat": "request",
                                "ph": "X",
                                "ts": (seg_start - t0) * 1e6,
                                "dur": (ev.t - seg_start) * 1e6,
                                "pid": 0,
                                "tid": rid,
                            }
                        )
                    phase, seg_start = next_phase, ev.t
            for ev in evs:
                out.append(
                    {
                        "name": ev.etype,
                        "cat": "event",
                        "ph": "i",
                        "s": "t",
                        "ts": (ev.t - t0) * 1e6,
                        "pid": 0,
                        "tid": ev.rid,
                        "args": {"step": ev.step, **ev.payload},
                    }
                )
        trace = {"traceEvents": out, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace


def load_jsonl(path: str) -> List[TraceEvent]:
    """Parse a JSON-lines trace back into events (schema-checked)."""
    events = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = TraceEvent.from_dict(json.loads(line))
            except (KeyError, ValueError, TypeError) as e:
                raise TraceInvariantError(f"{path}:{line_no}: {e}") from e
            validate_event(ev)
            events.append(ev)
    return events


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def _labels_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labels_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Instrument:
    """Shared machinery: a stored value or a live source callable."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.help = help
        self.labels = labels
        self._value = 0.0
        self._source: Optional[Callable[[], float]] = None

    def set_source(self, fn: Callable[[], float]) -> "_Instrument":
        """Read the value live at collection time instead of storing
        it — the engine's zero-hot-path-cost wiring."""
        self._source = fn
        return self

    @property
    def value(self) -> float:
        if self._source is not None:
            return float(self._source())
        return self._value


class Counter(_Instrument):
    kind = "counter"

    def inc(self, n: float = 1.0) -> None:
        assert self._source is None, "sourced counters are read-only"
        assert n >= 0, "counters only go up"
        self._value += n


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, v: float) -> None:
        assert self._source is None, "sourced gauges are read-only"
        self._value = float(v)


_DEFAULT_BUCKETS = (
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
)


class Histogram(_Instrument):
    """Sample-keeping histogram: exact quantiles for the façade, bucket
    counts for the Prometheus exporter.  ``set_source`` points it at a
    live sample list (e.g. ``ServeStats.step_latency_s``)."""

    kind = "histogram"

    def __init__(self, name, help, labels, buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.buckets = tuple(buckets)
        self._samples: List[float] = []
        self._list_source: Optional[Callable[[], Sequence[float]]] = None

    def observe(self, v: float) -> None:
        assert self._list_source is None, "sourced histograms are read-only"
        self._samples.append(float(v))

    def set_source(self, fn: Callable[[], Sequence[float]]) -> "Histogram":
        self._list_source = fn
        return self

    @property
    def samples(self) -> List[float]:
        if self._list_source is not None:
            return list(self._list_source())
        return list(self._samples)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def value(self) -> float:  # sum, for snapshot symmetry
        return float(sum(self.samples))

    def quantile(self, q: float) -> float:
        xs = self.samples
        if not xs:
            return 0.0
        return float(np.quantile(np.asarray(xs), q))


class MetricsRegistry:
    """Get-or-create instruments keyed by (name, labels); Prometheus
    text exposition; periodic snapshot hooks driven by the engine's
    step counter (``tick``)."""

    def __init__(self):
        self._instruments: Dict[Tuple[str, Tuple], _Instrument] = {}
        self._hooks: List[Tuple[int, Callable[["MetricsRegistry"], None]]] = []

    def _get(self, cls, name: str, help: str, labels: Dict[str, str], **kw):
        key = (name, _labels_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            inst = cls(name, help, _labels_key(labels), **kw)
            self._instruments[key] = inst
        assert isinstance(inst, cls), f"{name} registered as {inst.kind}"
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self, name: str, help: str = "", buckets=_DEFAULT_BUCKETS, **labels
    ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def value(self, name: str, **labels) -> float:
        """Read one instrument's current value (sum, for histograms)."""
        return self._instruments[(name, _labels_key(labels))].value

    # -- periodic snapshots ------------------------------------------------

    def every(self, n_steps: int, fn: Callable[["MetricsRegistry"], None]) -> None:
        """Run ``fn(registry)`` every ``n_steps`` engine steps (the
        periodic snapshot hook; e.g. append ``snapshot()`` to a log)."""
        assert n_steps >= 1
        self._hooks.append((n_steps, fn))

    def tick(self, step: int) -> None:
        for n, fn in self._hooks:
            if step > 0 and step % n == 0:
                fn(self)

    # -- exporters ---------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Flat dict of every instrument's current value; histograms
        expand to count/sum/p50/p95."""
        out: Dict[str, object] = {}
        for (name, labels), inst in sorted(self._instruments.items()):
            full = name + _labels_str(labels)
            if isinstance(inst, Histogram):
                out[full] = {
                    "count": inst.count,
                    "sum": inst.value,
                    "p50": inst.quantile(0.50),
                    "p95": inst.quantile(0.95),
                }
            else:
                out[full] = inst.value
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format (one scrape page)."""
        by_name: Dict[str, List[_Instrument]] = {}
        for (name, _), inst in sorted(self._instruments.items()):
            by_name.setdefault(name, []).append(inst)
        lines: List[str] = []
        for name, insts in by_name.items():
            first = insts[0]
            if first.help:
                lines.append(f"# HELP {name} {first.help}")
            lines.append(f"# TYPE {name} {first.kind}")
            for inst in insts:
                ls = _labels_str(inst.labels)
                if isinstance(inst, Histogram):
                    xs = inst.samples
                    acc = 0
                    for b in inst.buckets:
                        acc = sum(1 for x in xs if x <= b)
                        lb = dict(inst.labels)
                        lb["le"] = repr(b)
                        lines.append(
                            f"{name}_bucket{_labels_str(_labels_key(lb))} {acc}"
                        )
                    lb = dict(inst.labels)
                    lb["le"] = "+Inf"
                    lines.append(
                        f"{name}_bucket{_labels_str(_labels_key(lb))} {len(xs)}"
                    )
                    lines.append(f"{name}_sum{ls} {float(sum(xs))}")
                    lines.append(f"{name}_count{ls} {len(xs)}")
                else:
                    lines.append(f"{name}{ls} {inst.value}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# per-numerics-mode MAC attribution (core/policy site resolution)
# ---------------------------------------------------------------------------


def macs_per_token_by_mode(cfg) -> Dict[str, float]:
    """Per-token forward-pass MACs grouped by resolved numerics mode.

    Sites come from ``repro_torch.numerics.calibrate.site_macs``; each
    site's mode is resolved through the model's numerics policy
    (``repro_torch.core.policy.site_for``), per layer when layer-range rules
    exist, so a mixed policy reports exactly how many MACs run on the
    approximate multiplier vs exact posit vs float — the paper's
    cost-savings story as a serving metric.
    """
    from repro_torch.core.policy import cfg_spec_str, site_for
    from repro_torch.numerics.calibrate import site_macs

    out: Dict[str, float] = {}
    n_layers = getattr(cfg, "n_layers", 0) or 1
    layer_free = ("lm_head", "frontend", "hybrid.proj")
    for role, macs in site_macs(cfg).items():
        if role in layer_free:
            mode = cfg_spec_str(site_for(cfg.numerics, role, None, n_layers))
            out[mode] = out.get(mode, 0.0) + macs
        else:
            per_layer = macs / n_layers
            for layer in range(n_layers):
                mode = cfg_spec_str(site_for(cfg.numerics, role, layer, n_layers))
                out[mode] = out.get(mode, 0.0) + per_layer
    return out


# ---------------------------------------------------------------------------
# profiling hooks
# ---------------------------------------------------------------------------


def phase_annotation(name: str, enabled: bool = True):
    """Context manager naming an engine phase in a ``torch.profiler``
    capture (``torch.profiler.record_function``).  A null context when
    disabled, so the hot path never pays for it."""
    if not enabled:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# CLI: schema-check exported artifacts
# ---------------------------------------------------------------------------

_PROM_LINE = r"^(#.*|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [-+0-9.einfa]+)$"


def check_trace_file(path: str) -> Dict[str, int]:
    """Validate a trace.jsonl: every event schema-checks and every
    terminated request's sequence is grammatical.  Returns counts."""
    events = load_jsonl(path)
    by_rid: Dict[int, List[TraceEvent]] = {}
    for ev in events:
        by_rid.setdefault(ev.rid, []).append(ev)
    checked = 0
    for evs in by_rid.values():
        if evs[-1].etype in TERMINAL_EVENTS:
            check_request_events(evs)
            checked += 1
    return {"events": len(events), "requests": len(by_rid), "terminal": checked}


#: Metric families a serving-engine export must always carry: the
#: engine registers the prefix-cache counters unconditionally (they
#: simply stay at 0 with the cache off), so their absence from a file
#: that has any ``serve_`` family means the export predates the cache
#: or dropped families on the way out.
_REQUIRED_SERVE_FAMILIES: Tuple[str, ...] = (
    "serve_prefix_cache_hits_total",
    "serve_prefix_cache_misses_total",
    "serve_prefix_cache_evictions_total",
)


def check_prom_file(path: str) -> int:
    """Syntax-check a Prometheus text file; returns sample line count.
    Files containing serving-engine metrics must also carry the
    prefix-cache families (see :data:`_REQUIRED_SERVE_FAMILIES`)."""
    import re

    pat = re.compile(_PROM_LINE)
    samples = 0
    families = set()
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            if not pat.match(line):
                raise TraceInvariantError(f"{path}:{line_no}: bad prom line {line!r}")
            if not line.startswith("#"):
                samples += 1
                families.add(line.split("{", 1)[0].split(" ", 1)[0])
    if any(f.startswith("serve_") for f in families):
        missing = [f for f in _REQUIRED_SERVE_FAMILIES if f not in families]
        if missing:
            raise TraceInvariantError(
                f"{path}: serving export missing metric families {missing}"
            )
    return samples


def main(argv: Optional[Iterable[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="schema-check serving trace/metrics artifacts"
    )
    ap.add_argument("trace", help="trace.jsonl from launch/serve.py --trace-out")
    ap.add_argument("--prom", default=None, help="metrics.prom to syntax-check")
    args = ap.parse_args(argv)
    counts = check_trace_file(args.trace)
    print(
        f"{args.trace}: {counts['events']} events, {counts['requests']} requests, "
        f"{counts['terminal']} terminal sequences OK"
    )
    if args.prom:
        n = check_prom_file(args.prom)
        print(f"{args.prom}: {n} samples OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
