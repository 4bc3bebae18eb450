"""The port's serving observability against the JAX reference.

Parity: the JAX engine and the port's engine serve the same seeded
request sets (staggered arrivals, priorities, deadlines, a client
cancel) on the same converted weights under ONE fake clock that the
workload advances by one second a step, over the ``(preemption, spec_k,
prefill_chunk)`` matrix of tests/test_observability.py with the prefix
cache on and off.  They must give equal event lists (type, rid, step,
timestamp and the full payload, pool occupancy included), equal
breakdowns, latency summaries, Chrome traces and JSON-lines text, and
equal metric snapshots and Prometheus text.  Three metrics read wall
time (``time.perf_counter``), not the fake clock: the step-latency and
draft-propose histograms and the tok/s gauge; for those only the sample
counts are compared.

Port-only: ports of tests/test_observability.py's own tests against
``repro_torch.serving.observability`` (schema and grammar rejection,
exporters, the registry, per-mode MACs, the well-formedness property
over random request streams), ``stream()`` and the request handles
against the reference, and the ``torch.profiler`` spans.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import PagedServeConfig as JPagedCfg  # noqa: E402
from repro.serving import observability as j_obs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.modes import NumericsConfig  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.numerics.calibrate import site_macs  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    MetricsRegistry,
    ServeOptions,
    build_engine,
)
from repro_torch.serving import observability as t_obs  # noqa: E402
from repro_torch.serving.observability import (  # noqa: E402
    EVENT_SCHEMA,
    EVENT_TYPES,
    TERMINAL_EVENTS,
    TraceEvent,
    TraceInvariantError,
    check_prom_file,
    check_request_events,
    check_trace_file,
    load_jsonl,
    macs_per_token_by_mode,
    validate_event,
)
from test_torch_chunked import models  # noqa: E402

# metrics that read wall time (time.perf_counter), not the engine clock
WALL_METRICS = ("serve_step_latency_seconds", "serve_tok_per_s",
                "serve_draft_propose_seconds")
# tests/test_observability.py's engine matrix: (preemption, spec_k, chunk)
MATRIX = [("off", 0, 0), ("off", 0, 4), ("off", 2, 0),
          ("recompute", 0, 0), ("recompute", 0, 4), ("recompute", 2, 0)]
CASES = [(p, k, c, cache) for p, k, c in MATRIX for cache in (False, True)]
SPANS = ("serve.prefill", "serve.decode", "serve.verify", "serve.scrub", "serve.cow")


class FakeClock:
    """Monotonic seconds that only the workload advances."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _pcfg(preemption, spec_k, chunk, prefix_cache, clock):
    # under recompute preemption tests/test_torch_preemption.py's pool (7
    # allocatable blocks), which two of these requests overfill
    return dict(block_size=4, num_blocks=8 if preemption == "recompute" else 64,
                max_slots=2, max_seq_len=48, spec_k=spec_k, prefill_chunk=chunk,
                preemption=preemption, prefix_cache=prefix_cache, clock=clock)


def _stream_requests(eng, clock, seed, prefix):
    """tests/test_observability.py's random request stream (staggered
    arrivals, priorities, deadlines, a client cancel at step 3), with a
    shared two-block prefix and an exact repeat (copy on write) when
    ``prefix``.  The clock advances one second a step."""
    clock.t = 0.0
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 512, 8).tolist()
    handles = []
    for i in range(int(rng.integers(3, 6))):
        plen = int(rng.choice([3, 6, 11]))
        prompt = rng.integers(0, 512, plen).tolist()
        if prefix:
            prompt = list(shared) if i == 1 else shared + prompt
        handles.append(eng.submit(
            prompt, max_new_tokens=int(rng.integers(2, 8)),
            arrival_step=int(rng.integers(0, 3)) + (2 * i if prefix else 0),
            priority=int(rng.integers(0, 2)),
            deadline_s=float(rng.integers(3, 12)) if rng.integers(2) else None))
    cancel_at = 3 if rng.integers(2) else -1
    steps = 0
    while eng.scheduler.has_work():
        eng.step()
        clock.t += 1.0
        steps += 1
        if steps == cancel_at:
            eng.cancel(handles[0])
        assert steps < 500, "engine did not drain"
    return handles


@functools.lru_cache(maxsize=None)
def run_both(preemption, spec_k, chunk, prefix_cache):
    """One seeded request set through the JAX engine, then the port's, on
    the same weights and one fake clock.  Returns (jeng, teng, jh, th)."""
    jc, jp, tc, tm = models("f32")
    clock = FakeClock()
    opts = _pcfg(preemption, spec_k, chunk, prefix_cache, clock)
    seed = CASES.index((preemption, spec_k, chunk, prefix_cache))
    jeng = JEngine(jc, params=jp, pcfg=JPagedCfg(**opts))
    jh = _stream_requests(jeng, clock, seed, prefix_cache)
    teng = build_engine(tc, ServeOptions(**opts), params=tm, device="cpu")
    th = _stream_requests(teng, clock, seed, prefix_cache)
    assert [h.output for h in th] == [h.output for h in jh]
    assert all(v == 0 for v in _lib.launches.values())  # CPU: plain versions only
    return jeng, teng, jh, th


def _events(eng):
    return [ev.to_dict() for ev in eng.trace.events]


def _case_id(case):
    p, k, c, cache = case
    return f"{p}-spec{k}-chunk{c}-{'cache' if cache else 'nocache'}"


def _is_wall(key: str) -> bool:
    return any(key.startswith(name) for name in WALL_METRICS)


def _deterministic_prom(text: str):
    """The Prometheus text with each wall-time sample line replaced by
    nothing, except a histogram's ``_count`` (its sample count)."""
    out = []
    for line in text.splitlines():
        if line.startswith("#") or not _is_wall(line) or "_count" in line.split(" ")[0]:
            out.append(line)
    return out


# -- parity: events, derived views, metrics -----------------------------------


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_event_lists_match_reference(case):
    jeng, teng, _, _ = run_both(*case)
    assert _events(teng) == _events(jeng)
    teng.trace.validate()
    assert teng.trace.rids() == jeng.trace.rids()
    for key in ("steps", "preemptions", "resumes", "deadline_cancelled", "spec_steps"):
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_derived_views_match_reference(case, tmp_path):
    jeng, teng, jh, th = run_both(*case)
    for a, b in zip(th, jh):
        bd = a.breakdown()
        assert bd.to_dict() == b.breakdown().to_dict()
        assert a.trace() and [e.to_dict() for e in a.trace()] == [
            e.to_dict() for e in b.trace()]
        # the telescoping walk covers the request's lifetime exactly
        total = bd.queue_s + bd.prefill_s + bd.decode_s + bd.parked_s
        assert total == pytest.approx(bd.total_s, abs=1e-9)
    assert teng.trace.latency_summary() == jeng.trace.latency_summary()
    assert teng.trace.to_chrome_trace() == jeng.trace.to_chrome_trace()
    teng.trace.to_jsonl(str(tmp_path / "t.jsonl"))
    jeng.trace.to_jsonl(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_metrics_match_reference(case):
    jeng, teng, _, _ = run_both(*case)
    tsnap, jsnap = teng.metrics.snapshot(), jeng.metrics.snapshot()
    assert sorted(tsnap) == sorted(jsnap)
    for key, want in jsnap.items():
        if not _is_wall(key):
            assert tsnap[key] == want, key
        elif isinstance(want, dict):
            assert tsnap[key]["count"] == want["count"], key
    assert _deterministic_prom(teng.metrics.to_prometheus_text()) == _deterministic_prom(
        jeng.metrics.to_prometheus_text())
    # the ServeStats façade reads its quantiles through the registry
    hist = teng.metrics.histogram("serve_step_latency_seconds")
    assert hist.count == teng.stats.steps
    for q, fn in ((0.50, teng.stats.latency_p50), (0.95, teng.stats.latency_p95)):
        assert fn() == hist.quantile(q) == pytest.approx(
            float(np.quantile(teng.stats.step_latency_s, q)))


def test_matrix_covers_every_event_type():
    """Across the matrix every event type is emitted (and matched)."""
    seen = set()
    for case in CASES:
        seen.update(ev["etype"] for ev in _events(run_both(*case)[1]))
    assert seen == set(EVENT_TYPES)


@pytest.mark.parametrize("case", [CASES[0], CASES[-1]], ids=_case_id)
def test_cross_checkers_accept_each_others_exports(case, tmp_path):
    """The JAX checkers accept the port's files and the port's checkers
    the JAX engine's."""
    jeng, teng, jh, _ = run_both(*case)
    for name, eng in (("port", teng), ("jax", jeng)):
        eng.trace.to_jsonl(str(tmp_path / f"{name}.jsonl"))
        (tmp_path / f"{name}.prom").write_text(eng.metrics.to_prometheus_text())
    for mod in (t_obs, j_obs):
        for name in ("port", "jax"):
            counts = mod.check_trace_file(str(tmp_path / f"{name}.jsonl"))
            assert counts["requests"] == counts["terminal"] == len(jh)
            assert mod.check_prom_file(str(tmp_path / f"{name}.prom")) > 0


@pytest.mark.parametrize("policy", ["plam_sim:16:1", "f32"])
def test_macs_by_mode_matches_reference(policy):
    """``serve_macs_total`` per mode equals the JAX ``macs_per_token_by_mode``
    times the tokens served, and the per-mode split equals the reference's
    at full width (no family falls into the best-effort ``except``)."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config as t_get_config

    for jc, tc in ((j_get_config("yi-6b"), t_get_config("yi-6b")),
                   (models(policy)[0], models(policy)[2])):
        jc, tc = jc.with_numerics(f"default={policy}"), tc.with_numerics(f"default={policy}")
        assert macs_per_token_by_mode(tc) == j_obs.macs_per_token_by_mode(jc)
        assert set(macs_per_token_by_mode(tc)) == {policy}
    jc, jp, tc, tm = models(policy)
    eng = build_engine(tc, ServeOptions(block_size=4, num_blocks=64, max_slots=2,
                                        max_seq_len=48), params=tm, device="cpu")
    for i, n in enumerate((5, 9)):
        eng.submit(list(range(3, 3 + n)), max_new_tokens=3, arrival_step=i)
    eng.run()
    tokens = eng.stats.prefill_tokens + eng.stats.generated_tokens
    want = j_obs.macs_per_token_by_mode(jc)[policy] * tokens
    assert eng.metrics.value("serve_macs_total", mode=policy) == pytest.approx(want)
    assert f'serve_macs_total{{mode="{policy}"}}' in eng.metrics.to_prometheus_text()


def test_split_policy_macs_match_reference():
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config as t_get_config

    policy = "default=plam_sim:16:1, layers[0:8]=f32, lm_head=f32"
    jc = j_get_config("yi-6b").with_numerics(policy)
    tc = t_get_config("yi-6b").with_numerics(policy)
    got = macs_per_token_by_mode(tc)
    assert got == j_obs.macs_per_token_by_mode(jc)
    assert set(got) == {"plam_sim:16:1", "f32"}
    assert sum(got.values()) == pytest.approx(sum(site_macs(tc).values()))


# -- streaming and handles -----------------------------------------------------


def _stream_items(eng, clock):
    clock.t = 0.0
    eng.submit([7, 8, 9, 10, 11], max_new_tokens=3)  # another request in flight
    items = []
    for item in eng.stream([1, 2, 3, 4, 5, 6], max_new_tokens=5):
        items.append({"tokens": item["tokens"]} if "tokens" in item
                     else {"event": item["event"].to_dict()})
        clock.t += 0.5
    eng.run()
    return items


@pytest.mark.parametrize("spec_k", [0, 2])
def test_stream_matches_reference(spec_k):
    jc, jp, tc, tm = models("f32")
    clock = FakeClock()
    opts = _pcfg("off", spec_k, 0, False, clock)
    want = _stream_items(JEngine(jc, params=jp, pcfg=JPagedCfg(**opts)), clock)
    got = _stream_items(build_engine(tc, ServeOptions(**opts), params=tm, device="cpu"),
                        clock)
    assert got == want
    assert got[0]["event"]["etype"] == "SUBMIT"
    assert got[-1].get("event", {}).get("etype") in TERMINAL_EVENTS or "tokens" in got[-1]
    assert sum(len(i.get("tokens", [])) for i in got) == 5


def test_handles_without_tracing():
    _, _, tc, tm = models("f32")
    eng = build_engine(tc, ServeOptions(block_size=4, num_blocks=64, max_slots=2,
                                        max_seq_len=48, trace=False),
                       params=tm, device="cpu")
    assert eng.trace is None
    h = eng.submit([1, 2, 3], max_new_tokens=3)
    assert len(h.result()) == 3
    assert h.trace() == [] and h.breakdown() is None
    items = list(eng.stream([4, 5, 6], max_new_tokens=2))
    assert items and all("tokens" in i for i in items)
    assert eng.metrics.value("serve_steps_total") == eng.stats.steps


def test_serve_options_trace_on_by_default():
    from repro.serving import ServeOptions as JServeOptions

    assert ServeOptions().trace is True and ServeOptions().profile is False
    assert ServeOptions().trace == JServeOptions().trace
    assert ServeOptions(trace=False, profile=True).paged().profile is True


# -- profiler spans ------------------------------------------------------------


def _span_names(profile, **opts):
    from torch.profiler import ProfilerActivity

    _, _, tc, tm = models("f32")
    eng = build_engine(tc, ServeOptions(block_size=4, num_blocks=64, max_slots=2,
                                        max_seq_len=48, profile=profile,
                                        prefix_cache=True, **opts),
                       params=tm, device="cpu")
    shared = list(range(10, 18))  # two blocks: the repeat copies on write
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.submit(shared + [3, 4, 5], max_new_tokens=3)
        eng.submit(shared, max_new_tokens=3, arrival_step=3)
        eng.run()
    return {e.name for e in prof.events()} & set(SPANS), eng


@pytest.mark.parametrize("spec_k", [0, 2])
def test_profile_spans_under_torch_profiler(spec_k):
    names, eng = _span_names(True, spec_k=spec_k)
    want = {"serve.prefill", "serve.scrub", "serve.cow",
            "serve.verify" if spec_k else "serve.decode"}
    assert eng.allocator.cow_copies == 1
    assert names == want
    off, _ = _span_names(False, spec_k=spec_k)
    assert off == set()


# -- ports of tests/test_observability.py's own tests --------------------------

OBS_CFG = ModelConfig(
    name="obs-test", family="dense", n_layers=2, d_model=32, n_heads=2,
    n_kv=1, head_dim=16, d_ff=64, vocab=64,
    numerics=NumericsConfig(mode="f32"),
    act_dtype="float32", param_dtype="float32",
)
_CLOCK = FakeClock()
_ENGINES = {}


def _engine(preemption="off", spec_k=0, prefill_chunk=0):
    key = (preemption, spec_k, prefill_chunk)
    if key not in _ENGINES:
        _ENGINES[key] = build_engine(OBS_CFG, ServeOptions(
            block_size=4, num_blocks=16 if preemption == "recompute" else 64,
            max_slots=2, max_seq_len=48, spec_k=spec_k, prefill_chunk=prefill_chunk,
            preemption=preemption, clock=_CLOCK), device="cpu")
    return _ENGINES[key]


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10**9))
def test_event_streams_well_formed(seed):
    rng = np.random.default_rng(seed)
    preemption = "recompute" if rng.integers(2) else "off"
    spec_k = 2 if rng.integers(2) else 0
    chunk = 4 if (spec_k == 0 and rng.integers(2)) else 0
    eng = _engine(preemption, spec_k, chunk)
    eng.trace.clear()
    base = eng.current_step
    handles = []
    for _ in range(int(rng.integers(2, 5))):
        plen = int(rng.choice([3, 6, 11]))
        handles.append(eng.submit(
            rng.integers(0, OBS_CFG.vocab, plen).tolist(),
            max_new_tokens=int(rng.integers(2, 8)),
            arrival_step=base + int(rng.integers(0, 3)),
            priority=int(rng.integers(0, 2)),
            deadline_s=float(rng.integers(4, 40)) if rng.integers(2) else None))
    steps = 0
    while eng.scheduler.has_work():
        eng.step()
        _CLOCK.t += 1.0
        steps += 1
        if steps == 3 and rng.integers(2):
            eng.cancel(handles[0])
        assert steps < 500, "engine did not drain"
    eng.trace.validate()
    for h in handles:
        evs = h.trace()
        check_request_events(evs)
        assert sum(e.etype in TERMINAL_EVENTS for e in evs) == 1
        pr = [e.etype for e in evs if e.etype in ("PREEMPT", "RESUME")]
        assert pr[::2] == ["PREEMPT"] * len(pr[::2])
        assert pr[1::2] == ["RESUME"] * len(pr[1::2])
        bd = h.breakdown()
        total = bd.queue_s + bd.prefill_s + bd.decode_s + bd.parked_s
        assert total == pytest.approx(bd.total_s, abs=1e-9)
        assert bd.total_s == pytest.approx(evs[-1].t - evs[0].t, abs=1e-9)
        if bd.terminal == "FINISH" and h.output:
            assert bd.first_token_s is not None
            assert 0.0 <= bd.first_token_s <= bd.total_s


def test_schema_matches_reference():
    assert EVENT_SCHEMA == j_obs.EVENT_SCHEMA
    assert TERMINAL_EVENTS == j_obs.TERMINAL_EVENTS
    assert t_obs._REQUIRED_SERVE_FAMILIES == j_obs._REQUIRED_SERVE_FAMILIES


def test_schema_rejects_malformed_events():
    with pytest.raises(TraceInvariantError):
        validate_event(TraceEvent("NOT_A_TYPE", 0, 0, 0.0, {"out_len": 0}))
    with pytest.raises(TraceInvariantError):  # missing out_len
        validate_event(TraceEvent("DECODE", 0, 0, 0.0, {"new_tokens": 1}))
    validate_event(TraceEvent("DECODE", 0, 0, 0.0, {"new_tokens": 1, "out_len": 3}))
    validate_event(TraceEvent("FINISH", 0, 0, 0.0, {"out_len": 3, "free_blocks": 9}))


def test_grammar_rejects_malformed_sequences():
    sub = TraceEvent("SUBMIT", 0, 0, 0.0, {"prompt_len": 4, "max_new": 4})
    adm = TraceEvent("ADMIT", 0, 1, 1.0, {"slot": 0, "blocks": 1, "cached_len": 0})
    fin = TraceEvent("FINISH", 0, 3, 3.0, {"out_len": 4})
    res = TraceEvent("RESUME", 0, 2, 2.0, {"slot": 0, "blocks": 1, "parked_steps": 1})
    check_request_events([sub, adm, fin])
    for bad in ([adm, fin], [sub, adm, fin, fin], [sub, adm, res, fin],
                [sub, TraceEvent("ADMIT", 0, 1, -1.0,
                                 {"slot": 0, "blocks": 1, "cached_len": 0}), fin]):
        with pytest.raises(TraceInvariantError):
            check_request_events(bad)


def test_admit_schema_requires_cached_len():
    with pytest.raises(TraceInvariantError):
        validate_event(TraceEvent("ADMIT", 0, 0, 0.0, {"slot": 0, "blocks": 1}))


def test_prom_gate_requires_prefix_cache_families(tmp_path):
    p = tmp_path / "m.prom"
    p.write_text("serve_steps_total 3\n")
    with pytest.raises(TraceInvariantError):
        check_prom_file(str(p))
    p.write_text("unrelated_metric 1\n")
    assert check_prom_file(str(p)) == 1
    p.write_text("serve_steps_total 3\n"
                 "serve_prefix_cache_hits_total 0\n"
                 "serve_prefix_cache_misses_total 0\n"
                 "serve_prefix_cache_evictions_total 0\n")
    assert check_prom_file(str(p)) == 4


@pytest.fixture(scope="module")
def traced_run():
    eng = _engine()
    eng.trace.clear()
    hs = [eng.submit([1, 2, 3], max_new_tokens=4),
          eng.submit([4, 5, 6, 7, 8, 9], max_new_tokens=3)]
    while eng.scheduler.has_work():
        eng.step()
        _CLOCK.t += 1.0
    return eng, hs


def test_chrome_trace_structure(tmp_path, traced_run):
    eng, hs = traced_run
    path = tmp_path / "trace.json"
    eng.trace.to_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    assert {e["ph"] for e in evs} >= {"X", "i", "M"}
    for e in evs:
        assert {"ph", "pid", "tid", "name"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0
        if e["ph"] == "i":
            assert e["s"] in ("t", "p", "g")
        if e["ph"] == "M":
            assert e["name"] == "thread_name"
    assert {e["tid"] for e in evs if e["ph"] == "X"} <= {h.rid for h in hs}


def test_jsonl_roundtrip_and_schema_checker(tmp_path, traced_run):
    eng, hs = traced_run
    path = tmp_path / "trace.jsonl"
    eng.trace.to_jsonl(str(path))
    assert [e.to_dict() for e in load_jsonl(str(path))] == _events(eng)
    counts = check_trace_file(str(path))
    assert counts["requests"] == counts["terminal"] == len(hs)
    assert t_obs.main([str(path)]) == 0


def test_prometheus_text_syntax(tmp_path, traced_run):
    eng, _ = traced_run
    text = eng.metrics.to_prometheus_text()
    path = tmp_path / "metrics.prom"
    path.write_text(text)
    assert check_prom_file(str(path)) > 0
    assert "# TYPE serve_step_latency_seconds histogram" in text
    assert 'le="+Inf"' in text
    assert eng.metrics.value("serve_steps_total") == eng.stats.steps


def test_latency_summary_sane(traced_run):
    eng, hs = traced_run
    s = eng.trace.latency_summary()
    assert s["requests"] == len(hs)
    assert 0.0 <= s["first_token_p50_s"] <= s["total_p95_s"]
    assert s["total_p95_s"] > 0.0 and s["total_p50_s"] <= s["total_p95_s"]
    for h in hs:
        ttft, total = eng.trace.latency(h.rid)
        assert 0.0 <= ttft <= total


def test_registry_instruments_and_labels():
    reg = MetricsRegistry()
    reg.counter("c", "help text").inc()
    reg.counter("c").inc(2)
    assert reg.value("c") == 3.0
    with pytest.raises(AssertionError):
        reg.counter("c").inc(-1)
    reg.gauge("g", mode="plam").set(0.5)
    reg.gauge("g", mode="f32").set(0.25)
    assert reg.value("g", mode="plam") == 0.5 and reg.value("g", mode="f32") == 0.25
    h = reg.histogram("h")
    for v in (0.001, 0.002, 0.003, 0.4):
        h.observe(v)
    assert h.count == 4 and h.quantile(0.5) == pytest.approx(0.0025)
    text = reg.to_prometheus_text()
    assert "# HELP c help text" in text
    assert 'g{mode="plam"} 0.5' in text
    assert "h_count 4" in text


def test_registry_sources_and_snapshot_hooks():
    reg = MetricsRegistry()
    box = {"v": 1.0, "xs": [0.1]}
    reg.counter("src_total").set_source(lambda: box["v"])
    reg.histogram("src_hist").set_source(lambda: box["xs"])
    with pytest.raises(AssertionError):
        reg.counter("src_total").inc()
    box["v"] = 7.0
    box["xs"].append(0.3)
    assert reg.value("src_total") == 7.0 and reg.histogram("src_hist").count == 2
    fired = []
    reg.every(5, lambda r: fired.append(r.value("src_total")))
    for step in range(1, 11):
        reg.tick(step)
    assert fired == [7.0, 7.0]
    snap = reg.snapshot()
    assert snap["src_total"] == 7.0 and snap["src_hist"]["count"] == 2


def test_engine_ticks_snapshot_hooks_and_survives_stats_reset():
    eng = _engine("off", 0, 4)
    fired = []
    eng.metrics.every(2, lambda r: fired.append(r.value("serve_steps_total")))
    before = eng.stats.steps
    eng.submit([1, 2, 3, 4, 5], max_new_tokens=3)
    eng.run()
    assert fired and all(v % 2 == 0 for v in fired)
    assert fired[-1] <= eng.stats.steps and eng.stats.steps > before
    from repro_torch.serving import ServeStats

    eng.stats = ServeStats()  # a benchmark-style reset
    eng.submit([1, 2, 3], max_new_tokens=2)
    eng.run()
    assert eng.stats._registry is eng.metrics
    assert eng.metrics.value("serve_steps_total") == eng.stats.steps
    assert eng.stats.latency_p50() == eng.metrics.histogram(
        "serve_step_latency_seconds").quantile(0.5)


def test_engine_exports_mode_mac_counters(traced_run):
    eng, _ = traced_run
    assert 'serve_macs_total{mode="f32"}' in eng.metrics.to_prometheus_text()
    generated = eng.stats.prefill_tokens + eng.stats.generated_tokens
    per_tok = macs_per_token_by_mode(OBS_CFG)["f32"]
    assert eng.metrics.value("serve_macs_total", mode="f32") == pytest.approx(
        per_tok * generated)


def test_site_macs_match_reference():
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.numerics.calibrate import site_macs as j_site_macs

    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"numerics"}
    for kw in (dict(family="dense"), dict(family="moe", n_experts=8, top_k=2, moe_d_ff=96,
                                          n_shared_experts=1),
               dict(family="ssm", ssm_state=16), dict(family="hybrid", ssm_state=16,
                                                      shared_attn_every=3),
               dict(family="encdec", enc_layers=2, dec_layers=3, frontend_dim=80),
               dict(family="dense", glu=False)):
        tc = dataclasses.replace(OBS_CFG, **kw)
        jc = JModelConfig(**{k: getattr(tc, k) for k in fields})
        assert site_macs(tc) == j_site_macs(jc), kw
