"""Recompute preemption in the port's engine against the JAX reference.

Two max-length requests on a pool with room for about one: the later
one is evicted mid-decode (its blocks scrubbed), parked, and resumed by
recomputing its committed context through the chunk path.  The port
must give the reference engine's greedy tokens and counters across
chunked and unchunked prefill and speculative decoding on and off (the
matrix of tests/test_preemption.py), and the tokens of an uninterrupted
run.  Port-only: every block a preemption frees reads zero before reuse.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro_torch.serving import RequestState, ServeOptions, build_engine  # noqa: E402
from test_torch_chunked import models, serve_both  # noqa: E402

# block 4, 8 blocks (7 allocatable), 2 slots: an 8-token prompt with 12
# new tokens needs 5 blocks (6 with a burst of 2), so two collide
PRESSURE = dict(block_size=4, num_blocks=8, max_slots=2, max_seq_len=32,
                preemption="recompute")


def _two(eng):
    rng = np.random.default_rng(0)
    pa = rng.integers(0, 512, 8).tolist()
    pb = rng.integers(0, 512, 8).tolist()
    a = eng.submit(pa, max_new_tokens=12)
    b = eng.submit(pb, max_new_tokens=12, arrival_step=1)
    done = eng.run()
    return [done[a.rid], done[b.rid]]


@pytest.mark.parametrize("spec", [0, 2])
@pytest.mark.parametrize("chunk", [0, 4])
def test_preempted_stream_matches_reference(chunk, spec):
    jeng, teng, got = serve_both(models("f32"), _two, prefill_chunk=chunk, spec_k=spec,
                                 **PRESSURE)
    st = teng.stats
    assert st.preemptions > 0, "pool pressure never forced an eviction"
    assert st.resumes == st.preemptions
    assert st.resume_latency_steps == jeng.stats.resume_latency_steps
    assert all(s >= 1 for s in st.resume_latency_steps)
    assert st.resume_latency_mean_s() > 0.0
    assert teng.allocator.num_free == 7 and not teng.scheduler.has_work()
    # and the tokens of an uninterrupted run (a pool nothing is evicted from)
    tc, tm = models("f32")[2:]
    big = build_engine(tc, ServeOptions(**dict(PRESSURE, num_blocks=64), prefill_chunk=chunk,
                                        spec_k=spec), params=tm, device="cpu")
    assert _two(big) == got
    assert big.stats.preemptions == 0


def test_preempted_blocks_read_zero_before_reuse():
    """Right after the step that evicts b, every block on the free list
    reads zero in both pools (committed K/V included: the resume
    recomputes it; spec_k=2 puts rolled-back draft tails in the mix),
    while the survivor's blocks do not."""
    tc, tm = models("f32")[2:]
    eng = build_engine(tc, ServeOptions(**PRESSURE, spec_k=2), params=tm, device="cpu")
    rng = np.random.default_rng(5)
    a = eng.submit(rng.integers(0, 512, 8).tolist(), max_new_tokens=12)
    b = eng.submit(rng.integers(0, 512, 8).tolist(), max_new_tokens=12, arrival_step=1)
    for _ in range(200):
        if b.preempt_count:
            break
        eng.step()
    assert b.state is RequestState.PREEMPTED, "pressure never evicted b"
    free = list(eng.allocator._free)
    assert free and eng._scrub_pending == []
    for pool in (eng._k_pool, eng._v_pool):
        assert not pool[:, free].any(), "freed blocks still hold the victim's K/V"
    assert a.state is RequestState.RUNNING
    assert bool(eng._k_pool[:, a.alloc.blocks].any())
    eng.run()
    assert eng.allocator.num_free == 7


def test_preempted_request_can_be_cancelled():
    """A parked request is cancelled where it is, keeping its output."""
    tc, tm = models("f32")[2:]
    eng = build_engine(tc, ServeOptions(**PRESSURE), params=tm, device="cpu")
    rng = np.random.default_rng(6)
    a = eng.submit(rng.integers(0, 512, 8).tolist(), max_new_tokens=12)
    b = eng.submit(rng.integers(0, 512, 8).tolist(), max_new_tokens=12, arrival_step=1)
    for _ in range(200):
        if b.state is RequestState.PREEMPTED:
            break
        eng.step()
    assert b.state is RequestState.PREEMPTED, "pressure never evicted b"
    kept = list(b.output)
    b.cancel()
    assert b.state is RequestState.CANCELLED and b.output == kept
    assert len(a.result()) == 12
    assert eng.allocator.num_free == 7 and not eng.scheduler.has_work()
