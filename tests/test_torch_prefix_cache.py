"""The prefix cache in the port's engine against the JAX reference.

Admission serves the leading full blocks of a prompt from the
content-addressed cache and prefills only the miss suffix through the
chunk path.  The port must give the reference engine's greedy tokens,
counters and cache statistics with the cache on, across chunked and
unchunked prefill and speculative decoding on and off (the matrix of
tests/test_prefix_cache.py), and the tokens of the cache-off engine;
also for an identical prompt (copy-on-write), forced eviction, and a
preempted request resuming over its own published prefix.  Port-only:
scrubs coalesce into one ``index_fill_`` per pool per flush, and a
retired request's stale tail reads zero.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro_torch.serving import ServeOptions, build_engine  # noqa: E402
from test_torch_chunked import models, serve_both  # noqa: E402

POOL = dict(block_size=4, num_blocks=64, max_slots=4, max_seq_len=48)
CACHE = ("hits", "misses", "tokens_saved", "cow_copies", "evictions")


def _serve_cached(workload, **opts):
    """The workload with the cache on, port against reference (tokens,
    counters, cache statistics), then on the port with the cache off:
    the same tokens.  Returns the port's cache-on engine."""
    opts = dict(POOL, **opts)
    jeng, teng, got = serve_both(models("f32"), workload, prefix_cache=True, **opts)
    for field in CACHE:
        assert getattr(teng.allocator, field) == getattr(jeng.allocator, field), field
    tc, tm = models("f32")[2:]
    assert workload(build_engine(tc, ServeOptions(**opts), params=tm, device="cpu")) == got
    return teng


def _shared_prefix(eng):
    """Four prompts sharing a 16-token prefix (4 blocks), each arriving
    after the previous one's prefill has published its blocks."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 16).tolist()
    hs = [eng.submit(shared + rng.integers(0, 512, 3 + i).tolist(), max_new_tokens=6,
                     arrival_step=i * 10) for i in range(4)]
    done = eng.run()
    return [done[h.rid] for h in hs]


@pytest.mark.parametrize("spec", [0, 2])
@pytest.mark.parametrize("chunk", [0, 4])
def test_shared_prefix_matches_reference(chunk, spec):
    eng = _serve_cached(_shared_prefix, prefill_chunk=chunk, spec_k=spec)
    assert eng.allocator.hits > 0 and eng.allocator.tokens_saved > 0, "cache never hit"
    assert eng.allocator.num_referenced == 0


def test_identical_prompt_copies_on_write():
    """A block-aligned prompt sent twice hits every block; its last token
    is recomputed mid-block, so that block is copied out first."""
    prompt = np.random.default_rng(1).integers(0, 512, 16).tolist()

    def twice(eng):
        a = eng.submit(prompt, max_new_tokens=6)
        b = eng.submit(prompt, max_new_tokens=6, arrival_step=2)
        done = eng.run()
        return [done[a.rid], done[b.rid]]

    eng = _serve_cached(twice)
    assert eng.allocator.cow_copies > 0, "a fully cached prompt never copied on write"
    assert eng.allocator.num_referenced == 0


def test_forced_eviction_matches_reference():
    """A pool too small to keep every retired prefix: admissions evict
    idle cached blocks (scrubbed, then reused), and the evicted prefix
    sent again misses and recomputes."""
    rng = np.random.default_rng(2)
    pa = rng.integers(0, 512, 16).tolist()
    pb = rng.integers(0, 512, 16).tolist()

    def three(eng):
        outs = []
        for p in (pa, pb, pa):
            h = eng.submit(p, max_new_tokens=6, arrival_step=eng.current_step)
            outs.append(eng.run()[h.rid])
        return outs

    eng = _serve_cached(three, num_blocks=10, max_slots=1)
    assert eng.allocator.evictions > 0, "pool pressure never evicted"


def test_preempt_resume_hits_own_prefix_matches_reference():
    """Under recompute preemption a victim's registered blocks park on
    the LRU, and its resume hits them."""
    rng = np.random.default_rng(3)
    pa = rng.integers(0, 512, 8).tolist()
    pb = rng.integers(0, 512, 8).tolist()

    def two(eng):
        a = eng.submit(pa, max_new_tokens=12)
        b = eng.submit(pb, max_new_tokens=12, arrival_step=1)
        done = eng.run()
        return [done[a.rid], done[b.rid]]

    eng = _serve_cached(two, num_blocks=10, max_slots=2, preemption="recompute")
    assert eng.stats.preemptions > 0, "pool pressure never evicted"
    assert eng.allocator.hits > 0, "the resume never hit the cache"
    assert eng.allocator.num_referenced == 0


class _CountFills(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") == "index_fill_":
            self.calls += 1
        return func(*args, **(kwargs or {}))


def test_scrubs_coalesce_into_one_index_fill_per_pool():
    """Three retires in one step, each with a stale padding tail: the
    step's flush zeroes all of them with one index_fill_ per pool."""
    tc, tm = models("f32")[2:]
    eng = build_engine(tc, ServeOptions(**dict(POOL, max_slots=3)), params=tm, device="cpu")
    rng = np.random.default_rng(4)
    # 5-token prompts pad to 8: every retire leaves positions [5, 8) stale
    hs = [eng.submit(rng.integers(0, 512, 5).tolist(), max_new_tokens=3) for _ in range(3)]
    eng.step()  # prefills (token 1) and a decode (token 2)
    counter = _CountFills()
    with counter:
        finished = eng.step()
    assert len(finished) == 3 and all(h.request in finished for h in hs)
    assert counter.calls == 2
    assert eng._scrub_pending == []


def test_retired_stale_tail_reads_zero():
    """A retired request's stale tail (prefill padding past the last
    committed token) reads zero; its committed K/V may stay."""
    tc, tm = models("f32")[2:]
    eng = build_engine(tc, ServeOptions(**dict(POOL, num_blocks=8, max_slots=1)),
                       params=tm, device="cpu")
    # prompt 5 pads to 8, 2 new tokens commit through position 6: position
    # 7, in the second of the fresh engine's blocks [1, 2], stays stale
    h = eng.submit(np.random.default_rng(5).integers(0, 512, 5).tolist(), max_new_tokens=2)
    eng.run()
    assert h.state.name == "FINISHED" and eng.allocator.num_free == 7
    assert not eng._k_pool[:, 2].any() and not eng._v_pool[:, 2].any()
    assert bool(eng._k_pool[:, 1].any())
