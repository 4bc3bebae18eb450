"""Speculative decoding in the port's engine against the JAX reference.

A drafter proposes k tokens a slot; one batched verify scores all k + 1
positions, commits the agreed prefix plus the target's own token and
rolls the rejected tail back.  The port must give the reference
engine's greedy tokens and counters for k in {1, 2, 4}, chunked and
unchunked, and the tokens of plain decode; also when a stop token or
``max_new_tokens`` cuts a burst.  Port-only: the n-gram drafter against
the reference's, the reference's validation errors, the draft model
(``spec_draft="model:<arch>"``), and rolled-back blocks reading zero once
freed.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.serving import NgramDrafter as JNgram  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import NgramDrafter, Request, ServeOptions, build_engine  # noqa: E402
from repro_torch.serving import make_drafter  # noqa: E402
from test_torch_chunked import models, serve_both  # noqa: E402
from test_torch_ssm import one_thread  # noqa: E402,F401

POOL = dict(block_size=4, num_blocks=96, max_slots=3, max_seq_len=48)


def _mixed(eng, max_new=6, stop_token=None, lens=(3, 9, 17, 6)):
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, 512, n).tolist(), max_new_tokens=max_new,
                     arrival_step=i, stop_token=stop_token) for i, n in enumerate(lens)]
    done = eng.run()
    return [done[h.rid] for h in hs]


def _plain(workload, **opts):
    tc, tm = models("f32")[2:]
    return workload(build_engine(tc, ServeOptions(**dict(POOL, **opts)), params=tm,
                                 device="cpu"))


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_matches_reference(k, chunk):
    _, eng, got = serve_both(models("f32"), _mixed, spec_k=k, prefill_chunk=chunk, **POOL)
    st = eng.stats
    assert st.spec_steps > 0 and st.drafted_tokens == k * st.active_slot_steps
    assert st.tokens_per_verify_step() >= 1.0
    assert 0.0 <= st.acceptance_rate() <= 1.0
    assert eng.allocator.num_free == eng.allocator.num_blocks - 1
    assert got == _plain(_mixed, prefill_chunk=chunk)


@pytest.mark.parametrize("k", [2, 4])
def test_spec_stop_token_mid_burst(k):
    """A stop token inside a verify burst cuts the commit where plain
    decode stops."""
    base = _plain(lambda e: _mixed(e, max_new=12, lens=(5,)))[0]
    stop = base[6]
    want = base[:base.index(stop) + 1]

    def stopped(eng):
        return _mixed(eng, max_new=12, stop_token=stop, lens=(5,))

    _, eng, got = serve_both(models("f32"), stopped, spec_k=k, **POOL)
    assert got == [want]
    assert eng.allocator.num_free == eng.allocator.num_blocks - 1


@pytest.mark.parametrize("max_new", [2, 3, 7])
def test_spec_max_new_cuts_final_burst(max_new):
    def run(eng):
        return _mixed(eng, max_new=max_new, lens=(6,))

    _, _, got = serve_both(models("f32"), run, spec_k=4, **POOL)
    assert got == _plain(run) and len(got[0]) == max_new


def test_rolled_back_tails_read_zero_once_freed():
    """Verify writes k + 1 positions and commits fewer; when the request
    retires, the blocks holding the rejected tail read zero."""
    tc, tm = models("f32")[2:]
    eng = build_engine(tc, ServeOptions(**dict(POOL, max_slots=1), spec_k=4), params=tm,
                       device="cpu")
    h = eng.submit(np.random.default_rng(3).integers(0, 512, 6).tolist(), max_new_tokens=9)
    drafted, blocks = 0, []
    while h.state.name != "FINISHED":
        if h.alloc is not None:
            drafted, blocks = h.drafted_len, list(h.alloc.blocks)
        eng.step()
    committed = len(h.prompt) + len(h.output) - 1
    assert drafted > committed  # a tail was written past the committed length
    stale = sorted({p // 4 for p in range(committed, drafted)})
    assert not eng._k_pool[:, [blocks[i] for i in stale]].any()
    assert not eng._v_pool[:, [blocks[i] for i in stale]].any()


def test_ngram_drafter_matches_reference():
    rng = np.random.default_rng(0)
    for case in range(200):
        max_n = int(rng.integers(1, 5))
        k = int(rng.integers(1, 7))
        prompt = rng.integers(0, 6, int(rng.integers(1, 20))).tolist()
        output = rng.integers(0, 6, int(rng.integers(0, 10))).tolist()
        treq = Request(rid=case, prompt=prompt, max_new_tokens=16)
        jreq = JRequest(rid=case, prompt=prompt, max_new_tokens=16)
        treq.output, jreq.output = list(output), list(output)
        assert NgramDrafter(max_n).propose(treq, k) == JNgram(max_n).propose(jreq, k)
    assert isinstance(make_drafter("ngram", None), NgramDrafter)
    assert make_drafter("ngram:5", None).max_n == 5
    with pytest.raises(ValueError, match="unknown drafter"):
        make_drafter("bogus", None)


def test_spec_requires_greedy_sampling():
    tc = get_config("yi-6b").reduced()
    with pytest.raises(ValueError, match="greedy"):
        build_engine(tc, ServeOptions(spec_k=2, temperature=1.0), device="cpu")


@pytest.mark.usefixtures("one_thread")
def test_draft_model_is_not_ported_yet():
    """``spec_draft="model:<arch>"``, a later slice until the static engine
    was ported, now drafts with the reduced f32 arch on the static engine:
    the committed tokens are plain decode's (the drafter against the
    reference's is held in tests/test_torch_static_engine.py)."""
    from repro_torch.serving import DraftModelDrafter

    tc, tm = models("f32")[2:]
    want = _plain(_mixed)
    opts = dict(POOL, spec_k=2, spec_draft="model:yi-6b")
    eng = build_engine(tc, ServeOptions(**opts), params=tm, device="cpu")
    assert isinstance(eng.drafter, DraftModelDrafter)
    assert _mixed(eng) == want
    assert eng.drafter.proposals > 0 and eng.stats.drafted_tokens > 0
    with pytest.raises(ValueError, match="unknown draft arch"):
        make_drafter("model:no-such-arch", tc)
