"""The port's continuous-batching engine against the JAX reference engine.

Both engines get the same prompts on the same (converted) weights and
must give identical greedy tokens.  The port-only tests cover the
engine's bookkeeping: in-place scrubs, cancellation, deadlines,
sampling, and the options of later slices, which must raise.  Chunked
prefill, preemption, the prefix cache and speculative decoding have
files of their own (``tests/test_torch_{chunked,preemption,prefix_cache,spec}.py``).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import PagedServeConfig as JPagedCfg  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.serving import RequestState, ServeOptions, build_engine  # noqa: E402

BS, NB, SLOTS, MAX_LEN = 8, 32, 2, 32


def _cfgs(policy: str):
    j = dataclasses.replace(j_get_config("yi-6b").reduced(),
                            param_dtype="float32", act_dtype="float32")
    t = dataclasses.replace(t_get_config("yi-6b").reduced(),
                            param_dtype="float32", act_dtype="float32")
    return j.with_numerics(f"default={policy}"), t.with_numerics(f"default={policy}")


def _numpy_tree(tree):
    def one(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(one, tree)


def _prompts(vocab, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 10).tolist() for _ in range(n)]


def _port_engine(tc, params=None, **kw):
    opts = ServeOptions(block_size=BS, num_blocks=NB, max_slots=SLOTS,
                        max_seq_len=MAX_LEN, **kw)
    return build_engine(tc, opts, params=params, device="cpu"), opts


@pytest.mark.parametrize("policy,prequantize", [("plam_sim:16:1", True), ("f32", False),
                                                ("plam_sim:16:1", False)])
def test_engine_greedy_tokens_match_reference(policy, prequantize):
    """Three staggered requests over two slots (admission waits for a
    retirement): identical greedy tokens in both engines."""
    jc, tc = _cfgs(policy)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    prompts = _prompts(jc.vocab)

    jeng = JEngine(jc, params=jp, pcfg=JPagedCfg(
        block_size=BS, num_blocks=NB, max_slots=SLOTS, max_seq_len=MAX_LEN,
        prequantize=prequantize))
    jh = [jeng.submit(p, max_new_tokens=4, arrival_step=i) for i, p in enumerate(prompts)]
    jdone = jeng.run()

    teng, _ = _port_engine(tc, params_from_jax(_numpy_tree(jp), tc, device="cpu"),
                           prequantize=prequantize)
    th = [teng.submit(p, max_new_tokens=4, arrival_step=i) for i, p in enumerate(prompts)]
    tdone = teng.run()

    assert [tdone[h.rid] for h in th] == [jdone[h.rid] for h in jh]
    assert teng.prequant_meta == jeng.prequant_meta
    assert teng.stats.steps == jeng.stats.steps
    assert teng.stats.decode_steps == jeng.stats.decode_steps
    assert teng.stats.padding_waste() == pytest.approx(jeng.stats.padding_waste())
    assert all(v == 0 for v in _lib.launches.values())  # CPU: plain versions only


def test_engine_prequantized_or_not_gives_the_same_tokens():
    """bf16 weights (the serve path's): a plam_sim engine that encodes
    them on every forward gives the tokens of one that stored their
    int16 patterns at build."""
    tc = t_get_config("yi-6b").reduced().with_numerics("default=plam_sim:16:1")
    assert tc.param_dtype == "bfloat16"
    outs = []
    for prequantize in (True, False):
        eng, _ = _port_engine(tc, prequantize=prequantize)
        hs = [eng.submit(p, max_new_tokens=4, arrival_step=i)
              for i, p in enumerate(_prompts(tc.vocab))]
        done = eng.run()
        outs.append([done[h.rid] for h in hs])
    assert outs[0] == outs[1]


@pytest.fixture
def port_engine():
    _, tc = _cfgs("plam_sim:16:1")
    eng, _ = _port_engine(tc, prequantize=True)
    return eng


def test_engine_scrubs_stale_blocks_in_place(port_engine):
    """Retirement zeroes, in place, the block holding prefill padding that
    was never committed; committed-only blocks are left as they are."""
    eng = port_engine
    pools = (eng._k_pool, eng._v_pool)
    h = eng.submit(list(range(1, 11)), max_new_tokens=4)
    eng.step()
    blocks = list(h.alloc.blocks)
    assert len(blocks) == 2  # 10-token prompt padded to 16
    assert bool(eng._k_pool[:, blocks[1]].any())
    eng.run()
    assert h.state is RequestState.FINISHED and len(h.output) == 4
    assert (eng._k_pool, eng._v_pool) == pools  # same storage, updated in place
    assert not bool(eng._k_pool[:, blocks[1]].any())
    assert not bool(eng._v_pool[:, blocks[1]].any())
    assert bool(eng._k_pool[:, blocks[0]].any())
    assert eng.allocator.num_free == NB - 1


def test_engine_result_and_cancel(port_engine):
    eng = port_engine
    a = eng.submit(list(range(5, 17)), max_new_tokens=3)
    b = eng.submit(list(range(7, 19)), max_new_tokens=6)
    assert a.result() == a.output and len(a.output) == 3
    b.cancel()
    assert b.state is RequestState.CANCELLED
    assert not eng.scheduler.has_work()
    assert eng.allocator.num_free == NB - 1


def test_engine_deadline_expiry():
    now = [0.0]
    _, tc = _cfgs("f32")
    eng, _ = _port_engine(tc, clock=lambda: now[0])
    h = eng.submit(list(range(1, 9)), max_new_tokens=8, deadline_s=1.0)
    eng.step()
    now[0] = 5.0
    finished = eng.step()
    assert h.request in finished and h.state is RequestState.CANCELLED
    assert eng.stats.deadline_cancelled == 1 and 1 <= len(h.output) < 8


def test_engine_sampling_is_seeded():
    _, tc = _cfgs("f32")
    outs = []
    for seed in (1, 1, 2):
        eng, _ = _port_engine(tc, temperature=1.0, seed=seed)
        outs.append(eng.submit(list(range(3, 13)), max_new_tokens=6).result())
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]


def test_engine_rejects_oversized_request(port_engine):
    with pytest.raises(ValueError, match="max_seq_len"):
        port_engine.submit(list(range(30)), max_new_tokens=8)


@pytest.mark.parametrize("field,value", [
    ("tp", 2), ("engine", "static"),
    ("spec_draft", "model:yi-6b"),
])
def test_later_slice_options_raise(field, value):
    _, tc = _cfgs("f32")
    opts = {field: value}
    if field == "spec_draft":
        opts["spec_k"] = 2  # the drafter is made only when speculative decoding is on
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_engine(tc, ServeOptions(**opts), device="cpu")
