"""Tensor-parallel serving: the port's continuous engine at tp = 2, two
``gloo`` ranks on the CPU, against the JAX engine at tp = 1 (the engine
features at tp = 2 are in ``tests/test_torch_tp_features.py`` and the
prequantized ``plam_sim`` case in ``tests/test_torch_tp_plam.py``, which
import the cases and helpers here).

The reference's own bar is greedy-token identity between its tp = 2 and
tp = 1 engines (``tests/test_tp_chunked_serving.py::_TP_SCRIPT`` and the
three other ``test_tp2_*_forced_devices`` tests); those need a forced
multi-device jax platform, which fails in this environment, so the port
is held to the tp = 1 JAX engine's tokens, the reference's own claim.
The cases mirror those scripts: the toy config under ``posit_quant:16:1``
in f32 with kv = 2 (the kv heads cut over the ranks, chunked prefill 8)
and kv = 1 (the replicated-kv-head fallback, chunked prefill 4); n-gram
speculative decoding; recompute preemption on a pressure pool; the
prefix cache; then reduced yi-6b under ``plam_sim:16:1`` with its
weights prequantized on each rank after the cut.  The gathered prefill
logits at tp = 2 are held to tp = 1's within an f32 tolerance.

Each file's port runs go through ONE spawned world of two ranks
(``launch/mesh.py::spawn`` of ``launch/serve.py::serve_jobs``); weights
come from the reference's init through ``params_from_jax`` and are cut
by the engine (``shard_model``).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JCfg  # noqa: E402
from repro.core.modes import NumericsConfig as JNum  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import PagedServeConfig as JPaged  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TCfg  # noqa: E402
from repro_torch.core.modes import NumericsConfig as TNum  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.serve import serve_jobs  # noqa: E402
from repro_torch.serving import ServeOptions, build_engine  # noqa: E402

from test_torch_chunked import _numpy_tree  # noqa: E402

TP = 2
# (f): the same f32 arithmetic with the row-parallel projections' sums
# split in two and added once more; a few ulp of logits of size ~1
LOGIT_TOL = 1e-5


def _toy(n_kv, numerics="posit_quant"):
    """The reference scripts' toy config, in both packages."""
    kw = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv=n_kv,
              head_dim=8, d_ff=64, vocab=61, act_dtype="float32", param_dtype="float32")
    return (JCfg(**kw, numerics=JNum(mode=numerics, n=16, es=1)),
            TCfg(**kw, numerics=TNum(mode=numerics, n=16, es=1)))


def _yi_plam():
    red = dict(param_dtype="float32", act_dtype="float32")
    return (dataclasses.replace(j_get_config("yi-6b").reduced(), **red)
            .with_numerics("default=plam_sim:16:1"),
            dataclasses.replace(t_get_config("yi-6b").reduced(), **red)
            .with_numerics("default=plam_sim:16:1"))


def _requests(prompts, max_new, arrivals=None):
    arrivals = arrivals or list(range(len(prompts)))
    return [dict(prompt=p, max_new_tokens=max_new, arrival_step=a)
            for p, a in zip(prompts, arrivals)]


def _cases():
    """name -> (configs, JAX init key, requests, the JAX engine's pool at
    tp = 1, the port's ServeOptions at tp = 2).  The prompts are the
    reference scripts'."""
    cases = {}
    kv2, kv1 = _toy(2), _toy(1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, n).tolist() for n in (3, 9, 17, 6)]
    prompts1 = [rng.integers(0, 61, n).tolist() for n in (5, 11)]
    pool = dict(block_size=4, num_blocks=64, max_slots=3, max_seq_len=32)
    cases["chunked-kv2"] = (kv2, 0, _requests(prompts, 5), pool,
                            dict(pool, prefill_chunk=8))
    cases["chunked-kv1"] = (kv1, 1, _requests(prompts1, 4), pool,
                            dict(pool, prefill_chunk=4))
    # the engine features' reference runs use no feature: the greedy tokens
    # are the same with them or without (the reference's own bar)
    rng = np.random.default_rng(0)
    spec_prompts = [rng.integers(0, 61, n).tolist() for n in (3, 9, 17)]
    for chunk, k in ((0, 2), (8, 4)):
        cases[f"spec-chunk{chunk}-k{k}"] = (kv2, 0, _requests(spec_prompts, 5), pool,
                                            dict(pool, prefill_chunk=chunk, spec_k=k))
    rng = np.random.default_rng(0)
    pa, pb = rng.integers(0, 61, 8).tolist(), rng.integers(0, 61, 8).tolist()
    small = dict(block_size=4, max_slots=2, max_seq_len=32)
    for chunk, k in ((0, 0), (4, 2)):
        cases[f"preempt-chunk{chunk}-k{k}"] = (
            kv2, 0, _requests([pa, pb], 12), dict(small, num_blocks=64),
            dict(small, num_blocks=8, prefill_chunk=chunk, spec_k=k, preemption="recompute"))
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 61, 16).tolist()
    tails = [rng.integers(0, 61, 3 + i).tolist() for i in range(3)]
    big = dict(block_size=4, num_blocks=64, max_slots=3, max_seq_len=48)
    for chunk, k in ((0, 0), (4, 2)):
        cases[f"prefix-chunk{chunk}-k{k}"] = (
            kv2, 0, _requests([shared + t for t in tails], 6, [0, 10, 20]), big,
            dict(big, prefill_chunk=chunk, spec_k=k, prefix_cache=True))
    rng = np.random.default_rng(0)
    mixed = [rng.integers(0, 512, n).tolist() for n in (3, 9, 17, 6)]
    yi_pool = dict(block_size=4, num_blocks=96, max_slots=3, max_seq_len=48, prefill_chunk=8,
                   prequantize=True)
    cases["yi-plam-prequantized"] = (_yi_plam(), 0, _requests(mixed, 4), yi_pool, yi_pool)
    return cases


CASES = _cases()
_PARAMS = {}
_TOKENS = {}


def _jax_params(cfgs, seed):
    key = (cfgs[0], seed)
    if key not in _PARAMS:
        _PARAMS[key] = j_build(cfgs[0]).init(jax.random.PRNGKey(seed))
    return _PARAMS[key]


def jax_tokens(name):
    """The JAX engine's tokens at tp = 1 on the case's requests (one run
    for the cases that share its config, requests and pool)."""
    cfgs, seed, requests, pool, _ = CASES[name]
    key = repr((cfgs[0], seed, requests, sorted(pool.items())))
    if key not in _TOKENS:
        eng = JEngine(cfgs[0], params=_jax_params(cfgs, seed), pcfg=JPaged(**pool))
        hs = [eng.submit(**req) for req in requests]
        done = eng.run()
        _TOKENS[key] = [done[h.rid] for h in hs]
    return _TOKENS[key]


def _logits_job():
    cfgs = _toy(2, "f32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 61, n).tolist() for n in (3, 9, 17)]
    return cfgs, dict(cfg=cfgs[1], requests=_requests(prompts, 2), prefill_logits=True,
                      params=_numpy_tree(_jax_params(cfgs, 0)),
                      opts=ServeOptions(block_size=4, num_blocks=64, max_slots=3,
                                        max_seq_len=32, tp=TP))


def serve_cases(names, extra=None):
    """The named cases (and ``extra``, name -> job) on the port at tp = 2,
    in one world of two CPU ranks: name -> [rank 0's result, rank 1's]."""
    jobs = {}
    for name in names:
        cfgs, seed, requests, _, opts = CASES[name]
        jobs[name] = dict(cfg=cfgs[1], params=_numpy_tree(_jax_params(cfgs, seed)),
                          requests=requests, opts=ServeOptions(tp=TP, **opts))
    jobs.update(extra or {})
    ranks = spawn(serve_jobs, TP, "cpu", list(jobs.values()), threads=1, timeout=300)
    return {name: [r[i] for r in ranks] for i, name in enumerate(jobs)}


@pytest.fixture(scope="module")
def served():
    return serve_cases(["chunked-kv2", "chunked-kv1"], {"logits": _logits_job()[1]})


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (``tests/test_torch_ssm.py::one_thread``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same_on_both_ranks(res):
    assert res[0]["outputs"] == res[1]["outputs"]
    assert res[0]["stats"] == res[1]["stats"]
    return res[0]


@pytest.mark.parametrize("name,layout,kv_heads", [
    ("chunked-kv2", "kv_heads", 1), ("chunked-kv1", "replicated_kv_heads", 1)])
def test_tp2_chunked_prefill_matches_the_reference_tp1(served, name, layout, kv_heads):
    """``_TP_SCRIPT``'s two layouts: kv = 2 divides tp (each rank one kv
    head of the pool) and kv = 1 (the replicated-kv-head fallback)."""
    res = same_on_both_ranks(served[name])
    assert res["pool_layout"] == layout and res["kv_heads"] == kv_heads
    assert res["outputs"] == jax_tokens(name)
    assert res["stats"]["prefills"] > len(CASES[name][2])  # the 17/11-token prompts chunked


def test_tp2_prefill_logits_match_tp1(served):
    """The gathered prefill logits at tp = 2 against tp = 1 (the port, no
    world) within LOGIT_TOL: the f32 reduce order is the one difference."""
    _, job = _logits_job()
    res = served["logits"]
    want = serve_jobs("cpu", [dict(job, opts=dataclasses.replace(job["opts"], tp=1))])[0]
    for rank in res:
        assert rank["outputs"] == want["outputs"]
        for got, ref in zip(rank["logits"], want["logits"]):
            assert got.shape == ref.shape == (61,)
            np.testing.assert_allclose(got, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_tp_outside_a_world_raises():
    """The engine at tp = 2 needs a world of two ranks."""
    with pytest.raises(ValueError, match="tp=2 needs 2 ranks/devices"):
        build_engine(_toy(2)[1], ServeOptions(tp=TP), device="cpu")
