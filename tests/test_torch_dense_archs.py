"""The three dense archs beside yi-6b against the JAX reference: gemma-7b
(GeGLU, head_dim 256, tied and scaled embeddings), minitron-8b (a
squared-ReLU MLP without a gate, untied) and command-r-plus-104b (12
query heads a kv head, tied embeddings), at their reduced sizes with f32
parameters and activations.

The same weights (the port's seeded init, carried to the reference with
``params_to_jax``) and the same prompts go through both packages'
engines.  The continuous engine runs the paged prefill and decode step,
the static engine the contiguous prefill and decode step: each call's
logits are held to the reference engine's same call within 2e-3 of the
call's largest |logit| (at least 1), with the same argmax, under ``f32``
and under ``plam_sim:16:1`` (the port's continuous engine with its
weights prequantized to int16 at build, its static engine with them kept
float, against the reference's engines on the same int16 patterns, which
have the same values); the greedy tokens are equal.  The
engines keep K/V in bf16, where an f32 value one ulp apart can round to
the next bf16 step: that moves a logit by up to 1.6e-3 in f32 (gemma,
|logits| up to 2.6), and a posit pattern one step apart by up to 6.1e-3
under plam_sim (gemma, |logits| up to 7.5).  With f32 caches the f32
prefill agrees within 1e-5.  Also: the port's
``ARCHS`` is the reference's, config for config, and
``build_engine(engine="auto")`` picks the reference's engine kind for
every family.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JContinuous  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import PagedServeConfig as JPagedCfg  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro.serving import ServeOptions as JServeOptions  # noqa: E402
from repro.serving import build_engine as j_build_engine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.prequant import quantize_params as t_quantize  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.serving import Engine, ServeConfig, ServeOptions, build_engine  # noqa: E402

from test_torch_ssm import one_thread  # noqa: E402,F401

DENSE = ("gemma-7b", "minitron-8b", "command-r-plus-104b")
PLAM = "plam_sim:16:1"
TOL = 2e-3  # of the call's largest |logit| (at least 1)
F32_TOL = 1e-5  # f32 with f32 caches
BS, NB, SLOTS, MAX_LEN = 8, 32, 2, 32
PROMPTS = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(np.int32)
NEW = 4

pytestmark = pytest.mark.usefixtures("one_thread")


def _cfgs(arch, policy):
    j = dataclasses.replace(j_configs.get_config(arch).reduced(), param_dtype="float32",
                            act_dtype="float32")
    t = dataclasses.replace(t_configs.get_config(arch).reduced(), param_dtype="float32",
                            act_dtype="float32")
    return j.with_numerics(f"default={policy}"), t.with_numerics(f"default={policy}")


@functools.lru_cache(maxsize=None)
def weights(arch, policy="f32"):
    """The port's seeded f32 init of the reduced config as the reference's
    tree of numpy arrays; under plam_sim with the port's int16 patterns of
    the prequantized weights (the reference's own, bit for bit:
    ``test_torch_model.py``)."""
    _, tc = _cfgs(arch, policy)
    model = t_build(tc).init(seed=0, device="cpu")
    return params_to_jax(t_quantize(tc, model)[0] if policy == PLAM else model)


def check_logits(got, want, tol=TOL):
    """Call by call: the same shapes, the same argmax, within ``tol`` of
    the call's largest |logit| (at least 1)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1.0, float(np.abs(w).max())))
        assert np.array_equal(g.argmax(-1), w.argmax(-1))


def _capture(fn, into):
    """fn, with the logits (its first output) of each call kept in ``into``."""
    def call(*args, **kw):
        out = fn(*args, **kw)
        into.append(np.asarray(out[0], np.float32).copy() if not torch.is_tensor(out[0])
                    else out[0].float().numpy().copy())
        return out
    return call


def _serve(eng, kinds, logits):
    """Wrap the port engine's model API calls of ``kinds`` to capture their
    logits."""
    eng.api = dataclasses.replace(eng.api, **{k: _capture(getattr(eng.api, k), logits)
                                              for k in kinds})
    return eng


@functools.lru_cache(maxsize=None)
def reference_runs(arch, policy):
    """The reference's continuous engine (the two prompts one step apart
    over two slots) and static engine on the same weights, prequantized
    under plam_sim: (tokens, logits of each forward) of each."""
    jc, _ = _cfgs(arch, policy)
    jp = jax.tree.map(jnp.asarray, weights(arch, policy))
    cont_logits, static_logits = [], []
    eng = JContinuous(jc, params=jp, pcfg=JPagedCfg(block_size=BS, num_blocks=NB,
                                                     max_slots=SLOTS, max_seq_len=MAX_LEN))
    eng._prefill, eng._decode = (_capture(eng._prefill, cont_logits),
                                 _capture(eng._decode, cont_logits))
    hs = [eng.submit(p.tolist(), max_new_tokens=NEW, arrival_step=i)
          for i, p in enumerate(PROMPTS)]
    done = eng.run()
    static = JEngine(jc, params=jp)
    static._prefill, static._decode = (_capture(static._prefill, static_logits),
                                       _capture(static._decode, static_logits))
    out = static.generate({"tokens": jnp.asarray(PROMPTS)}, JServeConfig(max_new_tokens=NEW))
    return ([done[h.rid] for h in hs], cont_logits, np.asarray(out).tolist(), static_logits)


@pytest.mark.parametrize("policy", ["f32", PLAM])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_engines_match_reference(arch, policy):
    """The continuous engine (paged prefill and decode; under plam_sim
    with prequantized weights) and the static engine (contiguous prefill
    and decode; float weights): every forward's logits and the greedy
    tokens."""
    want_cont, want_cont_logits, want_static, want_static_logits = reference_runs(arch, policy)
    _, tc = _cfgs(arch, policy)
    tree = weights(arch)
    _lib.reset_launches()
    opts = ServeOptions(block_size=BS, num_blocks=NB, max_slots=SLOTS, max_seq_len=MAX_LEN,
                        prequantize=policy == PLAM)
    logits = []
    eng = _serve(build_engine(tc, opts, params=params_from_jax(tree, tc, device="cpu"),
                              device="cpu"), ("paged_prefill", "paged_decode_step"), logits)
    assert eng.prequant_meta or policy == "f32"
    hs = [eng.submit(p.tolist(), max_new_tokens=NEW, arrival_step=i)
          for i, p in enumerate(PROMPTS)]
    done = eng.run()
    assert [done[h.rid] for h in hs] == want_cont
    check_logits(logits, want_cont_logits)
    logits = []
    static = _serve(build_engine(tc, ServeOptions(engine="static"),
                                 params=params_from_jax(tree, tc, device="cpu"), device="cpu"),
                    ("prefill", "decode_step"), logits)
    assert isinstance(static, Engine) and not static.prequant_meta
    out = static.generate({"tokens": PROMPTS}, ServeConfig(max_new_tokens=NEW))
    assert out.tolist() == want_static
    check_logits(logits, want_static_logits)
    assert all(v == 0 for v in _lib.launches.values())  # CPU: plain versions only


@pytest.mark.parametrize("arch", DENSE)
def test_dense_f32_prefill_with_f32_caches_matches_reference(arch):
    jc, tc = _cfgs(arch, "f32")
    tree = weights(arch)
    want, _ = j_tf.prefill(jc, jax.tree.map(jnp.asarray, tree), jnp.asarray(PROMPTS),
                           j_tf.kv_cache_init(jc, 2, PROMPTS.shape[1], jnp.float32))
    got, _ = t_tf.prefill(tc, params_from_jax(tree, tc, device="cpu"), torch.from_numpy(PROMPTS),
                          t_tf.kv_cache_init(tc, 2, PROMPTS.shape[1], torch.float32, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)


def test_archs_and_configs_match_reference():
    """The port knows the reference's ten architectures, each config equal
    field for field (the numerics compared by their fields)."""
    assert list(t_configs.ARCHS) == list(j_configs.ARCHS)
    for name in j_configs.ARCHS:
        j, t = j_configs.get_config(name), t_configs.get_config(name)
        for f in dataclasses.fields(j):
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            if f.name == "numerics":
                jv, tv = dataclasses.asdict(jv), dataclasses.asdict(tv)
            assert jv == tv, (name, f.name)
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


@pytest.mark.parametrize("arch", list(j_configs.ARCHS))
def test_build_engine_auto_picks_the_reference_engine(arch):
    """engine="auto" picks the continuous engine for the paged families
    and the static one for the others, as the reference's build_engine."""
    jc = dataclasses.replace(j_configs.get_config(arch).reduced(), param_dtype="float32",
                             act_dtype="float32")
    tc = dataclasses.replace(t_configs.get_config(arch).reduced(), param_dtype="float32",
                             act_dtype="float32")
    want = type(j_build_engine(jc, JServeOptions(), params={})).__name__
    got = type(build_engine(tc, ServeOptions(), device="cpu")).__name__
    assert got == want == ("ContinuousBatchingEngine" if tc.family in ("dense", "moe")
                           else "Engine")
