"""The port's static engine, its CLI branch and the draft-model drafter
against the JAX reference (``repro/serving/engine.py::Engine``,
``repro/launch/serve.py`` without ``--continuous``,
``repro/serving/spec.py::DraftModelDrafter``).

At the reduced size with f32 parameters and activations, the same
weights (the reference's init converted with ``params_from_jax``) and the
same prompts: the port's ``Engine`` gives the JAX ``Engine``'s greedy
tokens and ``ServeStats`` counters for the dense, MoE, ssm and hybrid
families, under ``f32`` and under ``plam_sim:16:1`` with prequantized
weights and without (one reference run a family and mode: prequantizing
is value-identical, and the reference's prequantized run is the one
compared).  ``build_engine("auto")`` picks the static engine for ssm and
hybrid, and for encdec and vlm, which now serve on it (their tokens
against the JAX engine's are held in ``tests/test_torch_encdec.py`` and
``tests/test_torch_vlm.py``).  The CLI's
static tokens equal the JAX CLI's, and a draft model carried across
drafts for the continuous engine with the reference's committed tokens
and counters.
"""
import dataclasses
import functools
import re
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JContinuous  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import PagedServeConfig as JPagedCfg  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.spec import DraftModelDrafter as JDraft  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    DraftModelDrafter,
    Engine,
    ServeConfig,
    ServeOptions,
    build_engine,
)

from test_torch_chunked import _numpy_tree  # noqa: E402
from test_torch_ssm import one_thread  # noqa: E402,F401
from test_torch_train_loss import assert_trains  # noqa: E402

ARCHS = {"dense": "yi-6b", "moe": "deepseek-moe-16b", "ssm": "mamba2-780m",
         "hybrid": "zamba2-1.2b"}
PLAM = "plam_sim:16:1"
# the counters both engines fill
STATS = ("steps", "prefills", "prefill_tokens", "decode_steps", "active_slot_steps",
         "idle_slot_steps", "generated_tokens")
COUNTERS = ("serve_steps_total", "serve_prefills_total", "serve_prefill_tokens_total",
            "serve_decode_steps_total", "serve_generated_tokens_total")
PROMPTS = np.random.default_rng(0).integers(0, 512, (3, 10)).astype(np.int32)
NEW = 5

pytestmark = pytest.mark.usefixtures("one_thread")


def _cfgs(arch, policy):
    j = dataclasses.replace(j_get_config(arch).reduced(), param_dtype="float32",
                            act_dtype="float32")
    t = dataclasses.replace(t_get_config(arch).reduced(), param_dtype="float32",
                            act_dtype="float32")
    return j.with_numerics(f"default={policy}"), t.with_numerics(f"default={policy}")


@functools.lru_cache(maxsize=None)
def weights(arch):
    jc, _ = _cfgs(arch, "f32")
    return jax.jit(j_build(jc).init)(jax.random.PRNGKey(0))


def _counters(eng):
    snap = eng.metrics.snapshot()
    return {k: v for k, v in snap.items() if k in COUNTERS}


@functools.lru_cache(maxsize=None)
def reference_run(arch, policy):
    """The JAX engine's tokens, counters and prequant record (weights
    prequantized under plam_sim)."""
    jc, _ = _cfgs(arch, policy)
    eng = JEngine(jc, params=weights(arch), prequantize=policy == PLAM)
    out = eng.generate({"tokens": jnp.asarray(PROMPTS)},
                       JServeConfig(max_new_tokens=NEW, time_steps=True))
    stats = {f: getattr(eng.stats, f) for f in STATS}
    return (np.asarray(out).tolist(), stats, len(eng.stats.step_latency_s),
            _counters(eng), eng.prequant_meta)


@pytest.mark.parametrize("policy,prequantize", [("f32", False), (PLAM, True), (PLAM, False)],
                         ids=["f32", "plam-prequantized", "plam"])
@pytest.mark.parametrize("family", list(ARCHS))
def test_static_engine_matches_reference(family, policy, prequantize):
    arch = ARCHS[family]
    want, stats, n_lat, counters, meta = reference_run(arch, policy)
    _, tc = _cfgs(arch, policy)
    model = params_from_jax(_numpy_tree(weights(arch)), tc, device="cpu")
    _lib.reset_launches()
    eng = build_engine(tc, ServeOptions(engine="static", prequantize=prequantize),
                       params=model, device="cpu")
    assert isinstance(eng, Engine)
    out = eng.generate({"tokens": PROMPTS}, ServeConfig(max_new_tokens=NEW, time_steps=True))
    assert out.dtype == torch.int32 and out.shape == (3, NEW)
    assert out.tolist() == want
    assert {f: getattr(eng.stats, f) for f in STATS} == stats
    assert len(eng.stats.step_latency_s) == n_lat == NEW
    assert _counters(eng) == counters
    if prequantize:
        assert eng.prequant_meta == meta
    assert all(v == 0 for v in _lib.launches.values())  # CPU: plain versions only


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_build_engine_auto_picks_static(family):
    _, tc = _cfgs(ARCHS[family], "f32")
    eng = build_engine(tc, ServeOptions(), device="cpu")
    assert isinstance(eng, Engine)
    out = eng.generate({"tokens": PROMPTS[:1]}, ServeOptions(max_new_tokens=3).static())
    assert out.shape == (1, 3)
    with pytest.raises(ValueError, match="no paged KV layout"):
        build_engine(tc, ServeOptions(engine="continuous"), device="cpu")
    _, dense = _cfgs("yi-6b", "f32")
    assert isinstance(build_engine(dense, ServeOptions(), device="cpu"),
                      ContinuousBatchingEngine)


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_later_families_still_raise(family):
    """encdec and vlm, once a later slice, now build and serve on the
    static engine (``engine="static"`` and ``"auto"``); the continuous
    engine refuses them as the reference does (no paged KV layout), and
    the served model trains (the name is older than that): one AdamW
    step gives a finite loss and a gradient on every float leaf."""
    arch = {"encdec": "seamless-m4t-medium", "vlm": "qwen2-vl-72b"}[family]
    _, tc = _cfgs(arch, "f32")
    rng = np.random.default_rng(1)
    batch = {"tokens": PROMPTS[:1]}
    if family == "encdec":
        batch["frames"] = rng.standard_normal((1, 8, tc.frontend_dim)).astype(np.float32)
    else:
        batch["embeds_prefix"] = rng.standard_normal((1, 16, tc.d_model)).astype(np.float32)
    for engine in ("static", "auto"):
        eng = build_engine(tc, ServeOptions(engine=engine), device="cpu")
        assert isinstance(eng, Engine)
        out = eng.generate(batch, ServeOptions(max_new_tokens=3).static())
        assert out.shape == (1, 3)
    with pytest.raises(ValueError, match="no paged KV layout"):
        build_engine(tc, ServeOptions(engine="continuous"), device="cpu")
    assert_trains(eng.api, eng.model, dict(batch, labels=batch["tokens"]))



def test_static_sampling_is_seeded():
    _, tc = _cfgs("mamba2-780m", "f32")
    model = params_from_jax(_numpy_tree(weights("mamba2-780m")), tc, device="cpu")
    eng = Engine(tc, params=model, device="cpu")
    runs = [eng.generate({"tokens": PROMPTS}, ServeConfig(max_new_tokens=4, temperature=1.0,
                                                          seed=s)).tolist()
            for s in (1, 1, 2)]
    assert runs[0] == runs[1] != runs[2]


def test_cli_static_tokens_match_reference(monkeypatch, capsys):
    """``--arch mamba2-780m --reduced`` without ``--continuous``: the
    summary line without its times, and every ``batch[i]`` row, equal the
    JAX CLI's on the same weights (f32: the engine's plam_sim tokens are
    held above)."""
    import repro_torch.serving as t_serving

    argv = ["--arch", "mamba2-780m", "--reduced", "--batch", "3", "--prompt-len", "10",
            "--new-tokens", "4", "--seed", "3", "--numerics-policy", "default=f32"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    want = capsys.readouterr().out.splitlines()

    jc, tc = _cfgs("mamba2-780m", "f32")
    model = params_from_jax(_numpy_tree(j_build(jc).init(jax.random.PRNGKey(3))), tc,
                            device="cpu")
    build = t_serving.build_engine
    monkeypatch.setattr(t_serving, "build_engine",
                        lambda cfg, opts, init_seed, device: build(
                            cfg, opts, params=model, device=device))
    t_serve.main(argv + ["--device", "cpu", "--trace-out", "t.jsonl"])
    got = capsys.readouterr().out.splitlines()

    def summary(line):
        return re.sub(r" step_p(50|95)=[0-9.]+ms", "", line)

    assert summary(got[0]) == summary(want[0])
    rows = [ln for ln in got if ln.startswith("batch[")]
    assert len(rows) == 3 and rows == [ln for ln in want if ln.startswith("batch[")]
    assert got[-1] == "trace-out skipped: engine has no trace (static engine or trace=False): " \
                      "t.jsonl"


@pytest.mark.parametrize("flag", [["--prefill-chunk", "8"], ["--opt", "spec_k=2"],
                                  ["--opt", "priority=1"]])
def test_cli_static_rejects_continuous_options(flag):
    with pytest.raises(SystemExit, match="require --continuous"):
        t_serve.main(["--arch", "mamba2-780m", "--reduced", "--device", "cpu"] + flag)


def test_draft_model_drafter_matches_reference():
    """A 1-layer draft of the reduced yi-6b's widths (its own weights,
    carried across) drafts k = 2 for the f32 target on the continuous
    engine: the committed tokens, the verify counters and the drafter's
    own counters equal the reference's."""
    jc, tc = _cfgs("yi-6b", "f32")
    jd, td = (dataclasses.replace(c, n_layers=1) for c in (jc, tc))
    jdp = jax.jit(j_build(jd).init)(jax.random.PRNGKey(7))
    jdraft = JDraft(jd, jc, params=jdp)
    tdraft = DraftModelDrafter(td, tc, params=params_from_jax(_numpy_tree(jdp), td,
                                                              device="cpu"), device="cpu")
    pool = dict(block_size=4, num_blocks=64, max_slots=2, max_seq_len=40, spec_k=2)
    jeng = JContinuous(jc, params=weights("yi-6b"), pcfg=JPagedCfg(**pool, spec_draft=jdraft))
    teng = build_engine(tc, ServeOptions(**pool, spec_draft=tdraft),
                        params=params_from_jax(_numpy_tree(weights("yi-6b")), tc,
                                               device="cpu"), device="cpu")
    outs = []
    for eng in (jeng, teng):
        hs = [eng.submit(p.tolist(), max_new_tokens=6, arrival_step=i)
              for i, p in enumerate(PROMPTS)]
        done = eng.run()
        outs.append([done[h.rid] for h in hs])
    assert outs[1] == outs[0]
    for f in ("spec_steps", "drafted_tokens", "accepted_tokens", "steps"):
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    assert (tdraft.proposals, tdraft.proposed_tokens) == (jdraft.proposals,
                                                          jdraft.proposed_tokens)
    assert tdraft.proposals > 0
    with pytest.raises(ValueError, match="shared tokenizer"):
        DraftModelDrafter(dataclasses.replace(td, vocab=td.vocab + 1), tc, device="cpu")
