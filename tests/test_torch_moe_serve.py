"""The engine features and the serving CLI on the MoE family against the
JAX reference: chunked prefill, n-gram speculative decoding, recompute
preemption and the prefix cache, each against the reference engine with
the same feature on (a MoE forward couples its rows, so a feature that
changes a forward's rows may change tokens: never compared with the
feature-off run), and ``--arch deepseek-moe-16b --reduced --device cpu``
against the JAX CLI.  Models and helpers come from
``tests/test_torch_moe_engine.py``.

Under f32 both engines give the same tokens.  Under the card's serving
numerics (prequantized int16 ``plam_sim`` weights, the experts through
the grouped plain K1) the port agrees with the reference per forward,
within the plam_sim logit tolerance of ``tests/test_torch_model.py``,
and not bit for bit (a prefill's f32 attention adds in another order),
so a router near-tie may pick another expert a few steps on and part
the two engines' streams.  So every forward the port's engine makes
under each feature is replayed through the reference's function on the
same inputs: its logits and the K/V it writes must agree (outside the
scratch block, whose content both packages leave unspecified: no live
mask admits it).
"""
import dataclasses
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.prequant import quantize_params as j_quantize  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.serving import ServeOptions, build_engine  # noqa: E402
from repro_torch.serving.kv_cache import SCRATCH_BLOCK  # noqa: E402

from test_torch_chunked import _mixed, _numpy_tree, serve_both  # noqa: E402
from test_torch_moe_engine import POOL, _weights, models  # noqa: E402
from test_torch_prefix_cache import _shared_prefix  # noqa: E402
from test_torch_preemption import PRESSURE, _two  # noqa: E402

# tests/test_torch_model.py's plam_sim logit tolerance: an f32 input one
# ulp apart can move a posit pattern by one step (2^-12 relative)
TOL = 2e-2
# the model entry points an engine calls, each (model, tokens, k_pool,
# v_pool, ...) -> (logits, pools), the pools written in place by the port
FORWARDS = ("paged_prefill", "paged_prefill_chunk", "paged_score_tokens",
            "paged_decode_step")
PREFIX = dict(prefix_cache=True, block_size=4, num_blocks=64, max_slots=4, max_seq_len=48)


@pytest.mark.parametrize("feature", [
    dict(prefill_chunk=8), dict(spec_k=2), dict(prefill_chunk=8, spec_k=2),
], ids=["chunk8", "spec2", "chunk8-spec2"])
def test_moe_engine_features_match_reference(feature):
    """Chunked prefill and n-gram speculative decoding, each against the
    reference engine with the same feature on."""
    serve_both(models("deepseek", "f32"), lambda e: _mixed(e, max_new=4), **POOL, **feature)


def test_moe_engine_preemption_matches_reference():
    jeng, teng, _ = serve_both(models("deepseek", "f32"), _two, **PRESSURE)
    assert teng.stats.preemptions > 0, "pool pressure never forced an eviction"
    assert teng.stats.resume_latency_steps == jeng.stats.resume_latency_steps


def test_moe_engine_prefix_cache_matches_reference():
    jeng, teng, _ = serve_both(models("granite", "f32"), _shared_prefix, **PREFIX)
    assert teng.allocator.hits > 0 and teng.allocator.hits == jeng.allocator.hits
    assert teng.allocator.tokens_saved == jeng.allocator.tokens_saved


def _recording(teng):
    """Wrap the port engine's forwards: each call is kept with its inputs
    (the pools copied before it), its logits and the pools after it."""
    calls = []

    def wrap(name, fn):
        def forward(model, *args, use_kernel=None):
            before = [a.clone() if torch.is_tensor(a) else a for a in args]
            out = fn(model, *args, use_kernel=use_kernel)
            calls.append((name, before, out[0].clone(), args[1].clone(), args[2].clone()))
            return out
        return forward

    teng.api = dataclasses.replace(teng.api, **{n: wrap(n, getattr(teng.api, n))
                                                for n in FORWARDS})
    return calls


def _to_jax(a):
    if not torch.is_tensor(a):
        return jnp.int32(a)
    if a.dtype == torch.bfloat16:
        return jnp.asarray(a.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16))
    return jnp.asarray(a.numpy())


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("arch,workload,opts", [
    ("deepseek", lambda e: _mixed(e, max_new=4), dict(POOL, prefill_chunk=8)),
    ("deepseek", lambda e: _mixed(e, max_new=4), dict(POOL, spec_k=2)),
    ("deepseek", lambda e: _mixed(e, max_new=4), dict(POOL, prefill_chunk=8, spec_k=2)),
    ("deepseek", _two, PRESSURE),
    ("granite", _shared_prefix, PREFIX),
], ids=["chunk8", "spec2", "chunk8-spec2", "preemption", "prefix-cache"])
def test_moe_engine_features_prequantized_plam_match_reference_per_forward(arch, workload,
                                                                             opts):
    """The card's serving numerics under each feature: every forward of
    the port's engine (prefill, chunk, verify, decode, a resume, a prefix
    hit) against the reference's function on the same tokens, pools and
    tables; the logits and both written pools (but the scratch block)
    within TOL.  The weights' meta equals the reference's, and the
    feature was engaged."""
    jc, jp, tc, tm = models(arch, "plam_sim:16:1", fresh=True)
    teng = build_engine(tc, ServeOptions(prequantize=True, **opts), params=tm, device="cpu")
    calls = _recording(teng)
    out = workload(teng)
    jq, meta = j_quantize(jc, jp)
    assert teng.prequant_meta == meta
    assert all(len(o) > 0 and all(0 <= t < tc.vocab for t in o) for o in out)
    api = j_build(jc)
    fns = {n: jax.jit(getattr(api, n)) for n in FORWARDS}
    for i, (name, args, logits, k_pool, v_pool) in enumerate(calls):
        jl, (jk, jv) = fns[name](jq, *[_to_jax(a) for a in args])
        _close(logits, jl, f"forward {i} ({name}): logits")
        live = [b for b in range(k_pool.shape[1]) if b != SCRATCH_BLOCK]
        _close(k_pool[:, live], jk[:, np.array(live)], f"forward {i} ({name}): K pool")
        _close(v_pool[:, live], jv[:, np.array(live)], f"forward {i} ({name}): V pool")
    kinds = {c[0] for c in calls}
    st = teng.stats
    if opts.get("prefill_chunk"):
        assert "paged_prefill_chunk" in kinds and st.prefills > 4
    if opts.get("spec_k"):
        assert "paged_score_tokens" in kinds
    if opts.get("preemption"):
        assert st.preemptions > 0, "pool pressure never forced an eviction"
    if opts.get("prefix_cache"):
        assert teng.allocator.hits > 0, "the cache never hit"


def test_cli_serves_deepseek_reduced_with_the_reference_tokens(monkeypatch, capsys):
    """``--arch deepseek-moe-16b --reduced --device cpu`` prints the JAX
    CLI's request lines when both serve the same weights (the JAX init at
    the run's seed, converted), prequantized plam_sim."""
    import repro_torch.serving as t_serving

    seed = 3
    argv = ["--arch", "deepseek-moe-16b", "--reduced", "--continuous", "--prequantized",
            "--numerics-policy", "default=plam_sim:16:1", "--batch", "2", "--prompt-len",
            "6", "--new-tokens", "3", "--seed", str(seed)]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    want = capsys.readouterr().out.splitlines()
    jc, jp, tc, _ = _weights("deepseek", seed)
    model = params_from_jax(_numpy_tree(jp), tc, device="cpu")
    build = t_serving.build_engine
    monkeypatch.setattr(t_serving, "build_engine",
                        lambda cfg, opts, init_seed, device: build(
                            cfg, opts, params=model, device=device))
    t_serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    reqs = [ln for ln in got if ln.startswith("req[")]
    assert len(reqs) == 2 and reqs == [ln for ln in want if ln.startswith("req[")]
    assert got[0].startswith("arch=deepseek-moe-16b")
