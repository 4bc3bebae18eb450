"""The port's encdec family (seamless-m4t-medium's backbone,
``repro_torch/models/encdec.py``) against the JAX reference
(``repro/models/encdec.py``, ``repro/models/attention.py``'s
cross-attention, the static engine's encoder cache).

At the reduced size with f32 parameters and activations, the port's
seeded init carried to the reference with ``params_to_jax``: the
encoder, the cross-attention's K/V and its output in f32 within 1e-5;
the prefill with f32 caches, f32 within 1e-5 and ``plam_sim:16:1``
(prequantized in both packages) within 2e-3 with the same argmax, and
the f32 decode step within 1e-5; ``params_to_jax`` and ``params_from_jax`` round trips over
the reference's encdec tree, bit for bit; and the static engine's greedy
tokens, every forward's logits and ``ServeStats`` counters against the
reference ``Engine`` under f32 and under ``plam_sim:16:1`` with
prequantized weights.  The engine keeps K/V in bf16, where an f32 value
one ulp apart can round to the next bf16 step, and plam_sim encodes
every activation onto the posit grid, where one rmsnorm output one f32
ulp apart (as torch's and XLA's are in about a third of the lanes) can
land one pattern apart; the encoder's bidirectional attention spreads
each such step to every position.  So the engine's logits are held
within 2e-3 (f32) and 5e-3 (plam_sim; 2.5e-3 measured) of the call's
largest |logit|.  The stub audio frontend's frames are seeded numpy
arrays.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.policy import bind as j_bind  # noqa: E402
from repro.core.prequant import quantize_params as j_quantize  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.policy import bind  # noqa: E402
from repro_torch.core.prequant import quantize_params as t_quantize  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.serving import Engine, ServeConfig, ServeOptions, build_engine  # noqa: E402

from test_torch_dense_archs import _capture, _serve, check_logits  # noqa: E402
from test_torch_ssm import one_thread  # noqa: E402,F401
from test_torch_train_loss import assert_trains  # noqa: E402

ARCH = "seamless-m4t-medium"
PLAM = "plam_sim:16:1"
F32_TOL, PLAM_TOL = 1e-5, 2e-3  # the functions, with f32 caches
ENGINE_TOL = {"f32": 2e-3, PLAM: 5e-3}  # of the call's largest |logit|, bf16 caches
rng = np.random.default_rng(5)
FRAMES = rng.standard_normal((2, 12, 128)).astype(np.float32)  # [B, S_src, frontend_dim]
TOKENS = rng.integers(0, 512, (2, 6)).astype(np.int32)  # the target prefix
NEW = 4
STATS = ("steps", "prefills", "prefill_tokens", "decode_steps", "active_slot_steps",
         "generated_tokens")

pytestmark = pytest.mark.usefixtures("one_thread")


def _cfgs(policy="f32"):
    j = dataclasses.replace(j_get_config(ARCH).reduced(), param_dtype="float32",
                            act_dtype="float32")
    t = dataclasses.replace(t_get_config(ARCH).reduced(), param_dtype="float32",
                            act_dtype="float32")
    return j.with_numerics(f"default={policy}"), t.with_numerics(f"default={policy}")


@functools.lru_cache(maxsize=None)
def weights():
    """The port's seeded f32 init as the reference's tree of numpy arrays."""
    _, tc = _cfgs()
    return params_to_jax(t_build(tc).init(seed=0, device="cpu"))


def _models(policy="f32"):
    """(jc, jp, tc, tm) on the same weights, prequantized in both packages
    under plam_sim."""
    jc, tc = _cfgs(policy)
    jp = jax.tree.map(jnp.asarray, weights())
    tm = params_from_jax(weights(), tc, device="cpu")
    if policy == PLAM:
        jp, _ = j_quantize(jc, jp)
        tm, _ = t_quantize(tc, tm)
    return jc, jp, tc, tm


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_encode_matches_reference():
    jc, jp, tc, tm = _models()
    want = j_encdec.encode(jc, jp, jnp.asarray(FRAMES))
    got = t_encdec.encode(tc, tm, torch.from_numpy(FRAMES))
    assert got.shape == (2, 12, tc.d_model)
    _close(got, want)


def test_cross_attention_matches_reference():
    """``encode_cross_kv`` and ``cross_attn_apply`` of the first decoder
    block over a seeded encoder output and decoder input."""
    jc, jp, tc, tm = _models()
    enc = np.random.default_rng(6).standard_normal((2, 12, tc.d_model)).astype(np.float32)
    x = np.random.default_rng(7).standard_normal((2, 5, tc.d_model)).astype(np.float32)
    jx = jax.tree.map(lambda a: a[0], jp["dec_layers"]["xattn"])
    heads = dict(n_kv=jc.n_kv, head_dim=jc.hd)
    jk, jv = j_attn.encode_cross_kv(jx, jnp.asarray(enc), j_bind(jc.numerics), **heads)
    txa = tm.dec_layers[0].xattn
    tk, tv = t_attn.encode_cross_kv(txa, torch.from_numpy(enc), bind(tc.numerics), **heads)
    assert tk.shape == (2, 12, tc.n_kv, tc.hd)
    _close(tk, jk)
    _close(tv, jv)
    want = j_attn.cross_attn_apply(jx, jnp.asarray(x), (jk, jv), j_bind(jc.numerics),
                                   n_heads=jc.n_heads, **heads)
    got = t_attn.cross_attn_apply(txa, torch.from_numpy(x), (tk, tv), bind(tc.numerics),
                                  n_heads=tc.n_heads, **heads)
    _close(got, want)


@pytest.mark.parametrize("policy", ["f32", PLAM])
def test_prefill_and_decode_step_match_reference(policy):
    """The prefill (encoder, then the target prefix through the decoder),
    with f32 caches, and in f32 two decode steps over the encoder output
    (under plam_sim the engine test holds the decode steps)."""
    jc, jp, tc, tm = _models(policy)
    tol = F32_TOL if policy == "f32" else PLAM_TOL
    b, s = TOKENS.shape
    jcache = j_encdec.kv_cache_init(jc, b, s + 2, jnp.float32)
    tcache = t_encdec.kv_cache_init(tc, b, s + 2, torch.float32, "cpu")
    want, jcache = jax.jit(functools.partial(j_encdec.prefill, jc))(
        jp, jnp.asarray(FRAMES), jnp.asarray(TOKENS), jcache)
    got, tcache = t_encdec.prefill(tc, tm, torch.from_numpy(FRAMES), torch.from_numpy(TOKENS),
                                   tcache)
    assert got.shape == (b, 1, tc.vocab)
    _close(got, want, tol)
    assert np.array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    if policy == PLAM:
        return
    jenc = jax.jit(functools.partial(j_encdec.encode, jc))(jp, jnp.asarray(FRAMES))
    decode = jax.jit(functools.partial(j_encdec.decode_step, jc))
    tenc = t_encdec.encode(tc, tm, torch.from_numpy(FRAMES))
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    for i in range(2):
        want, jcache = decode(jp, jnp.asarray(tok), jenc, jcache, jnp.int32(s + i))
        got, tcache = t_encdec.decode_step(tc, tm, torch.from_numpy(tok), tenc, tcache, s + i)
        _close(got, want, tol)
        assert np.array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
        tok = np.asarray(want).argmax(-1).astype(np.int32)
    _close(tcache[0], jcache[0], tol)


def test_params_round_trip_over_the_encdec_tree():
    """The port's tree has the reference init's structure, shapes and
    dtypes, leaf for leaf (the stacks, xattn, ln_x, frontend_proj,
    ln_enc, ln_dec); tree -> port model -> tree is bit for bit."""
    jc, _, tc, tm = _models()
    shapes = jax.eval_shape(j_build(jc).init, jax.random.PRNGKey(0))
    want = weights()
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(shapes)
    for (path, a), sd in zip(jax.tree_util.tree_leaves_with_path(want),
                             jax.tree_util.tree_leaves(shapes)):
        assert a.dtype == sd.dtype and a.shape == sd.shape, path
    back = params_to_jax(tm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert back["dec_layers"]["xattn"]["wk"].shape == (2, tc.d_model, tc.n_kv * tc.hd)
    assert back["frontend_proj"].shape == (tc.frontend_dim, tc.d_model)
    # and a bf16 tree (as a uint16 view) keeps its bits
    bf = dataclasses.replace(tc, param_dtype="bfloat16")
    model = t_build(bf).init(seed=1, device="cpu")
    again = params_to_jax(params_from_jax(params_to_jax(model), bf, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(model)),
                    jax.tree_util.tree_leaves(again)):
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def reference_run(policy):
    """The reference static engine's tokens, per-forward logits, stats
    and prequant record (weights prequantized under plam_sim)."""
    jc, _ = _cfgs(policy)
    eng = JEngine(jc, params=jax.tree.map(jnp.asarray, weights()), prequantize=policy == PLAM)
    logits = []
    eng._prefill, eng._decode = _capture(eng._prefill, logits), _capture(eng._decode, logits)
    out = eng.generate({"frames": jnp.asarray(FRAMES), "tokens": jnp.asarray(TOKENS)},
                       JServeConfig(max_new_tokens=NEW, time_steps=True))
    stats = {f: getattr(eng.stats, f) for f in STATS}
    return np.asarray(out).tolist(), logits, stats, eng.prequant_meta


@pytest.mark.parametrize("policy", ["f32", PLAM])
def test_static_engine_matches_reference(policy):
    want, want_logits, stats, meta = reference_run(policy)
    _, tc = _cfgs(policy)
    tm = params_from_jax(weights(), tc, device="cpu")
    _lib.reset_launches()
    logits = []
    eng = _serve(build_engine(tc, ServeOptions(prequantize=policy == PLAM), params=tm,
                              device="cpu"), ("prefill", "decode_step"), logits)
    assert isinstance(eng, Engine)
    out = eng.generate({"frames": FRAMES, "tokens": TOKENS},
                       ServeConfig(max_new_tokens=NEW, time_steps=True))
    assert out.tolist() == want
    check_logits(logits, want_logits, ENGINE_TOL[policy])
    assert {f: getattr(eng.stats, f) for f in STATS} == stats
    assert eng.stats.prefill_tokens == TOKENS.size
    assert len(eng.stats.step_latency_s) == NEW
    assert eng.prequant_meta == meta
    if policy == PLAM:
        assert {"frontend_proj", "unembed", "dec_layers/xattn/wk"} <= set(meta)
    assert all(v == 0 for v in _lib.launches.values())  # CPU: plain versions only
    # the encoder output is computed once more per generate and kept
    enc = t_encdec.encode(tc, eng.model, torch.from_numpy(FRAMES))
    assert torch.equal(eng._enc_cache, enc)


def test_encdec_has_no_paged_layout_and_does_not_train():
    """As in the reference: the continuous engine refuses the encdec
    family.  It trains now (the name is older than that): one AdamW step
    gives a finite loss and a gradient on every float leaf, the encoder's
    among them."""
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="no paged KV layout"):
        build_engine(tc, ServeOptions(engine="continuous"), device="cpu")
    api = t_build(tc)
    assert_trains(api, api.init(device="cpu"), {"frames": FRAMES, "tokens": TOKENS,
                                                 "labels": TOKENS})
