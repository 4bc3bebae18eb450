"""The port's multi-token paged path and chunked prefill against the JAX
reference.

Model level: ``attn_apply`` with per-slot [B] offsets,
``paged_prefill_chunk`` and ``paged_score_tokens`` against their JAX
functions (logits and the pool positions they write), and a chunked
prefill against the port's own whole-prompt prefill.  Engine level: the
port's engine with ``prefill_chunk`` against
``repro.serving.ContinuousBatchingEngine`` on the same weights and
requests: identical greedy tokens and counters.

Reduced yi-6b with f32 parameters and activations, weights made by the
reference's init and converted with ``repro_torch.convert.params_from_jax``.
The other engine-feature files (``test_torch_preemption``,
``test_torch_prefix_cache``, ``test_torch_spec``) import ``models`` and
``serve_both`` from here.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.policy import layer_segments as j_layer_segments  # noqa: E402
from repro.core.prequant import quantize_params as j_quantize  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import PagedServeConfig as JPagedCfg  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.common import iter_layers  # noqa: E402
from repro_torch.serving import ServeOptions, build_engine  # noqa: E402

# Logit and pool tolerances: those of
# tests/test_torch_model.py::test_paged_prefill_and_decode_match_reference.
# f32: the same f32 arithmetic in another summation order, a few ulp;
# plam_sim re-encodes every activation onto the posit grid, where a
# one-ulp difference in an f32 input can move a pattern by one step
# (2^-12 relative), and that step propagates.
TOL = {"f32": 1e-4, "plam_sim:16:1": 2e-2}
# counters the port's engine must share with the reference's
STATS = ("steps", "decode_steps", "preemptions", "resumes", "spec_steps",
         "drafted_tokens", "accepted_tokens")


def _numpy_tree(tree):
    """JAX params -> numpy, bf16 leaves as a uint16 view."""
    def one(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(one, tree)


@functools.lru_cache(maxsize=None)
def models(policy: str):
    """(jc, jp, tc, tm); plam_sim weights are prequantized to int16.  No
    engine changes them (the port's engines share ``tm``)."""
    jc = dataclasses.replace(j_get_config("yi-6b").reduced(), param_dtype="float32",
                             act_dtype="float32").with_numerics(f"default={policy}")
    tc = dataclasses.replace(t_get_config("yi-6b").reduced(), param_dtype="float32",
                             act_dtype="float32").with_numerics(f"default={policy}")
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    if policy.startswith("plam"):
        jp, _ = j_quantize(jc, jp)
    return jc, jp, tc, params_from_jax(_numpy_tree(jp), tc, device="cpu")


def _owned(pool, blocks):
    """The pool's rows in ``blocks`` (never scratch block 0) as f32 numpy."""
    if isinstance(pool, torch.Tensor):
        return pool[:, list(blocks)].float().numpy()
    return np.asarray(pool[:, np.asarray(blocks)].astype(jnp.float32))


# -- model level ---------------------------------------------------------------


@pytest.mark.parametrize("policy", list(TOL))
def test_attn_apply_per_slot_offsets_match_reference(policy):
    """[B] cache_len: each slot writes its span at its own offset (one of
    them clamped, as dynamic_update_slice clamps) and attends under a
    [B, 1, Sq, Sk] mask."""
    jc, jp, tc, tm = models(policy)
    tol = TOL[policy]
    rng = np.random.default_rng(0)
    b, s, s_k = 4, 3, 16
    x = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, s_k, jc.n_kv, jc.hd)).astype(np.float32)
    cv = rng.standard_normal((b, s_k, jc.n_kv, jc.hd)).astype(np.float32)
    lengths = np.array([0, 5, 13, 15], np.int32)  # 15 + 3 > 16: clamped to 13
    positions = lengths[:, None] + np.arange(s, dtype=np.int32)
    kw = dict(n_heads=jc.n_heads, n_kv=jc.n_kv, head_dim=jc.hd, rope_theta=jc.rope_theta)
    jsite = j_layer_segments(jc.numerics, jc.n_layers)[0][2]
    jpar = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    jout, (jk, jv) = j_attn.attn_apply(
        jpar, jnp.asarray(x), jsite, positions=jnp.asarray(positions),
        kv_cache=(jnp.asarray(ck, jnp.bfloat16), jnp.asarray(cv, jnp.bfloat16)),
        cache_len=jnp.asarray(lengths), **kw)
    tsite = next(iter_layers(tc.numerics, tc.n_layers))[1]
    tk = torch.from_numpy(ck).to(torch.bfloat16)
    tv = torch.from_numpy(cv).to(torch.bfloat16)
    tout, _ = t_attn.attn_apply(
        tm.blocks[0].attn, torch.from_numpy(x), tsite, positions=torch.from_numpy(positions),
        kv_cache=(tk, tv), cache_len=torch.from_numpy(lengths), **kw)
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tk.float().numpy(), np.asarray(jk.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("policy", list(TOL))
def test_paged_prefill_chunk_and_score_tokens_match_reference(policy):
    """A 13-token prompt in two chunks of 8 (the second ragged), then a
    3-slot, 3-token verify over it, a fresh sequence and an idle slot:
    logits and every written position of the owned blocks."""
    jc, jp, tc, tm = models(policy)
    tol = TOL[policy]
    rng = np.random.default_rng(1)
    bs, nb, plen = 8, 16, 13
    prompt = rng.integers(0, jc.vocab, plen).astype(np.int32)
    row = np.array([3, 5, 9, 0], np.int32)
    jkp, jvp = j_tf.paged_kv_pool_init(jc, nb, bs)
    tkp, tvp = t_tf.paged_kv_pool_init(tc, nb, bs, torch.bfloat16, "cpu")
    j_chunk = jax.jit(functools.partial(j_tf.paged_prefill_chunk, jc))
    for start in (0, 8):
        real = min(plen - start, 8)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :real] = prompt[start:start + real]
        jl, (jkp, jvp) = j_chunk(jp, jnp.asarray(toks), jkp, jvp, jnp.asarray(row),
                                 jnp.int32(start), jnp.int32(real - 1))
        tl, _ = t_tf.paged_prefill_chunk(tc, tm, torch.from_numpy(toks), tkp, tvp,
                                         torch.from_numpy(row), start, real - 1)
        assert tl.shape == (1, 1, jc.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    np.testing.assert_allclose(_owned(tkp, row[:2]), _owned(jkp, row[:2]), rtol=tol, atol=tol)
    np.testing.assert_allclose(_owned(tvp, row[:2]), _owned(jvp, row[:2]), rtol=tol, atol=tol)

    tables = np.zeros((3, 4), np.int32)
    tables[0] = row
    tables[1, :1] = 7  # a fresh sequence from an empty cache
    lengths = np.array([plen, 0, 0], np.int32)  # slot 2 idle: scratch only
    toks = rng.integers(0, jc.vocab, (3, 3)).astype(np.int32)
    j_score = jax.jit(functools.partial(j_tf.paged_score_tokens, jc))
    jl, (jkp, jvp) = j_score(jp, jnp.asarray(toks), jkp, jvp, jnp.asarray(tables),
                             jnp.asarray(lengths))
    tl, _ = t_tf.paged_score_tokens(tc, tm, torch.from_numpy(toks), tkp, tvp,
                                    torch.from_numpy(tables), torch.from_numpy(lengths))
    assert tl.shape == (3, 3, jc.vocab)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=tol, atol=tol)
    assert np.array_equal(tl[:2].numpy().argmax(-1), np.asarray(jl)[:2].argmax(-1))
    owned = [3, 5, 9, 7]
    np.testing.assert_allclose(_owned(tkp, owned), _owned(jkp, owned), rtol=tol, atol=tol)
    np.testing.assert_allclose(_owned(tvp, owned), _owned(jvp, owned), rtol=tol, atol=tol)
    untouched = [b for b in range(1, nb) if b not in owned]
    assert not tkp[:, untouched].any() and not tvp[:, untouched].any()


def test_chunked_prefill_matches_whole_prefill():
    """Two chunks leave the pool as one whole-prompt prefill does and give
    the same last logits (the port against itself, f32 pools; as
    tests/test_tp_chunked_serving.py pins it for the reference)."""
    _, _, tc, tm = models("f32")
    rng = np.random.default_rng(2)
    plen, bs = 13, 4
    prompt = rng.integers(0, tc.vocab, (1, 16)).astype(np.int32)
    prompt[0, plen:] = 0
    blocks = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    kp_a, vp_a = t_tf.paged_kv_pool_init(tc, 8, bs, torch.float32, "cpu")
    logits_a, _ = t_tf.paged_prefill(tc, tm, torch.from_numpy(prompt), kp_a, vp_a, blocks,
                                     plen)
    kp_b, vp_b = t_tf.paged_kv_pool_init(tc, 8, bs, torch.float32, "cpu")
    for start in (0, 8):
        toks = np.zeros((1, 8), np.int32)
        real = min(plen - start, 8)
        toks[0, :real] = prompt[0, start:start + real]
        logits_b, _ = t_tf.paged_prefill_chunk(tc, tm, torch.from_numpy(toks), kp_b, vp_b,
                                               blocks, start, real - 1)
    shape = (tc.n_layers, -1, tc.n_kv, tc.hd)
    for a, b in ((kp_a, kp_b), (vp_a, vp_b)):
        np.testing.assert_allclose(a[:, 1:5].reshape(shape)[:, :plen].numpy(),
                                   b[:, 1:5].reshape(shape)[:, :plen].numpy(),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logits_a.numpy(), logits_b.numpy(), rtol=1e-5, atol=1e-5)
    assert int(logits_a.argmax()) == int(logits_b.argmax())


# -- engine level --------------------------------------------------------------


def serve_both(model, workload, **opts):
    """The same workload on the JAX engine and the port's (build_engine on
    the CPU); identical greedy tokens and counters.  Returns both engines
    and the tokens."""
    jc, jp, tc, tm = model
    jeng = JEngine(jc, params=jp, pcfg=JPagedCfg(**opts))
    teng = build_engine(tc, ServeOptions(**opts), params=tm, device="cpu")
    want = workload(jeng)
    got = workload(teng)
    assert got == want
    for field in STATS:
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    assert teng.stats.padding_waste() == pytest.approx(jeng.stats.padding_waste())
    assert all(v == 0 for v in _lib.launches.values())  # CPU: plain versions only
    return jeng, teng, got


def _mixed(eng, max_new=6):
    """Mixed-length prompts, one step apart (tests/test_spec_decoding.py's)."""
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, 512, n).tolist(), max_new_tokens=max_new,
                     arrival_step=i) for i, n in enumerate((3, 9, 17, 6))]
    done = eng.run()
    return [done[h.rid] for h in hs]


@pytest.mark.parametrize("chunk", [0, 4, 8])
def test_engine_chunked_prefill_matches_reference(chunk):
    jeng, teng, _ = serve_both(models("f32"), _mixed, block_size=4, num_blocks=96, max_slots=3,
                            max_seq_len=48, prefill_chunk=chunk)
    assert teng.stats.prefills == jeng.stats.prefills
    assert teng.stats.prefill_padding == jeng.stats.prefill_padding
    if chunk:
        assert teng.stats.prefills > 4  # the 17-token prompt takes several chunks


def test_engine_chunked_prefill_prequantized_plam_matches_reference():
    """The card's serving numerics: prequantized int16 plam_sim weights,
    chunked prefill."""
    serve_both(models("plam_sim:16:1"), lambda e: _mixed(e, max_new=4), block_size=4,
               num_blocks=96, max_slots=3, max_seq_len=48, prefill_chunk=8)


def test_chunked_prefill_interleaves_with_decode():
    """A running sequence keeps decoding while a long prompt is fed one
    chunk a step."""
    _, _, tc, tm = models("f32")
    rng = np.random.default_rng(1)
    eng = build_engine(tc, ServeOptions(block_size=4, num_blocks=64, max_slots=2,
                                        max_seq_len=48, prefill_chunk=4),
                       params=tm, device="cpu")
    short = eng.submit(rng.integers(0, 512, 4).tolist(), max_new_tokens=3)
    long_req = eng.submit(rng.integers(0, 512, 20).tolist(), max_new_tokens=3,
                          arrival_step=1)
    eng.run()
    assert short.finished_step <= long_req.finished_step - 3
    assert len(short.output) == 3 and len(long_req.output) == 3


def test_chunk_width_must_be_a_block_multiple():
    tc = t_get_config("yi-6b").reduced()
    with pytest.raises(ValueError, match="multiple of"):
        build_engine(tc, ServeOptions(block_size=4, prefill_chunk=6), device="cpu")
