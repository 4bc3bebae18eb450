"""The port's zamba2-style hybrid LM and the scalar-offset cache write of
``attn_apply`` against the JAX reference (``repro/models/hybrid.py``,
``repro/models/attention.py``).

``attn_apply`` writes a span at ``cache_len`` into a contiguous cache as
``jax.lax.dynamic_update_slice`` does: clamped to ``Sk - S``, while the
mask keeps the unclamped query positions.  The static engine never grows
the hybrid's shared KV cache past the prompt (neither does the
reference's), so every decode step writes onto its last slot and attends
to every key; the port must do the same to give the reference's tokens.
f32 paths within allclose 1e-5, weights from the reference's init
converted with ``repro_torch.convert.params_from_jax``.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.modes import NumericsConfig as JNumerics  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import hybrid as j_hybrid  # noqa: E402
from repro_torch.core.modes import NumericsConfig as TNumerics  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import hybrid as t_hybrid  # noqa: E402

from test_torch_ssm import _close, _dtype_name, _t, models, one_thread  # noqa: E402,F401

SK, S_PROMPT = 8, 8

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("cache_len", [SK - 1, SK, SK + 3])
def test_scalar_offset_write_clamps_as_the_reference(cache_len):
    """A one-token span into a [B, Sk] cache at Sk - 1 (the last slot), Sk
    and Sk + 3 (past the end: written onto the last slot, every key
    attended): the output and the cache equal the JAX ``attn_apply``'s."""
    rng = np.random.default_rng(cache_len)
    d, h, kv, hd = 32, 4, 2, 8
    ws = {n: (rng.standard_normal(shape) * d ** -0.5).astype(np.float32) for n, shape in
          (("wq", (d, h * hd)), ("wk", (d, kv * hd)), ("wv", (d, kv * hd)),
           ("wo", (h * hd, d)))}
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    ck = rng.standard_normal((2, SK, kv, hd)).astype(np.float32)
    cv = rng.standard_normal((2, SK, kv, hd)).astype(np.float32)
    pos = np.full((2, 1), cache_len, np.int32)
    kw = dict(n_heads=h, n_kv=kv, head_dim=hd)
    jo, (jk, jv) = j_attn.attn_apply(
        {n: jnp.asarray(w) for n, w in ws.items()}, jnp.asarray(x), JNumerics(mode="f32"),
        positions=jnp.asarray(pos), kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.int32(cache_len), **kw)
    p = t_attn.Attention(d, h, kv, hd, generator=torch.Generator(), device="cpu")
    for n, w in ws.items():
        setattr(p, n, torch.nn.Parameter(_t(w), requires_grad=False))
    to, (tk, tv) = t_attn.attn_apply(p, _t(x), TNumerics(mode="f32"), positions=_t(pos),
                                     kv_cache=(_t(ck), _t(cv)), cache_len=cache_len, **kw)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)
    assert not np.array_equal(tk[:, SK - 1].numpy(), ck[:, SK - 1])  # the last slot written


def _check_caches(tcache, jcache):
    """Dtypes, shapes and values; a bf16 entry written from allclose f32
    K/V is equal or one rounding (2^-8 relative) apart."""
    pairs = [(tcache["ssm"][k], jcache["ssm"][k]) for k in ("h", "conv")]
    pairs += [(tcache[k], jcache[k]) for k in ("shared_k", "shared_v")]
    for t, j in pairs:
        assert str(t.dtype)[6:] == _dtype_name(j)
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, 2 ** -7 if t.dtype == torch.bfloat16 else 1e-5)


def test_hybrid_prefill_and_decode_match_reference():
    """Through the registry (bf16 caches sized to the prompt, as the
    reference's): the prefill's logits and caches, with their dtypes, then
    a decode step on the reference's own post-prefill caches (a bf16 cache
    entry one rounding apart would move the next logits by ~1e-3)."""
    jc, tc, japi, jp, model = models("zamba2-1.2b")
    tapi = t_build(tc)
    toks = np.random.default_rng(2).integers(0, jc.vocab, (2, S_PROMPT)).astype(np.int32)
    jl, jcache = japi.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tapi.prefill(model, {"tokens": _t(toks)})
    _close(tl, jl)
    assert tcache["shared_k"].shape == (1, 2, S_PROMPT, tc.n_kv, 2 * tc.d_model // tc.n_heads)
    _check_caches(tcache, jcache)

    ref_caches = jax.tree.map(lambda a: _t(np.asarray(a, np.float32)), jcache)
    ref_caches["shared_k"] = ref_caches["shared_k"].to(torch.bfloat16)
    ref_caches["shared_v"] = ref_caches["shared_v"].to(torch.bfloat16)
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    jl, jcache = japi.decode_step(jp, {"token": jnp.asarray(tok), "caches": jcache,
                                       "cache_len": jnp.int32(S_PROMPT)})
    tl, tcache = tapi.decode_step(model, {"token": _t(tok), "caches": ref_caches,
                                          "cache_len": S_PROMPT})
    _close(tl, jl)
    _check_caches(tcache, jcache)


def test_clamped_hybrid_decode_matches_reference():
    """Four decode steps past the end of a prompt-sized f32 shared cache
    (cache_len 8, 9, 10, 11 over 8 slots: each write lands on the last
    slot, every key attended), the module functions of both packages:
    logits and caches after every step."""
    jc, tc, _, jp, model = models("zamba2-1.2b")
    toks = np.random.default_rng(3).integers(0, jc.vocab, (2, S_PROMPT)).astype(np.int32)
    jcache = j_hybrid.cache_init(jc, 2, S_PROMPT, jnp.float32)
    tcache = t_hybrid.cache_init(tc, 2, S_PROMPT, torch.float32, "cpu")
    jl, jcache = jax.jit(functools.partial(j_hybrid.prefill, jc))(jp, jnp.asarray(toks),
                                                                  jcache)
    tl, tcache = t_hybrid.prefill(tc, model, _t(toks), tcache)
    _close(tl, jl)
    _check_caches(tcache, jcache)
    decode = jax.jit(functools.partial(j_hybrid.decode_step, jc))
    for i in range(4):
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jcache = decode(jp, jnp.asarray(tok), jcache, jnp.int32(S_PROMPT + i))
        tl, tcache = t_hybrid.decode_step(tc, model, _t(tok), tcache, S_PROMPT + i)
        _close(tl, jl)
        _check_caches(tcache, jcache)
    assert tcache["shared_k"].shape[2] == S_PROMPT  # never grown


def test_hybrid_shared_block_binds_layer_free(monkeypatch):
    """The shared block runs n_layers // shared_attn_every times a forward
    with one set of weights, its sites bound with no layer (the
    reference's ``bind(cfg.numerics, None, cfg.n_layers)``)."""
    _, tc, _, _, model = models("zamba2-1.2b")
    assert t_hybrid.n_shared_invocations(tc) == 1
    names = {n for n, _ in model.named_parameters() if n.startswith("shared.")}
    assert names == {"shared.ln1.scale", "shared.attn.wq", "shared.attn.wk", "shared.attn.wv",
                     "shared.attn.wo", "shared.ln2.scale", "shared.mlp.wu", "shared.mlp.wd",
                     "shared.mlp.wg", "shared.out_proj"}
    binds = []
    real = t_hybrid.bind
    monkeypatch.setattr(t_hybrid, "bind",
                        lambda numerics, layer, n: binds.append((layer, n)) or real(
                            numerics, layer, n))
    t_hybrid.prefill(tc, model, torch.zeros((1, 4), dtype=torch.int32),
                     t_hybrid.cache_init(tc, 1, 4, torch.float32, "cpu"))
    assert binds == [(None, tc.n_layers)] * t_hybrid.n_shared_invocations(tc)
