"""The blockwise (flash) attention core and ``ModelConfig.flash_block``
against the reference.

``attn_core_blockwise`` runs the reference's online softmax over KV
blocks in f32 and walks the blocks again in its own backward pass (from
the saved log-sum-exp), so its gradient is held here against
``jax.vjp`` of the reference's, which differentiates through its scan.
Both compute in f32 and differ in summation order only: forward within
rtol 1e-5, gradients within a relative L2 of 1e-5 (bf16 inputs: one
bf16 rounding of the result, 2^-7).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core.modes import NumericsConfig as JNumericsConfig  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models.attention import attn_core_blockwise as j_blockwise  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.modes import NumericsConfig  # noqa: E402
from repro_torch.models.attention import attn_core, attn_core_blockwise  # noqa: E402
from repro_torch.models.common import causal_mask  # noqa: E402
from repro_torch.models.registry import build as t_build  # noqa: E402
from repro_torch.models.transformer import set_trainable  # noqa: E402

from test_torch_ssm import one_thread  # noqa: E402,F401

# b, s, heads, kv heads, head dim, block
SHAPE = (2, 32, 4, 2, 16, 8)
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


pytestmark = pytest.mark.usefixtures("one_thread")


def _inputs(dtype, seed=0):
    b, s, h, kv, hd, _ = SHAPE
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) * 2
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd))]
    if dtype == "bfloat16":  # values exact in bf16, the same bits on both sides
        arrs = [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_core_forward_and_gradient_match_reference(causal, softcap, dtype):
    q, k, v, ct = _inputs(dtype)
    block = SHAPE[-1]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def j_fn(q, k, v):
        return j_blockwise(q, k, v, causal=causal, block=block, softcap=softcap)

    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    j_out, vjp = jax.vjp(j_fn, jq, jk, jv)
    j_grads = vjp(jnp.asarray(ct).astype(jdt))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    t_out = attn_core_blockwise(tq, tk, tv, causal=causal, block=block, softcap=softcap)
    t_grads = torch.autograd.grad(t_out, [tq, tk, tv], torch.from_numpy(ct).to(tdt))
    assert t_out.dtype == tdt and all(g.dtype == tdt for g in t_grads)
    want = np.asarray(j_out.astype(jnp.float32))
    got = t_out.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -9)
    for name, g, w in zip("qkv", t_grads, j_grads):
        err = _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= GRAD_TOL[dtype], (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_core_equals_the_plain_core(causal):
    """The online softmax and the whole-matrix softmax of ``attn_core``
    (the path without ``flash_block``): the same function to f32
    rounding, forward and gradient."""
    q, k, v, ct = (torch.from_numpy(a) for a in _inputs("float32", seed=1))
    s = q.shape[1]
    mask = causal_mask(s, s) if causal else torch.ones((s, s), dtype=torch.bool)
    outs = []
    for fn in (lambda a, b, c: attn_core_blockwise(a, b, c, causal=causal, block=SHAPE[-1]),
               lambda a, b, c: attn_core(a, b, c, mask)):
        args = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*args)
        outs.append([out.detach(), *torch.autograd.grad(out, args, ct)])
    for a, b in zip(*outs):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5


def test_blockwise_core_rejects_a_ragged_block():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs("float32"))
    with pytest.raises(ValueError, match="multiple of the block"):
        attn_core_blockwise(q, k, v, causal=True, block=12)


def _toy(cls, numerics, **kw):
    return cls(name="fb", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
               head_dim=16, d_ff=128, vocab=97, numerics=numerics, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_flash_block_in_model_matches_reference_path(remat):
    """A 2-layer model with ``flash_block=16`` (two KV blocks a row of 32)
    against the reference's path without it (as the reference's own
    ``test_flash_block_in_model_matches_reference_path``): the loss and
    every gradient leaf within f32 tolerance; and the port without
    ``flash_block`` against the port with it."""
    base = _toy(JModelConfig, JNumericsConfig(mode="f32"), remat=remat)
    jp = jax.tree.map(np.asarray, j_build(base).init(jax.random.PRNGKey(0)))
    batch = {"tokens": np.random.default_rng(8).integers(0, 97, (2, 32)).astype(np.int32),
             "labels": np.random.default_rng(9).integers(0, 97, (2, 32)).astype(np.int32)}
    jloss, jgrads = jax.jit(jax.value_and_grad(j_build(base).train_loss))(jp, batch)
    jgrads = _flat(jax.tree.map(np.asarray, jgrads))
    runs = {}
    for fb in (16, 0):
        tc = _toy(ModelConfig, NumericsConfig(mode="f32"), remat=remat, flash_block=fb)
        model = set_trainable(params_from_jax(jp, tc, device="cpu"))
        loss = t_build(tc).train_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        runs[fb] = (float(loss.detach()), _flat(params_to_jax(grads)))
    for fb, (tloss, tgrads) in runs.items():
        assert tloss == pytest.approx(float(jloss), rel=1e-5), fb
        for path, want in jgrads.items():
            assert _rel(tgrads[path], want) <= 1e-4, (fb, path)


def test_flash_block_is_taken_only_where_the_reference_takes_it(monkeypatch):
    """The blockwise core runs for a forward without a cache whose length
    the block divides, never in a prefill or decode over a cache, and
    a length that the block does not divide takes the plain core."""
    from repro_torch.models import attention as att
    from repro_torch.models import transformer as tf

    calls = []
    real = att.attn_core_blockwise

    def counted(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(att, "attn_core_blockwise", counted)
    tc = _toy(ModelConfig, NumericsConfig(mode="f32"), flash_block=16)
    model = t_build(tc).init(seed=0, device="cpu")
    rng = np.random.default_rng(3)
    for s in (32, 24):
        tokens = torch.from_numpy(rng.integers(0, 97, (2, s)).astype(np.int32))
        t_build(tc).train_loss(model, {"tokens": tokens, "labels": tokens})
        caches = tf.kv_cache_init(tc, 2, s, torch.float32)
        tf.prefill(tc, model, tokens, caches)
    assert calls == [32, 32]  # two layers at S = 32; S = 24 and the prefills: plain
