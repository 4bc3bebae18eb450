"""The port's Mamba2 block and attention-free Mamba2 LM against the JAX
reference (``repro/models/ssm.py``, ``repro/models/mamba_lm.py``).

Seeded numpy inputs and the reference's init, converted with
``repro_torch.convert.params_from_jax``, go through both packages.  f32
paths are held within allclose 1e-5 (the same f32 arithmetic in another
summation order); the SSD scan at ragged lengths and chunk edges, the
one-token recurrence, the LM's logits and the caches it returns, with
their dtypes.  A decode step after a prompt shorter than ``ssm_conv - 1``
raises in both.  ``quantize_params``' record of the ssm and hybrid
families equals the reference's.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.modes import NumericsConfig as JNumerics  # noqa: E402
from repro.core.prequant import quantize_params as j_quantize  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.modes import NumericsConfig as TNumerics  # noqa: E402
from repro_torch.core.prequant import quantize_params as t_quantize  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

from test_torch_chunked import _numpy_tree  # noqa: E402
from test_torch_train_loss import assert_trains  # noqa: E402


@pytest.fixture
def one_thread():
    """One intra-op thread for the port's CPU ops.  The suite runs in
    parallel workers on shared cores, where each small op's thread pool
    waits on the others' (ten times slower in a loaded run)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
# reduced mamba2 widths: d_model 128, d_inner 256, 8 heads of 32, state 16
D, EXPAND, HD, DS, K = 128, 2, 32, 16, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cfgs(arch, act="float32", policy="f32"):
    j = dataclasses.replace(j_get_config(arch).reduced(), param_dtype=act, act_dtype=act)
    t = dataclasses.replace(t_get_config(arch).reduced(), param_dtype=act, act_dtype=act)
    return j.with_numerics(f"default={policy}"), t.with_numerics(f"default={policy}")


@functools.lru_cache(maxsize=None)
def models(arch, act="float32", policy="f32"):
    """(jax cfg, port cfg, jitted reference API calls, reference params, the
    port's model on the same weights) at the reduced size."""
    jc, tc = _cfgs(arch, act, policy)
    japi = j_build(jc)
    jp = jax.jit(japi.init)(jax.random.PRNGKey(0))
    ref = dataclasses.replace(japi, prefill=jax.jit(japi.prefill),
                              decode_step=jax.jit(japi.decode_step))
    return jc, tc, ref, jp, params_from_jax(_numpy_tree(jp), tc, device="cpu")


@pytest.mark.parametrize("s", [1, 7, 16, 37])
def test_causal_dwconv_matches_reference(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 40)).astype(np.float32)
    w = rng.standard_normal((K, 40)).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    want = jax.jit(j_ssm._causal_dwconv)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(t_ssm._causal_dwconv(_t(x), _t(w), _t(b)), want)


@pytest.mark.parametrize("s,chunk", [(1, 4), (7, 4), (16, 16), (37, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    """Output and final state, the last chunk padded with dt = 0 where s is
    not a multiple of the chunk."""
    rng = np.random.default_rng(100 + s)
    h = 3
    xh = rng.standard_normal((2, s, h, 8)).astype(np.float32)
    bs = rng.standard_normal((2, s, 5)).astype(np.float32)
    cs = rng.standard_normal((2, s, 5)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, s, h)))).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(h)).astype(np.float32)
    ssd = jax.jit(j_ssm._ssd_chunked, static_argnums=5)
    jy, jh = ssd(*map(jnp.asarray, (xh, bs, cs, dt, a_log)), chunk)
    ty, th = t_ssm._ssd_chunked(*map(_t, (xh, bs, cs, dt, a_log)), chunk)
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


def _block():
    """A reduced Mamba2 block from the reference's init, both sides, with
    non-trivial A_log, D and dt_bias."""
    jp = j_ssm.mamba2_init(jax.random.PRNGKey(5), D, expand=EXPAND, head_dim=HD, d_state=DS,
                           d_conv=K)
    rng = np.random.default_rng(5)
    nh = EXPAND * D // HD
    jp = dict(jp, A_log=jnp.asarray(0.3 * rng.standard_normal(nh), jnp.float32),
              D=jnp.asarray(rng.standard_normal(nh), jnp.float32),
              conv_b=jnp.asarray(0.1 * rng.standard_normal(jp["conv_b"].shape), jnp.float32))
    tp = t_ssm.Mamba2(D, expand=EXPAND, head_dim=HD, d_state=DS, d_conv=K,
                      generator=torch.Generator(), device="cpu")
    for name, leaf in jp.items():
        if name == "norm":
            tp.norm.scale = torch.nn.Parameter(_t(leaf["scale"]), requires_grad=False)
        else:
            setattr(tp, name, torch.nn.Parameter(_t(leaf), requires_grad=False))
    return jp, tp


def test_mamba2_apply_prefill_and_decode_match_reference():
    """A 9-token prefill (chunk 4: three chunks, the last padded), then two
    one-token decode steps on the returned state: outputs and states."""
    jp, tp = _block()
    kw = dict(expand=EXPAND, head_dim=HD, d_state=DS, chunk=4)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    tn = TNumerics(mode="f32")
    apply = jax.jit(functools.partial(j_ssm.mamba2_apply, ncfg=JNumerics(mode="f32"), **kw))
    jo, jc = apply(jp, jnp.asarray(x))
    to, tc = t_ssm.mamba2_apply(tp, _t(x), tn, **kw)
    _close(to, jo)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])
    for step in range(2):
        x1 = rng.standard_normal((2, 1, D)).astype(np.float32)
        jo, jc = apply(jp, jnp.asarray(x1), cache=jc)
        to, tc = t_ssm.mamba2_apply(tp, _t(x1), tn, cache=tc, **kw)
        _close(to, jo)
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])
    assert tc["h"].dtype == torch.float32 and tc["conv"].shape == (2, K - 1, 2 * D + 2 * DS)


def _dtype_name(a):
    return str(np.asarray(a).dtype) if np.asarray(a).dtype != jnp.bfloat16 else "bfloat16"


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_mamba_lm_prefill_and_decode_match_reference(act):
    """Logits of a prefill and of three decode steps after it, and the
    caches each returns with the reference's dtypes (``h`` f32, ``conv``
    in the activation dtype, not the bf16 of ``cache_init``).  bf16 is
    held to its dtypes and to greedy tokens within bf16's tolerance."""
    jc, tc, japi, jp, model = models("mamba2-780m", act)
    tapi = t_build(tc)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 11)).astype(np.int32)
    jl, jcache = japi.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tapi.prefill(model, {"tokens": _t(toks)})
    tol = TOL if act == "float32" else 0.1

    def kept(c):  # a decode step writes the port's caches in place
        return {k: v.clone() for k, v in c.items()}

    steps = [(jl, tl, jcache, kept(tcache))]
    for i in range(3):
        tok = np.argmax(np.asarray(jl, np.float32)[:, -1], -1).astype(np.int32)[:, None]
        jl, jcache = japi.decode_step(jp, {"token": jnp.asarray(tok), "caches": jcache,
                                           "cache_len": jnp.int32(11 + i)})
        tl, tcache = tapi.decode_step(model, {"token": _t(tok), "caches": tcache,
                                              "cache_len": 11 + i})
        steps.append((jl, tl, jcache, kept(tcache)))
    for jl, tl, jcache, tcache in steps:
        _close(tl, jl, tol)
        for key in ("h", "conv"):
            assert str(tcache[key].dtype)[6:] == _dtype_name(jcache[key])
            assert tuple(tcache[key].shape) == tuple(jcache[key].shape)
            _close(tcache[key], jcache[key], tol)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_short_prompt_decode_raises_as_the_reference(arch):
    """A prompt of 2 tokens leaves a conv tail of 2 rows, not ssm_conv - 1
    = 3: the reference's first decode step raises ValueError, and so does
    the port's."""
    jc, tc, japi, jp, model = models(arch)
    tapi = t_build(tc)
    toks = np.array([[3, 4]], np.int32)
    _, jcache = japi.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tcache = tapi.prefill(model, {"tokens": _t(toks)})
    one = np.array([[5]], np.int32)
    with pytest.raises(ValueError):
        japi.decode_step(jp, {"token": jnp.asarray(one), "caches": jcache,
                              "cache_len": jnp.int32(2)})
    with pytest.raises(ValueError, match="shorter than ssm_conv - 1"):
        tapi.decode_step(model, {"token": _t(one), "caches": tcache, "cache_len": 2})


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_quantize_params_meta_matches_reference(arch):
    """plam_sim everywhere: the in_proj/out_proj stacks, the shared block's
    projections (layer-free, ``hybrid.proj`` for its out_proj) and the
    unembedding are encoded, the conv and the f32 SSM leaves are not; the
    patterns equal the reference's."""
    jc, tc = _cfgs(arch, policy="plam_sim:16:1")
    jp = models(arch)[3]
    jq, jmeta = j_quantize(jc, jp)
    model, tmeta = t_quantize(tc, params_from_jax(_numpy_tree(jp), tc, device="cpu"))
    assert tmeta == jmeta
    assert "layers/mamba/in_proj" in tmeta and "layers/mamba/conv_w" not in tmeta
    for name, p in model.named_parameters():
        path = name.replace("blocks.", "layers.", 1).split(".")
        if name.startswith("blocks."):
            del path[1]
        leaf = jq
        for part in path:
            leaf = leaf[part]
        leaf = np.asarray(leaf)
        if name.startswith("blocks."):
            leaf = leaf[int(name.split(".")[1])]
        if not p.is_floating_point():
            np.testing.assert_array_equal(p.numpy(), leaf)


def test_ssm_and_hybrid_training_raise_naming_item_10a():
    """The ssm and hybrid families train (one AdamW step each: a finite
    loss, a gradient on every float leaf, ``A_log``, ``D``, ``dt_bias``,
    the conv and the gated norm among them) and keep no paged layout
    (the name predates their training)."""
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        _, tc = _cfgs(arch)
        api = t_build(tc)
        tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (1, 8))
                                  .astype(np.int32))
        assert_trains(api, api.init(device="cpu"), {"tokens": tokens, "labels": tokens})
        assert api.paged_decode_step is None and api.paged_prefill is None
        assert tuple(api.prefill_inputs(3, 10)["tokens"].shape) == (3, 10)
