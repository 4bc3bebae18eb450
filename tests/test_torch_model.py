"""The port's dense model, core and policy against the JAX reference.

Reduced yi-6b with f32 parameters and activations (as the reference's
launcher sets them for --reduced), weights made by the reference's init
and converted with ``repro_torch.convert.params_from_jax``.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import policy as j_policy  # noqa: E402
from repro.core.prequant import quantize_params as j_quantize  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402
from repro_torch.core.modes import nmatmul  # noqa: E402
from repro_torch.core.prequant import dequantize_params  # noqa: E402
from repro_torch.core.prequant import quantize_params as t_quantize  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

# Logit tolerances.  f32: both packages run the same f32 arithmetic in a
# different summation order (XLA vs torch), a few ulp.  posit_quant and
# plam_sim re-encode every activation onto the posit grid, where a one-ulp
# difference in an f32 input (rmsnorm, rope, softmax) can move a pattern
# by one step (2^-12 relative), and that step propagates to the logits.
TOL = {"f32": 1e-4, "posit_quant:16:1": 2e-2, "plam_sim:16:1": 2e-2}


def _cfgs(policy: str):
    j = dataclasses.replace(j_get_config("yi-6b").reduced(),
                            param_dtype="float32", act_dtype="float32")
    t = dataclasses.replace(t_get_config("yi-6b").reduced(),
                            param_dtype="float32", act_dtype="float32")
    return j.with_numerics(f"default={policy}"), t.with_numerics(f"default={policy}")


def _numpy_tree(tree):
    """JAX params -> numpy, bf16 leaves as a uint16 view."""
    def one(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(one, tree)


def _models(policy: str, prequantize: bool):
    jc, tc = _cfgs(policy)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    if prequantize:
        jp, _ = j_quantize(jc, jp)
    tm = params_from_jax(_numpy_tree(jp), tc, device="cpu")
    return jc, jp, tc, tm


@pytest.mark.parametrize("policy", list(TOL))
def test_paged_prefill_and_decode_match_reference(policy):
    jc, jp, tc, tm = _models(policy, prequantize=policy.startswith("plam"))
    tol = TOL[policy]
    rng = np.random.default_rng(0)
    s, bs, nb = 16, 8, 16
    toks = rng.integers(0, jc.vocab, (1, s)).astype(np.int32)
    block_ids = np.array([3, 5], np.int32)
    jkp, jvp = j_tf.paged_kv_pool_init(jc, nb, bs)
    tkp, tvp = t_tf.paged_kv_pool_init(tc, nb, bs, torch.bfloat16, "cpu")
    j_prefill = jax.jit(functools.partial(j_tf.paged_prefill, jc))
    j_decode = jax.jit(functools.partial(j_tf.paged_decode_step, jc))
    jl, (jkp, jvp) = j_prefill(jp, jnp.asarray(toks), jkp, jvp,
                               jnp.asarray(block_ids), jnp.int32(13))
    tl, _ = t_tf.paged_prefill(tc, tm, torch.from_numpy(toks), tkp, tvp,
                               torch.from_numpy(block_ids), 13)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    assert np.asarray(jl).argmax() == int(tl.argmax())

    tables = np.zeros((3, 4), np.int32)
    tables[0, :2] = block_ids
    tables[1, :1] = 7  # a second sequence starting from an empty cache
    lengths = np.array([13, 0, 0], np.int32)
    tok = np.array([[5], [6], [7]], np.int32)
    for _ in range(3):
        jl, (jkp, jvp) = j_decode(
            jp, jnp.asarray(tok), jkp, jvp, jnp.asarray(tables), jnp.asarray(lengths))
        tl, _ = t_tf.paged_decode_step(
            tc, tm, torch.from_numpy(tok), tkp, tvp, torch.from_numpy(tables),
            torch.from_numpy(lengths))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=tol, atol=tol)
        assert np.array_equal(jl.argmax(-1), tl.numpy().argmax(-1))
        tok = jl.argmax(-1).astype(np.int32)
        lengths = lengths + 1
    np.testing.assert_allclose(tkp.float().numpy(), np.asarray(jkp.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_lm_backbone_without_cache_matches_reference():
    jc, jp, tc, tm = _models("f32", prequantize=False)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 9)).astype(np.int32)
    jx = j_tf.embed_tokens(jc, jp, jnp.asarray(toks))
    jh, _ = j_tf.lm_backbone(jc, jp, jx, j_tf.default_positions(jc, 2, 9))
    tx = t_tf.embed_tokens(tc, tm, torch.from_numpy(toks))
    th, _ = t_tf.lm_backbone(tc, tm, tx, t_tf.default_positions(tc, 2, 9))
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)


def test_prequantized_patterns_and_meta_match_reference():
    """The port's quantize_params gives the reference's int16 patterns and
    its meta, key for key."""
    jc, tc = _cfgs("plam_sim:16:1")
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    tm = params_from_jax(_numpy_tree(jp), tc, device="cpu")
    jq, jmeta = j_quantize(jc, jp)
    tm, tmeta = t_quantize(tc, tm)
    assert tmeta == jmeta
    np.testing.assert_array_equal(tm.blocks[1].mlp.wd.numpy(),
                                  np.asarray(jq["layers"]["mlp"]["wd"][1]))
    np.testing.assert_array_equal(tm.unembed.numpy(), np.asarray(jq["unembed"]))
    assert tm.embed.dtype == torch.float32  # embeddings are never quantized
    dequantize_params(tm, tmeta)
    assert tm.blocks[0].attn.wq.dtype == torch.float32


def test_layer_mixed_site_stays_linear():
    """A site whose numerics differ across layers is not prequantized, as
    in the reference (stacked weights share one dtype)."""
    policy = "default=plam_sim:16:1, mlp@layers[0]=f32"
    jc, tc = _cfgs("f32")
    jc, tc = jc.with_numerics(policy), tc.with_numerics(policy)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    tm = params_from_jax(_numpy_tree(jp), tc, device="cpu")
    _, jmeta = j_quantize(jc, jp)
    _, tmeta = t_quantize(tc, tm)
    assert tmeta == jmeta
    assert "layers/mlp/wu" not in tmeta and tm.blocks[0].mlp.wu.is_floating_point()


POLICIES = [
    "plam_sim:16:1",
    "default=plam_sim:16:1, moe.router=f32, layers[0,-1]=posit_quant",
    "default=bf16, mlp=plam_sim:8:0, attn.out@layers[1:]=posit_quant:16:2",
    "default=f32, layers[:1]=plam_sim",
]
ROLES = ["attn.qkv", "attn.out", "mlp.up", "mlp.gate", "mlp.down", "moe.router", "lm_head"]


@pytest.mark.parametrize("spec", POLICIES)
def test_policy_parsing_and_resolution_match_reference(spec):
    jp, tp = j_policy.parse_policy(spec), t_policy.parse_policy(spec)
    assert t_policy.policy_to_str(tp) == j_policy.policy_to_str(jp)
    assert t_policy.policy_to_dict(tp) == j_policy.policy_to_dict(jp)
    n_layers = 4
    for layer in [None, *range(n_layers)]:
        for role in ROLES:
            jc = j_policy.site_for(jp, role, layer, n_layers)
            tc = t_policy.site_for(tp, role, layer, n_layers)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc), (role, layer)
    j_segs = [(a, b) for a, b, _ in j_policy.layer_segments(jp, n_layers)]
    t_segs = [(a, b) for a, b, _ in t_policy.layer_segments(tp, n_layers)]
    assert j_segs == t_segs
    assert t_policy.describe(tp) == j_policy.describe(jp)


@pytest.mark.parametrize("mode", ["f32", "bf16", "posit_quant", "plam_sim"])
@pytest.mark.parametrize("carrier", ["f32", "bf16"])
def test_nmatmul_modes_match_reference(mode, carrier):
    """Linear-weight nmatmul in every served mode.  plam_sim sums each
    K-chunk with jnp.sum in the reference, so it is only allclose."""
    from repro.core.modes import NumericsConfig as JCfg
    from repro.core.modes import nmatmul as j_nmatmul
    from repro_torch.core.modes import NumericsConfig as TCfg

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 70)).astype(np.float32)
    w = (rng.standard_normal((70, 24)) * 70 ** -0.5).astype(np.float32)
    want = np.asarray(j_nmatmul(jnp.asarray(x), jnp.asarray(w),
                                JCfg(mode=mode, carrier=carrier)), np.float32)
    got = nmatmul(torch.from_numpy(x), torch.from_numpy(w), TCfg(mode=mode, carrier=carrier))
    tol = 1e-2 if (mode, carrier) == ("posit_quant", "bf16") else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_pattern_matmul_plam_is_bit_identical():
    """Prequantized plam_sim: the pattern path is the PLAM kernel's plain
    version, bit-identical to the reference's."""
    from repro.core.modes import NumericsConfig as JCfg
    from repro.core.modes import nmatmul as j_nmatmul
    from repro.numerics import PositSpec, encode, pack16
    from repro_torch.core.modes import NumericsConfig as TCfg

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 40)).astype(np.float32)
    w = np.array(pack16(encode(jnp.asarray(rng.standard_normal((40, 12)), jnp.float32),
                                 PositSpec(16, 1))))
    want = np.asarray(j_nmatmul(jnp.asarray(x), jnp.asarray(w), JCfg(mode="plam_sim")))
    got = nmatmul(torch.from_numpy(x), torch.from_numpy(w), TCfg(mode="plam_sim"))
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_lm_init_is_seeded():
    _, tc = _cfgs("f32")
    a = t_tf.lm_init(tc, seed=3, device="cpu")
    b = t_tf.lm_init(tc, seed=3, device="cpu")
    c = t_tf.lm_init(tc, seed=4, device="cpu")
    assert torch.equal(a.blocks[1].attn.wq, b.blocks[1].attn.wq)
    assert not torch.equal(a.blocks[1].attn.wq, c.blocks[1].attn.wq)
    assert a.blocks[0].mlp.wg.shape == (tc.d_model, tc.d_ff)
