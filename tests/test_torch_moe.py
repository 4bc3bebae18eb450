"""The port's MoE layer, its stacked-expert ``nmatmul`` and the grouped PLAM
matmul against the JAX reference.

Reduced deepseek-moe-16b (4 experts, top-2, 2 shared experts) and
granite-moe-1b-a400m (4 experts, top-2, no shared expert), weights made
by the reference's init and converted with
``repro_torch.convert.params_from_jax``; activations made with numpy.
The dispatch couples the tokens of a forward, so the routing is held to
the reference's at the level of its indices (``eid``, ``pos``,
``keep``), the expert buffer bit for bit, and under prequantized
``plam_sim`` each expert projection bit for bit (the JAX kernel in
interpret mode against the port's plain version).  The grouped kernel's
own check against the 2-D kernel needs the card (``cuda`` marker).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.modes import NumericsConfig as JCfg  # noqa: E402
from repro.core.modes import nmatmul as j_nmatmul  # noqa: E402
from repro.core.policy import layer_segments as j_layer_segments  # noqa: E402
from repro.core.policy import site as j_site  # noqa: E402
from repro.core.prequant import quantize_params as j_quantize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.numerics import PositSpec as JSpec  # noqa: E402
from repro.numerics import encode as j_encode  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.modes import NumericsConfig as TCfg  # noqa: E402
from repro_torch.core.modes import nmatmul  # noqa: E402
from repro_torch.core.policy import site as t_site  # noqa: E402
from repro_torch.kernels import _lib, ops  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.common import iter_layers  # noqa: E402
from repro_torch.numerics import P16, pack16  # noqa: E402

from test_torch_chunked import _numpy_tree  # noqa: E402

# Output tolerances.  f32: the same f32 arithmetic in another summation
# order (XLA vs torch), a few ulp.  The posit modes and bf16 round every
# activation to a grid (posit patterns, bf16), where a one-ulp difference
# in an f32 input can move a value by one step (2^-12 relative for a
# posit, 2^-8 for bf16), the dense tests' 2e-2 (tests/test_torch_model.py).
# mitchell_f32 sums the same products in another order: f32 rounding.
TOL = {"f32": 1e-5, "bf16": 2e-2, "posit_quant:16:1": 2e-2, "plam_sim:16:1": 2e-2,
       "plam_sim:16:1 prequantized": 2e-2, "mitchell_f32": 1e-5}
ARCHS = {"deepseek": "deepseek-moe-16b", "granite": "granite-moe-1b-a400m"}
# tokens of a forward: B x S = 2 x 16, 16 a group at groups = 2
SHAPE = (2, 16)


def _cfg(get, arch: str, policy: str):
    c = dataclasses.replace(get(ARCHS[arch]).reduced(), param_dtype="float32",
                            act_dtype="float32")
    return c.with_numerics(f"default={policy}")


@functools.lru_cache(maxsize=None)
def _params(arch: str, prequantize: bool):
    """The reference's f32 init at seed 0, prequantized under plam_sim:16:1
    or not, and the port's model converted from it."""
    jc = _cfg(j_get_config, arch, "plam_sim:16:1")
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    if prequantize:
        jp, _ = j_quantize(jc, jp)
    tc = _cfg(t_get_config, arch, "plam_sim:16:1")
    return jp, params_from_jax(_numpy_tree(jp), tc, device="cpu")


def models(arch: str, policy: str, prequantize: bool = False):
    """(jc, jp, tc, tm) for the reduced arch in f32 under ``policy`` (the
    bf16 policy runs bf16 operands on f32 weights and activations).  Every
    policy shares one set of weights."""
    jp, tm = _params(arch, prequantize)
    return _cfg(j_get_config, arch, policy), jp, _cfg(t_get_config, arch, policy), tm


def _sites(jc, tc):
    return (j_layer_segments(jc.numerics, jc.n_layers)[0][2],
            next(iter(iter_layers(tc.numerics, tc.n_layers)))[1])


def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["layers"]["moe"])


def _x(d, seed=0, shape=SHAPE):
    """Activations with a direction all tokens share, so that the router
    favours some experts and a capacity factor of 1.25 drops rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, d)) + 2.0 * rng.standard_normal(d)
    return x.astype(np.float32)


def _j_route(logits, top_k, cap):
    """The reference's routing lines (repro/models/moe.py::_dispatch_group)
    on f32 logits: (gate, eid, pos, keep)."""
    probs = jax.nn.softmax(logits, axis=-1)
    gate, eid = jax.lax.top_k(probs, top_k)
    gate = gate / jnp.sum(gate, axis=-1, keepdims=True)
    eid_f = eid.reshape(-1)
    oh = jax.nn.one_hot(eid_f, logits.shape[-1], dtype=jnp.int32)
    pos = jnp.cumsum(oh, axis=0) - oh
    pos = jnp.take_along_axis(pos, eid_f[:, None], axis=-1)[:, 0]
    return gate, eid_f, pos, pos < cap


def _j_buffer(xf, eid, pos, keep, n_experts, cap, top_k):
    """The reference's expert buffer (its scatter-add of kept rows)."""
    pos_c = jnp.where(keep, pos, cap - 1)
    tok_idx = jnp.repeat(jnp.arange(xf.shape[0]), top_k)
    contrib = jnp.where(keep[:, None], xf[tok_idx], 0).astype(xf.dtype)
    return jnp.zeros((n_experts, cap, xf.shape[1]), xf.dtype).at[eid, pos_c].add(contrib)


def _cap(t, top_k, n_experts, cf):
    return max(1, int(t * top_k / n_experts * cf))


# -- routing ---------------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.25, 100.0])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_route_and_dispatch_match_reference(arch, cf):
    """eid, pos and keep equal the reference's exactly, and the expert
    buffer is bit-identical, on the layer's own router logits."""
    jc, jp, tc, tm = models(arch, "f32")
    x = _x(jc.d_model).reshape(-1, jc.d_model)
    logits = x @ np.asarray(_layer0(jp)["router"])
    cap = _cap(x.shape[0], jc.top_k, jc.n_experts, cf)
    j_gate, j_eid, j_pos, j_keep = _j_route(jnp.asarray(logits), jc.top_k, cap)
    gate, eid, pos, keep = t_moe.route(torch.from_numpy(logits), tc.top_k, cap)
    np.testing.assert_array_equal(eid.numpy(), np.asarray(j_eid))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    np.testing.assert_allclose(gate.numpy(), np.asarray(j_gate), rtol=1e-6, atol=1e-7)
    assert bool((~keep).any()) == (cf == 1.25)  # 1.25 drops rows here, 100 none
    buf = t_moe.dispatch(torch.from_numpy(x), eid, pos, keep, tc.n_experts, cap)
    j_buf = _j_buffer(jnp.asarray(x), j_eid, j_pos, j_keep, jc.n_experts, cap, jc.top_k)
    np.testing.assert_array_equal(buf.numpy().view(np.uint32),
                                  np.asarray(j_buf).view(np.uint32))


def test_zero_router_ties_go_to_the_lowest_experts():
    """Every probability ties: the reference (jax.lax.top_k) picks experts
    0..k-1 for every token, and so does the port."""
    t, e, k = 12, 8, 3
    logits = np.zeros((t, e), np.float32)
    _, j_eid, j_pos, _ = _j_route(jnp.asarray(logits), k, 100)
    gate, eid, pos, _ = t_moe.route(torch.from_numpy(logits), k, 100)
    np.testing.assert_array_equal(eid.numpy(), np.tile(np.arange(k), t))
    np.testing.assert_array_equal(eid.numpy(), np.asarray(j_eid))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    np.testing.assert_allclose(gate.numpy(), np.full((t, k), 1 / k, np.float32))


def test_zero_router_layer_matches_reference():
    """The whole layer with a zero router, where every choice ties."""
    jc, jp, tc, tm = models("deepseek", "f32")
    jsite, tsite = _sites(jc, tc)
    jl = dict(_layer0(jp), router=jnp.zeros_like(_layer0(jp)["router"]))
    tl = tm.blocks[0].moe
    router = tl.router
    tl.router = torch.nn.Parameter(torch.zeros_like(router), requires_grad=False)
    try:
        x = _x(jc.d_model, seed=3)
        kw = dict(n_experts=jc.n_experts, top_k=jc.top_k, capacity_factor=1.25, act=jc.act)
        want = np.asarray(j_moe.moe_apply(jl, jnp.asarray(x), jsite, **kw))
        got = t_moe.moe_apply(tl, torch.from_numpy(x), tsite, **kw).numpy()
    finally:
        tl.router = router
    np.testing.assert_allclose(got, want, rtol=TOL["f32"], atol=TOL["f32"])


# -- the layer ---------------------------------------------------------------------


def _moe_case(policy, arch, cf, groups):
    prequantize = policy.endswith("prequantized")
    jc, jp, tc, tm = models(arch, policy.split()[0], prequantize)
    jsite, tsite = _sites(jc, tc)
    x = _x(jc.d_model, seed=1)
    kw = dict(n_experts=jc.n_experts, top_k=jc.top_k, capacity_factor=cf, act=jc.act,
              groups=groups)
    want = np.asarray(j_moe.moe_apply(_layer0(jp), jnp.asarray(x), jsite, **kw))
    got = t_moe.moe_apply(tm.blocks[0].moe, torch.from_numpy(x), tsite, **kw)
    tol = TOL[policy]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert all(v == 0 for v in _lib.launches.values())  # CPU: plain versions only


@pytest.mark.parametrize("policy,cf", [(policy, 1.25) for policy in TOL] + [
    ("f32", 100.0), ("plam_sim:16:1 prequantized", 100.0)])
def test_moe_apply_matches_reference(policy, cf):
    """Every mode with rows dropped (capacity factor 1.25), and f32 and the
    serving numerics with none (100), deepseek's shape (2 shared
    experts), one group."""
    _moe_case(policy, "deepseek", cf, 1)


@pytest.mark.parametrize("cf,groups", [(1.25, 2), (100.0, 1)])
@pytest.mark.parametrize("policy", ["f32", "plam_sim:16:1 prequantized"])
def test_moe_apply_granite_groups_match_reference(policy, cf, groups):
    """granite's shape (no shared expert), one and two dispatch groups."""
    _moe_case(policy, "granite", cf, groups)


def test_moe_apply_deepseek_two_groups_matches_reference():
    _moe_case("plam_sim:16:1 prequantized", "deepseek", 1.25, 2)


def test_prequantized_expert_projections_bit_identical():
    """Under prequantized plam_sim each expert projection of the buffer is
    the reference's bit for bit: the JAX PLAM kernel (interpret mode,
    under vmap over experts) against the port's grouped plain version."""
    jc, jp, tc, tm = models("deepseek", "plam_sim:16:1", True)
    jsite, tsite = _sites(jc, tc)
    jl, tl = _layer0(jp), tm.blocks[0].moe
    x = _x(jc.d_model, seed=2).reshape(-1, jc.d_model)
    cap = _cap(x.shape[0], jc.top_k, jc.n_experts, 1.25)
    _, eid, pos, keep = _j_route(jnp.asarray(x) @ jl["router"], jc.top_k, cap)
    buf = _j_buffer(jnp.asarray(x), eid, pos, keep, jc.n_experts, cap, jc.top_k)
    for name, role, xin in [("wu", "up", buf), ("wg", "gate", buf),
                            ("wd", "down", jax.nn.silu(buf[..., :jc.moe_d_ff] * 0.5))]:
        jcfg = j_site(jsite, f"moe.expert.{role}")
        want = jax.vmap(lambda xe, we: j_nmatmul(xe, we, jcfg, out_dtype=jnp.float32))(
            xin, jl[name])
        got = nmatmul(torch.from_numpy(np.array(xin)), getattr(tl, name),
                      t_site(tsite, f"moe.expert.{role}"), out_dtype=torch.float32)
        assert getattr(tl, name).dtype == torch.int16
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))


# -- nmatmul over a stack of experts ---------------------------------------------


def _stack_operands(e=3, c=5, k=70, n=12, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) * k ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("mode,kw", [
    ("f32", {}), ("bf16", {}), ("posit_quant", {}), ("posit_quant", {"carrier": "bf16"}),
    ("plam_sim", {}), ("mitchell_f32", {}),
], ids=["f32", "bf16", "posit_quant", "posit_quant-bf16", "plam_sim", "mitchell_f32"])
@pytest.mark.parametrize("patterns", [False, True], ids=["float-w", "int16-w"])
def test_nmatmul_over_a_stack_matches_vmap(mode, kw, patterns):
    """[E, C, K] x [E, K, N] against jax.vmap(nmatmul) over the experts:
    float weights, and int16 posit patterns (prequantized storage)."""
    x, w = _stack_operands()
    if patterns:
        w = np.asarray(pack16(torch.from_numpy(
            np.array(j_encode(jnp.asarray(w), JSpec(16, 1)))).to(torch.int32)))
    want = jax.vmap(lambda xe, we: j_nmatmul(xe, we, JCfg(mode=mode, **kw),
                                             out_dtype=jnp.float32))(x, w)
    got = nmatmul(torch.from_numpy(x), torch.from_numpy(w), TCfg(mode=mode, **kw),
                  out_dtype=torch.float32)
    if mode == "plam_sim" and patterns:  # the PLAM kernel on both sides
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    else:
        # plam_sim over float weights: the reference sums K-chunks with
        # jnp.sum, the port k by k; bf16 and posit_quant: f32 sum order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # row block e times weight e, whatever the mode
    one = nmatmul(torch.from_numpy(x[1]), torch.from_numpy(w[1]), TCfg(mode=mode, **kw),
                  out_dtype=torch.float32)
    np.testing.assert_allclose(got[1].numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


def test_nmatmul_stack_rejects_flat_rows():
    x, w = _stack_operands()
    with pytest.raises(ValueError, match="stack of 3 experts"):
        nmatmul(torch.from_numpy(x.reshape(-1, x.shape[-1])), torch.from_numpy(w),
                TCfg(mode="f32"))


# -- K1 over a stack of experts ----------------------------------------------------


@pytest.mark.parametrize("m", [1, 7, 20])
def test_grouped_plain_plam_dense_matches_vmapped_kernel(m):
    """The grouped plain version against the JAX plam_dense (the Pallas
    kernel in interpret mode) under vmap over experts, bit for bit, at
    the decode path's M and one prefill M; int16 and int32 patterns, f32
    and bf16 activations."""
    rng = np.random.default_rng(m)
    e, k, n = 3, 70, 24
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    x[0, 0, :5] = 0.0  # zero lanes add +0.0
    w = np.array(j_encode(jnp.asarray(rng.standard_normal((e, k, n)), jnp.float32),
                            JSpec(16, 1)))
    want = np.asarray(jax.vmap(lambda xe, we: jops.plam_dense(xe, we))(x, w))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for xa in (xt, xt.to(torch.bfloat16)):
        want_a = want if xa.dtype == torch.float32 else np.asarray(jax.vmap(
            lambda xe, we: jops.plam_dense(xe, we))(
                np.asarray(xa.float()), w))
        for wb in (wt, pack16(wt)):
            got = ops.plam_dense(xa, wb, P16)
            assert got.shape == (e, m, n)
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          want_a.view(np.uint32))
    # patterns in A: plam_matmul_bits over the stack, expert by expert
    a = torch.from_numpy(np.array(j_encode(jnp.asarray(x), JSpec(16, 1))))
    got = ops.plam_matmul_bits(a, wt, P16)
    for i in range(e):
        assert torch.equal(got[i].view(torch.int32),
                           ops.plam_matmul_bits(a[i], wt[i], P16).view(torch.int32))


def test_grouped_operands_are_checked():
    a = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes"):
        ops.plam_matmul_bits(a, torch.zeros((3, 4, 5), dtype=torch.int32), P16)
    with pytest.raises(ValueError, match="shapes"):
        ops.plam_matmul_bits(a, torch.zeros((4, 5), dtype=torch.int32), P16)
    with pytest.raises(ValueError, match="x \\[E, C, K\\]"):
        ops.plam_dense(torch.zeros((3, 4)), torch.zeros((2, 4, 5), dtype=torch.int16), P16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 1, 2048, 1408), (32, 7, 1024, 512),
                                   (3, 65, 4097, 511), (3, 5, 1025, 9)],
                         ids=["deepseek-decode", "granite-decode", "prefill-ragged",
                              "ragged"])
def test_cuda_grouped_plam_matmul_equals_2d_kernel(cuda_device, shape):
    """One launch over all experts equals the 2-D kernel run expert by
    expert, bit for bit, for f32 and bf16 activations and int16 and
    int32 patterns."""
    e, m, k, n = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((e, m, k), generator=g, device=cuda_device)
    w32 = ops.posit_encode(torch.randn((e, k, n), generator=g, device=cuda_device) * k ** -0.5,
                           P16)
    for xa in (x, x.to(torch.bfloat16)):
        for wb in (w32, pack16(w32)):
            before = dict(_lib.launches)
            got = ops.plam_dense(xa, wb, P16)
            assert _lib.launches["plam_matmul_grouped"] == before["plam_matmul_grouped"] + 1
            for i in range(e):
                assert torch.equal(got[i].view(torch.int32),
                                   ops.plam_dense(xa[i], wb[i], P16).view(torch.int32))
            assert torch.equal(got.view(torch.int32),
                               ops.plam_dense(xa, wb, P16, use_kernel=False).view(torch.int32))
