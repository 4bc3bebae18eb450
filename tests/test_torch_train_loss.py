"""The port's ``train_loss`` and its gradients against
``jax.value_and_grad`` of the reference's, per numerics mode.

Reduced yi-6b (2 layers, d 128) with f32 parameters, the reference's
init converted with ``params_from_jax``, and the reference's
``lm_batch`` fed to both as numpy.  Under ``plam_sim`` and
``mitchell_f32`` every product goes through integer patterns, and the
reference's gradient is exactly zero; the port's must be too.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.modes import NumericsConfig as JNumericsConfig  # noqa: E402
from repro.data.synthetic import DataConfig, lm_batch  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.modes import NumericsConfig, nmatmul  # noqa: E402
from repro_torch.models.registry import build as t_build  # noqa: E402
from repro_torch.models.transformer import set_trainable  # noqa: E402

# (policy, loss rtol, per-leaf relative L2 of the gradients).  f32: the
# same arithmetic in another summation order.  posit_quant: every
# activation is re-encoded on the posit grid, where a one-ulp input
# difference can move a pattern by one step.  The bf16 carrier rounds
# every projection's output and every cotangent dot to bf16 (2^-8), so
# a summation-order difference that crosses a bf16 rounding boundary
# moves that element by a whole bf16 ulp, and the backward pass spreads
# it.  Readings on this model: the port's worst leaf (layers/attn/wk) is
# 1.61e-3 from the jitted reference, and the reference op by op is
# 1.35e-3 from itself jitted on the same leaf; the bound is 2e-3.
# test_bf16_carrier_projection_equals_the_reference_op_by_op holds one
# projection bit for bit.
CASES = {
    "f32": (1e-5, 1e-4),
    "posit_quant": (1e-4, 1e-3),
    "posit_quant_bf16": (1e-4, 2e-3),
}
ZERO_GRAD_MODES = ["plam_sim", "mitchell_f32"]
NUMERICS = {"f32": dict(mode="f32"), "posit_quant": dict(mode="posit_quant"),
            "posit_quant_bf16": dict(mode="posit_quant", carrier="bf16"),
            "plam_sim": dict(mode="plam_sim"), "mitchell_f32": dict(mode="mitchell_f32")}


def _numpy_tree(tree):
    def one(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(one, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _j_cfg(policy: str, remat: bool = True):
    jc = dataclasses.replace(j_get_config("yi-6b").reduced(), param_dtype="float32",
                             act_dtype="float32", remat=remat)
    return jc.with_numerics(JNumericsConfig(**NUMERICS[policy]))


@functools.lru_cache(maxsize=None)
def _params_and_batch():
    """The reference's init and batch (neither depends on the numerics)."""
    jc = _j_cfg("f32")
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    batch = lm_batch(DataConfig(seed=0, vocab=jc.vocab, seq_len=32, global_batch=2), 0)
    return jp, {k: np.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(policy: str):
    """(jax params, batch, loss, grads) for ``policy``."""
    jp, batch = _params_and_batch()
    loss, grads = jax.jit(jax.value_and_grad(j_build(_j_cfg(policy)).train_loss))(jp, batch)
    return jp, batch, float(loss), _flat(jax.tree.map(np.asarray, grads))


def _port(policy: str, jp, batch_np, remat: bool = True):
    tc = dataclasses.replace(t_get_config("yi-6b").reduced(), param_dtype="float32",
                             act_dtype="float32", remat=remat)
    tc = tc.with_numerics(NumericsConfig(**NUMERICS[policy]))
    model = set_trainable(params_from_jax(_numpy_tree(jp), tc, device="cpu"))
    batch = {k: torch.from_numpy(v.copy()) for k, v in batch_np.items()}
    loss = t_build(tc).train_loss(model, batch)
    named = dict(model.named_parameters())
    if loss.requires_grad:
        got = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    else:
        got = [None] * len(named)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named.items(), got)}
    return float(loss.detach()), _flat(params_to_jax(grads)), [g is None for g in got]


@pytest.mark.parametrize("policy", list(CASES))
def test_train_loss_and_grads_match_reference(policy):
    loss_rtol, grad_tol = CASES[policy]
    jp, batch, jloss, jgrads = _reference(policy)
    tloss, tgrads, _ = _port(policy, jp, batch)
    assert tloss == pytest.approx(jloss, rel=loss_rtol)
    assert set(tgrads) == set(jgrads)
    for path, want in jgrads.items():
        err = np.linalg.norm(tgrads[path] - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= grad_tol, (path, err)
        assert np.linalg.norm(want) > 0, path


@pytest.mark.parametrize("policy", ZERO_GRAD_MODES)
def test_integer_pattern_modes_give_zero_gradients_as_the_reference(policy):
    jp, batch, jloss, jgrads = _reference(policy)
    tloss, tgrads, unused = _port(policy, jp, batch)
    assert tloss == pytest.approx(jloss, rel=1e-4)
    for path, want in jgrads.items():
        assert not np.any(want), path  # the reference's gradient is exactly zero
        assert not np.any(tgrads[path]), path
    assert all(unused)  # no gradient reached any parameter, and nothing raised


@pytest.mark.parametrize("policy", ["f32"])
def test_remat_gives_the_same_numbers(policy):
    jp, batch, _, _ = _reference(policy)
    with_remat = _port(policy, jp, batch, remat=True)
    without = _port(policy, jp, batch, remat=False)
    assert with_remat[0] == without[0]
    for path in with_remat[1]:
        np.testing.assert_array_equal(with_remat[1][path], without[1][path])


def test_bf16_carrier_projection_equals_the_reference_op_by_op():
    """One posit_quant projection with the bf16 carrier: value and both
    gradients equal to the reference's, evaluated op by op (bf16
    operands, a bf16 product, bf16 cotangents through the STE)."""
    from repro.core.modes import nmatmul as j_nmatmul

    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 256)) / 11).astype(np.float32)
    ct = rng.standard_normal((16, 256)).astype(np.float32)
    jcfg = JNumericsConfig(mode="posit_quant", carrier="bf16")
    # not jitted: XLA would fold the bf16 rounding of the product's f32
    # sums into the convert that follows it
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: jnp.sum(j_nmatmul(a, b, jcfg, out_dtype=jnp.float32) * ct),
        argnums=(0, 1))(x, w)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    out = nmatmul(tx, tw, NumericsConfig(mode="posit_quant", carrier="bf16"),
                  out_dtype=torch.float32)
    tgx, tgw = torch.autograd.grad(torch.sum(out * torch.from_numpy(ct)), [tx, tw])
    out_j = np.asarray(j_nmatmul(jnp.asarray(x), jnp.asarray(w), jcfg, out_dtype=jnp.float32))
    np.testing.assert_array_equal(out.detach().numpy(), out_j)
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(tgw.numpy(), np.asarray(jgw))


def test_later_slices_raise():
    """What raised until the families trained (a MoE model; a dense model
    handed a patch prefix) now trains: one AdamW step each."""
    moe = dataclasses.replace(t_get_config("deepseek-moe-16b").reduced(),
                              param_dtype="float32", act_dtype="float32")
    api = t_build(moe)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (1, 8)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    assert_trains(api, api.init(device="cpu"), batch)
    dense = t_build(dataclasses.replace(t_get_config("yi-6b").reduced(), param_dtype="float32",
                                        act_dtype="float32"))
    prefix = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 4, 128))
                              .astype(np.float32))
    assert_trains(dense, dense.init(device="cpu"), {**batch, "embeds_prefix": prefix})


def _one_adamw_step(api, model, batch):
    """One AdamW step of ``api.train_loss`` through ``make_train_step``:
    the loss, and each float leaf's first moment (a multiple of its
    clipped gradient)."""
    from repro_torch.models.transformer import set_trainable
    from repro_torch.optim.optimizers import OptConfig, init_state
    from repro_torch.train.loop import TrainConfig, make_train_step

    model = set_trainable(model)
    tcfg = TrainConfig(opt=OptConfig())
    state = init_state(tcfg.opt, model)
    _, state, metrics = make_train_step(api.train_loss, tcfg)(model, state, batch)
    return float(metrics["loss"]), state["m"]


def assert_trains(api, model, batch):
    """A finite loss, and a finite gradient that is not all zero on every
    float leaf (the other test files import this)."""
    loss, moments = _one_adamw_step(api, model, batch)
    assert np.isfinite(loss)
    assert moments and set(moments) == {n for n, p in model.named_parameters()
                                        if p.is_floating_point()}
    for name, m in moments.items():
        assert bool(torch.isfinite(m).all()) and bool(m.any()), name
