"""The port's training parts against the JAX reference: synthetic data,
the optimizers, rmsnorm's backward, the MoE load-balance loss and the
straggler detector."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.data import synthetic as j_data  # noqa: E402
from repro.models.common import _rmsnorm_core  # noqa: E402
from repro.models.moe import aux_load_balance_loss as j_aux  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro_torch.data import synthetic as t_data  # noqa: E402
from repro_torch.models.common import RMSNorm, rmsnorm  # noqa: E402
from repro_torch.models.moe import aux_load_balance_loss as t_aux  # noqa: E402
from repro_torch.optim import optimizers as t_opt  # noqa: E402
from repro_torch.train.straggler import (  # noqa: E402
    StepTimer,
    StragglerPolicy,
    run_with_straggler_sim,
)

OPTIMIZERS = ["adamw", "adam", "sgd", "nesterov"]


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16).astype(np.int32)


# -- data ---------------------------------------------------------------------


def test_classification_dataset_is_the_reference_bit_for_bit():
    for args in [(0, 300, 617, 26), (3, 128, 561, 6)]:
        jx, jy = j_data.classification_dataset(*args)
        tx, ty = t_data.classification_dataset(*args)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tx.dtype == jx.dtype and ty.dtype == jy.dtype


def test_image_dataset_is_the_reference_bit_for_bit():
    for args in [(0, 64, 28, 1, 10), (1, 40, 32, 3, 10)]:
        jx, jy = j_data.image_dataset(*args)
        tx, ty = t_data.image_dataset(*args)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_lm_batch_structure():
    cfg = t_data.DataConfig(seed=0, vocab=64, seq_len=64, global_batch=16)
    a, b = t_data.lm_batch(cfg, 3), t_data.lm_batch(cfg, 3)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (16, 64)
    assert not torch.equal(a["tokens"], t_data.lm_batch(cfg, 4)["tokens"])
    other = t_data.DataConfig(seed=1, vocab=64, seq_len=64, global_batch=16)
    assert not torch.equal(a["tokens"], t_data.lm_batch(other, 3)["tokens"])
    # labels are the next tokens
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    # about 90% of transitions follow the fixed permutation
    perm = np.random.default_rng(cfg.seed + 7).permutation(cfg.vocab)
    follow = []
    for s in range(8):
        bt = t_data.lm_batch(cfg, s)
        tok, lab = bt["tokens"].numpy(), bt["labels"].numpy()
        follow.append(np.mean(perm[tok] == lab))
    assert 0.86 < np.mean(follow) < 0.94, follow


# -- optimizers ------------------------------------------------------------------


def _opt_case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "b": rng.standard_normal((16,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.3, 2.0, 0.05)]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    jg = [{k: jnp.asarray(v).astype(jdt) for k, v in g.items()} for g in grads]
    tg = [{k: torch.from_numpy(v).to(tdt) for k, v in g.items()} for g in grads]
    return jp, tp, jg, tg


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_apply_updates_matches_reference(name, dtype):
    """Three steps (the second clipped by the global norm) on the same
    params and grads: f32 within rtol 1e-6; bf16 the same bits or 1 ulp."""
    cfg_kw = dict(name=name, lr=1e-2, weight_decay=0.01)
    jcfg, tcfg = j_opt.OptConfig(**cfg_kw), t_opt.OptConfig(**cfg_kw)
    jp, tp, jg, tg = _opt_case(dtype)
    js, ts = j_opt.init_state(jcfg, jp), t_opt.init_state(tcfg, tp)
    for g_j, g_t in zip(jg, tg):
        jp, js = j_opt.apply_updates(jcfg, jp, g_j, js)
        tp, ts = t_opt.apply_updates(tcfg, tp, g_t, ts)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in jp:
        if dtype == "f32":
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        else:
            ulps = np.abs(_bf16_bits(tp[k].view(torch.int16).numpy())
                          - _bf16_bits(np.asarray(jp[k])))
            assert ulps.max() <= 1, (k, ulps.max())
    for key in [k for k in js if k != "step"]:
        for k in jp:
            np.testing.assert_allclose(ts[key][k].numpy(), np.asarray(js[key][k]),
                                       rtol=1e-5, atol=1e-7)


def test_apply_updates_takes_none_as_a_zero_gradient():
    cfg = t_opt.OptConfig(name="adamw", lr=1e-2)
    p = {"a": torch.ones(4), "b": torch.ones(4)}
    state = t_opt.init_state(cfg, p)
    p_zero = {k: v.clone() for k, v in p.items()}
    state_zero = t_opt.init_state(cfg, p_zero)
    g = torch.full((4,), 0.5)
    t_opt.apply_updates(cfg, p, {"a": g, "b": None}, state)
    t_opt.apply_updates(cfg, p_zero, {"a": g, "b": torch.zeros(4)}, state_zero)
    for k in p:
        assert torch.equal(p[k], p_zero[k])
        assert torch.equal(state["m"][k], state_zero["m"][k])


# -- rmsnorm backward --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_backward_matches_reference(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    ct = rng.standard_normal((3, 7, 64)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx, js, jct = (jnp.asarray(a).astype(jdt) for a in (x, scale, ct))
    out, vjp = jax.vjp(lambda a, s: _rmsnorm_core(a, s, 1e-6), jx, js)
    jdx, jds = vjp(jct)
    norm = RMSNorm(64, dtype=tdt)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale).to(tdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tout = rmsnorm(norm, tx)
    tdx, tds = torch.autograd.grad(tout, [tx, norm.scale], torch.from_numpy(ct).to(tdt))
    assert tdx.dtype == tdt and tds.dtype == tdt
    for got, want in [(tout, out), (tdx, jdx), (tds, jds)]:
        if dtype == "f32":
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        else:
            ulps = np.abs(_bf16_bits(got.detach().view(torch.int16).numpy())
                          - _bf16_bits(np.asarray(want)))
            assert ulps.max() <= 1, ulps.max()


# -- MoE load-balance loss -------------------------------------------------------------


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((50, 8)).astype(np.float32) * 2
    eid = rng.integers(0, 8, (50, 2)).astype(np.int32)
    want = float(j_aux(jnp.asarray(logits), jnp.asarray(eid), 8))
    got = float(t_aux(torch.from_numpy(logits), torch.from_numpy(eid), 8))
    assert got == pytest.approx(want, rel=1e-6)


# -- straggler detection (ports of tests/test_resilience.py) -----------------------------


def test_straggler_detection_and_escalation():
    flags, events = run_with_straggler_sim(
        lambda i: None, 60, slow_steps={k: 0.5 for k in range(30, 36)},
        timer=StepTimer(min_samples=5), policy=StragglerPolicy(patience=3, action="drop"),
        base_step_seconds=0.01)
    assert all(flags[30:36]), flags[28:38]
    assert not any(flags[:30])
    assert events and events[0]["action"] == "drop"
    assert 32 <= events[0]["step"] <= 35


def test_straggler_isolated_blips_do_not_escalate():
    flags, events = run_with_straggler_sim(
        lambda i: None, 60, slow_steps={20: 0.5, 40: 0.5},
        timer=StepTimer(min_samples=5), policy=StragglerPolicy(patience=3),
        base_step_seconds=0.01)
    assert flags[20] and flags[40]
    assert events == []


def test_straggler_window_not_poisoned():
    t = StepTimer(min_samples=5, window=20)
    for _ in range(10):
        t.observe(0.010)
    assert t.observe(0.5)
    assert t.observe(0.5)
