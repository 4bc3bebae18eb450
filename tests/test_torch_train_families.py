"""Training of the MoE, ssm, hybrid, encdec and vlm families: the port's
``train_loss`` and every leaf of its gradient against
``jax.value_and_grad`` of the reference's.

Each arch's ``.reduced()`` config with f32 parameters (2 layers, d 128),
the reference's init converted with ``params_from_jax``, the reference's
``lm_batch`` and seeded numpy frames or patch embeddings fed to both.
The tolerances are those of ``test_torch_train_loss.py``: f32 the same
arithmetic in another summation order; ``posit_quant`` re-encodes every
activation on the posit grid, where a one-ulp input difference can move
a pattern by one step (those cases are in
``test_torch_train_posit_{moe_ssm,hybrid_encdec_vlm}.py``, which import
this file's helpers).  The reference runs jitted and torch on one intra-op thread
(the suite runs in parallel workers on shared cores).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ShapeSpec  # noqa: E402
from repro.core.modes import NumericsConfig as JNumericsConfig  # noqa: E402
from repro.data.synthetic import DataConfig, lm_batch  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.modes import NumericsConfig  # noqa: E402
from repro_torch.models.registry import build as t_build  # noqa: E402
from repro_torch.models.transformer import set_trainable  # noqa: E402

from test_torch_ssm import one_thread  # noqa: E402,F401

ARCHS = ["deepseek-moe-16b", "granite-moe-1b-a400m", "mamba2-780m", "zamba2-1.2b",
         "seamless-m4t-medium", "qwen2-vl-72b"]
# (loss rtol, per-leaf relative L2 of the gradients)
TOL = {"f32": (1e-5, 1e-4), "posit_quant": (1e-4, 1e-3)}
SEQ, BATCH = 32, 2


pytestmark = pytest.mark.usefixtures("one_thread")


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


def _cfgs(arch, mode="f32", remat=None):
    jc = dataclasses.replace(j_get_config(arch).reduced(), param_dtype="float32",
                             act_dtype="float32")
    tc = dataclasses.replace(t_get_config(arch).reduced(), param_dtype="float32",
                             act_dtype="float32")
    if remat is not None:
        jc, tc = (dataclasses.replace(c, remat=remat) for c in (jc, tc))
    return (jc.with_numerics(JNumericsConfig(mode=mode)),
            tc.with_numerics(NumericsConfig(mode=mode)))


@functools.lru_cache(maxsize=None)
def _params_and_batch(arch):
    """The reference's init and a batch of ``train_inputs``' shapes: the
    reference's lm_batch tokens, seeded frames or patch embeddings."""
    jc, _ = _cfgs(arch)
    api = j_build(jc)
    jp = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(0)))
    spec = api.train_inputs(ShapeSpec("t", SEQ, BATCH, "train"))
    s_tok = spec["tokens"].shape[1]
    batch = {k: np.asarray(v) for k, v in
             lm_batch(DataConfig(seed=0, vocab=jc.vocab, seq_len=s_tok,
                                 global_batch=BATCH), 0).items()}
    rng = np.random.default_rng(5)
    for name in ("frames", "embeds_prefix"):
        if name in spec:
            batch[name] = rng.standard_normal(spec[name].shape).astype(np.float32)
    return jp, batch


@functools.lru_cache(maxsize=None)
def _reference(arch, mode):
    jp, batch = _params_and_batch(arch)
    jc, _ = _cfgs(arch, mode)
    loss, grads = jax.jit(jax.value_and_grad(j_build(jc).train_loss))(jp, batch)
    return float(loss), _flat(jax.tree.map(np.asarray, grads))


def _port(arch, mode, remat=None):
    jp, batch = _params_and_batch(arch)
    _, tc = _cfgs(arch, mode, remat)
    model = set_trainable(params_from_jax(_numpy_tree(jp), tc, device="cpu"))
    loss = t_build(tc).train_loss(model, {k: torch.from_numpy(v.copy())
                                          for k, v in batch.items()})
    named = dict(model.named_parameters())
    got = (torch.autograd.grad(loss, list(named.values()), allow_unused=True)
           if loss.requires_grad else [None] * len(named))
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named.items(), got)}
    return float(loss.detach()), _flat(params_to_jax(grads)), [g is None for g in got]


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def check_against_reference(arch, mode):
    loss_rtol, grad_tol = TOL[mode]
    jloss, jgrads = _reference(arch, mode)
    tloss, tgrads, _ = _port(arch, mode)
    assert tloss == pytest.approx(jloss, rel=loss_rtol)
    assert set(tgrads) == set(jgrads)
    for path, want in jgrads.items():
        assert np.linalg.norm(want) > 0, path
        assert _rel(tgrads[path], want) <= grad_tol, (path, _rel(tgrads[path], want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_leaf_match_reference(arch):
    """f32: loss and every leaf of the gradient, the encoder's leaves of
    the encdec (``frontend_proj``, ``enc_layers/*``, ``ln_enc``), the MoE
    router and expert stacks and the ssm's f32 leaves among them."""
    check_against_reference(arch, "f32")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m"])
def test_plam_sim_gives_zero_gradients_as_the_reference(arch):
    """Every plam_sim product goes through integer patterns; the
    reference's gradient is exactly zero but where a leaf reaches the loss
    outside every product (the ssm's f32 scan leaves, the norms, the MoE
    router's exact f32 site), and the port's is the same."""
    jloss, jgrads = _reference(arch, "plam_sim")
    tloss, tgrads, _ = _port(arch, "plam_sim")
    assert tloss == pytest.approx(jloss, rel=1e-4)
    zero = [p for p, g in jgrads.items() if not np.any(g)]
    assert zero  # the projections
    for path, want in jgrads.items():
        if not np.any(want):
            assert not np.any(tgrads[path]), path
        else:
            assert _rel(tgrads[path], want) <= 1e-3, (path, _rel(tgrads[path], want))


def test_moe_remat_gives_the_same_numbers():
    """deepseek-moe-16b's remat recomputes every layer in the backward
    pass, routing included: the same loss and gradients as without."""
    with_remat = _port("deepseek-moe-16b", "f32", remat=True)
    without = _port("deepseek-moe-16b", "f32", remat=False)
    assert with_remat[0] == without[0]
    for path in with_remat[1]:
        np.testing.assert_array_equal(with_remat[1][path], without[1][path])


@pytest.mark.parametrize("arch", ARCHS + ["yi-6b"])
def test_train_inputs_match_the_reference(arch):
    jc, tc = _cfgs(arch)
    for seq in (SEQ, 4100):
        want = j_build(jc).train_inputs(ShapeSpec("t", seq, 3, "train"))
        got = t_build(tc).train_inputs(3, seq)
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), (arch, k)
            assert got[k].device.type == "meta"
            assert str(got[k].dtype)[6:] == str(np.dtype(w.dtype)), (arch, k)


def test_ssd_mask_overflow_gives_nan_gradients_as_the_reference():
    """The SSD scan forms ``exp(dec)`` over the whole chunk and masks the
    upper triangle after it (``torch.where(mask, exp(dec), 0)``, the
    reference's ``jnp.where``).  Above the diagonal ``dec`` is the decay
    summed between two positions, positive; past 88.7 its f32 exp is inf,
    and the backward's 0 x inf is NaN though the loss is finite.  The port
    mirrors it: with ``dt_bias`` = 8 (dt near 8, a masked exponent near
    15 x 8 = 120 in the reduced chunk of 16) both give a finite loss and
    NaN in the same gradient leaves (the config's own ``dt_bias`` of -2
    gives finite gradients in both, test_train_loss_and_every_gradient_
    leaf_match_reference)."""
    arch = "mamba2-780m"
    jp, batch = _params_and_batch(arch)
    jc, tc = _cfgs(arch)
    mamba = jp["layers"]["mamba"]
    jp = {**jp, "layers": {**jp["layers"], "mamba": {
        **mamba, "dt_bias": np.full_like(mamba["dt_bias"], 8.0)}}}
    jloss, jgrads = jax.jit(jax.value_and_grad(j_build(jc).train_loss))(jp, batch)
    model = set_trainable(params_from_jax(_numpy_tree(jp), tc, device="cpu"))
    loss = t_build(tc).train_loss(model, {k: torch.from_numpy(v.copy())
                                          for k, v in batch.items()})
    named = dict(model.named_parameters())
    tgrads = _flat(params_to_jax(dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))))
    jgrads = _flat(jax.tree.map(np.asarray, jgrads))
    assert np.isfinite(float(jloss)) and np.isfinite(float(loss.detach()))
    want = {p for p, g in jgrads.items() if np.isnan(g).any()}
    assert want and want == {p for p, g in tgrads.items() if np.isnan(g).any()}
