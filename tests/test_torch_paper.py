"""The port's paper models (Table I/II) and ``calibrate`` against the JAX
reference.

The paper models run on the reference's own parameters (converted to a
dict of tensors) at hw 8 and a batch of 4; ``calibrate`` runs on the
reduced yi-6b with the reference's parameters and batch.
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
from repro.core.policy import parse_policy as j_parse_policy  # noqa: E402
from repro.data.synthetic import DataConfig, lm_batch  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.numerics import calibrate as j_cal  # noqa: E402
from repro.paper import models as j_pm  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.modes import NumericsConfig  # noqa: E402
from repro_torch.core.policy import parse_policy  # noqa: E402
from repro_torch.numerics import calibrate as t_cal  # noqa: E402
from repro_torch.paper import models as t_pm  # noqa: E402

# logits: f32 in another summation order; posit_quant re-encodes every
# activation on the posit grid; plam_sim sums the reference's K-chunks
# with jnp.sum, the port's plain K1 in order
MODES = {"f32": 1e-5, "posit_quant": 1e-4, "plam_sim": 1e-4}
MODELS = {
    "mlp": (lambda k: j_pm.mlp_init(k, (40, 24, 16, 6)), j_pm.mlp_apply, t_pm.mlp_apply,
            (4, 40)),
    "lenet5": (lambda k: j_pm.lenet5_init(k, in_ch=3, n_classes=10, hw=8), j_pm.lenet5_apply,
               t_pm.lenet5_apply, (4, 8, 8, 3)),
    "cifarnet": (lambda k: j_pm.cifarnet_init(k, in_ch=3, n_classes=10, hw=8),
                 j_pm.cifarnet_apply, t_pm.cifarnet_apply, (4, 8, 8, 3)),
}


def _torch_params(jp):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}


@functools.lru_cache(maxsize=None)
def _j_params(model, seed):
    return MODELS[model][0](jax.random.PRNGKey(seed))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model", list(MODELS))
def test_paper_model_logits_match_reference(model, mode):
    _, j_apply, t_apply, x_shape = MODELS[model]
    jp = _j_params(model, 1)
    x = np.random.default_rng(0).standard_normal(x_shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: j_apply(p, a, JNumericsConfig(mode=mode)))(jp, x))
    got = t_apply(_torch_params(jp), torch.from_numpy(x), NumericsConfig(mode=mode))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=MODES[mode], atol=MODES[mode])


def test_conv_mirrors_the_reference_im2col_permutation():
    """For C > 1 the reference's conv is a permuted convolution (patch
    features (C, kh, kw) against weight rows (kh, kw, C)); the port's is
    the same function, not the true convolution."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    want = np.asarray(j_pm._conv2d(jnp.asarray(x), jnp.asarray(w), JNumericsConfig(mode="f32")))
    got = t_pm._conv2d(torch.from_numpy(x), torch.from_numpy(w), NumericsConfig(mode="f32"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    true_conv = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    assert not torch.allclose(got, true_conv, atol=1e-3)


def test_train_classifier_adam_step_matches_reference():
    init, j_apply, t_apply, _ = MODELS["lenet5"]
    jp = init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    # one epoch of one batch of every sample: the same step in any order
    want = j_pm.train_classifier(lambda k: jp, j_apply, x, y, epochs=1, batch=16, lr=1e-3)
    got = t_pm.train_classifier(lambda g: _torch_params(jp), t_apply, x, y, epochs=1, batch=16,
                                lr=1e-3, device="cpu")
    for k in jp:
        assert not np.array_equal(np.asarray(want[k]), np.asarray(jp[k]))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)


def test_train_classifier_under_plam_sim_moves_only_what_a_gradient_reaches():
    """The reference's gradient through plam_sim's products is zero: its
    weights stay, the bias after the last product trains."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    y = (np.arange(32) % 3).astype(np.int32)
    init = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
            j_pm.mlp_init(jax.random.PRNGKey(0), (8, 6, 3)).items()}
    got = t_pm.train_classifier(lambda g: init, t_pm.mlp_apply, x, y, epochs=1, batch=16,
                                ncfg=NumericsConfig(mode="plam_sim"), device="cpu")
    for k in ("w0", "w1", "b0"):
        assert torch.equal(got[k], init[k]), k
    assert not torch.equal(got["b1"], init["b1"])


def test_accuracy_topk_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((37, 10)).astype(np.float32)
    logits[3, :] = 0.5  # a full tie
    y = rng.integers(0, 10, 37).astype(np.int32)
    xs = np.arange(37, dtype=np.float32)[:, None]

    def j_apply(p, x, ncfg):
        return jnp.asarray(logits)[x[:, 0].astype(jnp.int32)]

    def t_apply(p, x, ncfg, use_kernel=None):
        return torch.from_numpy(logits)[x[:, 0].to(torch.long)]

    want = j_pm.accuracy(j_apply, {}, xs, y, JNumericsConfig(mode="f32"), batch=8,
                         topk=(1, 3, 5))
    got = t_pm.accuracy(t_apply, {"p": torch.zeros(1)}, xs, y, NumericsConfig(mode="f32"),
                        batch=8, topk=(1, 3, 5))
    assert got == want


# -- calibrate ------------------------------------------------------------------


def test_cost_model_matches_reference():
    specs = ["f32", "bf16", "mitchell_f32", "posit_quant:16:1", "plam_sim:16:1",
             "plam_sim:8:0", "posit_quant:32:2"]
    for spec in specs:
        j = j_cal.unit_mult_cost(j_cal.parse_cfg_spec(spec))
        assert t_cal.unit_mult_cost(t_cal.parse_cfg_spec(spec)) == j
    policies = ["default=f32", "default=plam_sim:16:1", "default=f32, mlp=plam_sim:16:1",
                "default=posit_quant:16:1, layers[0]=plam_sim:16:1, lm_head=f32"]
    for arch in ["yi-6b", "deepseek-moe-16b"]:
        jc, tc = j_get_config(arch), t_get_config(arch)
        assert t_cal.default_candidate_sites(tc) == j_cal.default_candidate_sites(jc)
        for pol in policies:
            assert t_cal.estimate_cost(tc, parse_policy(pol)) == j_cal.estimate_cost(
                jc, j_parse_policy(pol))


@functools.lru_cache(maxsize=None)
def _calibration_case():
    jc = dataclasses.replace(j_get_config("yi-6b").reduced(), param_dtype="float32",
                             act_dtype="float32")
    tc = dataclasses.replace(t_get_config("yi-6b").reduced(), param_dtype="float32",
                             act_dtype="float32")
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    batch = lm_batch(DataConfig(seed=0, vocab=jc.vocab, seq_len=32, global_batch=2), 0)
    kw = dict(budget=0.001, sites=("mlp", "lm_head"))
    want = j_cal.calibrate(jc, jp, batch, **kw)
    model = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    got = t_cal.calibrate(tc, model, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                          **kw)
    return want, got


def test_calibrate_decisions_match_reference():
    want, got = _calibration_case()
    limit = want.base_loss * (1 + want.budget)
    for d in want.decisions:
        for trial in d["trials"]:
            # no trial near the limit, so f32 rounding cannot flip a decision
            assert abs(trial["loss"] - limit) > 1e-3 * abs(limit), trial
    assert got.base_loss == pytest.approx(want.base_loss, rel=1e-5)
    assert [d["site"] for d in got.decisions] == [d["site"] for d in want.decisions]
    assert [d["assigned"] for d in got.decisions] == [d["assigned"] for d in want.decisions]
    assert {d["assigned"] for d in got.decisions} != {"f32"}  # a site took posit or PLAM
    for gd, wd in zip(got.decisions, want.decisions):
        assert [t["cfg"] for t in gd["trials"]] == [t["cfg"] for t in wd["trials"]]
        for gt, wt in zip(gd["trials"], wd["trials"]):
            assert gt["loss"] == pytest.approx(wt["loss"], rel=1e-4)
        assert gd["est_savings"] == wd["est_savings"]
    assert got.policy_str == want.policy_str


def test_policy_artifacts_load_in_either_package(tmp_path):
    _, got = _calibration_case()
    t_path, j_path = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    t_cal.save_policy_artifact(t_path, got.policy, {"base_loss": got.base_loss})
    assert j_cal.load_policy_artifact(t_path) == j_parse_policy(got.policy_str)
    assert t_cal.load_policy_artifact(t_path) == got.policy
    j_cal.save_policy_artifact(j_path, j_parse_policy(got.policy_str))
    assert t_cal.load_policy_artifact(j_path) == got.policy
    with pytest.raises(FileNotFoundError):
        t_cal.load_policy_artifact(str(tmp_path / "missing.json"))


def test_top1_agreement():
    a = np.zeros((2, 3, 5), np.float32)
    a[..., 1] = 1.0
    b = a.copy()
    b[0, 0, 3] = 2.0
    assert t_cal.top1_agreement(a, b) == j_cal.top1_agreement(a, b) == 5 / 6
    assert t_cal.top1_agreement(torch.from_numpy(a), torch.from_numpy(a)) == 1.0
