"""The training loop, checkpoints and CLI over the MoE, ssm, hybrid and
encdec families' trees, against the JAX reference.

Reduced configs with f32 parameters and f32 numerics (the gradients
under posit_quant are held in ``test_torch_train_posit_*.py``), the
reference's init converted with ``params_from_jax`` and the reference's
``lm_batch`` fed to both.  Checkpoints take the reference's layout:
expert stacks [L, E, ...], the ssm leaves, the hybrid's ``shared``
block, ``enc_layers``/``dec_layers``; each package restores the
other's.
"""
import dataclasses
import functools
import json
import os
import re
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.modes import NumericsConfig as JNumericsConfig  # noqa: E402
from repro.core.policy import describe  # noqa: E402
from repro.data.synthetic import DataConfig, lm_batch  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.optim.optimizers import OptConfig as JOptConfig  # noqa: E402
from repro.optim.optimizers import init_state as j_init_state  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.modes import NumericsConfig  # noqa: E402
from repro_torch.models.registry import build as t_build  # noqa: E402
from repro_torch.models.transformer import set_trainable  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, init_state  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402

from test_torch_ssm import one_thread  # noqa: E402,F401

LOOP_ARCHS = ["mamba2-780m", "zamba2-1.2b", "deepseek-moe-16b"]
LR = 3e-3


pytestmark = pytest.mark.usefixtures("one_thread")


def _cfgs(arch):
    jc = dataclasses.replace(j_get_config(arch).reduced(), param_dtype="float32",
                             act_dtype="float32")
    tc = dataclasses.replace(t_get_config(arch).reduced(), param_dtype="float32",
                             act_dtype="float32")
    return (jc.with_numerics(JNumericsConfig(mode="f32")),
            tc.with_numerics(NumericsConfig(mode="f32")))


def _dcfg(arch):
    return DataConfig(seed=0, vocab=_cfgs(arch)[0].vocab, seq_len=32, global_batch=2)


@functools.lru_cache(maxsize=None)
def _j_params_np(arch):
    return jax.tree.map(np.asarray, j_build(_cfgs(arch)[0]).init(jax.random.PRNGKey(0)))


def _t_model(arch):
    return set_trainable(params_from_jax(_j_params_np(arch), _cfgs(arch)[1], device="cpu"))


@functools.lru_cache(maxsize=None)
def _j_batch(arch, step):
    return {k: np.asarray(v) for k, v in lm_batch(_dcfg(arch), step).items()}


@functools.lru_cache(maxsize=None)
def _reference_run(arch, tmp):
    """The reference's AdamW run over 5 steps, checkpointed at step 3 (and
    at its end): (losses of every step, checkpoint directory)."""
    d = os.path.join(tmp, arch)
    _, _, info = j_loop.run(
        loss_fn=j_build(_cfgs(arch)[0]).train_loss,
        init_params_fn=lambda: jax.tree.map(jnp.asarray, _j_params_np(arch)),
        batch_fn=lambda s: lm_batch(_dcfg(arch), s), num_steps=5,
        tcfg=j_loop.TrainConfig(opt=JOptConfig(lr=LR), log_every=1, ckpt_dir=d, ckpt_every=3))
    return [loss for _, loss in info["history"]], d


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("reference_runs"))


def _t_run(arch, steps, ckpt_dir):
    tcfg = loop.TrainConfig(opt=OptConfig(lr=LR), log_every=1, ckpt_dir=ckpt_dir,
                            ckpt_every=3)
    return loop.run(loss_fn=t_build(_cfgs(arch)[1]).train_loss,
                    init_params_fn=lambda: _t_model(arch),
                    batch_fn=lambda s: {k: torch.from_numpy(v.copy())
                                        for k, v in _j_batch(arch, s).items()},
                    tcfg=tcfg, num_steps=steps)


def _treedef(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)["treedef"]


@pytest.mark.parametrize("arch", LOOP_ARCHS)
def test_run_matches_reference_losses_and_checkpoints(arch, run_dir, tmp_path):
    """Three AdamW steps of ``loop.run`` against the reference's losses;
    the port's step-3 checkpoint has the reference's tree, restores in the
    reference and holds its step-3 parameters and AdamW moments (each leaf
    within a relative L2 of 1e-4, the f32 gradients' tolerance); and the
    port resumes from the reference's step-3 checkpoint to its losses of
    steps 3 and 4."""
    losses, ref_dir = _reference_run(arch, run_dir)
    _, _, info = _t_run(arch, 3, str(tmp_path / "port"))
    np.testing.assert_allclose([loss for _, loss in info["history"]], losses[:3], rtol=1e-4)
    assert _treedef(tmp_path / "port", 3) == _treedef(ref_dir, 3)
    like = (jax.tree.map(np.zeros_like, _j_params_np(arch)),
            j_init_state(JOptConfig(lr=LR), _j_params_np(arch)))
    got, _ = j_ckpt.restore(str(tmp_path / "port"), like, step=3)
    want, _ = j_ckpt.restore(ref_dir, like, step=3)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        # per leaf, as the gradients: Adam's update of an element whose v
        # is near 0 moves by a whole step for a last-bit difference in g
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), g.shape
    resume = tmp_path / "resume"
    shutil.copytree(os.path.join(ref_dir, "step_00000003"), resume / "step_00000003")
    _, _, info = _t_run(arch, 5, str(resume))
    assert [s for s, _ in info["history"]] == [3, 4]
    np.testing.assert_allclose([loss for _, loss in info["history"]], losses[3:], rtol=1e-4)


def test_encdec_checkpoint_restores_in_the_reference(tmp_path):
    """The encdec tree (``frontend_proj``, ``enc_layers``, ``dec_layers``
    with ``xattn``/``ln_x``, ``ln_enc``/``ln_dec``, ``unembed``) and its
    AdamW state, written by the port: the reference's treedef, its values
    read back by the reference, and the reference's own save read back by
    the port."""
    arch = "seamless-m4t-medium"
    model = _t_model(arch)
    state = init_state(OptConfig(), model)
    rng = np.random.default_rng(2)
    for part in (state["m"], state["v"]):
        for t in part.values():
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    tree = loop.train_tree(model, state)
    ckpt.save(str(tmp_path / "port"), 1, tree)
    jp = _j_params_np(arch)
    like = (jax.tree.map(np.zeros_like, jp), j_init_state(JOptConfig(), jp))
    got, _ = j_ckpt.restore(str(tmp_path / "port"), like)
    for g, w in zip(jax.tree.leaves(got), ckpt._flatten(tree)[0]):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    j_ckpt.save(str(tmp_path / "ref"), 1, jax.tree.map(jnp.asarray, got))
    assert _treedef(tmp_path / "ref", 1) == _treedef(tmp_path / "port", 1)
    fresh = _t_model(arch)
    fresh_state = init_state(OptConfig(), fresh)
    back, _ = ckpt.restore(str(tmp_path / "ref"), loop.train_tree(fresh, fresh_state))
    loop.load_train_tree(back, fresh, fresh_state)
    for (n, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for n, t in state[k].items():
            assert torch.equal(t, fresh_state[k][n]), (k, n)


def _reference_first_line(arch):
    jc = j_get_config(arch).reduced()
    jc = dataclasses.replace(jc, param_dtype="float32", act_dtype="float32")
    jc = jc.with_numerics(JNumericsConfig(mode="posit_quant"))
    n = sum(x.size for x in jax.tree.leaves(jax.eval_shape(
        lambda: j_build(jc).init(jax.random.PRNGKey(0)))))
    return f"arch={jc.name} (reduced) params={n / 1e6:.1f}M numerics={describe(jc.numerics)!r}"


def test_cli_trains_the_hybrid_with_the_reference_lines(capsys):
    from repro_torch.launch.train import main

    main(["--arch", "zamba2-1.2b", "--reduced", "--steps", "2", "--device", "cpu",
          "--seq-len", "16", "--batch", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == _reference_first_line("zamba2-1.2b")
    assert re.fullmatch(r"step     0  loss \d+\.\d{4}", lines[1]), lines
    assert lines[-1] == "restarts=0 final_step=2"


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-72b"])
def test_cli_exits_for_encdec_and_vlm_as_the_reference(arch, capsys, monkeypatch):
    """Both CLIs print the same first line, then exit with the same
    message pointing at ``examples/``."""
    import sys

    from repro.launch import train as j_train
    from repro_torch.launch.train import main

    argv = ["--arch", arch, "--reduced", "--steps", "2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(SystemExit) as want:
        j_train.main()
    j_lines = capsys.readouterr().out.strip().splitlines()
    with pytest.raises(SystemExit) as got:
        main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines() == j_lines
    assert j_lines == [_reference_first_line(arch)]
    assert str(got.value) == str(want.value) and "examples/" in str(got.value)
