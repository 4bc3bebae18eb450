"""The port's training loop, checkpoints and CLI against the JAX reference.

The toy config of the reference's own loop tests (2 layers, d 64), the
reference's init converted with ``params_from_jax``, and the
reference's ``lm_batch`` (threefry; the port draws its own batches from
numpy) fed to both as numpy.  The runs compared with the reference use
f32 numerics (``test_torch_train_loss.py`` holds the posit_quant
gradients; the loop does not look at the numerics), which keeps the
reference's compile short.
"""
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

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core.modes import NumericsConfig as JNumericsConfig  # noqa: E402
from repro.core.policy import parse_policy as j_parse_policy  # noqa: E402
from repro.data.synthetic import DataConfig, lm_batch  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.optim.optimizers import OptConfig as JOptConfig  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from repro_torch.core.modes import NumericsConfig  # noqa: E402
from repro_torch.core.policy import parse_policy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.models.transformer import set_trainable  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, init_state  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402

TOY = dict(name="toy", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
           head_dim=16, d_ff=128, vocab=64)
J_CFG = JModelConfig(**TOY, numerics=JNumericsConfig(mode="f32"))
T_CFG = ModelConfig(**TOY, numerics=NumericsConfig(mode="f32"))
DCFG = DataConfig(seed=0, vocab=64, seq_len=32, global_batch=8)
J_API, T_API = j_build(J_CFG), build(T_CFG)


def _numpy_tree(tree):
    def one(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(one, tree)


@functools.lru_cache(maxsize=None)
def _j_params_np(seed=0):
    return jax.tree.map(np.asarray, J_API.init(jax.random.PRNGKey(seed)))


def _j_params(seed=0):
    """Fresh reference arrays (its loop donates them)."""
    return jax.tree.map(jnp.asarray, _j_params_np(seed))


def _t_model(jp, cfg=T_CFG):
    return set_trainable(params_from_jax(_numpy_tree(jp), cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _j_batch(step):
    return {k: np.asarray(v) for k, v in lm_batch(DCFG, step).items()}


def _t_batch(step):
    return {k: torch.from_numpy(v.copy()) for k, v in _j_batch(step).items()}


def _t_run(tcfg, steps, failure=None):
    return loop.run(loss_fn=T_API.train_loss, init_params_fn=lambda: _t_model(_j_params()),
                    batch_fn=_t_batch, tcfg=tcfg, num_steps=steps, failure=failure)


@functools.lru_cache(maxsize=None)
def _reference_run(tmp: str):
    """The reference's AdamW run over 6 steps, checkpointed at step 3:
    (losses of every step, checkpoint directory)."""
    d = os.path.join(tmp, "ref")
    _, _, info = j_loop.run(
        loss_fn=J_API.train_loss, init_params_fn=lambda: _j_params(),
        batch_fn=lambda s: lm_batch(DCFG, s), num_steps=6,
        tcfg=j_loop.TrainConfig(opt=JOptConfig(lr=3e-3), log_every=1, ckpt_dir=d,
                                ckpt_every=3))
    return [loss for _, loss in info["history"]], d


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    return _reference_run(str(tmp_path_factory.mktemp("reference_run")))


# -- the loop ------------------------------------------------------------------


def test_run_matches_reference_losses(reference_run):
    _, _, tinfo = _t_run(loop.TrainConfig(opt=OptConfig(lr=3e-3), log_every=1), 5)
    tl = np.array([loss for _, loss in tinfo["history"]])
    assert len(tl) == 5
    np.testing.assert_allclose(tl, reference_run[0][:5], rtol=1e-4)
    assert tl[-1] < tl[0]


def test_grad_accum_equals_one_big_batch():
    """accum=4 micro-batches == one big batch (the reference's own test)."""
    jp = _j_params(1)
    opt = OptConfig(name="sgd", lr=1e-2, grad_clip=1e9)
    m1, m4 = _t_model(jp), _t_model(jp)
    s1, s4 = init_state(opt, m1), init_state(opt, m4)
    batch = _t_batch(0)
    _, _, r1 = loop.make_train_step(T_API.train_loss, loop.TrainConfig(opt=opt))(m1, s1, batch)
    _, _, r4 = loop.make_train_step(T_API.train_loss,
                                    loop.TrainConfig(opt=opt, grad_accum=4))(m4, s4, batch)
    assert abs(float(r1["loss"]) - float(r4["loss"])) < 2e-3
    for a, b in zip(m1.parameters(), m4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-3, atol=2e-4)


def test_int8_compression_is_unbiased_and_trains():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 24)).astype(np.float32))
    amax = float(g.abs().max())
    draws = torch.stack([loop._int8_compress(g, loop._compress_generator(s, "cpu"))
                         for s in range(1000)])
    assert float((draws[0] - g).abs().max()) <= amax / 127 * (1 + 1e-6)  # one step at most
    assert float((draws.mean(0) - g).abs().mean()) < 0.01 * amax  # unbiased over 1000 draws
    tcfg = loop.TrainConfig(opt=OptConfig(name="adamw", lr=1e-2), compress_grads=True)
    step = loop.make_train_step(T_API.train_loss, tcfg)
    model = _t_model(_j_params(3))
    state = init_state(tcfg.opt, model)
    losses = [float(step(model, state, _t_batch(i))[2]["loss"]) for i in range(12)]
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) * 0.9, losses


def test_failure_restart_is_bit_identical(tmp_path):
    """Crash at step 3, restore the step-2 checkpoint: the same parameters
    as an uninterrupted run (the batches replay)."""
    def run(d, failure):
        tcfg = loop.TrainConfig(opt=OptConfig(lr=1e-3), ckpt_dir=str(d), ckpt_every=2)
        return _t_run(tcfg, 5, failure)

    m_fail, _, info = run(tmp_path / "a", loop.FailureInjector([3]))
    m_ok, _, info_ok = run(tmp_path / "b", None)
    assert (info["restarts"], info_ok["restarts"]) == (1, 0)
    assert info["final_step"] == 5
    for a, b in zip(m_fail.parameters(), m_ok.parameters()):
        assert torch.equal(a, b)


# -- checkpoints ---------------------------------------------------------------------


def _tree(opt_name, dtype):
    """A (params, opt_state) checkpoint tree in the reference's layout."""
    rng = np.random.default_rng(4)

    def t(shape, dt=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)

    def like():
        return {"w": t((3, 5)), "layers": {"b": t((2, 4))}}

    params = {"w": t((3, 5), torch.bfloat16 if dtype == "bf16" else torch.float32),
              "layers": {"b": t((2, 4))}}
    step = torch.tensor(7, dtype=torch.int32)
    state = ({"m": like(), "v": like(), "step": step} if opt_name == "adamw"
             else {"mu": like(), "step": step})
    return params, state


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind in "Vu" else a


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, opt_name, dtype):
    tree = _tree(opt_name, dtype)
    ckpt.save(str(tmp_path), 3, tree, extra=ckpt.policy_extra(parse_policy("default=f32")))
    like = jax.tree.map(lambda t: np.zeros(t.shape), tree)
    got, manifest = j_ckpt.restore(str(tmp_path), like)
    want_leaves, _ = ckpt._flatten(tree)
    for g, w in zip(jax.tree.leaves(got), want_leaves):
        w = w.view(torch.int16).numpy().view(np.uint16) if w.dtype == torch.bfloat16 else w.numpy()
        np.testing.assert_array_equal(_bits(g), w)
    assert manifest["dtypes"] == [("bfloat16" if t.dtype == torch.bfloat16 else str(t.numpy().dtype))
                                  for t in want_leaves]
    assert j_ckpt.manifest_policy(manifest) == j_parse_policy("default=f32")
    # the same bytes as the reference writes for the same tree
    j_tree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                          if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), tree)
    j_ckpt.save(str(tmp_path / "ref"), 3, j_tree)
    with open(tmp_path / "ref" / "step_00000003" / "manifest.json") as f:
        assert json.load(f)["treedef"] == manifest["treedef"]
    ours = np.load(tmp_path / "step_00000003" / "arrays.npz")
    theirs = np.load(tmp_path / "ref" / "step_00000003" / "arrays.npz")
    for k in theirs.files:
        assert theirs[k].dtype.str.lstrip("<|") == ours[k].dtype.str.lstrip("<|")
        assert theirs[k].tobytes() == ours[k].tobytes()


def test_reference_checkpoint_resumes_in_the_port(tmp_path, reference_run):
    """The reference's step-3 checkpoint (params and AdamW state): the port
    restores it and continues to the reference's own losses of steps 3-5."""
    losses, ref_dir = reference_run
    shutil.copytree(os.path.join(ref_dir, "step_00000003"), tmp_path / "step_00000003")
    _, _, tinfo = _t_run(loop.TrainConfig(opt=OptConfig(lr=3e-3), ckpt_dir=str(tmp_path),
                                          ckpt_every=3, log_every=1), 6)
    assert [s for s, _ in tinfo["history"]] == [3, 4, 5]
    np.testing.assert_allclose([loss for _, loss in tinfo["history"]], losses[3:], rtol=1e-4)


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, opt_name, dtype):
    tree = _tree(opt_name, dtype)
    j_tree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                          if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), tree)
    j_ckpt.save(str(tmp_path), 2, j_tree)
    got, manifest = ckpt.restore(str(tmp_path), tree)
    for g, w in zip(ckpt._flatten(got)[0], ckpt._flatten(tree)[0]):
        if w.dtype == torch.bfloat16:
            assert g.dtype == np.uint16
            w = w.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(g, np.asarray(w))
    assert ("bfloat16" in manifest["dtypes"]) == (dtype == "bf16")


def test_checkpoint_atomic_gc_and_mismatches(tmp_path, monkeypatch):
    tree = ({"a": torch.ones(3)}, {"step": torch.tensor(1, dtype=torch.int32)})
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, tree, keep=3)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_npz", boom)
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path), 5, tree)
    monkeypatch.undo()
    assert ckpt.latest_step(str(tmp_path)) == 4  # no partial step_5
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(str(tmp_path), ({"a": torch.ones(3), "b": torch.ones(1)}, {"step": 0}))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), ({"a": torch.ones(4)}, {"step": torch.zeros(())}))
    t = ckpt.save_async(str(tmp_path), 9, tree)
    t.join(timeout=60)
    assert not t.is_alive() and ckpt.latest_step(str(tmp_path)) == 9


def test_policy_travels_in_the_manifest(tmp_path):
    pol = parse_policy("default=plam_sim:16:1, lm_head=f32")
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(2)}, extra=ckpt.policy_extra(pol))
    _, manifest = ckpt.restore(str(tmp_path), {"a": torch.ones(2)})
    assert ckpt.manifest_policy(manifest) == pol
    assert j_ckpt.manifest_policy(manifest) == j_parse_policy("default=plam_sim:16:1, lm_head=f32")
    j_ckpt.save(str(tmp_path / "j"), 1, {"a": jnp.ones(2)},
                extra=j_ckpt.policy_extra(j_parse_policy("default=posit_quant:16:1")))
    _, jm = ckpt.restore(str(tmp_path / "j"), {"a": torch.ones(2)})
    assert ckpt.manifest_policy(jm) == parse_policy("default=posit_quant:16:1")
    assert ckpt.manifest_policy({"extra": {}}) is None


def test_params_to_jax_inverts_params_from_jax():
    jp = _j_params()
    back = params_to_jax(_t_model(jp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == jax.tree.structure(back)


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_opt_state_round_trips_through_the_reference_layout(opt_name):
    """A reference state tree (its init_state, filled with seeded values),
    into the port's state and back."""
    from repro.optim.optimizers import init_state as j_init

    jp = _j_params()
    rng = np.random.default_rng(6)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                        j_init(JOptConfig(name=opt_name), jp))
    tree["step"] = np.asarray(3, np.int32)
    state = opt_state_from_jax(tree, _t_model(jp))
    assert int(state["step"]) == 3 and set(state) == set(tree)
    back = opt_state_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


# -- the CLI ------------------------------------------------------------------------


def test_cli_prints_the_reference_lines_and_stores_the_policy(tmp_path, capsys):
    from repro.configs import get_config
    from repro.core.policy import describe
    from repro_torch.launch.train import main

    main(["--arch", "yi-6b", "--reduced", "--steps", "4", "--device", "cpu", "--seq-len", "16",
          "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
          "--simulate-failure", "3", "--numerics", "f32"])
    lines = capsys.readouterr().out.strip().splitlines()
    # the reference's first line for the same arch, from its own functions
    jc = get_config("yi-6b").reduced().with_numerics(JNumericsConfig(mode="f32"))
    n = sum(x.size for x in jax.tree.leaves(jax.eval_shape(
        lambda: j_build(jc).init(jax.random.PRNGKey(0)))))
    assert lines[0] == (f"arch={jc.name} (reduced) params={n / 1e6:.1f}M "
                        f"numerics={describe(jc.numerics)!r}")
    assert re.fullmatch(r"step     0  loss \d+\.\d{4}", lines[1]), lines
    assert lines[-1] == "restarts=1 final_step=4"
    _, manifest = ckpt.restore(str(tmp_path), _like_toy_tree(tmp_path))
    assert ckpt.manifest_policy(manifest) == parse_policy(NumericsConfig(mode="f32"))


def _like_toy_tree(d):
    """A like-tree of the saved checkpoint's shapes (from its manifest)."""
    step = ckpt.latest_step(str(d))
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        shapes = json.load(f)["shapes"]
    return [np.zeros(s) for s in shapes]


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.launch.train import main
    from repro_torch.paper import models as pm

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "yi-6b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.train_classifier(lambda g: {}, pm.mlp_apply, np.zeros((4, 3)), np.zeros(4))
    # a MoE arch, which trains now, defaults to the card as well
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "deepseek-moe-16b", "--reduced", "--steps", "1"])
