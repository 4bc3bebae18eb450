"""Training over a (data x model) mesh of ``torch.distributed`` ranks
against the JAX package's unsharded step: the port's sharded step
(``train/loop.py`` under ``optim/optimizers.py::Zero1``: tensor
parallelism over ``model``, the global batch over ``data``, ZeRO-1 AdamW
state), elastic restore across packages, the int8 gradient compression
and the train CLI's drill.

ONE spawned world of four gloo ranks (``launch/mesh.py::spawn``) runs
every case (``_world``), each on its own mesh of the four; the JAX steps
run once, in a module fixture.  Weights go in through
``convert.params_from_jax`` and are cut by ``shard_model``; both sides
take the reference's ``lm_batch`` (threefry) as numpy, each data rank
its rows.

AdamW runs at ``eps=1e-5``: its first steps divide each gradient
element by its own magnitude plus eps, so an element whose gradient is
near 0 moves by lr x (its f32 rounding difference / eps).  At the
default 1e-8, a 1e-9 difference in a 1e-8 gradient (f32 sums in another
order, which the sharded step and XLA's step both have) moves a
parameter by 0.1 lr; at 1e-5 that term is below lr x 1e-4, while every
other element still moves by about lr, over 100x the tolerance.  The
first and second moments hold the gradients themselves and are compared
at the same tolerance.
"""
import concurrent.futures
import dataclasses
import functools
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.data.synthetic import lm_batch as j_lm_batch  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro.parallel import sharding as j_sh  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import train as t_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, spawn  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.models.transformer import set_trainable  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, Zero1, init_state, zero1_numel  # noqa: E402
from repro_torch.parallel.sharding import leaf_layouts, shard_model  # noqa: E402
from repro_torch.train import loop  # noqa: E402

from test_torch_chunked import _numpy_tree  # noqa: E402

LR, EPS, STEPS = 1e-3, 1e-5, 2
SEQ, BATCH = 16, 8
RTOL, ATOL = 1e-5, 1e-6
# posit_quant:16:1: an activation that the sharded step's f32 sums put on
# the other side of a posit rounding boundary moves by one posit step
# (2^-12 of it near 1), and with it its gradient's elements by ~1e-4 of
# theirs; AdamW turns that, where a gradient element is near eps, into
# up to a tenth of a step's move (lr) a step: the parameters are held
# within PARAM_ATOL_POSIT over the two steps (7.3e-5 measured between
# the port's sharded and one-rank steps), the loss, m and v at the f32
# tolerance
PARAM_ATOL_POSIT = 0.1 * LR * STEPS


def _cfgs(arch, numerics="f32"):
    red = dict(param_dtype="float32", act_dtype="float32")
    pol = f"default={numerics}"
    return (dataclasses.replace(j_get_config(arch).reduced(), **red).with_numerics(pol),
            dataclasses.replace(t_get_config(arch).reduced(), **red).with_numerics(pol))


def _batches(cfg):
    d = JDataConfig(seed=0, vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    return [{k: np.asarray(v) for k, v in j_lm_batch(d, s).items()} for s in range(STEPS)]


def _flat(tree, pre=""):
    """path -> numpy leaf of a nested tree (torch or jax leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{pre}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{pre}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {pre: tree.detach().float().numpy()}
    return {pre: np.asarray(tree, dtype=np.float32)}


def _jax_init(arch, numerics):
    """The reference's init (key 0) as numpy."""
    j_cfg, _ = _cfgs(arch, numerics)
    return _numpy_tree(jax.tree.map(np.asarray, j_build(j_cfg).init(jax.random.PRNGKey(0))))


def _jax_run(arch, numerics, ckpt_dir=None):
    """The reference's jitted unsharded step, STEPS times from its init:
    (init params as numpy, losses, (params, state) after the steps as
    numpy); its step-1 checkpoint in ``ckpt_dir``."""
    j_cfg, _ = _cfgs(arch, numerics)
    api = j_build(j_cfg)
    params = api.init(jax.random.PRNGKey(0))
    tcfg = j_loop.TrainConfig(opt=j_opt.OptConfig(lr=LR, eps=EPS))
    state = j_opt.init_state(tcfg.opt, params)
    step = jax.jit(j_loop.make_train_step(api.train_loss, tcfg))
    losses = []
    for s, batch in enumerate(_batches(j_cfg)):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        if ckpt_dir is not None and s == 0:
            j_ckpt.save(ckpt_dir, 1, (params, state))
    return _jax_init(arch, numerics), losses, jax.tree.map(np.asarray, (params, state))


def _steps_job(arch, numerics, data, model, init):
    _, cfg = _cfgs(arch, numerics)
    return dict(kind="steps", cfg=cfg, data=data, model=model, params=init,
                batches=_batches(cfg))


def _world(device, jobs):
    """Every job on this rank of the world (``spawn``'s target); rank 0's
    results."""
    out = {}
    for name, job in jobs.items():
        mesh = make_host_mesh(data=job["data"], model=job["model"])
        out[name] = globals()[f"_{job['kind']}"](device, job, mesh)
    return out if mesh.rank == 0 else None


def _sharded(job, mesh):
    cfg = job["cfg"]
    api = build(cfg)
    if job.get("params") is not None:
        model = shard_model(params_from_jax(job["params"], cfg, device="cpu"), cfg, mesh)
    else:
        model = api.init(seed=0, device="cpu", mesh=mesh)
    zero = Zero1(leaf_layouts(cfg, mesh), mesh)
    return api, set_trainable(model), zero


def _steps(device, job, mesh):
    """STEPS sharded steps: losses, the gathered (params, state), this
    rank's state bytes, and the collectives of the last step."""
    api, model, zero = _sharded(job, mesh)
    tcfg = loop.TrainConfig(opt=OptConfig(lr=LR, eps=EPS), grad_accum=job.get("accum", 1))
    state = init_state(tcfg.opt, model, zero)
    step = loop.make_train_step(api.train_loss, tcfg, zero)
    losses = []
    for batch in job["batches"]:
        mesh.traffic.clear()
        losses.append(float(step(model, state, batch)[2]["loss"]))
    return {"losses": losses, "collectives": dict(mesh.collectives),
            "state_bytes": zero.state_bytes(state),
            "tree": loop.gather_train_tree(model, state, zero)}


def _restore(device, job, mesh):
    """``loop.run`` from the reference's step-1 checkpoint in
    ``job["ckpt_dir"]`` to step 2, which it writes there."""
    api, _, zero = _sharded(job, mesh)
    batches = job["batches"]
    tcfg = loop.TrainConfig(opt=OptConfig(lr=LR, eps=EPS), ckpt_dir=job["ckpt_dir"],
                            ckpt_every=1, log_every=1)
    init = functools.partial(_sharded, job, mesh)
    params, state, info = loop.run(loss_fn=api.train_loss, init_params_fn=lambda: init()[1],
                                   batch_fn=lambda s: batches[s], tcfg=tcfg,
                                   num_steps=STEPS, zero=zero)
    return {"history": info["history"], "tree": loop.gather_train_tree(params, state, zero)}


def _compress(device, job, mesh):
    """``compress_grads`` on each rank's slices of seeded whole gradients,
    the results gathered over the model axis."""
    _, _, zero = _sharded(job, mesh)
    whole = {n: torch.from_numpy(g) for n, g in job["grads"].items()}
    local = {n: g if zero.layouts[n].partial else zero.layouts[n].local(g, mesh.model_rank)
             for n, g in whole.items()}
    got = loop.compress_grads(local, job["step"], zero)
    return {n: g if zero.layouts[n].partial else zero.layouts[n].whole(mesh.all_gather(g))
            for n, g in got.items()}


def _data_sum(device, job, mesh):
    """``loop._data_sum`` of seeded bf16 gradients (the all-gather of their
    bits at two data ranks) against the f32 all-reduce, bit for bit."""
    g = torch.randn(300, 77, generator=torch.Generator().manual_seed(mesh.rank))
    g = (g * 2.0 ** torch.randint(-30, 30, g.shape, generator=torch.Generator().manual_seed(
        9 + mesh.rank))).to(torch.bfloat16)
    got = loop._data_sum(g, mesh)
    return bool(torch.equal(got.view(torch.int32),
                            mesh.all_reduce(g.to(torch.float32), "data").view(torch.int32)))


def _cli(device, job, mesh):
    """The train CLI's rank body on this mesh: rank 0's lines."""
    return t_cli._train(t_cli.make_parser().parse_args(job["argv"]), device, mesh)


def _grads_of(cfg):
    rng = np.random.default_rng(9)
    model = build(cfg).init(seed=0, device="meta")
    return {n: rng.standard_normal(p.shape).astype(np.float32) * 10.0 ** rng.integers(-6, 0)
            for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the one world's results.  The world needs
    the reference's inits and its yi-6b step-1 checkpoint; it runs while
    the other two references step (a thread waiting on its ranks)."""
    tmp = tmp_path_factory.mktemp("tp_train")
    ref = {"yi": _jax_run("yi-6b", "f32", str(tmp / "jax_ckpt"))}
    shutil.copytree(tmp / "jax_ckpt", tmp / "world_ckpt")
    _, yi_cfg = _cfgs("yi-6b")
    jobs = {
        "yi_2x2": _steps_job("yi-6b", "f32", 2, 2, ref["yi"][0]),
        "yi_posit_2x2": _steps_job("yi-6b", "posit_quant:16:1", 2, 2,
                                   _jax_init("yi-6b", "posit_quant:16:1")),
        "yi_1x4": _steps_job("yi-6b", "f32", 1, 4, ref["yi"][0]),
        "yi_accum_2x2": dict(_steps_job("yi-6b", "f32", 2, 2, ref["yi"][0]), accum=2),
        "granite_2x2": _steps_job("granite-moe-1b-a400m", "f32", 2, 2,
                                  _jax_init("granite-moe-1b-a400m", "f32")),
        "restore_2x2": dict(kind="restore", cfg=yi_cfg, data=2, model=2,
                            batches=_batches(yi_cfg), ckpt_dir=str(tmp / "world_ckpt")),
        "compress_2x2": dict(kind="compress", cfg=yi_cfg, data=2, model=2, step=3,
                             grads=_grads_of(yi_cfg)),
        "data_sum_2x2": dict(kind="data_sum", data=2, model=2),
        "cli_2x2": dict(kind="cli", data=2, model=2, argv=[
            "--arch", "yi-6b", "--reduced", "--steps", "4", "--numerics", "f32",
            "--seq-len", str(SEQ), "--batch", "4", "--ckpt-dir", str(tmp / "cli_ckpt"),
            "--ckpt-every", "2", "--simulate-failure", "3"]),
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _world, 4, "cpu", jobs, threads=1, timeout=240)
        ref["yi_posit"] = _jax_run("yi-6b", "posit_quant:16:1")
        ref["granite"] = _jax_run("granite-moe-1b-a400m", "f32")
        world = world.result()[0]
    return {"ref": ref, "world": world, "tmp": tmp, "yi_cfg": yi_cfg}


def _assert_tree_close(got, want, *, param_atol=ATOL):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        atol = param_atol if k.startswith("/0/") else ATOL
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=atol, err_msg=k)


@pytest.mark.parametrize("case,ref,param_atol", [
    ("yi_2x2", "yi", ATOL), ("yi_1x4", "yi", ATOL), ("granite_2x2", "granite", ATOL),
    ("yi_posit_2x2", "yi_posit", PARAM_ATOL_POSIT), ("yi_accum_2x2", "yi", ATOL),
], ids=["yi-2x2-f32", "yi-1x4-replicated-kv", "granite-moe-2x2-f32", "yi-2x2-posit-quant",
        "yi-2x2-grad-accum-2"])
def test_sharded_steps_match_the_jax_unsharded_step(runs, case, ref, param_atol):
    """Two steps over the mesh: every step's loss, and every gathered
    parameter, m and v after them, against the reference's unsharded
    step.  (1 x 4) runs reduced yi-6b's 4 heads over 2 kv heads, each kv
    head on two ranks (their gradients summed over the ranks that hold
    them); granite-moe-1b-a400m routes with the whole batch's capacity
    ranks across the data ranks; with grad_accum = 2 each data rank
    accumulates its rows of the reference's two micro-batches (every
    label valid, so the mean of the micro-batches' means is the batch's
    mean, as in the reference's accumulation)."""
    got = runs["world"][case]
    _, losses, want = runs["ref"][ref]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=0)
    _assert_tree_close(got["tree"], want, param_atol=param_atol)


def test_rank_state_is_the_zero1_layout_and_collectives_are_counted(runs):
    """Rank 0's m + v bytes equal the reference's per-device ZeRO-1 count
    (``_zero1_dims`` on the stacked leaves) at (2 x 2) and (1 x 4), and a
    dense step's collectives are the hand count: over ``model`` the
    embedding's sum, wo's and wd's in the forward, wo's again in the remat
    recompute (it stops after the last saved input, before wd's), the two
    copies' in the backward, the head's copy and the norm: 5L + 3; one
    all-gather of the head's logits a loss chunk and its recompute; over
    ``data`` the loss, its label count and each float leaf's gradient
    (9L + 3), and one all-gather of updated parameters a reference leaf
    (12)."""
    j_cfg, cfg = _cfgs("yi-6b")
    tree = jax.eval_shape(lambda: j_build(j_cfg).init(jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    for case, (data, model) in (("yi_2x2", (2, 2)), ("yi_1x4", (1, 4))):
        mesh = type("M", (), {"axis_names": ("data", "model"),
                              "shape": {"data": data, "model": model}})()
        want = sum(8 * zero1_numel(leaf.shape, j_opt._zero1_dims(j_sh._path_str(path), leaf,
                                                                 mesh), mesh)
                   for path, leaf in leaves)
        if case == "yi_1x4":  # wk and wv keep a whole kv head: 32 columns, not 16
            want += sum(8 * cfg.n_layers * cfg.d_model * 16 for _ in ("wk", "wv"))
        assert runs["world"][case]["state_bytes"] == want, case
    L = cfg.n_layers
    got = runs["world"]["yi_2x2"]["collectives"]
    assert (got["all_reduce"], got["all_gather"], got["data_all_reduce"],
            got["data_all_gather"]) == (5 * L + 3, 2, 9 * L + 3 + 2, 12), got


def test_elastic_restore_across_packages(runs):
    """The reference's step-1 checkpoint (whole leaves) restores into the
    (2 x 2) world, each rank its tensor-parallel and ZeRO-1 slices, whose
    step 2 is the reference's step 2; the world's step-2 checkpoint,
    gathered and written by rank 0, restores in the reference."""
    got = runs["world"]["restore_2x2"]
    _, losses, want = runs["ref"]["yi"]
    assert [s for s, _ in got["history"]] == [1]
    np.testing.assert_allclose([loss for _, loss in got["history"]], losses[1:], rtol=RTOL)
    _assert_tree_close(got["tree"], want)
    like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), want)
    back, manifest = j_ckpt.restore(str(runs["tmp"] / "world_ckpt"), like)
    assert manifest["step"] == STEPS
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_numpy_host(got["tree"]))):
        np.testing.assert_array_equal(np.asarray(a), b)


def _numpy_host(tree):
    return jax.tree.map(lambda t: t.numpy(), tree,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


def test_compressed_gradients_are_one_ranks_bit_for_bit(runs):
    """``compress_grads`` under (2 x 2): each rank's int8 stochastic rounding
    of its slices (the whole leaf's largest magnitude, its slice of the
    whole leaf's noise) gathered is the one-rank port's, bit for bit."""
    whole = {n: torch.from_numpy(g) for n, g in _grads_of(runs["yi_cfg"]).items()}
    want = loop.compress_grads(whole, 3)
    got = runs["world"]["compress_2x2"]
    assert got.keys() == want.keys()
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_bf16_gradients_cross_two_data_ranks_as_their_bits(runs):
    """At two data ranks a bf16 gradient crosses as its two-byte bits and
    the two are added in f32 on each rank: the f32 all-reduce's result,
    bit for bit (rank 0's check)."""
    assert runs["world"]["data_sum_2x2"] is True


def test_cli_trains_over_a_mesh_and_restarts(runs):
    """The train CLI's rank body on a (2 x 2) mesh (what ``--data 2 --model
    2`` spawns): an injected failure at step 3, restored from the step-2
    checkpoint of whole leaves; rank 0's lines; the checkpoint restores
    in the reference."""
    lines = runs["world"]["cli_2x2"]
    assert lines[-1] == "restarts=1 final_step=4"
    assert lines[0].startswith("step     0  loss ")
    j_cfg, _ = _cfgs("yi-6b")
    params = jax.eval_shape(lambda: j_build(j_cfg).init(jax.random.PRNGKey(0)))
    like = (params, jax.eval_shape(lambda p: j_opt.init_state(j_opt.OptConfig(), p), params))
    _, manifest = j_ckpt.restore(str(runs["tmp"] / "cli_ckpt"), like)
    assert manifest["step"] == 4
    assert j_ckpt.manifest_policy(manifest) is not None


def test_cli_refuses_what_a_mesh_cannot_run(capsys):
    """``--data x --model`` beyond ``--force-host-devices``, a model axis
    that an arch's SSD heads do not divide, and a batch the data ranks
    cannot split exit before any rank starts."""
    base = ["--reduced", "--steps", "1", "--numerics", "f32", "--device", "cpu"]
    with pytest.raises(SystemExit, match="needs 4 ranks/devices, found 2 host devices"):
        t_cli.main(["--arch", "yi-6b", *base, "--data", "2", "--model", "2",
                    "--force-host-devices", "2"])
    with pytest.raises(SystemExit, match="8 SSD heads do not divide tp=3"):
        t_cli.main(["--arch", "mamba2-780m", *base, "--model", "3"])
    with pytest.raises(SystemExit, match="does not split"):
        t_cli.main(["--arch", "yi-6b", *base, "--data", "3", "--batch", "8"])
