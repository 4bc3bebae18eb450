"""The state-space and hybrid families over a (data x model) mesh of
``torch.distributed`` ranks against the JAX package's unsharded
functions: reduced mamba2-780m and zamba2-1.2b (f32), each rank its
shard (``parallel/sharding.py``: ``in_proj`` cut block by block, the
mixer's other leaves whole, the hybrid's shared block column- and
row-parallel, ``shared/out_proj`` over the replicated concat).

ONE spawned world of four gloo ranks (``launch/mesh.py::spawn``) runs
every case (``_world``) on a (data 2 x model 2) mesh: two sharded AdamW
steps with ZeRO-1 state (``train/loop.py``), a prefill of four rows (two
a data rank) and teacher-forced decode steps over f32 caches, zamba2's
decode at batch 1 with its shared K/V positions over ``data``
(``hybrid.py::seq_shard_caches``, ``attention.py::
attn_core_seq_parallel``), and the train CLI's ``--data 2 --model 2``.
The same world also runs ``chip_smoke.py``'s phase tp_ssm f32 forms
(``Smoke.tp_ssm_f32``) as they are and with a rank-reading fault put in,
against the JAX forward: the gate's tolerance must lie between the two.
The JAX steps and forwards run meanwhile in this process, jitted, from
the reference's init (key 0); weights go in through
``convert.params_from_jax``.  The virtual mesh of the sharded dry run
(``launch/mesh.py::VirtualMesh``, ``launch/dryrun.py``) counts each of
those steps on meta tensors: its collectives by axis and kind, with
their result bytes, must be the world's.

AdamW runs at eps 1e-5, as in ``tests/test_torch_tp_train.py`` (whose
reference steps and comparisons this file reuses); the tolerance is
rtol 1e-5 / atol 1e-6 there, and the logits are held within 1e-5.
"""
import concurrent.futures
import contextlib
import functools
import importlib.util
import os
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import hybrid as j_hybrid  # noqa: E402
from repro.models import mamba_lm as j_mamba  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro.parallel import sharding as j_sh  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as t_cli  # noqa: E402
from repro_torch.launch.mesh import VirtualMesh, make_host_mesh, spawn  # noqa: E402
from repro_torch.models import hybrid as t_hybrid  # noqa: E402
from repro_torch.models import mamba_lm as t_mamba  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, init_state, zero1_numel  # noqa: E402
from repro_torch.parallel.sharding import current_mesh, shard_model, use_mesh  # noqa: E402
from repro_torch.train import loop  # noqa: E402

from test_torch_ssm import one_thread  # noqa: E402,F401
from test_torch_tp_train import (  # noqa: E402
    EPS,
    LR,
    SEQ,
    _assert_tree_close,
    _batches,
    _cfgs,
    _jax_init,
    _jax_run,
    _sharded,
)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ("mamba2-780m", "zamba2-1.2b")
DATA, MODEL = 2, 2
ROWS, PROMPT, DECODE = 4, 16, 2  # prefill rows (ROWS / DATA a data rank), prompt, decode steps
LOGIT_TOL = 1e-5
MODULES = {"mamba2-780m": (j_mamba, t_mamba), "zamba2-1.2b": (j_hybrid, t_hybrid)}


def _tokens(cfg):
    """The prompt [ROWS, PROMPT] and the teacher-forced decode tokens [ROWS, DECODE]."""
    rng = np.random.default_rng(5)
    return (rng.integers(0, cfg.vocab, (ROWS, PROMPT)).astype(np.int32),
            rng.integers(0, cfg.vocab, (ROWS, DECODE)).astype(np.int32))


def _cache_len(cfg):
    return PROMPT if cfg.family == "hybrid" else 0  # the hybrid's shared K/V hold the prompt


def _jax_forward(arch, params):
    """The reference's f32-cache prefill of the prompt and its decode steps,
    jitted: logits [ROWS, 1 + DECODE, V]."""
    j_cfg, _ = _cfgs(arch)
    mod = MODULES[arch][0]
    prompt, dec = _tokens(j_cfg)
    caches = mod.cache_init(j_cfg, ROWS, _cache_len(j_cfg), jnp.float32)
    logits, caches = jax.jit(functools.partial(mod.prefill, j_cfg))(
        params, jnp.asarray(prompt), caches)
    out = [np.asarray(logits)]
    step = jax.jit(functools.partial(mod.decode_step, j_cfg))
    for i in range(DECODE):
        logits, caches = step(params, jnp.asarray(dec[:, i:i + 1]), caches,
                              jnp.int32(PROMPT + i))
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


def _world(device, jobs):
    """Every job on this rank of the world (``spawn``'s target); rank 0's
    results."""
    out = {}
    for name, job in jobs.items():
        mesh = make_host_mesh(data=job["data"], model=job["model"])
        out[name] = globals()[f"_{job['kind']}"](device, job, mesh)
    return out if mesh.rank == 0 else None


def _steps(device, job, mesh):
    """STEPS sharded steps (``test_torch_tp_train._sharded``'s model, ZeRO-1
    and step): losses, the gathered (params, state), this rank's state
    bytes and the last step's collectives by axis and kind."""
    api, model, zero = _sharded(job, mesh)
    tcfg = loop.TrainConfig(opt=OptConfig(lr=LR, eps=EPS))
    state = init_state(tcfg.opt, model, zero)
    step = loop.make_train_step(api.train_loss, tcfg, zero)
    losses = []
    for batch in job["batches"]:
        mesh.traffic.clear()
        losses.append(float(step(model, state, batch)[2]["loss"]))
    return {"losses": losses, "traffic": dict(mesh.traffic),
            "state_bytes": zero.state_bytes(state),
            "tree": loop.gather_train_tree(model, state, zero)}


def _serve(device, job, mesh):
    """This rank's shard of the reference's weights: the prefill of its
    rows and the teacher-forced decode steps over f32 caches, the logits
    gathered over ``data``; the collectives of the prefill and of a decode
    step; for the hybrid, row 0 at batch 1 with its shared K/V positions
    over ``data`` and that decode step's collectives."""
    cfg, mod = job["cfg"], MODULES[job["arch"]][1]
    model = shard_model(params_from_jax(job["params"], cfg, device="cpu"), cfg, mesh)
    prompt, dec = (torch.from_numpy(a) for a in _tokens(cfg))
    n = ROWS // mesh.data_size
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    out, traffic = {}, {}
    with torch.no_grad(), use_mesh(mesh):
        def run(prompt, dec, seq=False):
            caches = mod.cache_init(cfg, prompt.shape[0], _cache_len(cfg), torch.float32, "cpu")
            mesh.traffic.clear()
            logits, caches = mod.prefill(cfg, model, prompt, caches)
            traffic["seq_prefill" if seq else "prefill"] = dict(mesh.traffic)
            if seq:
                caches = t_hybrid.seq_shard_caches(caches, mesh)
            got = [logits]
            for i in range(DECODE):
                mesh.traffic.clear()
                kw = {"seq_parallel": True} if seq else {}
                logits, caches = mod.decode_step(cfg, model, dec[:, i:i + 1], caches,
                                                 PROMPT + i, **kw)
                got.append(logits)
            traffic["seq_decode" if seq else "decode"] = dict(mesh.traffic)
            return torch.cat(got, dim=1)

        mine = run(prompt[rows], dec[rows])
        out["logits"] = torch.cat(mesh.all_gather(mine.contiguous(), "data")).numpy()
        if cfg.family == "hybrid":
            out["seq_logits"] = run(prompt[:1], dec[:1], seq=True).numpy()
    out["traffic"] = traffic
    return out


#: the faults that phase tp_ssm's f32 gate must see, by family
FAULTS = {"ssm": ("none", "leaf_slices"), "hybrid": ("none", "leaf_slices", "concat_block")}


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _fault(name):
    """A rank that reads the wrong part of what it shares: the mixer's
    whole leaves (conv, A_log, D, dt_bias, the norm's scale) at rank 0's
    channels and heads on every rank (``leaf_slices``), or block 0 of the
    shared block's concat on every rank (``concat_block``).  (The gathered
    B and C in another rank order is no fault: it permutes B's and C's
    state channels alike, which the scan sums over.)"""
    saved = t_ssm._local_leaves, t_hybrid.model_block
    if name == "leaf_slices":
        t_ssm._local_leaves = lambda p, di, ds, nh, mesh: saved[0](
            p, di, ds, nh, types.SimpleNamespace(model_size=mesh.model_size, model_rank=0))
    elif name == "concat_block":
        t_hybrid.model_block = lambda x, dim: x.narrow(
            dim, 0, x.shape[dim] // current_mesh().model_size)
    try:
        yield
    finally:
        t_ssm._local_leaves, t_hybrid.model_block = saved


def _f32gate(device, job, mesh):
    """Phase tp_ssm (e)'s forms (``chip_smoke.Smoke.tp_ssm_f32``: the
    prefill and teacher-forced decode steps over f32 caches) on this
    rank's shard, as they are and under each of ``FAULTS``: the logits
    gathered over ``data``."""
    smoke = types.SimpleNamespace(torch=torch, dev=torch.device("cpu"))
    tp_ssm_f32 = _chip_smoke().Smoke.tp_ssm_f32
    cfg = job["cfg"]
    model = shard_model(params_from_jax(job["params"], cfg, device="cpu"), cfg, mesh)
    prompt, dec = (torch.from_numpy(a) for a in _tokens(cfg))
    n = ROWS // mesh.data_size
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    out = {}
    for fault in FAULTS[cfg.family]:
        with _fault(fault):
            got = tp_ssm_f32(smoke, cfg, model, prompt[rows], dec[rows], mesh)
        out[fault] = torch.cat(mesh.all_gather(got.contiguous(), "data")).numpy()
    return out


def _cli(device, job, mesh):
    return t_cli._train(t_cli.make_parser().parse_args(job["argv"]), device, mesh)


def _virtual_traffic(cfg, kind, batch, seq_len, rank=0):
    """The collectives of rank ``rank``'s ``kind`` step on the virtual
    (2 x 2) mesh (``launch/dryrun.py``, on meta): by "<axis>/<kind>"."""
    mesh = VirtualMesh(rank, data=DATA, model=MODEL)
    step, args = dryrun.build_cell(cfg, ShapeSpec("ci", seq_len, batch, kind), mesh=mesh)
    mesh.traffic.clear()
    with use_mesh(mesh):
        step(*args)
    return dict(mesh.traffic)


@pytest.fixture(scope="module")
def runs():
    """The JAX references and the one world's results; the world runs
    while the references step."""
    inits = {arch: _jax_init(arch, "f32") for arch in ARCHS}
    jobs = {}
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        jobs[f"{arch}/steps"] = dict(kind="steps", cfg=cfg, params=inits[arch],
                                     batches=_batches(cfg))
        jobs[f"{arch}/serve"] = dict(kind="serve", arch=arch, cfg=cfg, params=inits[arch])
        jobs[f"{arch}/f32gate"] = dict(kind="f32gate", cfg=cfg, params=inits[arch])
    jobs["cli"] = dict(kind="cli", argv=[
        "--arch", "zamba2-1.2b", "--reduced", "--steps", "2", "--numerics", "f32",
        "--seq-len", str(SEQ), "--batch", "4"])
    for job in jobs.values():
        job.update(data=DATA, model=MODEL)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _world, DATA * MODEL, "cpu", jobs, threads=1, timeout=240)
        ref = {}
        for arch in ARCHS:
            j_cfg, _ = _cfgs(arch)
            ref[arch] = {"steps": _jax_run(arch, "f32")}
            params = jax.tree.map(jnp.asarray, inits[arch])
            ref[arch]["logits"] = _jax_forward(arch, params)
        world = world.result()[0]
    return {"ref": ref, "world": world}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_the_jax_unsharded_step(runs, arch):
    """Two AdamW steps over the (2 x 2) mesh with ZeRO-1 state: each step's
    loss, and every gathered parameter, m and v after them, against the
    reference's unsharded jitted step (the mixer's whole leaves summed
    over ``model``, in_proj's blocks gathered into the whole leaf)."""
    got = runs["world"][f"{arch}/steps"]
    _, losses, want = runs["ref"][arch]["steps"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=0)
    _assert_tree_close(got["tree"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_the_jax_unsharded_forward(runs, arch):
    """The prefill of four rows (two a data rank) and two teacher-forced
    decode steps over f32 caches, each rank its heads and channels, the
    logits gathered over ``data``: the reference's unsharded logits
    within 1e-5."""
    got = runs["world"][f"{arch}/serve"]["logits"]
    want = runs["ref"][arch]["logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_sequence_parallel_decode_matches_the_jax_unsharded_decode(runs):
    """zamba2 at global batch 1: every data rank prefills the one row, then
    keeps its half of the shared K/V positions; each decode step writes
    the new K/V on the rank that owns the position and merges the ranks'
    partial softmaxes.  Its logits are the reference's row 0 (rows are
    independent) within 1e-5."""
    got = runs["world"]["zamba2-1.2b/serve"]["seq_logits"]
    np.testing.assert_allclose(got, runs["ref"]["zamba2-1.2b"]["logits"][:1],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_f32_gate_tells_a_fault_from_sum_order(runs, arch):
    """Phase tp_ssm (e) at reduced size: the world's f32 logits lie within
    a hundredth of ``TP_MESH_F32_TOL`` of the reference's (relative to its
    largest |logit|), and each rank-reading fault moves them by more than
    ten times the tolerance."""
    tol = _chip_smoke().TP_MESH_F32_TOL
    want = runs["ref"][arch]["logits"]
    err = {k: float(np.abs(v - want).max() / np.abs(want).max())
           for k, v in runs["world"][f"{arch}/f32gate"].items()}
    assert err.pop("none") <= tol / 100
    assert len(err) == len(FAULTS[_cfgs(arch)[1].family]) - 1
    assert all(e > 10 * tol for e in err.values()), err


CELLS = [(arch, kind) for arch in ARCHS for kind in ("train", "prefill", "decode")]
CELLS.append(("zamba2-1.2b", "seq_decode"))


@pytest.mark.parametrize("arch,kind", CELLS, ids=[f"{a}-{k}" for a, k in CELLS])
def test_virtual_mesh_counts_the_worlds_collectives(runs, arch, kind):
    """Rank 0 of the virtual (2 x 2) mesh, its step traced on meta, calls
    the world's collectives: the same axes and kinds, the same calls and
    result bytes (a training step: the last one's, after the updated
    parameters' gather over ``data``; a decode: one step, at batch 1 with
    the hybrid's shared K/V over ``data``)."""
    _, cfg = _cfgs(arch)
    world = runs["world"][f"{arch}/steps" if kind == "train" else f"{arch}/serve"]
    if kind == "train":
        want = world["traffic"]
        got = _virtual_traffic(cfg, "train", 8, SEQ)
    else:
        want = world["traffic"][kind]
        got = _virtual_traffic(cfg, "prefill" if kind == "prefill" else "decode",
                               1 if kind == "seq_decode" else ROWS, PROMPT)
    assert got == want, (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_state_is_the_zero1_layout(runs, arch):
    """Rank 0's m + v bytes equal the reference's per-device ZeRO-1 count
    (``_zero1_dims`` on the stacked leaves): in_proj's columns cut block
    by block hold (2 di + 2 ds + nh) / tp of them, the mixer's whole
    leaves are cut over ``data`` alone."""
    j_cfg, _ = _cfgs(arch)
    from repro.models import build as j_build

    tree = jax.eval_shape(lambda: j_build(j_cfg).init(jax.random.PRNGKey(0)))
    mesh = type("M", (), {"axis_names": ("data", "model"),
                          "shape": {"data": DATA, "model": MODEL}})()
    want = sum(8 * zero1_numel(leaf.shape, j_opt._zero1_dims(j_sh._path_str(path), leaf, mesh),
                               mesh)
               for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])
    assert runs["world"][f"{arch}/steps"]["state_bytes"] == want


def test_cli_trains_the_hybrid_over_a_mesh(runs):
    """The train CLI's rank body on the (2 x 2) mesh (what ``--data 2
    --model 2`` spawns) trains zamba2: rank 0's lines, the last one the
    run's end."""
    lines = runs["world"]["cli"]
    assert lines[0].startswith("step     0  loss ")
    assert lines[-1] == "restarts=0 final_step=2"
