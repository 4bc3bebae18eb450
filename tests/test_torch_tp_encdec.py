"""The encoder-decoder and vlm families over a (data x model) mesh of
``torch.distributed`` ranks against the JAX package's unsharded
functions: reduced seamless-m4t-medium (its ``n_layers`` the sum of its
two stacks, as the full config's 24 = 12 + 12), reduced qwen2-vl-72b and
the same with one kv head (kv < tp, as the production 8 kv heads over
16 ranks), all in f32, each rank its shard (``parallel/sharding.py``:
the cross-attention cut as self-attention, its ``wk``/``wv`` by
``kv_heads_for_rank``, ``frontend_proj`` whole).

ONE spawned world of four gloo ranks (``launch/mesh.py::spawn``) runs
every case (``_world``) on a (data 2 x model 2) mesh: two sharded AdamW
steps with ZeRO-1 state (``train/loop.py``; each data rank its rows of
the tokens, frames and patch embeddings), the registry's static prefill
and a decode step (their collectives), and ``chip_smoke.py``'s phase
tp_encdec f32 forms (``Smoke.tp_encdec_f32``: the prefill of four rows,
two a data rank, and teacher-forced decode steps over f32 caches) as
they are and with a rank-reading fault put in.  The JAX steps and
forwards run meanwhile in this process, jitted, from the reference's
init (key 0); weights go in through ``convert.params_from_jax``.  The
virtual mesh of the sharded dry run (``launch/mesh.py::VirtualMesh``,
``launch/dryrun.py``) counts each of those steps on meta tensors: its
collectives by axis and kind, with their result bytes, must be the
world's.

AdamW runs at eps 1e-5, as in ``tests/test_torch_tp_train.py`` (whose
comparison of trees this file reuses); the tolerance is rtol 1e-5 /
atol 1e-6 there, and the logits are held within 1e-5.  The cases draw
the vlm's patch embeddings at the token embeddings' scale; ``UNIT``
draws them at N(0, 1), as ``chip_smoke.py`` does, and holds the world
to the reference through the port's own unsharded step.
"""
import concurrent.futures
import contextlib
import dataclasses
import functools
import importlib.util
import os
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.data.synthetic import lm_batch as j_lm_batch  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro.parallel import sharding as j_sh  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import VirtualMesh, make_host_mesh, spawn  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.models.registry import build, vlm_patches  # noqa: E402
from repro_torch.models.transformer import set_trainable  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, init_state, zero1_numel  # noqa: E402
from repro_torch.parallel import sharding as t_sh  # noqa: E402
from repro_torch.parallel.sharding import shard_model, use_mesh  # noqa: E402
from repro_torch.train import loop  # noqa: E402

from test_torch_chunked import _numpy_tree  # noqa: E402
from test_torch_dryrun_mesh import _kv_excess  # noqa: E402
from test_torch_ssm import one_thread  # noqa: E402,F401
from test_torch_tp_train import ATOL, RTOL, _assert_tree_close, _flat, _sharded  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

#: case -> (arch, config changes): seamless with n_layers = enc + dec (so
#: that a single depth for both stacks puts ZeRO-1's layers on the wrong
#: data ranks), qwen2-vl as reduced (2 kv heads) and with kv < tp
CASES = {"seamless-m4t-medium": ("seamless-m4t-medium", {"n_layers": 4}),
         "qwen2-vl-72b": ("qwen2-vl-72b", {}),
         "qwen2-vl-72b-kv1": ("qwen2-vl-72b", {"n_kv": 1})}
#: qwen2-vl with its patch embeddings at N(0, 1) (its training steps only)
UNIT = "qwen2-vl-72b-unit"
ARCHS = {**CASES, UNIT: ("qwen2-vl-72b", {})}
DATA, MODEL = 2, 2
LR, EPS, STEPS, BATCH = 1e-3, 1e-5, 2, 8
SEQ = 32  # a training row: 32 frames (and 32 target tokens), or 16 patches and 16 tokens
ROWS, PROMPT, DECODE = 4, 16, 2  # prefill rows (ROWS / DATA a data rank), prompt, decode steps
LOGIT_TOL = 1e-5
#: the faults that phase tp_encdec's f32 gate must see, by case (one kv
#: head: every rank reads the same one, so no kv-head fault shows)
FAULTS = {"seamless-m4t-medium": ("none", "cross_heads"), "qwen2-vl-72b": ("none", "kv_heads"),
          "qwen2-vl-72b-kv1": ("none",)}


def _cfgs(case):
    arch, change = ARCHS[case]
    red = dict(param_dtype="float32", act_dtype="float32", **change)
    return (dataclasses.replace(j_get_config(arch).reduced(), **red).with_numerics("default=f32"),
            dataclasses.replace(t_get_config(arch).reduced(), **red).with_numerics("default=f32"))


def _frontend(cfg, rows, length, seed, unit=False):
    """Seeded frames [rows, length, frontend_dim], N(0, 1), or patch
    embeddings [rows, length, d] at the token embeddings' scale (N(0, 1 /
    d), as both packages draw ``embed``; with ``unit`` N(0, 1)), f32
    numpy."""
    if cfg.family == "encdec":
        return np.random.default_rng(seed).standard_normal(
            (rows, length, cfg.frontend_dim)).astype(np.float32)
    x = np.random.default_rng(seed).standard_normal((rows, length, cfg.d_model))
    return (x if unit else x * cfg.d_model ** -0.5).astype(np.float32)


def _extra_key(cfg):
    return "frames" if cfg.family == "encdec" else "embeds_prefix"


@functools.lru_cache(maxsize=None)
def _batches(case):
    """STEPS global batches of ``train_inputs``' shapes: the reference's
    lm_batch tokens and labels, seeded frames or patch embeddings."""
    _, cfg = _cfgs(case)
    spec = build(cfg).train_inputs(BATCH, SEQ)
    key = _extra_key(cfg)
    d = JDataConfig(seed=0, vocab=cfg.vocab, seq_len=spec["tokens"].shape[1],
                    global_batch=BATCH)
    out = []
    for s in range(STEPS):
        batch = {k: np.asarray(v) for k, v in j_lm_batch(d, s).items()}
        batch[key] = _frontend(cfg, BATCH, spec[key].shape[1], 5 + s, unit=case == UNIT)
        out.append(batch)
    return out


def _prompt(cfg):
    """The prefill's inputs {tokens [ROWS, PROMPT], frames or embeds_prefix}
    (numpy) and the teacher-forced decode tokens [ROWS, DECODE]."""
    rng = np.random.default_rng(7)
    length = PROMPT if cfg.family == "encdec" else vlm_patches(cfg)
    batch = {"tokens": rng.integers(0, cfg.vocab, (ROWS, PROMPT)).astype(np.int32),
             _extra_key(cfg): _frontend(cfg, ROWS, length, 7)}
    return batch, rng.integers(0, cfg.vocab, (ROWS, DECODE)).astype(np.int32)


def _jax_init(case):
    j_cfg, _ = _cfgs(case)
    return _numpy_tree(jax.tree.map(np.asarray, j_build(j_cfg).init(jax.random.PRNGKey(0))))


def _jax_steps(case):
    """The reference's jitted unsharded AdamW step, STEPS times from its
    init: (losses, (params, state) as numpy)."""
    j_cfg, _ = _cfgs(case)
    api = j_build(j_cfg)
    params = api.init(jax.random.PRNGKey(0))
    tcfg = j_loop.TrainConfig(opt=j_opt.OptConfig(lr=LR, eps=EPS))
    state = j_opt.init_state(tcfg.opt, params)
    step = jax.jit(j_loop.make_train_step(api.train_loss, tcfg))
    losses = []
    for batch in _batches(case):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return losses, jax.tree.map(np.asarray, (params, state))


def _port_steps(case):
    """The port's own AdamW step, unsharded (one process, no mesh), STEPS
    times from the reference's init: (params, state) as the reference's
    tree."""
    _, cfg = _cfgs(case)
    api = build(cfg)
    model = set_trainable(params_from_jax(_jax_init(case), cfg, device="cpu"))
    tcfg = loop.TrainConfig(opt=OptConfig(lr=LR, eps=EPS))
    state = init_state(tcfg.opt, model)
    step = loop.make_train_step(api.train_loss, tcfg)
    for batch in _batches(case):
        step(model, state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    return loop.train_tree(model, state)


def _jax_forward(case, params):
    """The reference's prefill of the prompt over f32 caches and its
    teacher-forced decode steps, jitted: logits [ROWS, 1 + DECODE, V]
    (the vlm's prefill as the reference's registry runs it, into caches
    with room for the decode)."""
    cfg, _ = _cfgs(case)
    batch, dec = _prompt(cfg)
    tokens = jnp.asarray(batch["tokens"])
    if cfg.family == "encdec":
        frames = jnp.asarray(batch["frames"])
        caches = j_encdec.kv_cache_init(cfg, ROWS, PROMPT + DECODE, jnp.float32)
        logits, caches = jax.jit(functools.partial(j_encdec.prefill, cfg))(
            params, frames, tokens, caches)
        enc_out = jax.jit(functools.partial(j_encdec.encode, cfg))(params, frames)
        step = jax.jit(lambda p, t, c, at: j_encdec.decode_step(cfg, p, t, enc_out, c, at))
        at = PROMPT
    else:
        prefix = jnp.asarray(batch["embeds_prefix"])

        def prefill(params, tokens, prefix, caches):
            x = j_tf.embed_tokens(cfg, params, tokens)
            x = jnp.concatenate([prefix.astype(x.dtype), x], axis=1)
            positions = j_tf.default_positions(cfg, ROWS, x.shape[1])
            hidden, caches = j_tf.lm_backbone(cfg, params, x, positions, kv_caches=caches,
                                              cache_len=jnp.int32(0))
            return j_tf.lm_logits(cfg, params, hidden[:, -1:, :]), caches

        at = prefix.shape[1] + PROMPT
        caches = j_tf.kv_cache_init(cfg, ROWS, at + DECODE, jnp.float32)
        logits, caches = jax.jit(prefill)(params, tokens, prefix, caches)
        step = jax.jit(functools.partial(j_tf.decode_step, cfg))
    out = [np.asarray(logits)]
    for i in range(DECODE):
        logits, caches = step(params, jnp.asarray(dec[:, i:i + 1]), caches, jnp.int32(at + i))
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


def _world(device, jobs):
    """Every job on this rank of the world (``spawn``'s target); rank 0's
    results."""
    out = {}
    mesh = make_host_mesh(data=DATA, model=MODEL)
    for name, job in jobs.items():
        out[name] = globals()[f"_{job['kind']}"](device, job, mesh)
    return out if mesh.rank == 0 else None


def _snapshot(mesh):
    """A copy of the mesh's collectives so far (its tallies change in place)."""
    return {k: list(v) for k, v in mesh.traffic.items()}


def _steps(device, job, mesh):
    """STEPS sharded steps (``test_torch_tp_train._sharded``'s model, ZeRO-1
    and step) on the global batches: losses, the gathered (params, state),
    this rank's state bytes and the last step's collectives."""
    api, model, zero = _sharded(job, mesh)
    tcfg = loop.TrainConfig(opt=OptConfig(lr=LR, eps=EPS))
    state = init_state(tcfg.opt, model, zero)
    step = loop.make_train_step(api.train_loss, tcfg, zero)
    losses = []
    for batch in job["batches"]:
        mesh.traffic.clear()
        losses.append(float(step(model, state, batch)[2]["loss"]))
    return {"losses": losses, "traffic": _snapshot(mesh),
            "state_bytes": zero.state_bytes(state),
            "tree": loop.gather_train_tree(model, state, zero)}


def _rows(a, mesh):
    """This data rank's rows of numpy ``a`` [ROWS, ...] (of each leaf of a
    dict), as torch tensors."""
    if isinstance(a, dict):
        return {k: _rows(v, mesh) for k, v in a.items()}
    n = ROWS // mesh.data_size
    return torch.from_numpy(a[mesh.data_rank * n:(mesh.data_rank + 1) * n])


def _serve(device, job, mesh):
    """This rank's rows through the registry's static prefill and one
    decode step (the encdec's over its encoder output): the collectives
    of each."""
    cfg = job["cfg"]
    api = build(cfg)
    model = shard_model(params_from_jax(job["params"], cfg, device="cpu"), cfg, mesh)
    batch, dec = _prompt(cfg)
    mine = _rows(batch, mesh)
    traffic = {}
    with torch.no_grad(), use_mesh(mesh):
        mesh.traffic.clear()
        _, caches = api.prefill(model, mine)
        traffic["prefill"] = _snapshot(mesh)
        step = {"token": _rows(dec, mesh)[:, :1], "kv_caches": caches,
                "cache_len": caches[0].shape[2] - 1}
        if cfg.family == "encdec":
            step["enc_out"] = t_encdec.encode(cfg, model, mine["frames"])
        mesh.traffic.clear()
        api.decode_step(model, step)
        traffic["decode"] = _snapshot(mesh)
    return traffic


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _fault(name):
    """A rank that reads the wrong heads: each decoder layer's cross K/V with
    the rank's kv heads in reverse order (``cross_heads``), or every rank
    keeping model rank 0's kv heads (``kv_heads``)."""
    saved = t_encdec.encode_cross_kv, t_sh.kv_heads_for_rank
    if name == "cross_heads":
        def flipped(*a, **kw):
            k, v = saved[0](*a, **kw)
            return k.flip(2), v.flip(2)

        t_encdec.encode_cross_kv = flipped
    elif name == "kv_heads":
        t_sh.kv_heads_for_rank = lambda h, kv, tp, rank: saved[1](h, kv, tp, 0)
    try:
        yield
    finally:
        t_encdec.encode_cross_kv, t_sh.kv_heads_for_rank = saved


def _f32gate(device, job, mesh):
    """Phase tp_encdec (a)'s forms (``chip_smoke.Smoke.tp_encdec_f32``) on
    this rank's shard and rows, as they are and under each of the case's
    ``FAULTS``: the logits gathered over ``data``."""
    smoke = types.SimpleNamespace(torch=torch, dev=torch.device("cpu"))
    tp_encdec_f32 = _chip_smoke().Smoke.tp_encdec_f32
    cfg = job["cfg"]
    batch, dec = _prompt(cfg)
    mine = _rows(batch, mesh)
    out = {}
    for fault in FAULTS[job["case"]]:
        with _fault(fault):
            model = shard_model(params_from_jax(job["params"], cfg, device="cpu"), cfg, mesh)
            got = tp_encdec_f32(smoke, cfg, model, mine, _rows(dec, mesh), mesh)
        out[fault] = torch.cat(mesh.all_gather(got.contiguous(), "data")).numpy()
    return out


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
    inits = {case: _jax_init(case) for case in ARCHS}
    jobs = {}
    for case in ARCHS:
        _, cfg = _cfgs(case)
        common = dict(case=case, cfg=cfg, params=inits[case])
        jobs[f"{case}/steps"] = dict(kind="steps", batches=_batches(case), **common)
        if case in CASES:
            jobs[f"{case}/serve"] = dict(kind="serve", **common)
            jobs[f"{case}/f32gate"] = dict(kind="f32gate", **common)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, _world, DATA * MODEL, "cpu", jobs, threads=1, timeout=240)
        ref = {}
        for case in CASES:
            ref[case] = {"steps": _jax_steps(case),
                         "logits": _jax_forward(case, jax.tree.map(jnp.asarray, inits[case]))}
        ref[UNIT] = {"steps": _jax_steps(UNIT), "port": _port_steps(UNIT)}
        world = world.result()[0]
    return {"ref": ref, "world": world}


@pytest.mark.parametrize("case", CASES)
def test_sharded_steps_match_the_jax_unsharded_step(runs, case):
    """Two AdamW steps over the (2 x 2) mesh with ZeRO-1 state, each data
    rank its rows of the tokens and of the frames or patch embeddings:
    each step's loss, and every gathered parameter, m and v after them,
    against the reference's unsharded jitted step."""
    got = runs["world"][f"{case}/steps"]
    losses, want = runs["ref"][case]["steps"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=0)
    _assert_tree_close(got["tree"], want)


def test_unit_patch_embeddings_part_from_the_reference_by_sum_order_only(runs):
    """qwen2-vl's two sharded AdamW steps with its patch embeddings at
    N(0, 1), as ``chip_smoke.py`` draws them: √d times the token rows, and
    so are the gradient terms that cancel into a near-zero gradient
    element, where AdamW at eps 1e-5 divides m by little more than eps.
    There the world's parameters may sit just past the tolerance from the
    reference's (at one embed element here) where the port's own
    unsharded step sits short of it at the same element: two changes of
    f32 sum order, the port's and the mesh's, stack.  So the losses, m and
    v (the gradients) are held to the reference's, and the parameters
    through the port's unsharded step: the world to it, and it to the
    reference, each at the f32 tolerance."""
    got = runs["world"][f"{UNIT}/steps"]
    losses, want = runs["ref"][UNIT]["steps"]
    port = runs["ref"][UNIT]["port"]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=0)
    flat, ref = _flat(got["tree"]), _flat(want)
    state = [k for k in ref if k.startswith(("/1/m/", "/1/v/"))]
    assert state
    for k in state:
        np.testing.assert_allclose(flat[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=k)
    _assert_tree_close(port, want)
    _assert_tree_close(got["tree"], port)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_logits_match_the_jax_unsharded_forward(runs, case):
    """Phase tp_encdec's f32 forms on four rows (two a data rank), each rank
    its heads: the prefill and two teacher-forced decode steps over f32
    caches, the logits gathered over ``data``, within 1e-5 of the
    reference's unsharded logits."""
    got = runs["world"][f"{case}/f32gate"]["none"]
    want = runs["ref"][case]["logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("case", CASES)
def test_chip_smoke_f32_gate_tells_a_fault_from_sum_order(runs, case):
    """Phase tp_encdec (a) at reduced size: the world's f32 logits lie
    within a hundredth of ``TP_MESH_F32_TOL`` of the reference's
    (relative to its largest |logit|), and each rank-reading fault moves
    them by more than ten times the tolerance."""
    tol = _chip_smoke().TP_MESH_F32_TOL
    want = runs["ref"][case]["logits"]
    err = {k: float(np.abs(v - want).max() / np.abs(want).max())
           for k, v in runs["world"][f"{case}/f32gate"].items()}
    assert err.pop("none") <= tol / 100
    assert len(err) == len(FAULTS[case]) - 1
    assert all(e > 10 * tol for e in err.values()), err


CELLS = [(case, kind) for case in CASES for kind in ("train", "prefill", "decode")]


@pytest.mark.parametrize("case,kind", CELLS, ids=[f"{c}-{k}" for c, k in CELLS])
def test_virtual_mesh_counts_the_worlds_collectives(runs, case, kind):
    """Rank 0 of the virtual (2 x 2) mesh, its step traced on meta, calls
    the world's collectives: the same axes and kinds, the same calls and
    result bytes (a training step: the last one's; a decode: one step)."""
    _, cfg = _cfgs(case)
    if kind == "train":
        want = runs["world"][f"{case}/steps"]["traffic"]
        got = _virtual_traffic(cfg, "train", BATCH, SEQ)
    else:
        want = runs["world"][f"{case}/serve"][kind]
        seq = PROMPT if cfg.family == "encdec" else 2 * PROMPT  # the vlm's: patches + tokens
        got = _virtual_traffic(cfg, kind, ROWS, seq)
    assert got == want, (got, want)


@pytest.mark.parametrize("case", CASES)
def test_rank_state_is_the_zero1_layout(runs, case):
    """Rank 0's m + v bytes equal the reference's per-device ZeRO-1 count
    (``_zero1_dims`` on the stacked leaves: [enc_layers] and [dec_layers]
    apart for the encdec), with wk/wv's whole kv heads where kv < tp."""
    j_cfg, cfg = _cfgs(case)
    tree = jax.eval_shape(lambda: j_build(j_cfg).init(jax.random.PRNGKey(0)))
    mesh = type("M", (), {"axis_names": ("data", "model"),
                          "shape": {"data": DATA, "model": MODEL}})()
    want = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        p = j_sh._path_str(path)
        want += (8 * zero1_numel(leaf.shape, j_opt._zero1_dims(p, leaf, mesh), mesh)
                 * _kv_excess(cfg, p, MODEL))
    assert runs["world"][f"{case}/steps"]["state_bytes"] == want
