"""Tensor parallelism's rules and layout (``repro_torch/parallel/sharding.py``,
``repro_torch/launch/mesh.py``) against the reference's
``repro/parallel/sharding.py``, and K6, the head-sharded paged decode
attention, on one rank's slice against the reference's plain version.

No process group is started here: the rules, the slices and K6 need only
a rank and a world (``Mesh``); the served tokens at tp = 2 are held in
``tests/test_torch_tp_serving.py`` and ``tests/test_torch_tp_moe.py``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.decode_attention import paged_decode_attention_ref as j_paged  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.parallel import sharding as j_sh  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.prequant import param_path  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.parallel import sharding as t_sh  # noqa: E402
from repro_torch.serving import ServeOptions, build_engine  # noqa: E402

# the module (the package exports a function of the same name)
t_da = importlib.import_module("repro_torch.kernels.decode_attention")

ARCHS = ("yi-6b", "gemma-7b", "minitron-8b", "command-r-plus-104b", "deepseek-moe-16b",
         "granite-moe-1b-a400m")
TPS = (2, 4, 8)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (``tests/test_torch_ssm.py::one_thread``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _StandIn:
    """What the reference's ``sanitize`` reads of a jax Mesh."""

    def __init__(self, tp):
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": tp}


def _ref_paths(arch):
    """The reference's parameter paths and leaf ranks (stacked layers
    included), from its init under ``jax.eval_shape``."""
    jc = j_get_config(arch).reduced()
    tree = jax.eval_shape(lambda: j_build(jc).init(jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {j_sh._path_str(path): leaf.ndim for path, leaf in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_the_reference(arch):
    """For every parameter of the reduced config: the port's spec under
    both rule sets is the reference's on the same path (and, with the
    stacked layer axis, on the reference's own leaf), and ``sanitize``
    keeps and drops what the reference's does at model = 2, 4 and 8."""
    cfg = t_get_config(arch).reduced()
    model = t_tf.lm_init(cfg, device="meta")
    ref = _ref_paths(arch)
    names = [(param_path(n), p) for n, p in model.named_parameters()]
    assert {path for path, _ in names} == set(ref)
    for path, p in names:
        for t_rules, j_rules in ((None, None),
                                 (t_sh.expert_parallel_rules(), j_sh.expert_parallel_rules())):
            spec = t_sh.spec_for_param(path, p.dim(), t_rules)
            assert spec == j_sh.spec_for_param(path, p.dim(), j_rules), path
            assert (j_sh.spec_for_param(path, ref[path], j_rules)
                    == (None,) * (ref[path] - p.dim()) + spec), path
            for tp in TPS:
                assert (t_sh.sanitize(t_sh.Mesh(0, tp), spec, tuple(p.shape))
                        == j_sh.sanitize(_StandIn(tp), spec, tuple(p.shape))), (path, tp)


@pytest.mark.parametrize("tp", TPS)
def test_sanitize_drops_an_indivisible_vocab(tp):
    """granite-moe-1b-a400m's vocab of 49,155 divides no model axis: the
    embedding and the head stay whole, as in the reference."""
    for path, spec, shape in (("embed", ("model", None), (49155, 1024)),
                              ("unembed", (None, "model"), (1024, 49155)),
                              ("embed", ("model", None), (64000, 4096))):
        got = t_sh.sanitize(t_sh.Mesh(0, tp), spec, shape)
        assert got == j_sh.sanitize(_StandIn(tp), spec, shape)
        assert ("model" in got) == (shape[spec.index("model")] % tp == 0)


@pytest.mark.parametrize("n_heads,n_kv,tp,want", [
    (32, 4, 2, [[0, 1], [2, 3]]),            # yi-6b at tp = 2: kv / tp heads a rank
    (32, 4, 8, [[0], [0], [1], [1], [2], [2], [3], [3]]),  # kv < tp: replicated heads
    (4, 1, 2, [[0], [0]]),                   # the reference's kv = 1 fallback
    (12, 3, 2, [[0, 0, 0, 0, 1, 1], [1, 1, 2, 2, 2, 2]]),  # unequal groups: a head a q head
    (16, 16, 2, [list(range(8)), list(range(8, 16))]),
])
def test_kv_heads_for_rank(n_heads, n_kv, tp, want):
    assert [t_sh.kv_heads_for_rank(n_heads, n_kv, tp, r) for r in range(tp)] == want


def test_paged_pool_spec_follows_the_reference_choice():
    """The kv-head axis where the kv heads divide the model axis (the
    port's layout too), else positions within a block (the port keeps
    replicated kv heads instead), else replicated."""
    mesh = t_sh.Mesh(0, 2)
    assert t_sh.paged_pool_spec(mesh, (2, 64, 16, 4, 128)) == (None, None, None, "model", None)
    assert t_sh.paged_pool_spec(mesh, (2, 64, 16, 1, 128)) == (None, None, "seq_tp", None, None)
    assert t_sh.paged_pool_spec(mesh, (2, 64, 15, 1, 128)) == (None,) * 5
    assert t_sh.pool_layout(mesh, (2, 64, 16, 4, 128)) == "kv_heads"
    assert t_sh.pool_layout(t_sh.Mesh(0, 8), (2, 64, 16, 4, 128)) == "replicated_kv_heads"


def _cut_cfg(arch, **over):
    return dataclasses.replace(t_get_config(arch).reduced(), param_dtype="float32",
                               act_dtype="float32", **over)


@pytest.mark.parametrize("arch,tp,over", [
    ("yi-6b", 2, {}), ("yi-6b", 4, {}), ("gemma-7b", 2, {}), ("deepseek-moe-16b", 2, {}),
    ("granite-moe-1b-a400m", 2, {"vocab": 49155}),
], ids=["yi-tp2", "yi-tp4-replicated-kv", "gemma-tied", "deepseek", "granite-vocab-49155"])
def test_sharded_init_equals_shard_model(arch, tp, over):
    """The seeded init under a mesh keeps, rank by rank, the slices that
    ``shard_model`` cuts from the whole init, with the same marks; the
    ranks' blocks put back together are the whole parameter."""
    cfg = _cut_cfg(arch, **over)
    whole = dict(t_tf.lm_init(cfg, seed=3, device="cpu").named_parameters())
    cuts = []
    for r in range(tp):
        mesh = t_sh.Mesh(r, tp)
        drawn = t_tf.lm_init(cfg, seed=3, device="cpu", mesh=mesh)
        cut = t_sh.shard_model(t_tf.lm_init(cfg, seed=3, device="cpu"), cfg, mesh)
        assert drawn.tp_shard == cut.tp_shard == (r, tp)
        assert drawn.vocab_parallel == cut.vocab_parallel == (cfg.vocab % tp == 0)
        for (name, a), (_, b) in zip(drawn.named_parameters(), cut.named_parameters()):
            assert torch.equal(a, b), name
        for m_a, m_b in zip(drawn.modules(), cut.modules()):
            assert getattr(m_a, "row_parallel", None) == getattr(m_b, "row_parallel", None)
        cuts.append(dict(cut.named_parameters()))
    attn = cuts[0]["blocks.0.attn.wq"].shape[-1] // cfg.hd
    assert attn == cfg.n_heads // tp
    for name, full in whole.items():
        parts = [c[name] for c in cuts]
        if parts[0].shape == full.shape:
            assert all(torch.equal(p, full) for p in parts) or "attn.w" in name, name
            continue
        dim = next(d for d in range(full.dim()) if parts[0].shape[d] != full.shape[d])
        if name.endswith(("attn.wk", "attn.wv")):  # the kv heads of each rank
            heads = [t_sh.kv_heads_for_rank(cfg.n_heads, cfg.n_kv, tp, r) for r in range(tp)]
            for p, hs in zip(parts, heads):
                cols = full.reshape(full.shape[0], cfg.n_kv, cfg.hd)[:, hs]
                assert torch.equal(p, cols.reshape(full.shape[0], -1)), name
            continue
        assert torch.equal(torch.cat(parts, dim=dim), full), name


def test_a_mesh_of_one_marks_without_cutting():
    """tp = 1 inside a world of one: nothing is cut, every cut is marked, so
    the forward runs each collective (an identity there)."""
    cfg = _cut_cfg("yi-6b")
    model = t_sh.shard_model(t_tf.lm_init(cfg, seed=0, device="cpu"), cfg, t_sh.Mesh(0, 1))
    whole = t_tf.lm_init(cfg, seed=0, device="cpu")
    for (name, a), (_, b) in zip(model.named_parameters(), whole.named_parameters()):
        assert torch.equal(a, b), name
    assert model.vocab_parallel and model.blocks[0].attn.row_parallel
    assert model.blocks[0].mlp.row_parallel


def _paged_case(seed, b, h, kv, hd, bs, nb, max_blk):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    tables = rng.integers(1, nb, (b, max_blk)).astype(np.int32)
    lengths = np.array([0, 1, bs + 3, max_blk * bs][:b], np.int32)
    return q, kp, vp, tables, lengths


# K6 on the CPU is K2's plain version on a rank's slice: the same op order
# as the reference's gather oracle, in f32; a few ulp of the softmax sums
K6_TOL = 1e-5


@pytest.mark.parametrize("h,kv,tp", [(8, 4, 2), (8, 2, 4), (8, 1, 2), (12, 3, 2)],
                         ids=["kv-heads", "replicated-kv", "kv-1", "unequal-groups"])
def test_paged_decode_attention_tp_on_a_rank_slice(h, kv, tp):
    """Each rank's q heads over its kv heads (``kv_heads_for_rank``: its
    block, or the replicated heads of the fallback) through
    ``paged_decode_attention_tp`` against the reference's
    ``paged_decode_attention_ref`` on the matching heads, and against the
    whole-head result's rows."""
    q, kp, vp, tables, lengths = _paged_case(h * 10 + kv, 4, h, kv, 16, 4, 9, 3)
    full = np.asarray(j_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths)))
    local = h // tp
    for r in range(tp):
        heads = t_sh.kv_heads_for_rank(h, kv, tp, r)
        q_r, kp_r, vp_r = q[:, r * local:(r + 1) * local], kp[:, :, heads], vp[:, :, heads]
        with t_sh.use_mesh(t_sh.Mesh(r, tp)):
            got = t_da.paged_decode_attention(
                torch.from_numpy(q_r), torch.from_numpy(kp_r), torch.from_numpy(vp_r),
                torch.from_numpy(tables), torch.from_numpy(lengths)).numpy()
        want = np.asarray(j_paged(
            jnp.asarray(q_r), jnp.asarray(kp_r), jnp.asarray(vp_r), jnp.asarray(tables),
            jnp.asarray(lengths)))
        np.testing.assert_allclose(got, want, rtol=K6_TOL, atol=K6_TOL)
        np.testing.assert_allclose(got, full[:, r * local:(r + 1) * local],
                                   rtol=K6_TOL, atol=K6_TOL)


def test_paged_decode_attention_dispatches_to_tp_under_a_mesh(monkeypatch):
    """Under a mesh of more than one rank ``paged_decode_attention`` is K6;
    with no mesh it is not."""
    calls = []
    real = t_da.paged_decode_attention_tp
    monkeypatch.setattr(t_da, "paged_decode_attention_tp",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _paged_case(0, 2, 4, 2, 16, 4,
                                                                          5, 2))
    t_da.paged_decode_attention(q, kp, vp, tables, lengths)
    assert not calls
    with t_sh.use_mesh(t_sh.Mesh(1, 2)):
        t_da.paged_decode_attention(q, kp, vp, tables, lengths)
    assert calls == [1]


def test_collectives_are_the_identity_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert t_sh.reduce_model(x) is x and t_sh.gather_model(x, -1) is x
    assert t_sh.current_mesh() is None


def test_meshes_need_a_world_and_the_training_side_raises():
    """Outside a torch.distributed world a mesh of two ranks raises naming
    them, a data axis among them (the training side's meshes); the
    production meshes are virtual: one rank of the reference's 16 x 16
    (2 x 16 x 16) cards with no world, whose collectives on meta tensors
    are counted and move nothing, and which raise on a real tensor; the
    backend rule: gloo where ranks share a card or run on the CPU; the
    mesh's dims and its rank layout (model groups of neighbours)."""
    with pytest.raises(ValueError, match="tp=2 needs 2 ranks/devices"):
        t_mesh.make_host_mesh(model=2)
    with pytest.raises(ValueError, match="needs 2 ranks/devices"):
        t_mesh.make_host_mesh(data=2, model=1)
    for multi_pod, dims, world in ((False, {"data": 16, "model": 16}, 256),
                                   (True, {"pod": 2, "data": 16, "model": 16}, 512)):
        mesh = t_mesh.make_production_mesh(multi_pod=multi_pod, rank=world - 1)
        assert t_mesh.mesh_dims(mesh) == dims and mesh.world_size == world
        assert (mesh.data_rank, mesh.model_rank, mesh.batch_size) == (15, 15, world // 16)
        x = torch.empty(3, 4, device="meta")
        assert mesh.all_reduce(x).shape == x.shape
        assert [p.shape for p in mesh.all_gather(x, "data")] == [x.shape] * 16
        assert mesh.traffic == {"model/all-reduce": [1, 48], "data/all-gather": [1, 768]}
        with pytest.raises(ValueError, match="moves nothing"):
            mesh.all_reduce(torch.zeros(3))
    assert t_mesh.choose_backend(2, "cpu") == "gloo"
    if torch.cuda.device_count() < 8:
        assert t_mesh.choose_backend(8, "cuda") == "gloo"
    assert t_mesh.mesh_dims(t_sh.Mesh(1, 4)) == {"data": 1, "model": 4}
    mesh = t_sh.Mesh(3, 2, data=2)
    assert t_mesh.mesh_dims(mesh) == {"data": 2, "model": 2}
    assert (mesh.data_rank, mesh.model_rank) == (1, 1)


def test_static_engine_serves_at_tp_1_only():
    cfg = _cut_cfg("yi-6b")
    with pytest.raises(ValueError, match="static engine serves at tp=1"):
        build_engine(cfg, ServeOptions(engine="static", tp=2), device="cpu")
