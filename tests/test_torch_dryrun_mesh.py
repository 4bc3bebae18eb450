"""The sharded dry run's accounting (``launch/dryrun.py`` on a
``launch/mesh.py::VirtualMesh``), against the JAX package's rules and
without a world.

For the ten configs at full size, each on the (2 x 4)
test mesh, the reference's 16 x 16 production mesh and its 2 x 16 x 16
two-pod mesh, the first and the last rank's shard (``init(mesh=...)`` on
the meta device) holds the per-device parameter bytes of the reference's
``spec_for_param``/``sanitize``, and its ZeRO-1 AdamW state the m + v
bytes of the reference's ``_zero1_dims``; where kv < tp a rank keeps the
whole kv heads its q heads read (``kv_heads_for_rank``), and wk/wv hold
that many times more.  A reduced cell's record carries the mesh's fields,
its collectives by axis with the link each crosses, and the roofline
prices them there.
"""
import functools

import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro.parallel import sharding as j_sh  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_virtual_mesh, parse_mesh  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, Zero1, init_state, zero1_numel  # noqa: E402
from repro_torch.parallel import sharding as t_sh  # noqa: E402

from test_torch_ssm import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

LM_ARCHS = ("minitron-8b", "yi-6b", "command-r-plus-104b", "gemma-7b", "mamba2-780m",
            "granite-moe-1b-a400m", "deepseek-moe-16b", "zamba2-1.2b", "seamless-m4t-medium",
            "qwen2-vl-72b")
MESHES = ("2x4", "16x16", "2x16x16")


class _StandIn:
    """The reference's mesh as its rules read it: axis names and sizes."""

    def __init__(self, spec):
        dims = parse_mesh(spec)
        if dims["pod"] == 1:
            dims.pop("pod")
        self.axis_names, self.shape = tuple(dims), dims


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    tree = jax.eval_shape(lambda: j_build(j_get_config(arch)).init(jax.random.PRNGKey(0)))
    return [(j_sh._path_str(path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _kv_excess(cfg, path, tp):
    """The port's kept wk/wv columns over the reference's per-device ones
    (whole kv heads where kv < tp), 1 elsewhere."""
    if not path.endswith(("attn/wk", "attn/wv")):
        return 1
    hd = t_sh.head_dim_of(cfg, path)
    held = len(t_sh.kv_heads_for_rank(cfg.n_heads, cfg.n_kv, tp, 0)) * hd
    whole = cfg.n_kv * hd
    return held / (whole / tp if whole % tp == 0 else whole)


def _ref_per_device(arch, spec):
    """(parameter bytes, m + v bytes) a device holds by the reference's rules
    (the port's kv-head excess folded in)."""
    cfg, mesh = get_config(arch), _StandIn(spec)
    tp = mesh.shape["model"]
    params = state = 0.0
    for path, leaf in _ref_leaves(arch):
        dims = j_sh.sanitize(mesh, j_sh.spec_for_param(path, leaf.ndim), leaf.shape)
        n = 1
        for size, d in zip(leaf.shape, dims):
            n *= size // (tp if d == "model" else 1)
        excess = _kv_excess(cfg, path, tp)
        params += n * leaf.dtype.itemsize * excess
        state += 8 * zero1_numel(leaf.shape, j_opt._zero1_dims(path, leaf, mesh), mesh) * excess
    return params, state


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_rank_bytes_are_the_reference_rules(arch, spec):
    """The first and the last rank's parameter bytes and ZeRO-1 m + v
    bytes, on meta, against the reference's per-device count; the dry
    run's own count of the rules (``param_bytes_rules``) is the
    reference's where no kv head is kept whole."""
    cfg = get_config(arch)
    want_params, want_state = _ref_per_device(arch, spec)
    world = make_virtual_mesh(spec).world_size
    for rank in (0, world - 1):
        mesh = make_virtual_mesh(spec, rank)
        model = build(cfg).init(device="meta", mesh=mesh)
        held = sum(p.numel() * p.element_size() for p in model.parameters())
        assert held == want_params, (rank, held, want_params)
        zero = Zero1(t_sh.leaf_layouts(cfg, mesh), mesh)
        state = init_state(OptConfig(), model, zero)
        assert zero.state_bytes(state) == want_state, rank
    if cfg.family in ("ssm", "hybrid") or cfg.n_kv % mesh.model_size == 0:
        assert dryrun.param_bytes_rules(cfg, mesh) == want_params
        assert dryrun.state_bytes_rules(cfg, mesh) == want_state


def test_reduced_cell_records_the_mesh():
    """A reduced zamba2 training cell on the (2 x 4) mesh: the record's
    mesh fields, its argument bytes split into the rules' counts, its
    collectives by axis with each axis' link (inside one node of eight
    cards: NVLink), the roofline's collective term priced there, and the
    one-card step's K3 launches; on 16 x 16 both axes cross InfiniBand;
    an encdec cell is analysed too, its collectives by axis."""
    cfg = get_config("zamba2-1.2b").reduced()
    shape = ShapeSpec("ci", 64, 8, "train")
    rec, _ = dryrun.analyze_mesh_cell(cfg, shape, "2x4")
    assert (rec["mesh"], rec["devices"]) == ("2x4", 8)
    assert rec["rank"] == {"rank": 0, "data": 0, "model": 0, "batch_rows": 4,
                           "seq_parallel": False}
    assert rec["ranks"]["analysed"] == [0]
    mem = rec["memory"]
    assert mem["param_bytes"] == mem["param_bytes_rules"] > 0
    assert mem["opt_state_bytes"] == mem["opt_state_bytes_rules"] > 0
    by_axis = rec["collectives"]["by_axis"]
    assert {a: (v["group"], v["link"]) for a, v in by_axis.items()} == {
        "model": (4, "nvlink"), "data": (2, "nvlink")}
    assert all(v["bytes"]["all-reduce"] > 0 for v in by_axis.values())
    t = roofline.terms(rec)
    want = sum(sum(roofline._COLL_FACTOR[k] * b for k, b in v["bytes"].items())
               for v in by_axis.values()) / roofline.LINK_BW
    assert t["collective"] == pytest.approx(want, rel=1e-12)
    one, _ = dryrun.analyze_cell(cfg, shape)
    assert rec["launches"] == one["launches"] and one["launches"]["posit_codec"] > 0
    assert roofline.axis_link(parse_mesh("16x16"), "model") == "ib"
    assert roofline.axis_link(parse_mesh("16x16"), "data") == "ib"
    enc, _ = dryrun.analyze_mesh_cell(get_config("seamless-m4t-medium").reduced(), shape, "2x4")
    assert enc["devices"] == 8 and "skipped" not in enc
    assert {a: v["group"] for a, v in enc["collectives"]["by_axis"].items()} == {
        "model": 4, "data": 2}


def test_encdec_decode_at_global_batch_one_over_data_raises():
    """The reference cuts an encdec decode's enc_out by position over
    ``data`` at a global batch of 1; the port does not (no applicable cell
    decodes one) and says so rather than running another layout."""
    cfg = get_config("seamless-m4t-medium").reduced()
    with pytest.raises(NotImplementedError, match="enc_out"):
        dryrun.analyze_mesh_cell(cfg, ShapeSpec("ci", 64, 1, "decode"), "2x4")
