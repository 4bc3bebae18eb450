"""The port's roofline (``launch/roofline.py``) against the reference's
counts and a hand count with the H100 constants.

``count_params`` (counted on the meta device) equals the reference's for
the ten archs (total, active, encoder, decoder); ``model_flops`` and
``model_bytes`` equal the reference's at all 32 applicable cells;
``roofline_row`` of a written record and ``load_and_report`` follow the
H100 constants by hand.
"""
import json

import pytest

from repro import configs as ref_configs
from repro.launch import roofline as ref_roofline
from repro_torch import configs
from repro_torch.launch import roofline

from test_torch_ssm import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = sorted(ref_configs.ARCHS)


@pytest.fixture(scope="module")
def params():
    """arch -> (the port's count, the reference's count)."""
    return {a: (roofline.count_params(configs.get_config(a)),
                ref_roofline.count_params(ref_configs.get_config(a))) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_the_reference(arch, params):
    ours, ref = params[arch]
    assert ours == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_bytes_equal_the_reference(arch, params):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    ours, ref = params[arch]
    shapes = configs.applicable_shapes(cfg)
    assert [s.name for s in shapes] == [s.name for s in ref_configs.applicable_shapes(ref_cfg)]
    for shape in shapes:
        ref_shape = ref_configs.shape_by_name(shape.name)
        assert roofline.model_flops(cfg, shape, ours) == \
            ref_roofline.model_flops(ref_cfg, ref_shape, ref), shape.name
        assert roofline.model_bytes(cfg, shape, ours) == \
            ref_roofline.model_bytes(ref_cfg, ref_shape, ref), shape.name


def test_h100_constants():
    assert roofline.PEAK_INT32 == pytest.approx(16.73e12, rel=1e-3)
    assert roofline.PEAK_ELEM == 2 * roofline.PEAK_INT32
    assert (roofline.PEAK_BF16, roofline.PEAK_TF32, roofline.PEAK_F32) == (989e12, 495e12, 67e12)
    assert (roofline.HBM_BW, roofline.HBM_BYTES, roofline.LINK_BW) == (3.35e12, 80e9, 450e9)


def _record(arch, shape, **kw):
    rec = {"arch": arch, "shape": shape, "mesh": "1", "devices": 1, "numerics": "x",
           "flops": 3e12, "flops_by_class": {"f32": 1e12, "bf16": 2e12}, "int_ops": 5e12,
           "elem_ops": 4e12, "bytes_accessed": 9e11,
           "collectives": {"collective_bytes": {}, "collective_total": 0.0},
           "memory": {"peak_bytes": 7e10, "fits": True}, "tag": ""}
    rec.update(kw)
    return rec


def test_roofline_row_by_hand(params):
    cfg = configs.get_config("yi-6b").with_numerics("default=plam_sim:16:1")
    shape = configs.shape_by_name("decode_32k")
    row = roofline.roofline_row(_record("yi-6b", "decode_32k"), cfg, shape)
    compute = 1e12 / 67e12 + 2e12 / 989e12 + 5e12 / roofline.PEAK_INT32 + 4e12 / roofline.PEAK_ELEM
    assert row["t_compute_s"] == pytest.approx(compute, rel=1e-12)
    assert row["t_memory_s"] == pytest.approx(9e11 / 3.35e12, rel=1e-12)
    assert row["t_collective_s"] == 0.0
    assert row["dominant"] == "compute" and row["t_bound_s"] == row["t_compute_s"]
    n = params["yi-6b"][0]
    mf = 2.0 * n["active"] * 128 + 2 * 2 * 32 * 32768 * (4 * 128) * 128
    mb = n["active"] * 2 + 32 * 128 * 32768 * 4 * 128 * 2 * 2
    assert row["model_flops_global"] == mf
    # plam_sim: one integer add a product, or the ideal bytes
    t_ideal = max(mf / 2 / roofline.PEAK_INT32, mb / 3.35e12)
    assert row["t_ideal_s"] == pytest.approx(t_ideal, rel=1e-12)
    assert row["roofline_fraction"] == pytest.approx(t_ideal / compute, rel=1e-12)
    # an f32 carrier multiplies on the CUDA cores, bf16 on the tensor cores
    assert roofline.ideal_seconds("posit_quant", 67e12, 0.0) == pytest.approx(1.0)
    assert roofline.ideal_seconds("bf16", 989e12, 0.0) == pytest.approx(1.0)
    assert roofline.ideal_seconds("plam_sim", 0.0, 3.35e12) == pytest.approx(1.0)
    # a collective's bytes take the reference's ring factor over NVLink
    coll = {"collective_bytes": {"all-reduce": 450e9}, "collective_total": 450e9}
    row = roofline.roofline_row(_record("yi-6b", "decode_32k", collectives=coll), cfg, shape)
    assert row["t_collective_s"] == pytest.approx(2.0)


def test_load_and_report(tmp_path):
    d = tmp_path / "dryrun"
    d.mkdir()
    policy = "default=plam_sim:16:1"
    for name, rec in {"yi-6b__decode_32k__1": _record("yi-6b", "decode_32k",
                                                       numerics_policy=policy),
                      "yi-6b__long_500k__1": {"arch": "yi-6b", "shape": "long_500k",
                                              "mesh": "1", "skipped": "quadratic"},
                      "yi-6b__train_4k__1__tagged": _record("yi-6b", "train_4k", tag="t")}.items():
        (d / f"{name}.json").write_text(json.dumps(rec))
    rows, md = roofline.load_and_report(str(d), str(tmp_path / "r.md"), mesh_filter="1")
    assert [(r["arch"], r["shape"], r["mode"]) for r in rows] == [("yi-6b", "decode_32k",
                                                                   "plam_sim")]
    assert (tmp_path / "r.md").read_text().strip() == md
    assert md.count("\n") == 2 and "**compute**" in md
