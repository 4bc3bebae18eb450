"""The port's dry run (``launch/dryrun.py``) on the meta device.

The reference's ``test_dryrun_reduced`` cells (reduced yi-6b,
granite-moe-1b-a400m and mamba2-780m training at (64, 4), and yi-6b's
decode) run on a mesh of one card, and their kernel launches are
``chip_smoke.py``'s hand counts (``family_quantize_count``,
``launch_counts``); no plain version of a kernel runs on a meta tensor;
a reduced f32 yi-6b prefill's matmul FLOPs are the reference's
``analyze`` of its jitted prefill; a full-width yi-6b decode dry run
finishes without the process growing by the model's bytes; the CLI
writes the reference's record fields and the op trace, which the
roofline re-aggregates to the same totals.
"""
import gzip
import importlib
import importlib.util
import json
import os
import resource

import jax
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.launch.hlo_analysis import analyze
from repro.models import build as ref_build
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.kernels import _lib, plam_matmul, posit_codec
from repro_torch.launch import dryrun, roofline

from test_torch_ssm import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PLAM = "default=plam_sim:16:1"
REF_FIELDS = ("arch", "shape", "kind", "mesh", "devices", "flops", "elem_ops",
              "bytes_accessed", "collectives", "memory", "numerics", "tag")


@pytest.fixture(autouse=True)
def launches_restored():
    """The meta launches a test here counts are taken back after it: the
    port's other tests, which may share this process, hold the counters
    at 0 on the CPU."""
    before = dict(_lib.launches)
    yield
    _lib.launches.update(before)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


@pytest.fixture
def no_plain_on_meta(monkeypatch):
    """Every plain version of a kernel raises if it is handed a meta
    tensor: the dry run must take the kernels' path."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")

    def guard(mod, name):
        real = getattr(mod, name)

        def call(*args, **kw):
            assert not any(getattr(a, "is_meta", False) for a in args), \
                f"{name} ran on a meta tensor"
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, call)

    guard(plam_matmul, "plam_matmul_seqref")
    for name in ("encode_plain", "decode_plain", "quantize_plain", "exact_mul", "plam_mul"):
        guard(posit_codec, name)
    guard(da, "paged_decode_attention_ref")
    guard(da, "decode_attention_ref")


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m", "mamba2-780m"])
def test_reduced_train_cells(arch, smoke, no_plain_on_meta):
    """The reference's CI cells on one card: the config's own numerics
    (posit_quant:16:1), K3's quantize a step as the hand count, FLOPs and
    no collectives."""
    cfg = get_config(arch).reduced()
    rec, ana = dryrun.analyze_cell(cfg, ShapeSpec("ci", 64, 4, "train"))
    _, want = smoke.Smoke.family_quantize_count(cfg, 64)
    assert rec["launches"] == {"posit_codec": want}
    assert ana.kernels["posit_codec"]["launches"] == want
    assert rec["flops"] > 0 and rec["int_ops"] > 0
    assert rec["collectives"]["collective_total"] == 0.0
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
    assert mem["temp_bytes"] > 0 and mem["fits"]


@pytest.mark.parametrize("numerics", ["config", PLAM])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_reduced_serve_cells(numerics, kind, smoke, no_plain_on_meta):
    """yi-6b's decode (the reference's CI cell) and prefill: under
    plam_sim with prequantized weights 7L+1 K1 and no K3
    (``launch_counts``); under the config's posit_quant, K3's quantize of
    both operands of every projection (``family_quantize_count``'s
    forward at the step's positions)."""
    cfg = get_config("yi-6b").reduced()
    if numerics != "config":
        cfg = cfg.with_numerics(numerics)
    rec, _ = dryrun.analyze_cell(cfg, ShapeSpec("ci", 64, 4, kind),
                                 prequantize=numerics != "config")
    if numerics == "config":
        fwd, _ = smoke.Smoke.family_quantize_count(cfg, 1 if kind == "decode" else 64)
        assert rec["launches"] == {"posit_codec": fwd}
    else:
        assert rec["launches"] == {"plam_matmul": smoke.launch_counts(cfg)["k1"]}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m", "zamba2-1.2b",
                                  "seamless-m4t-medium", "qwen2-vl-72b"])
def test_reduced_decode_launches_by_family(arch, smoke, no_plain_on_meta):
    cfg = get_config(arch).reduced().with_numerics(PLAM)
    rec, _ = dryrun.analyze_cell(cfg, ShapeSpec("ci", 64, 4, "decode"), prequantize=True)
    lc = smoke.launch_counts(cfg)
    want = {"plam_matmul": lc["k1"]}
    if cfg.n_experts:  # the experts' three stacks a layer, one launch each
        want["plam_matmul_grouped"] = 3 * cfg.n_layers
    assert rec["launches"] == want


def test_f32_prefill_flops_equal_the_reference():
    """Every matmul of the jitted reference prefill is a dot XLA keeps:
    the projections, the attention's two einsums and the head's last
    position; the port's are the same."""
    ref_cfg = ref_get_config("yi-6b").reduced().with_numerics("default=f32")
    api = ref_build(ref_cfg)
    params = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))
    batch = api.prefill_inputs(RefShapeSpec("ci", 64, 4, "prefill"))
    want = analyze(jax.jit(api.prefill).lower(params, batch).compile().as_text()).flops
    cfg = get_config("yi-6b").reduced().with_numerics("default=f32")
    rec, _ = dryrun.analyze_cell(cfg, ShapeSpec("ci", 64, 4, "prefill"))
    assert rec["flops"] == want
    # attention over the bf16 cache (Q.K^T and P.V, 2 x 4 x 4 heads x 64 x
    # 64 x 32 multiply-adds each a layer) runs in bf16, the projections in f32
    attn = 2 * 2 * 4 * 4 * 64 * 64 * 32 * cfg.n_layers
    assert rec["flops_by_class"] == {"f32": want - attn, "bf16": attn}
    assert rec["launches"] == {}


def test_full_width_decode_allocates_no_model(no_plain_on_meta):
    """yi-6b at full width and depth (6.06 G parameters, 12 GB in bf16):
    the process does not grow by a fraction of that."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec, _ = dryrun.analyze_cell(get_config("yi-6b").with_numerics(PLAM),
                                 ShapeSpec("chip_decode", 64, 4, "decode"), prequantize=True)
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) * 1024
    assert grown < 1 << 30
    assert rec["launches"] == {"plam_matmul": 7 * 32 + 1}
    assert rec["memory"]["argument_bytes"] > 12e9  # int16 weights, bf16 embedding, caches


def test_cli_records_and_reanalysis(tmp_path):
    out = tmp_path / "dryrun"
    dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k", "--numerics", "plam_sim",
                 "--prequantized", "--out-dir", str(out)])
    dryrun.main(["--arch", "yi-6b", "--shape", "long_500k", "--out-dir", str(out)])
    rec = json.loads((out / "mamba2-780m__long_500k__1.json").read_text())
    for field in REF_FIELDS:
        assert field in rec, field
    assert rec["mesh"] == "1" and rec["devices"] == 1 and rec["kind"] == "decode"
    assert rec["launches"] == {"plam_matmul": 2 * 48 + 1}
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes", "temp_bytes",
                                  "peak_bytes", "device_bytes", "fits"}
    assert rec["memory"]["device_bytes"] == roofline.HBM_BYTES
    assert rec["int_ops"] > 0 and "flops_by_class" in rec and rec["trace_s"] >= 0
    skip = json.loads((out / "yi-6b__long_500k__1.json").read_text())
    assert "skipped" in skip
    with gzip.open(out / "mamba2-780m__long_500k__1.ops.jsonl.gz", "rt") as f:
        assert sum(1 for _ in f) > 0
    before = {k: rec[k] for k in ("flops", "elem_ops", "bytes_accessed", "int_ops")}
    roofline.reanalyze(str(out))
    again = json.loads((out / "mamba2-780m__long_500k__1.json").read_text())
    assert {k: again[k] for k in before} == pytest.approx(before, rel=1e-12)
    rows, _ = roofline.load_and_report(str(out), str(tmp_path / "r.md"))
    assert [r["arch"] for r in rows] == ["mamba2-780m"] and rows[0]["mode"] == "plam_sim"
    dryrun.main(["--arch", "seamless-m4t-medium", "--shape", "train_4k", "--multi-pod",
                 "--out-dir", str(out)])
    rec = json.loads((out / "seamless-m4t-medium__train_4k__2x16x16.json").read_text())
    assert rec["devices"] == 512 and "skipped" not in rec
    assert set(rec["collectives"]["by_axis"]) == {"model", "data", "batch"}
