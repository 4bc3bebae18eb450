"""The port's conformance subsystem (``repro_torch.conformance``) against the
reference's, on the CPU, and its ``cuda`` oracle on the card (``cuda`` marker).

Inputs are made with numpy seeds and handed to both packages; the port runs
with ``device="cpu"``, where the ``cuda`` oracle is not registered and every
wrapper takes its plain version.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro import conformance as JC  # noqa: E402
from repro.conformance import fuzz as jfuzz  # noqa: E402
from repro.numerics import PositSpec as JSpec  # noqa: E402
from repro_torch import conformance as TC  # noqa: E402
from repro_torch.conformance import fuzz as tfuzz  # noqa: E402
from repro_torch.conformance import vectors as tvec  # noqa: E402
from repro_torch.conformance.__main__ import main  # noqa: E402
from repro_torch.conformance.shrink import describe_pattern  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.numerics import PositSpec  # noqa: E402

CPU_IMPLS = ["golden", "torch", "torch_logfix", "table", "kernel_plain"]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """Nothing here launches a kernel unless a card is present."""
    _lib.reset_launches()
    yield
    if not torch.cuda.is_available():
        assert all(v == 0 for v in _lib.launches.values()), _lib.launches


def test_default_impls_on_cpu_have_no_cuda_oracle():
    impls = TC.default_impls(PositSpec(16, 1), device="cpu")
    assert sorted(impls) == sorted(CPU_IMPLS)
    assert all(getattr(im, "device", torch.device("cpu")).type == "cpu"
               for im in impls.values())
    with pytest.raises(ValueError, match="CUDA"):
        TC.KernelImpl(use_kernel=True, device="cpu")
    # exact_mul only where its word fits, as in the reference
    assert "exact_mul" not in impls["kernel_plain"].ops(PositSpec(24, 1))


def test_committed_vectors_green_on_cpu():
    assert TC.check_vectors(device="cpu") == []


def test_vector_files_regenerate_byte_identical(tmp_path):
    """The port's gen writes the reference's committed files, byte for byte,
    and only into the directory it is given."""
    assert main(["gen", "--dir", str(tmp_path), "--device", "cpu"]) == 0
    written = sorted(p.name for p in tmp_path.glob("*.json"))
    assert written == sorted(p.name for p in tvec.VECTOR_DIR.glob("*.json"))
    for name in written:
        assert (tmp_path / name).read_bytes() == (tvec.VECTOR_DIR / name).read_bytes(), name
    with pytest.raises(ValueError, match="refusing"):
        tvec.generate_vectors(tvec.VECTOR_DIR, device="cpu")


def test_check_reports_a_drifted_vector(tmp_path):
    doc = json.loads((tvec.VECTOR_DIR / "plam_mul_p8es0_exhaustive.json").read_text())
    doc["sha256"] = "0" * 64
    (tmp_path / "plam_mul_p8es0_exhaustive.json").write_text(json.dumps(doc))
    failures = TC.check_vectors(tmp_path, device="cpu")
    assert any("hash" in f for f in failures)
    assert sum("missing vector file" in f for f in failures) == 14
    assert main(["check", "--dir", str(tmp_path), "--device", "cpu"]) == 1


def test_small_fuzz_is_clean():
    report = TC.run_fuzz(specs=(PositSpec(8, 0),), seed=3, count=128, device="cpu")
    assert report.ok, report.summary()
    assert report.checked > 0
    # kernel_plain runs torch's numerics, so it is not counted as independent
    assert sum(report.checked_by.values()) == report.checked
    assert report.checked_by["kernel_plain"] == report.checked_by["torch"] > 0
    assert report.independent == report.checked - report.checked_by["kernel_plain"]


@pytest.mark.parametrize("n,es", [(6, 0), (8, 1), (16, 1), (16, 2)])
@pytest.mark.parametrize("mode", ["uniform", "boundary", "dnn"])
def test_operand_samplers_match_reference(n, es, mode):
    want_b = jfuzz.boundary_patterns(JSpec(n, es))
    got_b = tfuzz.boundary_patterns(PositSpec(n, es))
    assert np.array_equal(want_b, got_b)
    want = jfuzz.sample_patterns(np.random.default_rng(n + es), JSpec(n, es), 1000, mode)
    got = tfuzz.sample_patterns(np.random.default_rng(n + es), PositSpec(n, es), 1000, mode)
    assert got.dtype == want.dtype and np.array_equal(want, got)
    want_x = jfuzz.sample_floats(np.random.default_rng(n), 300)
    got_x = tfuzz.sample_floats(np.random.default_rng(n), 300)
    assert np.array_equal(want_x.view(np.uint32), got_x.view(np.uint32))


FAULT_PLANS = [
    ("golden", "exact_mul", 0),
    ("torch", "plam_mul", 2),
    ("table", "plam_mul", 0),
    ("kernel_plain", "decode", 7),
    ("kernel_plain", "plam_mul", 0),
    ("kernel_plain", "exact_mul", 3),
    ("kernel_plain", "encode", 1),
]


@pytest.mark.parametrize("layer,op,bit", FAULT_PLANS,
                         ids=[f"{p[0]}.{p[1]}^{p[2]}" for p in FAULT_PLANS])
def test_single_bit_fault_is_caught_and_shrunk(layer, op, bit):
    """One flipped output bit in any layer is caught by the differential
    fuzzer and reduced to a minimal reproducer."""
    spec = PositSpec(8, 0)
    impls = TC.default_impls(spec, device="cpu")
    impls[layer] = TC.FaultyImpl(impls[layer], op, bit=bit)
    report = TC.run_fuzz(specs=(spec,), seed=1, count=256, impls=impls,
                         modes=("uniform",), device="cpu")
    assert not report.ok, f"fault in {layer}.{op} went undetected"
    caught = [m for m in report.mismatches if layer in m.impl_a or layer in m.impl_b]
    assert caught, f"mismatches found but none attributed to {layer}"
    rep = next(m.report for m in caught if m.report)
    assert "CONFORMANCE MISMATCH" in rep
    assert "def test_regression_" in rep and "repro_torch.conformance" in rep


def test_shrinker_and_reports_match_reference():
    assert TC.shrink_pair(lambda a, b: bool(a & 1), 0xB7, 0x5D, 8) == (1, 0)
    for n, es in [(8, 0), (16, 1)]:
        for p in [0, 1, 1 << (n - 1), 1 << (n - 2), 0x5A, (1 << n) - 3]:
            assert describe_pattern(p, PositSpec(n, es)) == \
                JC.shrink.describe_pattern(p, JSpec(n, es))


class _JaxAdapter(TC.Impl):
    """The reference's JaxImpl behind the port's Impl interface: the spec is
    rebuilt as the reference's PositSpec, numpy in and out."""

    def __init__(self, variant):
        self.inner = JC.JaxImpl(variant)
        self.name = "ref_" + self.inner.name

    def ops(self, spec):
        return self.inner.ops(JSpec(spec.n, spec.es))

    def run(self, op, inputs, spec):
        return self.inner.run(op, inputs, JSpec(spec.n, spec.es))


@pytest.mark.parametrize("n,es", [(8, 1), (16, 1)])
def test_cross_package_fuzz_has_no_mismatch(n, es):
    """The reference's JAX numerics as two more oracles in the port's matrix:
    every op agrees bit for bit with the port's impls and golden."""
    spec = PositSpec(n, es)
    impls = TC.default_impls(spec, device="cpu")
    impls["ref_jax"] = _JaxAdapter("field")
    impls["ref_jax_logfix"] = _JaxAdapter("logfix")
    report = TC.run_fuzz(specs=(spec,), seed=5, count=1024, impls=impls, device="cpu")
    assert report.ok, report.summary()
    # every op of every oracle was compared: 7 oracles beside golden
    assert report.checked > 7 * 1024


def test_cli_fuzz_on_cpu():
    assert main(["fuzz", "--specs", "6:0", "--count", "64", "--device", "cpu"]) == 0
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.conformance", "fuzz", "--specs", "6:0",
         "--count", "32", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "0 mismatches, 0 property failures" in out.stdout


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the conformance phase there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_oracle_passes_vectors_and_fuzz(cuda_device):
    impls = TC.default_impls(PositSpec(16, 1))
    assert "cuda" in impls
    assert TC.check_vectors() == []
    report = TC.run_fuzz(specs=(PositSpec(8, 1), PositSpec(16, 1)), seed=2, count=512)
    assert report.ok, report.summary()
    assert _lib.launches["posit_mul"] > 0 and _lib.launches["posit_codec"] > 0
