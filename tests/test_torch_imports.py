"""The port stands alone: no JAX and nothing of the JAX package, and its
entry points run on CUDA unless the caller asks for the CPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_port_imports_without_jax_in_a_fresh_interpreter():
    """Importing every port module pulls in no JAX module."""
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")


def test_entry_points_default_to_cuda_and_raise_without_it(no_card, capsys):
    from repro_torch.conformance import check_vectors, default_impls, run_fuzz
    from repro_torch.conformance.__main__ import main as conformance_main
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import lm_init
    from repro_torch.numerics import P16
    from repro_torch.serving import ServeOptions, build_engine

    cfg = get_config("yi-6b").reduced()
    for call in (
        lambda: resolve_device(),
        lambda: lm_init(cfg),
        lambda: build_engine(cfg, ServeOptions()),
        lambda: params_from_jax({}, cfg),
        lambda: default_impls(P16),
        lambda: check_vectors(),
        lambda: run_fuzz(count=8),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    # the CLI exits non-zero instead of carrying on on the CPU
    for argv in (["check"], ["fuzz", "--count", "8"]):
        assert conformance_main(argv) == 2
        assert "device='cpu'" in capsys.readouterr().err


def test_conformance_gen_needs_a_directory():
    """gen never falls back to the reference's committed vector directory."""
    from repro_torch.conformance.__main__ import main as conformance_main

    with pytest.raises(SystemExit) as exc:
        conformance_main(["gen", "--device", "cpu"])
    assert exc.value.code != 0


def test_chip_smoke_fails_without_a_card(no_card):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
