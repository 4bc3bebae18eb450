"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ for Hopper (``sm_90a``) under ``csrc/`` with a
plain C interface.  On first use, :func:`library` compiles every ``.cu``
file with ``nvcc`` (all started together, one process per source),
links them into one shared library under ``build/repro_torch/`` at the
repository root, and binds it with ``ctypes``.  The library's name
carries a hash of the sources and flags, so an edited source rebuilds.
Nothing is built or imported when this module is imported.

Every wrapper adds one to its kernel's entry in :data:`launches` where
it launches the kernel, and nowhere else, so a run can show that the
main path went through the kernels.

The meta device takes the kernels' path too (:func:`wants_kernel`): a
launch on meta tensors (:func:`launch`) loads no library, calls no
``nvcc`` and runs nothing, but returns the kernel's output (an empty
meta tensor of its shape and dtype, which the wrapper allocated), counts
the launch in :data:`launches` as the card would, and hands its work
(:class:`Work`) to every analysis listening (``launch/op_analysis.py``).
A model run on meta is so the dry run of the step the card would run
(``launch/dryrun.py``).  CPU tensors still take the plain versions.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# No --use_fast_math and no FTZ: the codec must see subnormal inputs as
# they are (they encode to +-minpos), and sums keep IEEE semantics.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

#: launches per kernel since the last reset_launches()
launches: Dict[str, int] = {
    "plam_matmul": 0,
    "plam_matmul_grouped": 0,  # the K1 launches above that run over an expert axis
    "paged_decode_attention": 0,
    "posit_codec": 0,
    "posit_codec_table": 0,  # K3's bf16 encode tables, built once per (spec, device)
    "posit_codec_quant_table": 0,  # K3's bf16 quantize tables, likewise
    "posit_mul": 0,
    "decode_attention": 0,
}

#: seconds the last build in this process took (0.0 when it was cached)
build_seconds = 0.0


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def wants_kernel(t: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """Kernel or plain version for tensor ``t``.

    ``None`` decides by device: the kernel for a CUDA or a meta tensor
    (whose launch runs nothing: :func:`launch`), the plain version for a
    CPU tensor.  ``False`` asks for the plain version on any device (tests
    and the chip smoke use it as the reference); ``True`` insists on the
    kernel and raises for a CPU tensor.
    """
    if use_kernel is None:
        return t.is_cuda or t.is_meta
    if use_kernel and not (t.is_cuda or t.is_meta):
        raise ValueError("the CUDA kernels need CUDA tensors")
    return bool(use_kernel)


@dataclasses.dataclass(frozen=True)
class Work:
    """One launch's work, as PERF.md's bounds count it: integer lane
    operations (K1: one add a product; K3: one a lane; K4: its ALU
    operations a lane), f32 FLOPs (K2, K5: two a multiply-add), and the
    bytes it must move (each operand read once, the output written once),
    with the operands' shapes and dtypes."""

    int_ops: float
    flops: float
    bytes: float
    shapes: tuple
    dtypes: tuple


#: the analyses that hear of every launch: callables (name, Work)
listeners: List[Callable[[str, Work], None]] = []


def launch(name: str, out: torch.Tensor, call: Callable[[], int], *,
           inputs: Sequence[torch.Tensor] = (), int_ops: float = 0.0,
           flops: float = 0.0, moved: Optional[float] = None) -> torch.Tensor:
    """Launch kernel ``name``: ``call()`` hands the pointers to the library
    (and returns its error code) on CUDA tensors; on meta tensors nothing
    is called.  Either way the launch counts under ``name`` and its work
    goes to :data:`listeners`.  ``moved`` overrides the bytes of
    ``inputs`` and ``out`` (K2 reads only the blocks its table names).
    Returns ``out``."""
    tensors = (*inputs, out)
    on_meta = {t.is_meta for t in tensors}
    if len(on_meta) > 1:
        raise ValueError(f"{name}: meta and CUDA tensors in one launch")
    if True in on_meta:
        launches[name] += 1
    else:
        check_launch(name, call())
    if listeners:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        work = Work(float(int_ops), float(flops), float(nbytes if moved is None else moved),
                    tuple(tuple(t.shape) for t in tensors),
                    tuple(str(t.dtype).replace("torch.", "") for t in tensors))
        for listen in listeners:
            listen(name, work)
    return out


@functools.lru_cache(maxsize=None)
def source_constant(source: str, name: str) -> int:
    """``constexpr int <name> = <N>;`` of ``csrc/<source>``: the hand
    counts of a kernel's operations live beside its code."""
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text)
    if m is None:
        raise KeyError(f"{name} not found in {source}")
    return int(m.group(1))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile and link the kernels (a no-op when the library exists)."""
    global build_seconds
    so = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if so.exists():
        build_seconds = 0.0
        return so
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = pathlib.Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    build_seconds = time.perf_counter() - t0
    return so


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "plam_matmul_launch": [_P, _P, _I, _P, _I, _I, _I, _I, _L, _L, _L, _I, _I, _P],
    "plam_dense_launch": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _L, _L, _L, _I, _I, _P],
    "plam_matmul_prefill_width": [_I, _I, _I, _I, _I],
    "posit_encode_launch": [_P, _I, _P, _I, ctypes.c_int64, _I, _I, _P, _P],
    "posit_decode_launch": [_P, _I, _P, ctypes.c_int64, _I, _I, _P],
    "posit_quantize_launch": [_P, _I, _P, ctypes.c_int64, _I, _I, _P, _P],
    "paged_decode_attention_launch": [
        _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, _P],
    "posit_mul_launch": [_P, _P, _P, ctypes.c_int64, _I, _I, _I, _P],
    "decode_attention_launch": [
        _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, bound with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


#: dtype codes of the C interface
DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.int32: 2,
    torch.int16: 3,
}


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise when a launch was refused (the C side returns cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    launches[name] += 1


def require(t: torch.Tensor, name: str, dtypes, ndim: Optional[int] = None) -> None:
    """Checks every wrapper makes before handing a pointer to a kernel.
    A meta tensor passes as a CUDA one would: :func:`launch` hands no
    pointer of it to the library."""
    if not (t.is_cuda or t.is_meta):
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; expected one of {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
