"""Golden conformance vectors (port of ``repro/conformance/vectors.py``).

The reference package commits the vector files under ``tests/vectors/``;
the port reads them as data (:data:`VECTOR_DIR`) and never writes there:
:func:`generate_vectors` writes only to a directory its caller names.

A vector file pins the full input/output relation of one op on one
spec so that a refactor of *any* single layer (golden, torch, table,
kernels) diffs against an artifact none of the layers can silently
move:

* ``kind="exhaustive"`` — ALL bit pairs (multipliers) or ALL patterns
  (decode) for n <= 10: the result array is hashed (sha256 over
  little-endian uint16 patterns / uint32 f32 bits), plus a handful of
  explicit sample triples for human debugging and for spot-checking
  the slow pure-Python golden model.
* ``kind="sampled"`` — a seeded pattern sample for n = 16 where
  all-pairs is out of reach; same hash + samples format.

``generate_vectors`` cross-checks the whole oracle matrix (vectorized
impls on the full set, golden on the samples) and refuses to write
vectors the implementations disagree on; its files are byte-identical to
the reference's for the same seed.  ``check_vectors`` recomputes
every vectorized impl's full-array hash against the committed file and
re-runs golden on the stored samples — drift in any layer fails PRs.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
from typing import Dict, List, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.numerics import PositSpec

from .oracles import Impl, default_impls, outputs_equal

#: the reference's committed vector files, read only
VECTOR_DIR = pathlib.Path(__file__).resolve().parents[3] / "tests" / "vectors"

EXHAUSTIVE_SPECS = ((6, 0), (8, 0), (8, 1), (10, 1))
SAMPLED_SPECS = ((16, 1),)
SAMPLED_COUNT = 4096
VECTOR_MUL_OPS = ("plam_mul", "exact_mul")
N_SAMPLES = 32
FORMAT_VERSION = 1


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _hash_patterns(out: np.ndarray) -> str:
    return _sha((np.asarray(out, np.int64) & 0xFFFF).astype("<u2"))


def _hash_floats(out: np.ndarray) -> str:
    return _sha(np.asarray(out, np.float32).view(np.uint32).astype("<u4"))


def pair_grid(n: int):
    """All (pa, pb) bit pairs for an n-bit posit, flattened."""
    pats = np.arange(1 << n, dtype=np.int32)
    pa = np.repeat(pats, 1 << n)
    pb = np.tile(pats, 1 << n)
    return pa, pb


def sampled_pairs(n: int, seed: int, count: int):
    rng = np.random.default_rng(np.random.SeedSequence([seed, n, 0xC0]))
    pa = rng.integers(0, 1 << n, count).astype(np.int32)
    pb = rng.integers(0, 1 << n, count).astype(np.int32)
    return pa, pb


def _vector_inputs(op: str, spec: PositSpec, kind: str, seed: int):
    if op in VECTOR_MUL_OPS:
        if kind == "exhaustive":
            return pair_grid(spec.n)
        return sampled_pairs(spec.n, seed, SAMPLED_COUNT)
    assert op == "decode", op
    if kind == "exhaustive":
        return (np.arange(1 << spec.n, dtype=np.int32),)
    rng = np.random.default_rng(np.random.SeedSequence([seed, spec.n, 0xDE]))
    return (rng.integers(0, 1 << spec.n, SAMPLED_COUNT).astype(np.int32),)


def _file_name(op: str, n: int, es: int, kind: str) -> str:
    return f"{op}_p{n}es{es}_{kind}.json"


def plan() -> List[dict]:
    """Every vector file this repo commits: op x spec x kind."""
    out = []
    for n, es in EXHAUSTIVE_SPECS:
        for op in VECTOR_MUL_OPS + ("decode",):
            out.append(dict(op=op, n=n, es=es, kind="exhaustive"))
    for n, es in SAMPLED_SPECS:
        for op in VECTOR_MUL_OPS + ("decode",):
            out.append(dict(op=op, n=n, es=es, kind="sampled"))
    return out


def _compute(impl: Impl, op: str, inputs, spec: PositSpec) -> np.ndarray:
    return np.asarray(impl.run(op, inputs, spec))


def _sample_indices(total: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, total]))
    k = min(N_SAMPLES, total)
    return np.sort(rng.choice(total, size=k, replace=False))


def generate_vectors(
    directory: pathlib.Path,
    seed: int = 0,
    impls: Optional[Dict[str, Impl]] = None,
    log=lambda s: None,
    device: DeviceLike = None,
) -> List[pathlib.Path]:
    """Generate every vector file into ``directory``, cross-checking the
    oracle matrix.

    ``directory`` is required and may not be :data:`VECTOR_DIR`: the
    reference's committed files are never rewritten from here.  The
    canonical result array comes from the torch impl; before writing,
    every other vectorized impl must match it exactly on the full set and
    the golden model must match on the stored samples — generation
    aborts on any disagreement, so a vector file is already an N-way
    agreement certificate.
    """
    directory = pathlib.Path(directory)
    if directory.resolve() == VECTOR_DIR.resolve():
        raise ValueError(f"refusing to write the reference's vectors in {VECTOR_DIR}")
    device = resolve_device(device)
    directory.mkdir(parents=True, exist_ok=True)
    written = []
    for item in plan():
        op, n, es, kind = item["op"], item["n"], item["es"], item["kind"]
        spec = PositSpec(n, es)
        allimpls = impls if impls is not None else default_impls(spec, device)
        inputs = _vector_inputs(op, spec, kind, seed)
        log(f"gen {op} Posit<{n},{es}> {kind} ({len(inputs[0])} lanes)")
        ref = _compute(allimpls["torch"], op, inputs, spec)
        for name, im in allimpls.items():
            if name in ("torch", "golden") or op not in im.ops(spec):
                continue
            out = _compute(im, op, inputs, spec)
            bad = ~outputs_equal(ref, out)
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                raise AssertionError(
                    f"refusing to write {op} Posit<{n},{es}>: torch vs {name} "
                    f"disagree at lane {i} "
                    f"(inputs {[int(np.ravel(x)[i]) for x in inputs]})"
                )
        idx = _sample_indices(len(ref), seed)
        gold_in = tuple(np.ravel(x)[idx] for x in inputs)
        gold_out = _compute(allimpls["golden"], op, gold_in, spec)
        if (~outputs_equal(ref[idx], gold_out)).any():
            raise AssertionError(
                f"refusing to write {op} Posit<{n},{es}>: golden disagrees "
                f"on sampled lanes"
            )
        if op == "decode":
            digest = _hash_floats(ref)
            samples = [
                [int(gold_in[0][j]),
                 int(np.float32(gold_out[j]).view(np.uint32))]
                for j in range(len(idx))
            ]
        else:
            digest = _hash_patterns(ref)
            samples = [
                [int(gold_in[0][j]), int(gold_in[1][j]), int(gold_out[j])]
                for j in range(len(idx))
            ]
        doc = dict(
            version=FORMAT_VERSION,
            op=op,
            spec=[n, es],
            kind=kind,
            seed=seed,
            count=int(len(ref)),
            sha256=digest,
            samples=samples,
        )
        path = directory / _file_name(op, n, es, kind)
        path.write_text(json.dumps(doc, indent=1) + "\n")
        written.append(path)
    return written


def check_vectors(
    directory: Optional[pathlib.Path] = None,
    impls: Optional[Dict[str, Impl]] = None,
    log=lambda s: None,
    device: DeviceLike = None,
) -> List[str]:
    """Verify every vector file (default: the reference's committed ones);
    returns failure strings.

    Vectorized impls recompute the full result array and must hash to
    the committed digest; the pure-Python golden model re-evaluates the
    stored sample triples (full golden evaluation is the job of the
    exhaustive sweep tests, not this fast gate).  ``device`` holds the
    default oracle matrix (CUDA unless named).
    """
    directory = pathlib.Path(directory or VECTOR_DIR)
    device = resolve_device(device)
    failures: List[str] = []
    files = sorted(directory.glob("*.json"))
    if not files:
        return [f"no vector files under {directory}"]
    names = {_file_name(i["op"], i["n"], i["es"], i["kind"]) for i in plan()}
    missing = names - {f.name for f in files}
    failures.extend(f"missing vector file {m}" for m in sorted(missing))
    for path in files:
        doc = json.loads(path.read_text())
        op = doc["op"]
        n, es = doc["spec"]
        spec = PositSpec(n, es)
        allimpls = impls if impls is not None else default_impls(spec, device)
        inputs = _vector_inputs(op, spec, doc["kind"], doc["seed"])
        if len(inputs[0]) != doc["count"]:
            failures.append(f"{path.name}: input-set size drifted")
            continue
        hasher = _hash_floats if op == "decode" else _hash_patterns
        for name, im in allimpls.items():
            if name == "golden" or op not in im.ops(spec):
                continue
            log(f"check {path.name} vs {name}")
            digest = hasher(_compute(im, op, inputs, spec))
            if digest != doc["sha256"]:
                failures.append(
                    f"{path.name}: {name} hash {digest[:16]}… != committed "
                    f"{doc['sha256'][:16]}…"
                )
        golden = allimpls["golden"]
        for s in doc["samples"]:
            if op == "decode":
                pat, want_bits = s
                got = np.float32(golden.decode(np.int32([pat]), spec)[0])
                if int(got.view(np.uint32)) != want_bits and not (
                    np.isnan(got)
                    and np.isnan(np.uint32(want_bits).view(np.float32))
                ):
                    failures.append(
                        f"{path.name}: golden decode({pat:#x}) = {got!r}, "
                        f"vector says bits {want_bits:#010x}"
                    )
            else:
                pa, pb, want = s
                got = int(
                    np.ravel(golden.run(op, (np.int32([pa]), np.int32([pb])),
                                        spec))[0]
                )
                if got != want:
                    failures.append(
                        f"{path.name}: golden {op}({pa:#x}, {pb:#x}) = "
                        f"{got:#x}, vector says {want:#x}"
                    )
    return failures
