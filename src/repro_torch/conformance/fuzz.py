"""Seeded structured fuzzers + N-way differential / metamorphic checks
(port of ``repro/conformance/fuzz.py``).

Three operand distributions (paper-motivated; Fixed-Posit and Deep
Positron both validate format corner cases exhaustively):

* ``uniform``  — uniform n-bit patterns: every field combination,
  including the regime-dominated tails.
* ``boundary`` — biased toward the format's corner cases: 0, NaR, ±1,
  ±minpos, ±maxpos, every regime-transition pattern (single-run
  bodies), and ±1-pattern neighbors of all of these.
* ``dnn``      — N(0, 1)-valued operands encoded into the spec, the
  weight/activation regime the paper's Table II accuracy claims live
  in (fractions dense, scales small).

The differential runner evaluates every oracle in the matrix on the
same batch and compares each against the reference (golden) with
bit-exact equality; metamorphic checks assert the algebra that must
hold regardless of implementation — commutativity, sign/negation
symmetry, NaR absorption, multiplicative identity, the eq. (24) error
bound everywhere, and scale-independence of ``plam_relative_error``.

Every mismatch is shrunk to a minimal reproducer (see ``shrink.py``)
before it is reported.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import numerics as tn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.numerics import PositSpec

from . import shrink as _shrink
from .oracles import MUL_OPS, Impl, default_impls, outputs_equal

MODES = ("uniform", "boundary", "dnn")

DEFAULT_SPECS = (
    PositSpec(6, 0),
    PositSpec(8, 0),
    PositSpec(8, 1),
    PositSpec(10, 1),
    PositSpec(16, 1),
    PositSpec(16, 2),
)


REPRO_PROP_MULT = "REPRO_PROP_MULT"


def prop_mult() -> int:
    """CI stress lanes scale fuzz budgets via REPRO_PROP_MULT."""
    return max(1, int(os.environ.get(REPRO_PROP_MULT, "1")))


@dataclasses.dataclass
class Mismatch:
    """One differential disagreement, shrunk to a single operand pair."""

    op: str
    spec: PositSpec
    impl_a: str  # reference
    impl_b: str
    inputs: tuple  # ints for mul/decode ops, floats for encode/quantize
    out_a: object
    out_b: object
    count: int  # lanes that disagreed in the originating batch
    report: str = ""  # shrunk human-readable reproducer


@dataclasses.dataclass
class FuzzReport:
    checked: int = 0  # (impl, op, lane) comparisons performed
    checked_by: Dict[str, int] = dataclasses.field(default_factory=dict)  # per impl
    mismatches: List[Mismatch] = dataclasses.field(default_factory=list)
    property_failures: List[str] = dataclasses.field(default_factory=list)
    # one shrunk exemplar per (op, spec, impl pair) across the whole run
    seen: set = dataclasses.field(default_factory=set)

    @property
    def ok(self) -> bool:
        return not self.mismatches and not self.property_failures

    @property
    def independent(self) -> int:
        """Comparisons of oracles with code of their own: ``kernel_plain``
        runs ``torch``'s numerics behind the kernel wrappers."""
        return self.checked - self.checked_by.get("kernel_plain", 0)

    def summary(self) -> str:
        lines = [
            f"conformance fuzz: {self.checked} comparisons, "
            f"{len(self.mismatches)} mismatches, "
            f"{len(self.property_failures)} property failures",
            f"comparisons of independent oracles: {self.independent} "
            f"(by oracle: {dict(sorted(self.checked_by.items()))})",
        ]
        for m in self.mismatches:
            lines.append("")
            lines.append(m.report or
                         f"{m.op} {m.spec}: {m.impl_a} vs {m.impl_b} on {m.inputs}")
        lines.extend(f"PROPERTY: {p}" for p in self.property_failures)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# operand generators
# ---------------------------------------------------------------------------


def boundary_patterns(spec: PositSpec) -> np.ndarray:
    """Deterministic corner-case pattern set for ``spec``.

    0, NaR, ±1, ±minpos, ±maxpos, every single-run (pure-regime) body —
    the regime-transition points where the encoded fraction width
    changes — and the ±1 neighbors of all of the above.
    """
    n = spec.n
    mask = spec.mask_n
    one = 1 << (n - 2)  # body 10...0 decodes to +1.0
    core = {0, spec.nar, 1, spec.maxpos_body, one}
    # pure-regime bodies: 0b0..01, 0b0..011, ... and 0b10..0, 0b110..0 ...
    for r in range(1, n):
        core.add((1 << r) - 1)  # low run of ones
        core.add(((1 << r) - 1) << (n - 1 - r) & (mask >> 1))  # high run
    out = set()
    for p in core:
        for d in (-1, 0, 1):
            out.add((p + d) & mask)
            out.add((-(p + d)) & mask)  # negations
    return np.array(sorted(out), np.int32)


def sample_patterns(
    rng: np.random.Generator, spec: PositSpec, count: int, mode: str = "uniform"
) -> np.ndarray:
    """``count`` posit patterns drawn per the given distribution."""
    if mode == "uniform":
        return rng.integers(0, 1 << spec.n, count).astype(np.int32)
    if mode == "boundary":
        pool = boundary_patterns(spec)
        # half exact corners, half uniform so cross terms are exercised
        picks = pool[rng.integers(0, pool.shape[0], count)]
        uni = rng.integers(0, 1 << spec.n, count).astype(np.int32)
        take = rng.random(count) < 0.5
        return np.where(take, picks, uni).astype(np.int32)
    if mode == "dnn":
        vals = rng.standard_normal(count).astype(np.float32)
        return tn.encode(torch.from_numpy(vals), spec).numpy() & spec.mask_n
    raise ValueError(f"unknown fuzz mode {mode!r}")


def sample_floats(rng: np.random.Generator, count: int) -> np.ndarray:
    """Codec-op inputs: log-uniform magnitudes + specials."""
    mags = 10.0 ** rng.uniform(-30, 30, count)
    signs = np.where(rng.random(count) < 0.5, -1.0, 1.0)
    x = (mags * signs).astype(np.float32)
    with np.errstate(over="ignore"):
        # 1e-40 is an f32 subnormal, 3.5e38 overflows to +inf — both are
        # exactly the corner cases the codecs must agree on
        specials = np.array(
            [0.0, -0.0, 1.0, -1.0, np.nan, np.inf, -np.inf,
             1e-40, -1e-40, 3.5e38],
            np.float32,
        )
    k = min(specials.shape[0], count)
    x[:k] = specials[:k]
    return x


# ---------------------------------------------------------------------------
# differential comparison
# ---------------------------------------------------------------------------


def _neg(p, spec):
    return (-np.asarray(p, np.int64)) & spec.mask_n


def differential_op(
    impls: Dict[str, Impl],
    op: str,
    inputs: Sequence[np.ndarray],
    spec: PositSpec,
    ref: str = "golden",
    report: Optional[FuzzReport] = None,
    max_mismatches: int = 4,
) -> List[Mismatch]:
    """Run ``op`` through every impl supporting it; compare vs ``ref``.

    Each disagreement batch is reduced to its first few offending lanes
    and (for the pattern-pair ops) shrunk to a minimal single pair with
    a paste-ready reproducer attached.
    """
    todo = {name: im for name, im in impls.items() if op in im.ops(spec)}
    if ref not in todo:
        return []
    out_ref = todo[ref].run(op, inputs, spec)
    found: List[Mismatch] = []
    for name, im in todo.items():
        if name == ref:
            continue
        out = im.run(op, inputs, spec)
        eq = outputs_equal(out_ref, out)
        if report is not None:
            report.checked += int(np.size(eq))
            report.checked_by[name] = report.checked_by.get(name, 0) + int(np.size(eq))
        if bool(np.all(eq)):
            continue
        key = (op, spec.n, spec.es, ref, name)
        if report is not None and key in report.seen:
            continue
        if report is not None:
            report.seen.add(key)
        bad = np.flatnonzero(~np.ravel(eq))
        for idx in bad[:max_mismatches]:
            ins = tuple(np.ravel(x)[idx].item() for x in inputs)
            mm = Mismatch(
                op=op,
                spec=spec,
                impl_a=ref,
                impl_b=name,
                inputs=ins,
                out_a=np.ravel(out_ref)[idx].item(),
                out_b=np.ravel(out)[idx].item(),
                count=int(bad.shape[0]),
            )
            _shrink.attach_report(mm, todo[ref], im)
            found.append(mm)
            break  # one shrunk exemplar per impl pair is enough
    if report is not None:
        report.mismatches.extend(found)
    return found


# ---------------------------------------------------------------------------
# metamorphic properties
# ---------------------------------------------------------------------------


def check_metamorphic(
    impl: Impl,
    spec: PositSpec,
    pa: np.ndarray,
    pb: np.ndarray,
    failures: List[str],
) -> None:
    """Algebraic invariants every multiplier implementation must hold."""
    name = impl.name
    ops = impl.ops(spec)
    mask = spec.mask_n
    one = 1 << (spec.n - 2)
    for op in MUL_OPS:
        if op not in ops:
            continue
        ab = np.asarray(impl.run(op, (pa, pb), spec), np.int64) & mask
        ba = np.asarray(impl.run(op, (pb, pa), spec), np.int64) & mask
        if not np.array_equal(ab, ba):
            i = int(np.flatnonzero(ab != ba)[0])
            failures.append(
                f"{name}.{op} {spec}: not commutative at "
                f"pa={int(pa[i]):#x} pb={int(pb[i]):#x}"
            )
        # sign symmetry: (-a) * b == -(a * b); posit negation is exact
        nab = np.asarray(impl.run(op, (_neg(pa, spec), pb), spec), np.int64) & mask
        want = _neg(ab, spec)
        # NaR is its own negation; zero too — covered by _neg
        if not np.array_equal(nab, want):
            i = int(np.flatnonzero(nab != want)[0])
            failures.append(
                f"{name}.{op} {spec}: negation asymmetry at "
                f"pa={int(pa[i]):#x} pb={int(pb[i]):#x}"
            )
        # NaR absorption and multiplicative identity
        nar = np.full_like(pa, spec.nar)
        if not np.all((np.asarray(impl.run(op, (nar, pb), spec), np.int64) & mask)
                      == spec.nar):
            failures.append(f"{name}.{op} {spec}: NaR not absorbing")
        ones = np.full_like(pa, one)
        ida = np.asarray(impl.run(op, (pa, ones), spec), np.int64) & mask
        if not np.array_equal(ida, np.asarray(pa, np.int64) & mask):
            i = int(np.flatnonzero(ida != (np.asarray(pa, np.int64) & mask))[0])
            failures.append(
                f"{name}.{op} {spec}: x*1 != x at pa={int(pa[i]):#x}"
            )


def check_error_model(spec: PositSpec, pa, pb, failures: List[str],
                      device: DeviceLike = "cpu") -> None:
    """eq. (24): bound and pure-fraction dependence of the PLAM error."""
    ja = torch.from_numpy(np.int32(pa)).to(device)
    jb = torch.from_numpy(np.int32(pb)).to(device)
    err = tn.plam_relative_error(ja, jb, spec).cpu().numpy().astype(np.float64)
    if err.max() > 1.0 / 9.0 + 1e-6 or err.min() < 0.0:
        failures.append(
            f"plam_relative_error {spec}: out of [0, 1/9] "
            f"(min {err.min():.3g}, max {err.max():.3g})"
        )
    # scale-independence: rebuild each operand pair at shifted scales
    # (fractions preserved); the error must be bit-identical
    sign, scale, frac, is_zero, is_nar = tn.decode_fields(ja, spec)
    ok = ~(is_zero | is_nar).cpu().numpy()
    for shift in (-2, 1, 3):
        # keep shifted scales in regime range so the fraction width survives
        lim = spec.max_scale // 2
        sa2 = (scale + shift).clamp(-lim, lim)
        pa2 = tn.encode_fields(sign, sa2, frac, spec.fbmax, spec)
        err2 = tn.plam_relative_error(pa2, jb, spec).cpu().numpy().astype(np.float64)
        # only compare lanes whose fraction survived the re-encode
        _, _, frac2, _, _ = tn.decode_fields(pa2, spec)
        same_f = ((frac2 == frac) & ((sa2 - scale).abs() == abs(shift))).cpu().numpy() & ok
        if not np.allclose(err[same_f], err2[same_f], rtol=0, atol=0):
            failures.append(
                f"plam_relative_error {spec}: depends on scale (shift {shift})"
            )


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run_fuzz(
    specs: Sequence[PositSpec] = DEFAULT_SPECS,
    seed: int = 0,
    count: int = 2048,
    impls: Optional[Dict[str, Impl]] = None,
    modes: Sequence[str] = MODES,
    ref: str = "golden",
    golden_cap: int = 4096,
    log: Callable[[str], None] = lambda s: None,
    device: DeviceLike = None,
) -> FuzzReport:
    """Differential + metamorphic fuzz across the oracle matrix.

    ``count`` operands are drawn per (spec, mode); ``REPRO_PROP_MULT``
    multiplies it in CI stress lanes.  The pure-Python golden oracle is
    subsampled to ``golden_cap`` lanes per batch to keep wall-clock
    bounded; the vectorized impls always see the full batch (compared
    against the torch impl when golden is capped out of a lane).
    ``device`` (resolved by :func:`repro_torch.device.resolve_device`:
    CUDA unless named) holds the default oracle matrix and the error-model
    check.
    """
    device = resolve_device(device)
    count = count * prop_mult()
    report = FuzzReport()
    for spec in specs:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, spec.n, spec.es])
        )
        for mode in modes:
            log(f"fuzz {spec} mode={mode} count={count}")
            pa = sample_patterns(rng, spec, count, mode)
            pb = sample_patterns(rng, spec, count, mode)
            allimpls = impls if impls is not None else default_impls(spec, device)
            # golden cap: evaluate golden on a prefix slice, the rest of
            # the batch differentials against the torch impl as reference
            cap = min(count, golden_cap)
            capped = {n: i for n, i in allimpls.items()}
            for op in MUL_OPS:
                differential_op(
                    capped, op, (pa[:cap], pb[:cap]), spec, ref=ref, report=report
                )
                if count > cap and "torch" in allimpls and ref == "golden":
                    rest = {n: i for n, i in allimpls.items() if n != "golden"}
                    differential_op(
                        rest, op, (pa[cap:], pb[cap:]), spec, ref="torch",
                        report=report,
                    )
            # codec ops: patterns for decode, floats for encode/quantize
            differential_op(capped, "decode", (pa[:cap],), spec, ref=ref,
                            report=report)
            xs = sample_floats(rng, cap)
            differential_op(capped, "encode", (xs,), spec, ref=ref, report=report)
            differential_op(capped, "quantize", (xs,), spec, ref=ref,
                            report=report)
            # metamorphic algebra on the vectorized impls (full batch) and
            # on golden (capped batch)
            for name, im in allimpls.items():
                batch = cap if name == "golden" else count
                check_metamorphic(im, spec, pa[:batch], pb[:batch],
                                  report.property_failures)
            check_error_model(spec, pa, pb, report.property_failures, device)
    return report
