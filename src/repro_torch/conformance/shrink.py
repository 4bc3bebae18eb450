"""Mismatch minimization + reproducer reports (port of
``repro/conformance/shrink.py``).

Given a differential disagreement between two implementations on a
batch, reduce it to a *minimal* single operand pair: greedily replace
each operand with structurally simpler patterns (fewer set bits,
shorter bodies, canonical constants) while the two implementations
still disagree.  The final report decodes every posit field of the
minimal operands (via ``golden.decode_fields_py``), shows each
implementation's output, and emits a paste-ready pytest regression
snippet.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import numpy as np

from repro_torch.numerics import PositSpec, golden

from .oracles import outputs_equal

__all__ = ["shrink_pair", "shrink_value", "describe_pattern", "reproducer",
           "attach_report"]


def _popcount(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1")


def _cost(p: int) -> Tuple[int, int]:
    """Shrink order: fewer set bits first, then smaller value."""
    return (_popcount(p), p)


def _pattern_candidates(p: int, n: int) -> Iterable[int]:
    """Structurally simpler replacements for pattern ``p`` (maybe equal)."""
    mask = (1 << n) - 1
    one = 1 << (n - 2)
    yield 0
    yield one  # +1.0
    yield 1 << (n - 1)  # NaR
    yield 1  # minpos
    for b in range(n):  # clear each set bit
        if p & (1 << b):
            yield p & ~(1 << b) & mask
    yield (p >> 1) & mask
    yield p & (mask >> 1)  # drop the sign
    yield one | (p & (one - 1))  # same fraction-ish bits at scale ~1


def shrink_value(
    interesting: Callable[[int], bool], p: int, n: int, max_steps: int = 4096
) -> int:
    """Greedy single-pattern shrink: smallest-cost candidate that stays
    interesting, iterated to a fixed point."""
    steps = 0
    while steps < max_steps:
        steps += 1
        best = None
        for c in _pattern_candidates(p, n):
            if c == p or _cost(c) >= _cost(p):
                continue
            if best is not None and _cost(c) >= _cost(best):
                continue
            if interesting(c):
                best = c
        if best is None:
            return p
        p = best
    return p


def shrink_pair(
    interesting: Callable[[int, int], bool],
    pa: int,
    pb: int,
    n: int,
    max_steps: int = 4096,
) -> Tuple[int, int]:
    """Minimize ``(pa, pb)`` while ``interesting(pa, pb)`` holds.

    Alternates single-operand shrinks until neither operand can get
    simpler — the classic delta-debugging fixed point, specialized to
    bit patterns.
    """
    assert interesting(pa, pb), "shrink_pair needs a failing pair to start"
    while True:
        pa2 = shrink_value(lambda a: interesting(a, pb), pa, n, max_steps)
        pb2 = shrink_value(lambda b: interesting(pa2, b), pb, n, max_steps)
        if (pa2, pb2) == (pa, pb):
            return pa, pb
        pa, pb = pa2, pb2


def describe_pattern(p: int, spec: PositSpec) -> str:
    """One-line field decode: sign/regime k/exponent e/fraction f/value."""
    n, es = spec.n, spec.es
    p &= spec.mask_n
    if p == 0:
        return f"{p:#0{n // 4 + 2}x} = zero"
    if p == spec.nar:
        return f"{p:#0{n // 4 + 2}x} = NaR"
    s, k, e, f = golden.decode_fields_py(p, n, es)
    v = golden.decode_py(p, n, es)
    return (
        f"{p:#0{n // 4 + 2}x} = {'-' if s else '+'}2^{k * (1 << es) + e}"
        f"*(1+{f:.6g})  [k={k} e={e} f={f:.6g}]  value {v:.8g}"
    )


def _fmt_out(v) -> str:
    if isinstance(v, float):
        return f"{v!r} (0x{np.float32(v).view(np.uint32).item():08x})" \
            if not math.isnan(v) else "nan"
    return hex(int(v))


def reproducer(mm, spec: PositSpec) -> str:
    """Human-readable report + paste-ready pytest snippet for a mismatch."""
    n, es = spec.n, spec.es
    lines = [
        f"CONFORMANCE MISMATCH  op={mm.op}  spec=Posit<{n},{es}>  "
        f"{mm.impl_a} vs {mm.impl_b}  ({mm.count} lanes in batch)",
    ]
    if mm.op in ("exact_mul", "plam_mul", "decode"):
        for tag, p in zip(("a", "b"), mm.inputs):
            lines.append(f"  operand {tag}: {describe_pattern(int(p), spec)}")
    else:
        lines.append(f"  input x = {mm.inputs[0]!r}")
    lines.append(f"  {mm.impl_a:>14}: {_fmt_out(mm.out_a)}")
    lines.append(f"  {mm.impl_b:>14}: {_fmt_out(mm.out_b)}")
    args = ", ".join(repr(v) for v in mm.inputs)
    test_name = f"test_regression_{mm.op}_p{n}_{es}_{mm.impl_b}".replace(
        "!", "_faulty_").replace("^", "_bit")
    lines += [
        "",
        "  # --- paste-ready regression test " + "-" * 30,
        "  from repro_torch.numerics import PositSpec",
        "  from repro_torch.conformance import default_impls, outputs_equal",
        "",
        f"  def {test_name}():",
        f"      spec = PositSpec({n}, {es})",
        "      impls = default_impls(spec)",
        f"      a = impls[{mm.impl_a!r}].run({mm.op!r}, ({args},), spec)",
        f"      b = impls[{mm.impl_b.split('!')[0]!r}].run({mm.op!r}, ({args},), spec)",
        "      assert outputs_equal(a, b).all()",
    ]
    return "\n".join(lines)


def attach_report(mm, impl_ref, impl_bad) -> None:
    """Shrink a mul-op mismatch to a minimal pair and attach its report.

    Codec-op mismatches keep their single offending input (floats do
    not shrink meaningfully on the posit grid); pattern-pair ops run the
    full delta-debugging loop with single-pair re-evaluations.
    """
    spec = mm.spec
    if mm.op in ("exact_mul", "plam_mul"):

        def interesting(a: int, b: int) -> bool:
            oa = np.ravel(impl_ref.run(mm.op, (np.int32([a]), np.int32([b])), spec))
            ob = np.ravel(impl_bad.run(mm.op, (np.int32([a]), np.int32([b])), spec))
            return not bool(outputs_equal(oa, ob).all())

        pa, pb = int(mm.inputs[0]), int(mm.inputs[1])
        pa, pb = shrink_pair(interesting, pa, pb, spec.n)
        oa = np.ravel(impl_ref.run(mm.op, (np.int32([pa]), np.int32([pb])), spec))
        ob = np.ravel(impl_bad.run(mm.op, (np.int32([pa]), np.int32([pb])), spec))
        mm.inputs = (pa, pb)
        mm.out_a = oa[0].item()
        mm.out_b = ob[0].item()
    mm.report = reproducer(mm, spec)
