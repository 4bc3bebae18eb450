"""CLI: ``python -m repro_torch.conformance {gen,check,fuzz}``.

* ``gen``   — generate the vector files into ``--dir`` (required: the
  reference's committed files under ``tests/vectors/`` are never
  rewritten), cross-checking the whole oracle matrix first.
* ``check`` — verify the committed vectors (or ``--dir``) against every
  implementation; exit 1 on drift.
* ``fuzz``  — run the seeded differential + metamorphic fuzzer; on
  mismatch, print the shrunk minimal reproducers, write them to
  ``--out``, and exit 1.  ``REPRO_PROP_MULT`` scales the per-batch
  example budget.

Every command takes ``--device`` (default: CUDA, which registers the
``cuda`` oracle that launches the kernels); ``--device cpu`` runs the
plain versions.  Without a card and without ``--device cpu`` the command
exits 2.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.device import resolve_device
from repro_torch.numerics import PositSpec

from .fuzz import DEFAULT_SPECS, run_fuzz
from .vectors import check_vectors, generate_vectors


def _parse_specs(text):
    if not text:
        return DEFAULT_SPECS
    out = []
    for item in text.split(","):
        n, es = item.strip().split(":")
        out.append(PositSpec(int(n), int(es)))
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.conformance")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate golden vectors into a new directory")
    g.add_argument("--dir", required=True, help="output directory")
    g.add_argument("--seed", type=int, default=0)

    c = sub.add_parser("check", help="verify the committed vectors")
    c.add_argument("--dir", default=None)

    f = sub.add_parser("fuzz", help="differential + metamorphic fuzz")
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--count", type=int, default=2048,
                   help="operands per (spec, mode); REPRO_PROP_MULT multiplies")
    f.add_argument("--specs", default=None,
                   help='comma list like "16:1,8:0" (default: the full matrix)')
    f.add_argument("--out", default=None,
                   help="directory for shrunk-reproducer artifacts on failure")

    for p in (g, c, f):
        p.add_argument("--device", default=None,
                       help="torch device (default: cuda; cpu runs the plain versions)")

    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"conformance: {e}", file=sys.stderr)
        return 2

    if args.cmd == "gen":
        paths = generate_vectors(pathlib.Path(args.dir), seed=args.seed, log=print,
                                 device=device)
        print(f"wrote {len(paths)} vector files")
        return 0

    if args.cmd == "check":
        failures = check_vectors(directory=args.dir and pathlib.Path(args.dir),
                                 log=lambda s: None, device=device)
        if failures:
            print("conformance vector check FAILED:")
            for msg in failures:
                print("  " + msg)
            return 1
        print("conformance vectors: all implementations agree")
        return 0

    report = run_fuzz(specs=_parse_specs(args.specs), seed=args.seed,
                      count=args.count, log=print, device=device)
    print(report.summary())
    if not report.ok and args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        name = f"conformance_seed{args.seed}.txt"
        (out / name).write_text(report.summary() + "\n")
        print(f"wrote {out / name}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
