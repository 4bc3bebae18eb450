"""Differential conformance + fuzzing for the port's posit/PLAM numerics.

Port of ``repro/conformance``.  The port carries five semi-independent
implementations of Posit<n,es> arithmetic — the pure-Python golden model
(``numerics/golden.py``), the vectorized PyTorch numerics
(``numerics/posit.py`` / ``plam.py``), the exhaustive-table codec
(``numerics/table.py``), and the CUDA kernels K3/K4
(``kernels/posit_codec.py``) with their plain versions.  This package
keeps them mutually bit-exact and holds them to the reference's
committed vectors:

* :mod:`repro_torch.conformance.oracles` — a uniform :class:`Impl`
  interface over every implementation.
* :mod:`repro_torch.conformance.fuzz` — seeded structured fuzzers running
  N-way differential comparison plus metamorphic property checks.
* :mod:`repro_torch.conformance.shrink` — mismatch minimization down to a
  single operand pair, with a paste-ready regression-test snippet.
* :mod:`repro_torch.conformance.vectors` — check the committed vector
  files under ``tests/vectors/``, or generate new ones elsewhere.

CLI: ``python -m repro_torch.conformance {gen,check,fuzz} [--device D]``;
the device defaults to CUDA, where the ``cuda`` oracle runs the kernels.
"""

from .oracles import (  # noqa: F401
    CODEC_OPS,
    MUL_OPS,
    OPS,
    FaultyImpl,
    GoldenImpl,
    Impl,
    KernelImpl,
    TableImpl,
    TorchImpl,
    default_impls,
    outputs_equal,
)
from .fuzz import (  # noqa: F401
    DEFAULT_SPECS,
    FuzzReport,
    Mismatch,
    boundary_patterns,
    run_fuzz,
    sample_patterns,
)
from .shrink import reproducer, shrink_pair  # noqa: F401
from .vectors import check_vectors, generate_vectors  # noqa: F401
