"""Hand-written CUDA kernels for Hopper, each with its plain version.

* ``plam_matmul``       — the PLAM matmul (K1, ``csrc/plam_matmul.cu``)
* ``decode_attention``  — paged decode attention (K2,
  ``csrc/paged_decode_attention.cu``)
* ``posit_codec``       — posit encode / decode / quantize (K3,
  ``csrc/posit_codec.cu``)

Kernels are built on first use (``_lib.library``); launches are counted
in ``_lib.launches``.
"""
from ._lib import launches, reset_launches  # noqa: F401
from .decode_attention import (  # noqa: F401
    gather_pages,
    paged_decode_attention,
    paged_decode_attention_kernel,
    paged_decode_attention_ref,
)
from .ops import (  # noqa: F401
    plam_dense,
    plam_matmul_bits,
    posit_decode,
    posit_encode,
    posit_quantize,
)
