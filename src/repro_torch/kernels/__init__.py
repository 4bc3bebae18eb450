"""Hand-written CUDA kernels for Hopper, each with its plain version.

* ``plam_matmul``             — the PLAM matmul (K1, ``csrc/plam_matmul.cuh``;
  entry points ``plam_matmul.cu`` over posit patterns and ``plam_dense.cu``
  over float activations, which it encodes itself; either also over a
  stack of experts in one launch)
* ``paged_decode_attention``  — paged decode attention (K2,
  ``csrc/paged_decode_attention.cu``, on the split-key core of
  ``csrc/decode_attention.cuh`` that K5 shares)
* ``posit_codec``             — posit encode / decode / quantize (K3,
  ``csrc/posit_codec.cu``; a bf16 weight's encode looks its patterns up
  in a table in shared memory, built once per spec and device)
* ``posit_mul``               — element-wise PLAM and exact posit products
  (K4, ``csrc/posit_mul.cu``)
* ``decode_attention``        — contiguous-cache decode attention split
  along the keys (K5, ``csrc/decode_attention.cu``)

Kernels are built on first use (``_lib.library``); launches are counted
in ``_lib.launches`` (K3's table builds apart, as ``posit_codec_table``;
K1's launches over a stack of experts also as ``plam_matmul_grouped``).
"""
from ._lib import launches, reset_launches  # noqa: F401
from .decode_attention import (  # noqa: F401
    decode_attention,
    decode_attention_kernel,
    decode_attention_ref,
    gather_pages,
    paged_decode_attention,
    paged_decode_attention_kernel,
    paged_decode_attention_ref,
)
from .ops import (  # noqa: F401
    exact_mul_elementwise,
    plam_dense,
    plam_matmul_bits,
    plam_mul_elementwise,
    posit_decode,
    posit_encode,
    posit_quantize,
)
