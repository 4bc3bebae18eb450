"""Posit<n,es> arithmetic and PLAM (the paper's core) in PyTorch."""
from .posit import (  # noqa: F401
    P8,
    P16,
    P32,
    PositSpec,
    decode,
    decode_fields,
    encode,
    encode_fields,
    pack16,
    quantize,
    unpack16,
)
from .plam import (  # noqa: F401
    exact_mul,
    mitchell_mul_f32,
    plam_mul,
    plam_mul_logfix,
    plam_product_f32,
    plam_relative_error,
)
from .table import decode_table, encode_table, tables  # noqa: F401
