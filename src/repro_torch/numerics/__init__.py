"""Posit<n,es> arithmetic and the PLAM product in PyTorch."""
from .plam import plam_product_f32  # noqa: F401
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
