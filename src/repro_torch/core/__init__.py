"""The paper's contribution as composable numerics modes + dense layer.

``modes`` is the per-matmul dispatch (NumericsConfig / nmatmul),
``policy`` the per-site resolver (NumericsPolicy / site tags), and
``prequant`` the one-shot posit weight encoding for serving.
"""
from .dense import dense, dense_init  # noqa: F401
from .modes import (  # noqa: F401
    EXACT_BF16,
    PLAM16,
    POSIT16_QUANT,
    NumericsConfig,
    nmatmul,
)
from .policy import (  # noqa: F401
    NumericsPolicy,
    parse_policy,
    policy_from_dict,
    policy_to_dict,
    policy_to_str,
    site,
    site_for,
)
from .prequant import dequantize_params, quantize_params  # noqa: F401
