"""Architecture configs: the reference's ten (``repro/configs/__init__.py``),
field for field.  The port serves every family: dense (``yi-6b``,
``gemma-7b``, ``minitron-8b``, ``command-r-plus-104b``), MoE
(``deepseek-moe-16b``, ``granite-moe-1b-a400m``), ssm (``mamba2-780m``),
hybrid (``zamba2-1.2b``), encdec (``seamless-m4t-medium``) and vlm
(``qwen2-vl-72b``)."""
from . import (
    command_r_plus_104b,
    deepseek_moe_16b,
    gemma_7b,
    granite_moe_1b_a400m,
    mamba2_780m,
    minitron_8b,
    qwen2_vl_72b,
    seamless_m4t_medium,
    yi_6b,
    zamba2_1_2b,
)
from .base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    ShapeSpec,
    applicable_shapes,
    shape_by_name,
)

ARCHS = {
    "minitron-8b": minitron_8b.config,
    "yi-6b": yi_6b.config,
    "command-r-plus-104b": command_r_plus_104b.config,
    "gemma-7b": gemma_7b.config,
    "mamba2-780m": mamba2_780m.config,
    "seamless-m4t-medium": seamless_m4t_medium.config,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.config,
    "deepseek-moe-16b": deepseek_moe_16b.config,
    "qwen2-vl-72b": qwen2_vl_72b.config,
    "zamba2-1.2b": zamba2_1_2b.config,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port knows {sorted(ARCHS)}")
    return ARCHS[name]()
