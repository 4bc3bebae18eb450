"""Architecture configs the port serves: the dense ``yi-6b``, the MoE
``deepseek-moe-16b`` and ``granite-moe-1b-a400m``, the ssm
``mamba2-780m`` and the hybrid ``zamba2-1.2b``."""
from . import deepseek_moe_16b, granite_moe_1b_a400m, mamba2_780m, yi_6b, zamba2_1_2b
from .base import ModelConfig  # noqa: F401

ARCHS = {
    "yi-6b": yi_6b.config,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.config,
    "deepseek-moe-16b": deepseek_moe_16b.config,
    "mamba2-780m": mamba2_780m.config,
    "zamba2-1.2b": zamba2_1_2b.config,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r}; the port knows {sorted(ARCHS)} so far"
        )
    return ARCHS[name]()
