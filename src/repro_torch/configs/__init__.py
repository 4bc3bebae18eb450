"""Architecture configs the port serves: the dense ``yi-6b`` and the MoE
``deepseek-moe-16b`` and ``granite-moe-1b-a400m``."""
from . import deepseek_moe_16b, granite_moe_1b_a400m, yi_6b
from .base import ModelConfig  # noqa: F401

ARCHS = {
    "yi-6b": yi_6b.config,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.config,
    "deepseek-moe-16b": deepseek_moe_16b.config,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r}; the port knows {sorted(ARCHS)} so far"
        )
    return ARCHS[name]()
