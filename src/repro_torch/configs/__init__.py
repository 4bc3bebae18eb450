"""Architecture configs the port serves (the dense ``yi-6b`` so far)."""
from . import yi_6b
from .base import ModelConfig  # noqa: F401

ARCHS = {
    "yi-6b": yi_6b.config,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r}; the port knows {sorted(ARCHS)} so far"
        )
    return ARCHS[name]()
