"""yi-6b: llama-architecture GQA [arXiv:2403.04652]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv=4, head_dim=128,
        d_ff=11008, vocab=64000, act="silu", glu=True,
        rope_theta=5_000_000.0,
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    )
