"""qwen2-vl-72b backbone: M-RoPE, stub vision frontend [arXiv:2409.12191]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
        d_ff=29568, vocab=152064, act="silu", glu=True,
        rope_theta=1_000_000.0,
        frontend="vision", frontend_dim=8192,
        mrope_sections=(16, 24, 24),  # half-dims (t, h, w)
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    )
