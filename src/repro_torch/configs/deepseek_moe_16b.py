"""deepseek-moe-16b: fine-grained 64 routed top-6 + 2 shared [arXiv:2401.06066]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
        d_ff=1408, vocab=102400, act="silu", glu=True,
        n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    )
