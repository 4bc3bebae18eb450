"""granite-3.0-1b-a400m: 32 experts, top-8 [hf:ibm-granite]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv=8, head_dim=64,
        d_ff=512, vocab=49155, act="silu", glu=True,
        n_experts=32, top_k=8, moe_d_ff=512, n_shared_experts=0,
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16",
    )
