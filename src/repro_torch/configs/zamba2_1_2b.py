"""zamba2-1.2b: Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv=32,
        d_ff=8192, vocab=32000, act="gelu", glu=True,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
        shared_attn_every=6, sub_quadratic=True,
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16",
    )
