"""mamba2-780m: SSD, attention-free [arXiv:2405.21060]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv=0,
        d_ff=0, vocab=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
        sub_quadratic=True,
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16",
    )
