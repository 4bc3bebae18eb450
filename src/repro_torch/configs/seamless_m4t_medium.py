"""seamless-m4t-medium backbone: enc-dec, audio stub frontend [arXiv:2308.11596]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=24, enc_layers=12, dec_layers=12,
        d_model=1024, n_heads=16, n_kv=16, head_dim=64,
        d_ff=4096, vocab=256206, act="gelu", glu=False,
        frontend="audio", frontend_dim=160,  # stacked mel-frame embeddings
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16",
    )
