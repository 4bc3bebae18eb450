"""command-r-plus-104b: GQA, no-bias, tied embeddings [hf:CohereForAI]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv=8, head_dim=128,
        d_ff=33792, vocab=256000, act="silu", glu=True,
        tie_embeddings=True, rope_theta=8_000_000.0,
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    )
