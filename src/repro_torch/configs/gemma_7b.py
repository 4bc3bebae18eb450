"""gemma-7b: GeGLU, head_dim 256, MHA (kv=16) [arXiv:2403.08295]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv=16, head_dim=256,
        d_ff=24576, vocab=256000, act="gelu", glu=True,  # GeGLU
        tie_embeddings=True, scale_embeddings=True,
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    )
