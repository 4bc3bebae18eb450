"""minitron-8b: width-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.core.modes import NumericsConfig

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
        d_ff=16384, vocab=256000, act="relu2", glu=False,  # squared-ReLU MLP
        numerics=NumericsConfig(mode="posit_quant", n=16, es=1),
        param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    )
