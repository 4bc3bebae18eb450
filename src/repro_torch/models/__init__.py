"""Model zoo: the dense, MoE, ssm (Mamba2) and hybrid (zamba2) families."""
from .registry import ModelAPI, build  # noqa: F401
