"""Model zoo: the dense decoder family so far."""
from .registry import ModelAPI, build  # noqa: F401
