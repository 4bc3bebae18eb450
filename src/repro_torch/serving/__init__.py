"""Serving layer: the continuous-batching paged engine and its API."""
from .api import PAGED_FAMILIES, ServeOptions, SubmitHandle, build_engine  # noqa: F401
from .engine import ContinuousBatchingEngine, PagedServeConfig, ServeStats  # noqa: F401
from .kv_cache import (  # noqa: F401
    SCRATCH_BLOCK,
    BlockAllocator,
    OutOfBlocksError,
    SequenceAllocation,
    padded_prompt_len,
)
from .scheduler import Request, RequestState, Scheduler  # noqa: F401
from .spec import Drafter, NgramDrafter, make_drafter  # noqa: F401

__all__ = [
    "ContinuousBatchingEngine",
    "ServeOptions",
    "SubmitHandle",
    "build_engine",
]
