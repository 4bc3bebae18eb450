"""Serving layer: the continuous-batching paged engine, its API and its
observability (trace, metrics registry, profiler spans)."""
from .api import PAGED_FAMILIES, ServeOptions, SubmitHandle, build_engine  # noqa: F401
from .engine import ContinuousBatchingEngine, PagedServeConfig, ServeStats  # noqa: F401
from .kv_cache import (  # noqa: F401
    SCRATCH_BLOCK,
    BlockAllocator,
    OutOfBlocksError,
    SequenceAllocation,
    padded_prompt_len,
)
from .observability import (  # noqa: F401
    MetricsRegistry,
    RequestBreakdown,
    TraceEvent,
    TraceRecorder,
    check_request_events,
    derive_breakdown,
)
from .scheduler import Request, RequestState, Scheduler  # noqa: F401
from .spec import Drafter, NgramDrafter, make_drafter  # noqa: F401

__all__ = [
    "ContinuousBatchingEngine",
    "ServeOptions",
    "SubmitHandle",
    "build_engine",
    "TraceRecorder",
    "MetricsRegistry",
]
