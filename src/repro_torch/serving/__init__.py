"""Serving layer: the continuous-batching paged engine, the static engine,
their API and observability (trace, metrics registry, profiler spans)."""
from .api import PAGED_FAMILIES, ServeOptions, SubmitHandle, build_engine  # noqa: F401
from .engine import (  # noqa: F401
    ContinuousBatchingEngine,
    Engine,
    PagedServeConfig,
    ServeConfig,
    ServeStats,
)
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
from .spec import Drafter, DraftModelDrafter, NgramDrafter, make_drafter  # noqa: F401

__all__ = [
    "ContinuousBatchingEngine",
    "Engine",
    "ServeConfig",
    "ServeOptions",
    "SubmitHandle",
    "build_engine",
    "TraceRecorder",
    "MetricsRegistry",
]
