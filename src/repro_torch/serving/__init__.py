from .engine import GenerationEngine, SamplerConfig
from .metrics import ServeMetrics
from .paged_engine import PagedConfig, PagedEngine
from .prefix_cache import PrefixCache
from .scheduler import PoolState, Request, Scheduler, SchedulerPolicy

__all__ = [
    "GenerationEngine",
    "PagedConfig",
    "PagedEngine",
    "PoolState",
    "PrefixCache",
    "Request",
    "SamplerConfig",
    "Scheduler",
    "SchedulerPolicy",
    "ServeMetrics",
]
