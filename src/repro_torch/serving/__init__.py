from repro_torch.serving.engine import ServeEngine, ServeStats
from repro_torch.serving.kv_manager import (PageAllocationError,
                                            PagedKVManager, PrefixAllocation,
                                            ResidencyPlan,
                                            SimulatedTierDevice, TierBudget,
                                            page_bytes)
from repro_torch.serving.metrics import (latency_summary_ms, pct_ms,
                                         percentile)
from repro_torch.serving.scheduler import (AdaptiveSpecK, ContinuousScheduler,
                                           Request)
from repro_torch.serving.streams import VirtualStream
from repro_torch.serving.trace import (PHASES, TraceRecorder,
                                       validate_chrome_trace)

__all__ = ["ServeEngine", "ServeStats",
           "PageAllocationError", "PagedKVManager", "PrefixAllocation",
           "ResidencyPlan", "SimulatedTierDevice", "TierBudget",
           "page_bytes", "AdaptiveSpecK",
           "ContinuousScheduler", "Request", "PHASES", "TraceRecorder",
           "VirtualStream", "validate_chrome_trace", "latency_summary_ms",
           "pct_ms", "percentile"]
