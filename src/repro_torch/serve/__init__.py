from repro_torch.serve.engine import (Request, ServeEngine,
                                      map_contiguous_tick, map_paged_tick)
from repro_torch.serve.kv import KVCacheOOM, PagedKVCache, SwappedPages
from repro_torch.serve.router import Router
from repro_torch.serve.workload import (TrafficReport, WorkloadSpec, generate,
                                        replay)

__all__ = ["KVCacheOOM", "PagedKVCache", "Request", "Router",
           "ServeEngine", "SwappedPages", "TrafficReport", "WorkloadSpec",
           "generate", "map_contiguous_tick", "map_paged_tick", "replay"]
