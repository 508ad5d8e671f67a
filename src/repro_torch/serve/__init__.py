from repro_torch.serve.engine import (Request, ServeEngine,
                                      map_contiguous_tick, map_paged_tick)
from repro_torch.serve.kv import KVCacheOOM, PagedKVCache, SwappedPages

__all__ = ["KVCacheOOM", "PagedKVCache", "Request", "ServeEngine",
           "SwappedPages", "map_contiguous_tick", "map_paged_tick"]
