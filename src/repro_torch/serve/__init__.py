from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kv import KVCacheOOM, PagedKVCache, SwappedPages

__all__ = ["KVCacheOOM", "PagedKVCache", "Request", "ServeEngine",
           "SwappedPages"]
