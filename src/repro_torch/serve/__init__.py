"""Serving of the port: block pool and prefix cache, scheduler, metrics,
the paged and slots engines and the asyncio frontend."""
from repro_torch.serve.engine import (PagedServeEngine, Request, ServeEngine,
                                     check_servable, request_key,
                                     supports_paging)
from repro_torch.serve.frontend import (AsyncServeFrontend,
                                       FrontendClosedError, QueueFullError,
                                       StreamHandle)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paging import (BlockPool, PrefixCache, blocks_for,
                                      set_block_tables)
from repro_torch.serve.scheduler import Scheduler

__all__ = ["AsyncServeFrontend", "BlockPool", "FrontendClosedError",
           "PagedServeEngine", "PrefixCache", "QueueFullError", "Request",
           "Scheduler", "ServeEngine", "ServeMetrics", "StreamHandle",
           "blocks_for", "check_servable", "request_key",
           "set_block_tables", "supports_paging"]
