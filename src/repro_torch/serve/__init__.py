"""Serving of the port: block pool, scheduler, metrics, the paged and
slots engines."""
from repro_torch.serve.engine import (PagedServeEngine, Request, ServeEngine,
                                     check_servable, supports_paging)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paging import BlockPool, blocks_for, set_block_tables
from repro_torch.serve.scheduler import Scheduler

__all__ = ["BlockPool", "PagedServeEngine", "Request", "Scheduler",
           "ServeEngine", "ServeMetrics", "blocks_for", "check_servable",
           "set_block_tables", "supports_paging"]
