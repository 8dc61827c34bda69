"""Paged serving of the port: block pool, scheduler, metrics, engine."""
from repro_torch.serve.engine import PagedServeEngine, Request
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paging import BlockPool, blocks_for, set_block_tables
from repro_torch.serve.scheduler import Scheduler

__all__ = ["BlockPool", "PagedServeEngine", "Request", "Scheduler",
           "ServeMetrics", "blocks_for", "set_block_tables"]
