"""Serving observability of the port: event-level traces and exporters.

The port's own copy of ``repro.obs``.  Where ``serve/metrics.py`` keeps
aggregates (TTFT, tokens/s), a :class:`Tracer` threaded through the
paged engine and its scheduler records which tick, which request and
which phase; ``export`` renders it as Chrome trace-event JSON (Perfetto
or ``chrome://tracing``) or as a per-request timeline table.
"""
from repro_torch.obs.export import (format_timeline, save_chrome, timeline,
                                    to_chrome, validate_chrome)
from repro_torch.obs.trace import (ENGINE_TRACKS, NULL, SCHEMA_VERSION,
                                   NullTracer, Tracer, activate, get_active,
                                   record_kernel_config,
                                   record_kernel_unsupported, req_track,
                                   set_active)

__all__ = [
    "ENGINE_TRACKS", "NULL", "SCHEMA_VERSION", "NullTracer", "Tracer",
    "activate", "format_timeline", "get_active", "record_kernel_config",
    "record_kernel_unsupported", "req_track", "save_chrome", "set_active",
    "timeline", "to_chrome", "validate_chrome",
]
