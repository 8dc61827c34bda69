"""Event-level serving trace: a bounded ring of spans and instants.

The port's own copy of ``repro.obs.trace``.  ``Tracer`` is the
low-overhead recorder the serving stack threads its hooks through
(``serve/engine.py``, ``serve/scheduler.py``).  Design constraints, in
order:

  * **cheap when off** — engines hold a :data:`NULL` tracer by default;
    every hook is a no-op method call, no branching at call sites;
  * **bounded** — events land in a ring buffer (``capacity`` newest
    kept, ``dropped`` counts the rest), so a week-long serve cannot OOM
    the host because someone left tracing on;
  * **deterministic under test** — the clock is injectable (tests pass
    a fake), timestamps are microseconds since tracer construction;
  * **schema-versioned** — every exported artifact carries
    :data:`SCHEMA_VERSION` so downstream consumers (Perfetto loaders,
    the perf-trajectory gate, future async-loop debugging) can detect
    drift.

Events are plain dicts (see :meth:`Tracer.emit`) with two shapes:
complete spans (``ph == "X"``, with ``dur``) and instants
(``ph == "i"``).  Every event lives on a *track*: ``"engine/<phase>"``
for engine phases (tick, admission, prefix, prefill, decode, sync,
sample, preempt, evict, kernel) or ``"req/<uid>"`` for per-request
timelines.  ``obs/export.py`` maps tracks onto Chrome trace-event
process/thread lanes.

Double-buffered ticks (``PagedServeEngine.step_async``) interleave the
lanes on purpose: tick N's ``decode_dispatch`` span (``engine/decode``,
``mode="async"``) precedes tick N-1's ``device_sync`` span inside the
same ``tick`` span — the overlap the async host loop exists for is
directly visible as that ordering.  Sync spans carry ``sync_tick`` (the
tick whose tokens they wait for) and token instants on ``req/<uid>``
tracks consequently land one tick after their ``decode_dispatch``; the
tick-top deadline sweep and cancellations add ``deadline`` / ``fail``
instants on the request track.

The module-level *active tracer* is how code that cannot be handed a
tracer instance (a kernel-config resolver deep inside op wrappers)
still records: engines ``set_active`` their tracer at construction and
such code calls :func:`record_kernel_config` or
:func:`record_kernel_unsupported`, which no-op unless a tracer is
active.  (Their callers come with the port of ``tune/``.)

``profiler_bridge=True`` wraps every span in
``torch.profiler.record_function``, so host spans line up with a
``torch.profiler`` trace of the device; it needs only torch, which the
port always has, so it is never switched off behind the caller's back.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch

SCHEMA_VERSION = 1

# the engine-phase track catalogue; export groups these into one
# process lane, in this order
ENGINE_TRACKS = (
    "engine/tick", "engine/admission", "engine/prefix", "engine/prefill",
    "engine/decode", "engine/sync", "engine/sample", "engine/preempt",
    "engine/evict", "engine/kernel",
)


def req_track(uid) -> str:
    """The per-request track name for a request uid."""
    return f"req/{uid}"


class _Span:
    """Class-based context manager for :meth:`Tracer.span` — spans are
    the tracer's hottest path (several per engine tick) and a generator
    contextmanager costs ~3x more per entry than this slotted object,
    which matters for the <= 5% trace-overhead budget the serving bench
    enforces."""

    __slots__ = ("tr", "name", "track", "cat", "args", "t0", "bridge")

    def __init__(self, tr, name, track, cat, args):
        self.tr = tr
        self.name = name
        self.track = track
        self.cat = cat
        self.args = args
        self.bridge = None

    def __enter__(self):
        tr = self.tr
        if tr._annotation is not None:
            self.bridge = tr._annotation(self.name)
            self.bridge.__enter__()
        self.t0 = tr.now_us()
        return tr

    def __exit__(self, *exc):
        tr = self.tr
        tr.emit(self.name, "X", self.t0, self.track, self.cat,
                dur=tr.now_us() - self.t0, args=self.args)
        if self.bridge is not None:
            self.bridge.__exit__(*exc)
        return False


class Tracer:
    """Span/instant recorder over an injectable clock and a ring buffer.

    ``capacity`` bounds retained events (newest win); ``profiler_bridge``
    additionally wraps every span in ``torch.profiler.record_function``
    so host spans line up with a ``torch.profiler`` trace of the device.
    """

    def __init__(self, clock=time.perf_counter, capacity: int = 1 << 16,
                 profiler_bridge: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock
        self.capacity = capacity
        self._t0 = clock()
        self._buf: deque = deque(maxlen=capacity)
        self.total = 0              # events ever emitted (incl. dropped)
        self.tick: int = -1         # engine tick, tagged onto every event
        self._annotation = (torch.profiler.record_function
                            if profiler_bridge else None)

    # ------------------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since tracer construction."""
        return (self.clock() - self._t0) * 1e6

    def emit(self, name: str, ph: str, ts: float, track: str,
             cat: str = "engine", dur: Optional[float] = None,
             args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": ph, "ts": ts, "track": track, "cat": cat}
        if dur is not None:
            ev["dur"] = dur
        a = dict(args) if args else {}
        if self.tick >= 0 and "tick" not in a:
            a["tick"] = self.tick
        if a:
            ev["args"] = a
        self._buf.append(ev)
        self.total += 1

    def instant(self, name: str, *, track: str = "engine/tick",
                cat: str = "engine", **args) -> None:
        self.emit(name, "i", self.now_us(), track, cat, args=args)

    def span(self, name: str, *, track: str = "engine/tick",
             cat: str = "engine", **args) -> "_Span":
        """Record a complete span (``ph == "X"``) around the body."""
        return _Span(self, name, track, cat, args)

    # ------------------------------------------------------------------
    @property
    def events(self) -> List[dict]:
        return list(self._buf)

    @property
    def dropped(self) -> int:
        return self.total - len(self._buf)

    def tracks(self) -> List[str]:
        """Distinct tracks with at least one event, engine lanes first
        (catalogue order), then request lanes by first appearance."""
        seen: Dict[str, None] = {}
        for ev in self._buf:
            seen.setdefault(ev["track"], None)
        eng = [t for t in ENGINE_TRACKS if t in seen]
        eng += [t for t in seen if t.startswith("engine/")
                and t not in ENGINE_TRACKS]
        return eng + [t for t in seen if not t.startswith("engine/")]

    def clear(self) -> None:
        self._buf.clear()
        self.total = 0


class NullTracer:
    """API-compatible no-op: engines hold this when tracing is off so
    hook call sites stay branch-free.  ``span`` hands back a shared
    null context; nothing is ever recorded."""

    tick = -1
    capacity = 0
    total = 0
    dropped = 0
    events: List[dict] = []

    def emit(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def span(self, *a, **kw):
        return nullcontext()

    def now_us(self) -> float:
        return 0.0

    def tracks(self) -> List[str]:
        return []

    def clear(self) -> None:
        pass


NULL = NullTracer()

# ---------------------------------------------------------------------------
# active tracer: the escape hatch for call sites that cannot be handed a
# tracer instance (kernel-config resolution inside op wrappers)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None


def set_active(tracer: Optional[Tracer]) -> None:
    global _ACTIVE
    _ACTIVE = tracer


def get_active() -> Optional[Tracer]:
    return _ACTIVE


@contextmanager
def activate(tracer: Optional[Tracer]):
    prev = get_active()
    set_active(tracer)
    try:
        yield tracer
    finally:
        set_active(prev)


def record_kernel_config(kernel: str, source: str, config, **meta) -> None:
    """Record one kernel-launch config resolution on the active tracer.

    For a kernel-config resolver (the reference's
    ``tune.dispatch.kernel_config``), so traces show which launches ran
    a *tuned* config and which the *heuristic* (``source``: ``"cache"``
    | ``"tuned"`` | ``"heuristic"``); ``config`` has ``to_dict()``.
    No-op without an active tracer.
    """
    t = _ACTIVE
    if t is None:
        return
    t.instant(f"kernel_config:{kernel}", track="engine/kernel",
              cat="kernel", kernel=kernel, source=source,
              config=config.to_dict(), **meta)


def record_kernel_unsupported(kernel: str, reason: str, **meta) -> None:
    """Record one failed capability negotiation on the active tracer.

    For a capability probe (the reference's
    ``tune.dispatch.kernel_unsupported_reason``) that rejects a kernel
    for a problem, with the SPECIFIC cap that failed
    (``"window"``, ``"kv_dtype"``, ``"latent"``, ``"tp"``, ...) — so a
    trace of a gathered-fallback run says *why* it gathered instead of
    collapsing every reason into one boolean.  No-op without an active
    tracer.
    """
    t = _ACTIVE
    if t is None:
        return
    t.instant(f"kernel_unsupported:{kernel}", track="engine/kernel",
              cat="kernel", kernel=kernel, reason=reason, **meta)
