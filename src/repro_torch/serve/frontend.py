"""Asyncio request frontend over the port's
:class:`~repro_torch.serve.engine.PagedServeEngine` (the port's own copy
of ``repro.serve.frontend``).

The engine is a tick machine; this module gives it a serving surface:

  * :meth:`AsyncServeFrontend.submit` -> a :class:`StreamHandle` whose
    tokens arrive as an async iterator and whose completion is
    awaitable (``await handle.wait()``);
  * a **bounded admission queue** — when ``max_queue`` requests are
    already waiting, ``submit`` raises the typed :class:`QueueFullError`
    instead of queueing unboundedly (open-loop load must shed, not
    buffer);
  * **per-request deadlines** (``deadline_ms``) stamped as absolute
    times on the engine clock and enforced by the engine's tick-top
    deadline sweep, so an expired request frees its pool blocks whether
    it is still queued or mid-decode;
  * **cancellation** (``handle.cancel()``) with the same block-release
    guarantee; a token already sampled on-device for a cancelled
    request is dropped at emission.

One event loop, one thread: the frontend never races the engine — ticks
run inline in :meth:`serve_forever` (or :meth:`drain`), and control
returns to the loop between ticks (``await asyncio.sleep(0)``) so
submitters, cancellers and stream consumers interleave with the engine
at tick granularity.  The engine itself stays asyncio-free: everything
awaitable lives here, everything tick-shaped lives in the engine, and
the double-buffered ``step_async`` hides the device sync behind the
next tick's planning either way.

No new dependencies: pure stdlib ``asyncio`` + the existing engine.
"""
from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np

from repro_torch.serve.engine import PagedServeEngine, Request


class QueueFullError(RuntimeError):
    """Admission queue at capacity: the submit was rejected, nothing was
    enqueued.  Carries ``limit`` so callers can report the bound."""

    def __init__(self, limit: int):
        super().__init__(f"admission queue full ({limit} waiting)")
        self.limit = limit


class FrontendClosedError(RuntimeError):
    """submit() after close()."""


_DONE = object()          # token-stream sentinel


class StreamHandle:
    """One submitted request: async-iterate it for tokens, ``await
    handle.wait()`` for the finished :class:`Request`.  The handle never
    raises on engine-side failure — inspect ``handle.error`` (e.g.
    ``"deadline"``, ``"cancelled"``, ``"oom"``) after completion."""

    def __init__(self, frontend: "AsyncServeFrontend", req: Request):
        self.request = req
        self._frontend = frontend
        self._queue: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()

    # -- engine-facing ---------------------------------------------------
    def _on_token(self, tok: int, req: Request) -> None:
        self._queue.put_nowait(int(tok))

    def _finish(self) -> None:
        if not self._done.is_set():
            self._done.set()
            self._queue.put_nowait(_DONE)

    # -- client-facing ---------------------------------------------------
    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def error(self) -> Optional[str]:
        return self.request.error

    @property
    def out_tokens(self) -> list:
        return self.request.out_tokens

    def __aiter__(self) -> "StreamHandle":
        return self

    async def __anext__(self) -> int:
        tok = await self._queue.get()
        if tok is _DONE:
            raise StopAsyncIteration
        return tok

    async def wait(self) -> Request:
        """Await completion (normal or errored); returns the request."""
        await self._done.wait()
        return self.request

    def cancel(self) -> bool:
        """Cancel this request (releases its pool blocks immediately).
        Returns False if it had already finished."""
        return self._frontend.cancel(self)


class AsyncServeFrontend:
    """The asyncio serving surface for one :class:`PagedServeEngine`.

    ``max_queue`` bounds the engine's waiting queue (admitted-and-running
    requests don't count — the pool already bounds those); ``idle_sleep``
    is how long :meth:`serve_forever` naps when there is no work.  All
    timing (deadlines, metrics) uses the ENGINE's injectable clock, so
    tests drive expiry with a fake clock and zero real sleeping."""

    def __init__(self, engine: PagedServeEngine, *, max_queue: int = 64,
                 idle_sleep: float = 0.001):
        self.engine = engine
        self.max_queue = max_queue
        self.idle_sleep = idle_sleep
        self._handles: dict = {}            # uid -> live StreamHandle
        self._next_uid = 0
        self._reaped = 0                    # engine.finished cursor
        self._closed = False

    # ------------------------------------------------------------------
    def submit_nowait(self, prompt, *, max_new_tokens: int = 32,
                      temperature: float = 0.0, top_k: int = 0,
                      seed: Optional[int] = None,
                      deadline_ms: Optional[float] = None,
                      uid: Optional[int] = None) -> StreamHandle:
        """Enqueue a request; raises :class:`QueueFullError` when the
        bounded admission queue is at capacity and
        :class:`FrontendClosedError` after :meth:`close`."""
        if self._closed:
            raise FrontendClosedError("frontend is closed")
        if len(self.engine.sched.waiting) >= self.max_queue:
            raise QueueFullError(self.max_queue)
        if uid is None:
            uid = self._next_uid
        self._next_uid = max(self._next_uid, uid) + 1
        req = Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, seed=seed)
        handle = StreamHandle(self, req)
        req.on_token = handle._on_token
        if deadline_ms is not None:
            req.deadline_s = self.engine.clock() + deadline_ms / 1e3
        self.engine.submit(req)
        self._handles[uid] = handle
        return handle

    async def submit(self, prompt, **kw) -> StreamHandle:
        """Async-flavored :meth:`submit_nowait` (same typed errors); the
        awaitable shape lets callers treat admission as a suspension
        point even though enqueueing itself never blocks."""
        handle = self.submit_nowait(prompt, **kw)
        await asyncio.sleep(0)
        return handle

    def cancel(self, handle: StreamHandle) -> bool:
        ok = self.engine.cancel(handle.request, "cancelled")
        self._reap()
        return ok

    # ------------------------------------------------------------------
    def _reap(self) -> None:
        """Finalize handles for everything the engine retired since the
        last sweep (``engine.finished`` is append-only)."""
        fin = self.engine.finished
        while self._reaped < len(fin):
            req = fin[self._reaped]
            self._reaped += 1
            h = self._handles.pop(req.uid, None)
            if h is not None:
                h._finish()

    def _has_work(self) -> bool:
        return self.engine.sched.has_work() or self.engine.has_inflight

    def step(self) -> None:
        """One engine tick + handle reaping (exposed for tests that want
        tick-exact control; the async entry points call this)."""
        if self._has_work():
            self.engine.step_async()
        self._reap()

    async def drain(self, max_ticks: int = 100000) -> None:
        """Tick until every submitted request has finished, yielding to
        the event loop between ticks."""
        ticks = 0
        while self._has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
            await asyncio.sleep(0)
        self._reap()

    async def serve_forever(self) -> None:
        """Engine loop: tick while there is work, nap when idle, exit on
        :meth:`close`.  Run as a task next to the submitting coroutines:

            loop = asyncio.create_task(frontend.serve_forever())
            h = await frontend.submit(prompt)
            async for tok in h: ...
            frontend.close(); await loop
        """
        while not self._closed:
            if self._has_work():
                self.step()
                await asyncio.sleep(0)
            else:
                await asyncio.sleep(self.idle_sleep)

    def close(self) -> None:
        """Stop :meth:`serve_forever` and fail any still-live request
        with ``error="shutdown"`` so no awaiter hangs."""
        if self._closed:
            return
        self._closed = True
        self.engine.flush()
        for h in list(self._handles.values()):
            if not h.request.done:
                self.engine.cancel(h.request, "shutdown")
        self._reap()
        # anything the engine never saw finish (defensive): unblock it
        for h in list(self._handles.values()):
            h._finish()
        self._handles.clear()
