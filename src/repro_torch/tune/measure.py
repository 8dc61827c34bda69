"""Device time of one call on the card, by CUDA events.

Counterpart of ``repro.tune.measure``.  A host clock around an
asynchronous launch measures the enqueue, so :class:`Timer` brackets
each call with CUDA events, and two things keep those events honest:

  * the L2 cache (50 MB) is flushed before each call by zeroing a
    128 MiB buffer, because the serve path streams each weight once a
    step and finds it cold;
  * a spin kernel (``torch.cuda._sleep``) is queued ahead of the events,
    so the card is still busy while the host runs the Python wrapper and
    enqueues the work: the events then bracket device time only, not
    the host's dispatch time.

:func:`measure` is the tuner's harness: the median of ``n`` such calls,
in seconds.  Neither runs on the CPU: there is no device time there.
"""
from __future__ import annotations

import statistics
from typing import Callable, Dict

_FLUSH: Dict[int, object] = {}


def _flush_buffer(torch):
    index = torch.cuda.current_device()
    buf = _FLUSH.get(index)
    if buf is None:
        buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        _FLUSH[index] = buf
    return buf


class Timer:
    """Per-launch CUDA-event timing of device work, L2 flushed before
    each call.  ``timer(fn)`` is the mean over ``iters`` calls in ms,
    after ``warmup`` calls; ``timer.times(fn)`` each call's ms."""

    SPIN_CYCLES = 4_000_000          # ~2 ms at H100 clocks

    def __init__(self, iters: int = 10, warmup: int = 2):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("Timer measures device time: no CUDA device")
        if iters < 1:
            raise ValueError("iters must be >= 1")
        self.torch = torch
        self.iters, self.warmup = iters, warmup
        self.flush = _flush_buffer(torch)

    def times(self, fn: Callable) -> list:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        out = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return out

    def __call__(self, fn: Callable) -> float:
        return sum(self.times(fn)) / self.iters


def measure(fn: Callable, *, n: int = 5, warmup: int = 2) -> float:
    """Median device seconds per call of ``fn`` over ``n`` timed calls."""
    return statistics.median(Timer(n, warmup).times(fn)) * 1e-3
