"""Serving telemetry: latency histograms + engine counters.

The port's own copy of ``repro.serve.metrics`` (numpy only).  The engine
feeds events through the ``on_*`` hooks with timestamps from an
injectable clock; ``summary()`` renders TTFT, per-token latency,
throughput, pool occupancy, the analytic KV-traffic counters, the
prefix cache's hits, tokens saved, copy-on-write recomputes and
evictions, the cancel and deadline counters, and the device-busy
fraction over the union of the decode steps' dispatch-to-sync windows
(under the async tick they overlap the next tick's host work); and
``to_json`` persists them.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np


class Histogram:
    """Log-bucketed latency histogram (seconds) that also keeps a capped
    sample reservoir so percentiles stay exact for short runs and
    unbiased (uniform reservoir sampling) for long ones."""

    def __init__(self, max_samples: int = 4096):
        # 100ns .. 100s in half-decade buckets
        self.bounds = np.logspace(-7, 2, 19)
        self.counts = np.zeros(len(self.bounds) + 1, np.int64)
        self.total = 0.0
        self.n = 0
        # exact running extrema: the reservoir can evict the true max on
        # long runs, so percentile(100) under-reports it — min/max must
        # never come from the sample set
        self._min = float("inf")
        self._max = float("-inf")
        self._samples: List[float] = []
        self._max_samples = max_samples
        self._rng = np.random.default_rng(0)

    def observe(self, v: float) -> None:
        self.counts[np.searchsorted(self.bounds, v)] += 1
        self.total += v
        self.n += 1
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        if len(self._samples) < self._max_samples:
            self._samples.append(v)
        else:                    # classic reservoir: keep each of the n
            j = int(self._rng.integers(0, self.n))   # seen w.p. k/n
            if j < self._max_samples:
                self._samples[j] = v

    def percentile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        return float(np.percentile(np.asarray(self._samples), q))

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    @property
    def min(self) -> float:
        return self._min if self.n else 0.0

    @property
    def max(self) -> float:
        return self._max if self.n else 0.0

    def summary(self) -> Dict[str, float]:
        return {"n": self.n, "mean": self.mean,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "min": self.min, "max": self.max}


class ServeMetrics:
    """Per-engine counters + TTFT / inter-token latency / occupancy."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.ttft = Histogram()
        self.per_token = Histogram()
        self.queue_delay = Histogram()
        self.counters = {"submitted": 0, "admitted": 0, "completed": 0,
                         "failed": 0, "preempted": 0, "rejected": 0,
                         "cancelled": 0, "deadline_expired": 0,
                         "tokens_out": 0, "prefill_chunks": 0,
                         "prefill_tokens": 0, "ticks": 0,
                         "decode_steps": 0, "decode_tokens": 0,
                         "kv_bytes_fused_est": 0, "kv_bytes_gathered_est": 0,
                         "prefill_kv_bytes_fused_est": 0,
                         "prefill_kv_bytes_gathered_est": 0,
                         "prefix_lookups": 0, "prefix_hit_requests": 0,
                         "prefix_queried_blocks": 0, "prefix_hit_blocks": 0,
                         "prefix_tokens_saved": 0, "prefix_cow_events": 0,
                         "prefix_cow_tokens": 0, "prefix_evictions": 0}
        # device-busy accounting: dispatch->sync windows, union-merged so
        # overlapping double-buffered steps never double-count
        self._busy_time = 0.0
        self._busy_until = float("-inf")
        self._admitted_once: set = set()
        # decode steps per attention path: a single last-write string
        # would hide mixed fused/gather runs (e.g. a capability
        # negotiation change mid-run), so count per path and report both
        self.decode_path_steps: Dict[str, int] = {}
        self.prefill_path_chunks: Dict[str, int] = {}
        self.occupancy: List[float] = []       # one sample per tick
        self.active: List[int] = []            # concurrent running seqs
        self.sharing: List[float] = []         # logical/physical blocks
        self.prefix_cached: List[int] = []     # cache-held blocks per tick
        self._t_submit: Dict[int, float] = {}
        self._t_last_tok: Dict[int, float] = {}
        self._t0 = clock()
        # throughput clock starts at FIRST ADMISSION, not construction:
        # engine construction / compile warmup would deflate tokens/s
        self._t_first_admit: Optional[float] = None

    # ------------------------------------------------------------------
    def on_submit(self, uid: int) -> None:
        self.counters["submitted"] += 1
        self._t_submit[uid] = self.clock()

    def on_admit(self, uid: int) -> None:
        self.counters["admitted"] += 1
        now = self.clock()
        if self._t_first_admit is None:
            self._t_first_admit = now
        # queue delay is submit -> FIRST admission (scheduling delay);
        # preempt-recompute re-admissions would re-observe cumulative
        # lifetimes and drown the signal
        if uid not in self._admitted_once:
            self._admitted_once.add(uid)
            self.queue_delay.observe(now - self._t_submit.get(uid, now))

    def on_reject(self, uid: int) -> None:
        self.counters["rejected"] += 1

    def on_preempt(self, uid: int) -> None:
        self.counters["preempted"] += 1

    def on_token(self, uid: int) -> None:
        now = self.clock()
        if uid not in self._t_last_tok:           # first token: TTFT
            self.ttft.observe(now - self._t_submit.get(uid, self._t0))
        else:
            self.per_token.observe(now - self._t_last_tok[uid])
        self._t_last_tok[uid] = now
        self.counters["tokens_out"] += 1

    def on_complete(self, uid: int) -> None:
        self.counters["completed"] += 1

    def on_fail(self, uid: int, error: Optional[str] = None) -> None:
        """Retired with an error (e.g. pool OOM truncation).  Client
        cancellations and deadline expiries additionally bump their own
        counters so load-shedding is visible separately from engine
        faults."""
        self.counters["failed"] += 1
        if error == "cancelled":
            self.counters["cancelled"] += 1
        elif error == "deadline":
            self.counters["deadline_expired"] += 1

    def on_device_interval(self, start: float, end: float) -> None:
        """One dispatch->sync device window (engine clock).  Windows are
        union-merged: under the double-buffered tick, step N's window
        overlaps the host work of step N+1, and summing raw durations
        would count busy time twice."""
        if end <= start:
            return
        s = max(start, self._busy_until)
        if end > s:
            self._busy_time += end - s
        self._busy_until = max(self._busy_until, end)

    def on_prefix_lookup(self, uid: int, queried_blocks: int,
                         hit_blocks: int, tokens_saved: int,
                         cow_tokens: int) -> None:
        """One admission-time prefix-index probe.  ``queried_blocks`` is
        how many full prompt blocks were eligible for adoption,
        ``hit_blocks`` how many were found live (== pool blocks saved),
        ``tokens_saved`` the prefill tokens skipped, and ``cow_tokens``
        the cached tokens that had to be RECOMPUTED into a private block
        because they sat in a partially-matching tail block
        (copy-on-write by recompute)."""
        self.counters["prefix_lookups"] += 1
        self.counters["prefix_queried_blocks"] += int(queried_blocks)
        self.counters["prefix_hit_blocks"] += int(hit_blocks)
        self.counters["prefix_tokens_saved"] += int(tokens_saved)
        if hit_blocks > 0:
            self.counters["prefix_hit_requests"] += 1
        if cow_tokens > 0:
            self.counters["prefix_cow_events"] += 1
            self.counters["prefix_cow_tokens"] += int(cow_tokens)

    def on_tick(self, occupancy: float, active: int,
                logical_blocks: Optional[int] = None,
                physical_blocks: Optional[int] = None,
                prefix_cached: Optional[int] = None,
                prefix_evictions: Optional[int] = None) -> None:
        self.counters["ticks"] += 1
        self.occupancy.append(float(occupancy))
        self.active.append(int(active))
        if logical_blocks is not None and physical_blocks:
            # effective-capacity gauge: block-table entries across running
            # sequences over distinct pool blocks in use.  > 1.0 means
            # sharing is letting logical context exceed physical KV.
            self.sharing.append(logical_blocks / physical_blocks)
        if prefix_cached is not None:
            self.prefix_cached.append(int(prefix_cached))
        if prefix_evictions is not None:
            self.counters["prefix_evictions"] = int(prefix_evictions)

    def on_prefill_chunk(self, tokens: int = 0, fused_bytes: int = 0,
                         gathered_bytes: int = 0,
                         path: Optional[str] = None) -> None:
        """One chunked-prefill dispatch: ``tokens`` is the chunk length,
        plus the analytic KV traffic of BOTH prefill attention paths for
        this chunk — the fused flash kernel streams only the sequence's
        own table-mapped blocks (scale rows included on int8 pools),
        while the gathered path materializes k/v/pos views over the full
        per-sequence capacity.  ``path`` is the one actually taken; the
        legacy zero-argument form just counts the chunk."""
        self.counters["prefill_chunks"] += 1
        self.counters["prefill_tokens"] += int(tokens)
        self.counters["prefill_kv_bytes_fused_est"] += int(fused_bytes)
        self.counters["prefill_kv_bytes_gathered_est"] += int(gathered_bytes)
        if path is not None:
            self.prefill_path_chunks[path] = \
                self.prefill_path_chunks.get(path, 0) + 1

    def on_decode_step(self, tokens: int, fused_bytes: int,
                       gathered_bytes: int, path: str) -> None:
        """One decode batch: ``tokens`` rows advanced, plus the analytic
        KV traffic of BOTH paged decode paths for this step (the engine
        computes them from live block counts; see
        ``PagedServeEngine._decode_kv_bytes``).  ``path`` is the one
        actually taken."""
        self.counters["decode_steps"] += 1
        self.counters["decode_tokens"] += int(tokens)
        self.counters["kv_bytes_fused_est"] += int(fused_bytes)
        self.counters["kv_bytes_gathered_est"] += int(gathered_bytes)
        self.decode_path_steps[path] = self.decode_path_steps.get(path, 0) + 1

    # ------------------------------------------------------------------
    @property
    def decode_path(self) -> Optional[str]:
        """The single decode path taken, or ``"mixed"`` when a run used
        more than one (``decode_path_steps`` has the per-path counts)."""
        if not self.decode_path_steps:
            return None
        if len(self.decode_path_steps) == 1:
            return next(iter(self.decode_path_steps))
        return "mixed"

    @property
    def prefill_path(self) -> Optional[str]:
        """The single prefill-attention path taken, or ``"mixed"``
        (``prefill_path_chunks`` has the per-path chunk counts)."""
        if not self.prefill_path_chunks:
            return None
        if len(self.prefill_path_chunks) == 1:
            return next(iter(self.prefill_path_chunks))
        return "mixed"

    def throughput(self) -> float:
        """Emitted tokens over wall time since the first admission (the
        construction timestamp is only the fallback when nothing was
        ever admitted, where the numerator is zero anyway)."""
        t0 = self._t_first_admit if self._t_first_admit is not None \
            else self._t0
        dt = self.clock() - t0
        return self.counters["tokens_out"] / dt if dt > 0 else 0.0

    def device_busy_fraction(self) -> float:
        """Fraction of serving wall time (since first admission) covered
        by a dispatched-but-unsynced decode step.  An *estimate of host-
        side overlap*, not a device counter: prefill-only phases count
        as idle on both tick modes, so the sync and async engines are
        directly comparable — the async engine's whole point is pushing
        this toward 1.0."""
        if self._t_first_admit is None:
            return 0.0
        dt = self.clock() - self._t_first_admit
        return min(1.0, self._busy_time / dt) if dt > 0 else 0.0

    def summary(self) -> Dict:
        occ = np.asarray(self.occupancy) if self.occupancy else np.zeros(1)
        act = np.asarray(self.active) if self.active else np.zeros(1)
        shr = np.asarray(self.sharing) if self.sharing else np.ones(1)
        ndec = max(self.counters["decode_tokens"], 1)
        npre = max(self.counters["prefill_tokens"], 1)
        nq = max(self.counters["prefix_queried_blocks"], 1)
        return {
            "counters": dict(self.counters),
            "ttft_s": self.ttft.summary(),
            "per_token_s": self.per_token.summary(),
            "queue_delay_s": self.queue_delay.summary(),
            "throughput_tok_s": self.throughput(),
            "device_busy_fraction": self.device_busy_fraction(),
            "occupancy": {"mean": float(occ.mean()),
                          "peak": float(occ.max())},
            "peak_active": int(act.max()),
            "paged_kernel": {
                "path": self.decode_path,
                "steps_by_path": dict(self.decode_path_steps),
                "kv_bytes_per_token_fused":
                    self.counters["kv_bytes_fused_est"] / ndec,
                "kv_bytes_per_token_gathered":
                    self.counters["kv_bytes_gathered_est"] / ndec,
                "prefill_path": self.prefill_path,
                "prefill_chunks_by_path": dict(self.prefill_path_chunks),
                "kv_bytes_per_prefill_token_fused":
                    self.counters["prefill_kv_bytes_fused_est"] / npre,
                "kv_bytes_per_prefill_token_gathered":
                    self.counters["prefill_kv_bytes_gathered_est"] / npre,
            },
            "prefix_cache": {
                "hit_rate": self.counters["prefix_hit_blocks"] / nq,
                "blocks_saved": self.counters["prefix_hit_blocks"],
                "tokens_saved": self.counters["prefix_tokens_saved"],
                "cow_events": self.counters["prefix_cow_events"],
                "evictions": self.counters["prefix_evictions"],
                "cached_blocks_peak":
                    max(self.prefix_cached) if self.prefix_cached else 0,
            },
            "effective_capacity": {     # 1.0 == no sharing (cache off)
                "mean": float(shr.mean()),
                "peak": float(shr.max()),
            },
        }

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s
