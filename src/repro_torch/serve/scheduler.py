"""Serving scheduler: FCFS admission by free-block budget, chunked
prefill over the length buckets, decode/prefill interleaving, and
preempt-by-recompute when the block pool runs dry.

The port's own copy of ``repro.serve.scheduler`` (pure host bookkeeping
over a :class:`~repro_torch.serve.paging.BlockPool`), without the prefix
cache, which is not ported yet.  Each tick's :class:`TickPlan`:

  1. admits waiting requests FCFS while a batch row is free and the pool
     can cover the prompt plus a decode-headroom reserve (requests that
     could never fit are rejected, not queued forever);
  2. tops up decode blocks for every fully-prefilled sequence, preempting
     the youngest running sequence when the pool is dry;
  3. picks one bucket-sized prefill chunk (FCFS) and allocates its blocks.

Preemption is by recompute: the victim's blocks are released and its
request re-enters the front of the queue with its generated tokens
folded into the prompt, so greedy decoding continues token for token.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

from repro_torch.serve.paging import BlockPool


@dataclasses.dataclass
class SeqState:
    """A request occupying a batch row, with its block table.  During
    prefill ``kv_len < prefill_target``; during decode ``len(tokens) ==
    kv_len + 1`` (the last sampled token is the pending input)."""
    req: object
    row: int
    admit_seq: int
    prefill_target: int
    kv_len: int = 0
    table: List[int] = dataclasses.field(default_factory=list)

    @property
    def uid(self):
        return self.req.uid

    @property
    def tokens(self) -> list:
        return list(self.req.prompt) + self.req.out_tokens


@dataclasses.dataclass
class PrefillChunk:
    seq: SeqState
    start: int
    length: int


@dataclasses.dataclass
class TickPlan:
    admitted: List[SeqState] = dataclasses.field(default_factory=list)
    decode: List[SeqState] = dataclasses.field(default_factory=list)
    prefill: Optional[PrefillChunk] = None
    preempted: List[SeqState] = dataclasses.field(default_factory=list)
    rejected: List[object] = dataclasses.field(default_factory=list)
    failed: List[SeqState] = dataclasses.field(default_factory=list)


class Scheduler:
    def __init__(self, pool: BlockPool, rows: int, buckets,
                 max_blocks_per_seq: int, decode_reserve: int = 1,
                 max_seq_len: int = 0):
        self.pool = pool
        self.buckets = sorted(buckets)
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_seq_len = max_seq_len or max_blocks_per_seq * pool.block_size
        self.decode_reserve = decode_reserve
        self.waiting: deque = deque()
        self.running: List[SeqState] = []
        self._free_rows = list(range(rows - 1, -1, -1))
        self._admit_counter = 0

    def submit(self, req) -> None:
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def active(self) -> int:
        return len(self.running)

    def bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def finish(self, seq: SeqState) -> None:
        """Retire a sequence: release its blocks and batch row."""
        self.pool.free(seq.table, seq.uid)
        seq.table = []
        self.running.remove(seq)
        self._free_rows.append(seq.row)

    def _preempt(self, seq: SeqState) -> None:
        self.pool.free(seq.table, seq.uid)
        seq.table = []
        seq.kv_len = 0
        self.running.remove(seq)
        self._free_rows.append(seq.row)
        self.waiting.appendleft(seq.req)

    def _youngest(self, than: Optional[SeqState] = None):
        cands = self.running
        if than is not None:
            cands = [s for s in cands if s.admit_seq > than.admit_seq]
        return max(cands, key=lambda s: s.admit_seq) if cands else None

    def _record_preempt(self, plan: TickPlan, victim: SeqState) -> None:
        """A victim admitted this tick is a net no-op: it leaves
        ``plan.admitted`` instead of entering ``plan.preempted``."""
        self._preempt(victim)
        if victim in plan.admitted:
            plan.admitted.remove(victim)
        else:
            plan.preempted.append(victim)
        if victim in plan.decode:
            plan.decode.remove(victim)

    def plan_tick(self) -> TickPlan:
        plan = TickPlan()
        self._admit(plan)
        self._plan_decode(plan)
        self._plan_prefill(plan)
        return plan

    def _admit(self, plan: TickPlan) -> None:
        reserved = 0
        while self.waiting and self._free_rows:
            req = self.waiting[0]
            if len(req.prompt) == 0:
                self.waiting.popleft()
                req.error = "empty_prompt"
                req.done = True
                plan.rejected.append(req)
                continue
            total = len(req.prompt) + req.max_new_tokens
            need_total = self.pool.blocks_for(total)
            if total > self.max_seq_len or \
                    need_total > min(self.pool.capacity,
                                     self.max_blocks_per_seq):
                self.waiting.popleft()
                req.error = "too_long"
                req.done = True
                plan.rejected.append(req)
                continue
            target = len(req.prompt) + len(req.out_tokens)
            need_now = min(self.pool.blocks_for(target) + self.decode_reserve,
                           need_total)
            if self.pool.free_blocks - reserved < need_now:
                break
            reserved += need_now
            self.waiting.popleft()
            seq = SeqState(req=req, row=self._free_rows.pop(),
                           admit_seq=self._admit_counter,
                           prefill_target=target)
            self._admit_counter += 1
            self.running.append(seq)
            plan.admitted.append(seq)

    def _plan_decode(self, plan: TickPlan) -> None:
        for seq in list(self.running):
            if seq not in self.running:
                continue
            if seq.kv_len < seq.prefill_target:
                continue
            needed = self.pool.blocks_for(seq.kv_len + 1)
            skip = False
            while len(seq.table) < needed:
                blks = self.pool.alloc(seq.uid, 1)
                if blks is not None:
                    seq.table.extend(blks)
                    continue
                victim = self._youngest()
                if victim is seq and len(self.running) == 1:
                    seq.req.error = "oom"
                    plan.failed.append(seq)
                    skip = True
                    break
                self._record_preempt(plan, victim)
                if victim is seq:
                    skip = True
                    break
            if not skip:
                plan.decode.append(seq)

    def _plan_prefill(self, plan: TickPlan) -> None:
        """One bucket-sized chunk per tick; only strictly-younger
        sequences may be preempted for a prefill."""
        for seq in self.running:
            if seq.kv_len >= seq.prefill_target:
                continue
            length = min(seq.prefill_target - seq.kv_len, self.buckets[-1])
            need = self.pool.blocks_for(seq.kv_len + length) - len(seq.table)
            while need > 0:
                blks = self.pool.alloc(seq.uid, need)
                if blks is not None:
                    seq.table.extend(blks)
                    break
                victim = self._youngest(than=seq)
                if victim is None:
                    return
                self._record_preempt(plan, victim)
            plan.prefill = PrefillChunk(seq=seq, start=seq.kv_len,
                                        length=length)
            return
