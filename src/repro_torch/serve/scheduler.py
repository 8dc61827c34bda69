"""Serving scheduler: FCFS admission by free-block budget, prefix-cache
hits mapped onto live blocks at admission, chunked prefill over the
length buckets, decode/prefill interleaving, and preempt-by-recompute
when the block pool runs dry.

The port's own copy of ``repro.serve.scheduler``: pure host-side
bookkeeping over a :class:`~repro_torch.serve.paging.BlockPool` (plus an
optional :class:`~repro_torch.serve.paging.PrefixCache`), no model, so
every policy is unit-testable without running one.  The engine executes
one :class:`TickPlan` per tick:

  1. register newly completed full prompt blocks in the prefix index
     (their KV is final and immutable from here on);
  2. admit waiting requests FCFS while a batch row is free and the pool
     can cover the prompt plus a decode-headroom reserve.  With a
     prefix cache, the request's prompt is first probed against the
     index: hit blocks are adopted by reference (``BlockPool.share``)
     and their prefill is SKIPPED — the admission budget counts only
     the NEW blocks the request needs, so a mostly-cache-resident
     request is never deferred for blocks it will not allocate.
     Requests that could never fit are rejected outright, not queued
     forever;
  3. top up decode blocks for every fully-prefilled sequence (one new
     block each time its length crosses a block boundary), evicting
     cache-only blocks and then preempting the youngest running
     sequence when the pool is dry;
  4. pick one prefill chunk (bucket-sized, FCFS) and allocate its blocks.

Ownership / refcount / immutability invariants the policies maintain
(see also ``serve/paging.py``):

  * a sequence's writes — decode appends at ``kv_len``, prefill chunks
    over ``[kv_len, kv_len + length)`` — always land in blocks whose
    SOLE holder is that sequence.  Shared (refcount > 1) blocks are
    immutable: only fully-written prompt blocks are ever registered or
    adopted, and adoption stops at least one token short of the prompt
    end so the partially-filled tail block is always private
    (copy-on-write by recompute);
  * ``finish`` and preemption release by decref: a shared block
    survives until its last holder (sequence or cache) lets go, so
    refcounts never go negative and no sequence ever loses a block it
    still references;
  * preempt-by-recompute victims re-enter the waiting queue and
    RE-PROBE the index on re-admission, so their own registered blocks
    (kept alive by the cache's reference) make the recompute cheap.

Preemption is by *recompute*: the victim's holds are released and the
request re-enters the waiting queue with its generated tokens folded
into the prompt, so re-admission prefills the whole (uncached) prefix
and greedy decoding continues token-for-token where it left off.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

from repro_torch.obs import trace as obs_trace
from repro_torch.serve.paging import BlockPool, PrefixCache


@dataclasses.dataclass
class SeqState:
    """A request occupying a batch row, with its block table.

    ``kv_len`` counts tokens whose KV is cached.  During prefill
    ``kv_len < prefill_target``; during decode ``len(tokens) ==
    kv_len + 1`` (the last sampled token is the pending model input).
    A prefix-cache hit starts the sequence at ``kv_len ==
    shared_tokens`` with the adopted blocks already in ``table`` —
    those leading blocks are shared and must never be written.

    Under the async engine ``kv_len`` is *projected*: it advances at
    dispatch, one tick before the host sees the sampled token, and
    ``inflight`` counts tokens sampled on-device but not yet emitted.
    The scheduler itself needs no async awareness — planning against
    projected state is exactly planning one tick ahead.  ``retiring``
    marks a sequence whose blocks and row were already released at
    dispatch (count-based retire) while its last tokens are still in
    flight; completion bookkeeping happens at emission.
    """
    req: object                        # serve.engine.Request
    row: int
    admit_seq: int
    prefill_target: int
    kv_len: int = 0
    table: List[int] = dataclasses.field(default_factory=list)
    inflight: int = 0                  # sampled on device, not yet emitted
    retiring: bool = False             # freed at dispatch, awaiting emission
    # --- prefix-cache bookkeeping (all zero when the cache is off) ----
    shared_tokens: int = 0             # tokens adopted from the index
    prefix_queried: int = 0            # full prompt blocks probed
    prefix_hit: int = 0                # blocks adopted (== blocks saved)
    cow_tokens: int = 0                # cached tokens recomputed (CoW)
    reg_key: Optional[int] = None      # chain key of last registered block
    reg_blocks: int = 0                # full blocks registered/adopted
    reg_stopped: bool = False          # hash-collision guard tripped

    @property
    def uid(self):
        return self.req.uid

    @property
    def tokens(self) -> list:
        return list(self.req.prompt) + self.req.out_tokens


@dataclasses.dataclass
class PrefillChunk:
    seq: SeqState
    start: int                         # absolute position of first token
    length: int                        # real tokens in the chunk


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
                 max_seq_len: int = 0,
                 prefix_cache: Optional[PrefixCache] = None,
                 tracer=None):
        self.pool = pool
        self.prefix = prefix_cache
        # scheduling-decision trace hooks (prefix probes, evictions,
        # preemptions); a NullTracer when observability is off
        self.trace = tracer if tracer is not None else obs_trace.NULL
        self.buckets = sorted(buckets)
        self.max_blocks_per_seq = max_blocks_per_seq
        # the TOKEN bound, which is tighter than the block bound whenever
        # max_seq_len is not a multiple of block_size: admission must
        # compare against it or a sequence legally decodes up to
        # block_size-1 tokens past max_seq_len inside its last block
        # (overrunning learned-position tables)
        self.max_seq_len = max_seq_len or max_blocks_per_seq * pool.block_size
        self.decode_reserve = decode_reserve
        self.waiting: deque = deque()
        self.running: List[SeqState] = []
        self._free_rows = list(range(rows - 1, -1, -1))   # pop() -> row 0 first
        self._admit_counter = 0

    # ------------------------------------------------------------------
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

    # ------------------------------------------------------------------
    def _available(self) -> int:
        """Blocks an allocation could obtain right now: the free list
        plus cache-only blocks the prefix index would evict on demand.
        Budget checks must use this, or a warm cache (which deliberately
        keeps the pool occupied) would starve admission."""
        extra = self.prefix.evictable() if self.prefix is not None else 0
        return self.pool.free_blocks + extra

    def _alloc(self, owner, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, evicting cache-only prefix blocks
        first when the free list alone cannot cover the request."""
        if self.prefix is not None and n > self.pool.free_blocks:
            want = n - self.pool.free_blocks
            before = self.pool.free_blocks
            self.prefix.evict(want)
            self.trace.instant("prefix_evict", track="engine/evict",
                               cat="scheduler", owner=owner, want=want,
                               freed=self.pool.free_blocks - before)
        return self.pool.alloc(owner, n)

    # ------------------------------------------------------------------
    def finish(self, seq: SeqState) -> None:
        """Retire a sequence: release its block holds (shared blocks
        survive in the prefix cache) and free its batch row."""
        self.pool.free(seq.table, seq.uid)
        seq.table = []
        self.running.remove(seq)
        self._free_rows.append(seq.row)

    def _preempt(self, seq: SeqState) -> None:
        """Preempt-by-recompute: decref every held block (NOT a hard
        free — blocks shared with the cache or other sequences live
        on), requeue at the front (victims are popped youngest-first,
        so repeated appendleft keeps the waiting queue in original
        arrival order).  Re-admission re-probes the prefix index, so
        the victim's own registered blocks make the recompute cheap."""
        self.pool.free(seq.table, seq.uid)
        seq.table = []
        seq.kv_len = 0
        self.running.remove(seq)
        self._free_rows.append(seq.row)
        self.waiting.appendleft(seq.req)

    def _youngest(self, than: Optional[SeqState] = None) -> Optional[SeqState]:
        """Latest-admitted running sequence (optionally strictly younger
        than ``than``) — the preemption victim, vLLM-style."""
        cands = self.running
        if than is not None:
            cands = [s for s in cands if s.admit_seq > than.admit_seq]
        return max(cands, key=lambda s: s.admit_seq) if cands else None

    def _record_preempt(self, plan: TickPlan, victim: SeqState) -> None:
        """Preempt ``victim`` and keep the plan's event lists consistent.

        A victim admitted THIS tick is a net no-op (it never held KV or
        ran a step): it is dropped from ``plan.admitted`` instead of
        appearing in both lists, so the engine's admit/preempt metrics
        see it exactly zero times — the invariant the engine asserts.
        """
        self.trace.instant("preempt", track="engine/preempt",
                           cat="scheduler", uid=victim.uid,
                           kv_len=victim.kv_len,
                           blocks_held=len(victim.table),
                           same_tick=victim in plan.admitted)
        self._preempt(victim)
        if victim in plan.admitted:
            plan.admitted.remove(victim)
        else:
            plan.preempted.append(victim)
        if victim in plan.decode:
            plan.decode.remove(victim)

    # ------------------------------------------------------------------
    def plan_tick(self) -> TickPlan:
        plan = TickPlan()
        self._register_prefixes()
        self._admit(plan)
        self._plan_decode(plan)
        self._plan_prefill(plan)
        return plan

    def _register_prefixes(self) -> None:
        """Index every newly completed full prompt block.  A block is
        registered only once ``(j + 1) * block_size <= min(kv_len,
        prefill_target)`` — its contents are final (prefill only moves
        forward, decode writes land past ``prefill_target``), so the
        immutability contract holds the moment it becomes adoptable."""
        if self.prefix is None:
            return
        bs = self.pool.block_size
        for seq in self.running:
            full = min(seq.kv_len, seq.prefill_target) // bs
            if seq.reg_stopped or seq.reg_blocks >= full:
                continue
            toks = seq.tokens
            while seq.reg_blocks < full:
                j = seq.reg_blocks
                chunk = tuple(int(t) for t in toks[j * bs:(j + 1) * bs])
                key = self.prefix.register(seq.reg_key, chunk, seq.table[j])
                if key is None:          # hash collision: stop this chain
                    seq.reg_stopped = True
                    break
                seq.reg_key = key
                seq.reg_blocks += 1

    def _admit(self, plan: TickPlan) -> None:
        """FCFS: stop at the first request the budget can't cover (no
        skip-ahead — later, shorter requests must not starve the head)."""
        reserved = 0     # blocks promised to seqs admitted THIS tick
                         # (allocation happens later, at prefill/decode)
        bs = self.pool.block_size
        while self.waiting and self._free_rows:
            req = self.waiting[0]
            if len(req.prompt) == 0:
                self.waiting.popleft()
                req.error = "empty_prompt"
                req.done = True
                plan.rejected.append(req)
                continue
            # final KV footprint: generation stops at max_new_tokens, so
            # tokens already generated (preempt-recompute) don't add to it
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
            # prefix probe: adopt the longest cached chain, capped one
            # token short of the prefill target — the model must still
            # compute the last prompt token's logits, and that keeps
            # the partially-filled tail block private (CoW-by-recompute:
            # shared blocks are never written)
            hits, last_key, cow = [], None, 0
            cap = (target - 1) // bs
            if self.prefix is not None and cap > 0:
                t0 = self.trace.now_us()
                toks = list(req.prompt) + req.out_tokens
                hits, last_key = self.prefix.lookup(toks, cap)
                tail = toks[len(hits) * bs:
                            min((len(hits) + 1) * bs, target)]
                cow = self.prefix.cached_overlap(last_key, tail)
                # emitted as a closed span so the probe's cost AND its
                # outcome (hit/cow counts) land in one trace event
                self.trace.emit("prefix_lookup", "X", t0, "engine/prefix",
                                "scheduler", dur=self.trace.now_us() - t0,
                                args=dict(uid=req.uid, queried_blocks=cap,
                                          hit_blocks=len(hits),
                                          cow_tokens=cow))
            # decode headroom, capped by the sequence's FINAL footprint:
            # a prompt that fills its last block only partially decodes
            # into that block, so demanding an extra reserve block it
            # will never use can wedge admission forever when the final
            # footprint equals pool capacity (found by the fuzz suite).
            # Hit blocks are adopted by reference, never allocated, so
            # the budget counts only the NEW blocks this request needs
            # — a mostly-cache-resident request must not be deferred
            # for blocks it already has.
            need_now = min(self.pool.blocks_for(target) + self.decode_reserve,
                           need_total) - len(hits)
            if self._available() - reserved < max(need_now, 0):
                break
            reserved += max(need_now, 0)
            self.waiting.popleft()
            seq = SeqState(req=req, row=self._free_rows.pop(),
                           admit_seq=self._admit_counter,
                           prefill_target=target,
                           kv_len=len(hits) * bs, table=list(hits),
                           shared_tokens=len(hits) * bs,
                           prefix_queried=cap, prefix_hit=len(hits),
                           cow_tokens=cow,
                           reg_key=last_key, reg_blocks=len(hits))
            if hits:
                self.pool.share(hits, req.uid)
            self._admit_counter += 1
            self.running.append(seq)
            plan.admitted.append(seq)

    def _plan_decode(self, plan: TickPlan) -> None:
        for seq in list(self.running):
            if seq not in self.running:        # preempted by an older seq
                continue
            if seq.kv_len < seq.prefill_target:
                continue
            # next write position is kv_len; top up its block if needed
            needed = self.pool.blocks_for(seq.kv_len + 1)
            skip = False
            while len(seq.table) < needed:
                blks = self._alloc(seq.uid, 1)
                if blks is not None:
                    seq.table.extend(blks)
                    continue
                # pool dry even after cache eviction: preempt the
                # youngest running sequence — which may be this one (an
                # older request's blocks are never stolen for a younger
                # decode)
                victim = self._youngest()
                if victim is seq and len(self.running) == 1:
                    # alone yet out of blocks: the request can never fit
                    # (admission bounds should prevent this)
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
        """One bucket-sized chunk per tick, FCFS over running sequences.
        Only strictly-younger sequences may be preempted for a prefill
        (never steal blocks from an older request's decode)."""
        for seq in self.running:
            if seq.kv_len >= seq.prefill_target:
                continue
            length = min(seq.prefill_target - seq.kv_len, self.buckets[-1])
            need = self.pool.blocks_for(seq.kv_len + length) - len(seq.table)
            while need > 0:
                if need <= self._available():
                    blks = self._alloc(seq.uid, need)
                    if blks is not None:
                        seq.table.extend(blks)
                        break
                    # _available() promised blocks eviction could not
                    # actually deliver (e.g. a cache-only parent pinned
                    # under a live child) — fall through and preempt
                victim = self._youngest(than=seq)
                if victim is None:
                    return                     # defer the chunk to a later tick
                self._record_preempt(plan, victim)
            plan.prefill = PrefillChunk(seq=seq, start=seq.kv_len,
                                        length=length)
            return
