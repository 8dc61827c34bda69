"""Continuous-batching engines (synchronous tick).

``PagedServeEngine`` is the counterpart of
``repro.serve.engine.PagedServeEngine.step``/``run``: KV lives in a
shared block pool, the scheduler admits FCFS by free-block budget,
prefill runs in bucket-sized chunks written straight into the pool, one
decode batch and at most one prefill chunk run every tick, and the pool
preempts by recompute when it runs dry.

``ServeEngine`` is the counterpart of the reference's fixed-slot engine
over a contiguous cache (one ``cache_len`` row per request): each prompt
is left-padded into its bucket and prefilled on a 1-row cache that is
spliced into the grid, and one decode step advances every slot.  It is
the fallback for configs the paged engine refuses (``supports_paging``)
and the paged engine's equivalence oracle.  It refuses an
encoder-decoder at construction: its requests carry no ``frames``
(the reference's engine fails on the first prefill with a
``KeyError``); such a model is driven through ``Model.prefill`` and
``Model.decode_step``.

Sampling is greedy on the host (``np.argmax``, ties to the lowest
index, as the reference's ``_sample_host``).

Not ported yet (ROADMAP.md queue 1 item 9): temperature sampling (the
reference derives its keys from ``jax.random``), the double-buffered
async tick and frontend, the prefix cache, tracing, deadlines and mesh
serving.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.attention import (kv_entry_bytes, paged_kernel_mode,
                                          paged_prefill_mode)
from repro_torch.models.model import set_block_tables
from repro_torch.models.transformer import layer_plan
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paging import BlockPool
from repro_torch.serve.scheduler import Scheduler


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int = 32
    temperature: float = 0.0      # only greedy (0) is ported
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    on_token: Optional[Callable] = None
    error: Optional[str] = None


def _emit(req: Request, tok: int) -> None:
    req.out_tokens.append(int(tok))
    cb = req.on_token
    if cb is None:
        return
    try:
        cb(int(tok), req)
    except Exception:
        # a broken streaming consumer fails ITS request only
        req.error = "callback"
        req.on_token = None


def _sample_host(req: Request, logits_row: np.ndarray) -> int:
    if req.temperature > 0:
        raise NotImplementedError("temperature sampling is not ported yet "
                                  "(ROADMAP.md queue 1 item 9)")
    return int(np.argmax(logits_row))


def _refuse_temperature(req: Request) -> None:
    if req.temperature > 0:
        raise NotImplementedError(
            "temperature sampling is not ported yet (ROADMAP.md queue 1 "
            "item 9); submit greedy requests (temperature=0)")


def supports_paging(cfg) -> bool:
    """Whether a config can serve through the paged engine: an
    attention-only decoder, no sliding window (a ring cache is already a
    fixed-size reservation), no encoder-decoder cross-KV."""
    return (not cfg.is_encdec and not cfg.sliding_window
            and all(mixer == "attn" for mixer, _ in layer_plan(cfg)))


def check_servable(cfg) -> None:
    """Refuse a config that neither engine serves: an encoder-decoder,
    whose encoder needs frames that a request does not carry (the
    reference's ``ServeEngine`` passes only ``{"tokens": ...}`` to
    ``Model.prefill`` and fails with ``KeyError: 'frames'``)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: neither engine serves it, "
            "because a request carries only tokens and the encoder needs "
            "frames (the reference's ServeEngine passes only {'tokens': "
            "...} to Model.prefill and fails with KeyError: 'frames'); "
            "drive the model API instead: Model.prefill(tokens, cache, "
            "frames=...), then Model.decode_step")


class PagedServeEngine:
    """Continuous batching over a paged KV cache (see module docstring).

    ``paged_kernel`` ("auto" | "fused" | "gather", default: the model
    config's) picks the paged attention path; ``decode_path`` and
    ``prefill_path`` report the one taken."""

    def __init__(self, model, *, num_blocks: int = 64, block_size: int = 16,
                 max_batch: int = 8, max_seq_len: int = 0,
                 prefill_buckets=(32, 128, 512),
                 paged_kernel: Optional[str] = None,
                 clock=time.perf_counter):
        if paged_kernel is not None and paged_kernel != model.cfg.paged_kernel:
            model = model.with_config(paged_kernel=paged_kernel)
        self.model = model
        self.max_batch = max_batch
        self.block_size = block_size
        self.buckets = sorted(prefill_buckets)
        max_seq_len = max_seq_len or model.cfg.max_seq_len
        self.max_seq_len = max_seq_len
        self.max_blocks_per_seq = -(-max_seq_len // block_size)
        self.decode_path = paged_kernel_mode(model.cfg)
        self.prefill_path = paged_prefill_mode(model.cfg)
        # MLA: the latent + rotary key; int8 pools: with their scale rows
        self._kv_entry_bytes = kv_entry_bytes(model.cfg)
        self.cache = model.init_paged_cache(max_batch, num_blocks, block_size,
                                            self.max_blocks_per_seq)
        self.pool = BlockPool(num_blocks, block_size)
        self.sched = Scheduler(self.pool, rows=max_batch, buckets=self.buckets,
                               max_blocks_per_seq=self.max_blocks_per_seq,
                               max_seq_len=max_seq_len)
        self.clock = clock
        self.metrics = ServeMetrics(clock)
        self.tables = np.full((max_batch, self.max_blocks_per_seq), -1,
                              np.int32)
        self.ticks = 0
        self.finished: list = []

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        _refuse_temperature(req)
        self.metrics.on_submit(req.uid)
        self.sched.submit(req)

    def _sync_tables(self) -> None:
        self.tables.fill(-1)
        for seq in self.sched.running:
            self.tables[seq.row, :len(seq.table)] = seq.table

    def _finalize_detached(self, req: Request) -> None:
        req.done = True
        self.finished.append(req)
        if req.error:
            self.metrics.on_fail(req.uid, req.error)
        else:
            self.metrics.on_complete(req.uid)

    def _retire(self, seq) -> None:
        self.sched.finish(seq)
        self._finalize_detached(seq.req)

    def _decode_kv_bytes(self, decode) -> tuple:
        """Analytic per-step KV traffic of both decode paths (bytes): the
        fused kernels read each live block once per layer; the gathered
        path makes 3 view-sized copies of the full table capacity."""
        per_layer = self.block_size * self._kv_entry_bytes
        live = sum(len(seq.table) for seq in decode)
        layers = self.model.cfg.n_layers
        fused = live * per_layer * layers
        gathered = 3 * self.max_batch * self.max_blocks_per_seq \
            * per_layer * layers
        return fused, gathered

    def _prefill_kv_bytes(self, seq) -> tuple:
        per_layer = self.block_size * self._kv_entry_bytes
        layers = self.model.cfg.n_layers
        fused = len(seq.table) * per_layer * layers
        gathered = 3 * self.max_blocks_per_seq * per_layer * layers
        return fused, gathered

    def _emit_token(self, seq, tok: int) -> None:
        _emit(seq.req, tok)
        self.metrics.on_token(seq.req.uid)
        if seq.req.error == "callback":
            self._retire(seq)
            return
        # retire at the TOKEN bound, not the block-rounded capacity
        if len(seq.req.out_tokens) >= seq.req.max_new_tokens \
                or seq.kv_len + 1 >= self.max_seq_len:
            self._retire(seq)

    def _masked_tables(self, decode) -> np.ndarray:
        tables = self.tables.copy()
        rows = {seq.row for seq in decode}
        for r in range(self.max_batch):
            if r not in rows:
                tables[r] = -1       # idle rows write to the trash block
        return tables

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One synchronous tick: plan, one decode batch, at most one
        prefill chunk, greedy sampling on the host."""
        plan = self.sched.plan_tick()
        for req in plan.rejected:
            self.metrics.on_reject(req.uid)
            self.finished.append(req)
        for seq in plan.admitted:
            self.metrics.on_admit(seq.req.uid)
        for seq in plan.preempted:
            self.metrics.on_preempt(seq.req.uid)
        for seq in plan.failed:
            self._retire(seq)
        self._sync_tables()
        dev = self.model.device

        if plan.decode:
            tables = self._masked_tables(plan.decode)
            tokens = np.zeros((self.max_batch, 1), np.int32)
            posv = np.zeros(self.max_batch, np.int32)
            for seq in plan.decode:
                tokens[seq.row, 0] = seq.req.out_tokens[-1]
                posv[seq.row] = seq.kv_len
            cache = set_block_tables(self.cache, tables)
            t_disp = self.clock()
            logits, self.cache = self.model.decode_step(
                torch.from_numpy(tokens).to(dev), cache,
                torch.from_numpy(posv).to(dev))
            logits = logits.float().cpu().numpy()
            self.metrics.on_device_interval(t_disp, self.clock())
            fused_b, gathered_b = self._decode_kv_bytes(plan.decode)
            self.metrics.on_decode_step(len(plan.decode), fused_b,
                                        gathered_b, self.decode_path)
            for seq in plan.decode:
                seq.kv_len += 1
                self._emit_token(seq, _sample_host(seq.req, logits[seq.row]))

        if plan.prefill is not None:
            pf = plan.prefill
            seq, start, clen = pf.seq, pf.start, pf.length
            bucket = self.sched.bucket(clen)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :clen] = seq.tokens[start:start + clen]
            cache = set_block_tables(self.cache,
                                     self.tables[seq.row:seq.row + 1])
            logits, self.cache = self.model.prefill_chunk(
                torch.from_numpy(toks).to(dev), cache, start, clen - 1)
            fused_b, gathered_b = self._prefill_kv_bytes(seq)
            self.metrics.on_prefill_chunk(clen, fused_b, gathered_b,
                                          self.prefill_path)
            seq.kv_len += clen
            if seq.kv_len >= seq.prefill_target:
                row = logits.float().cpu().numpy()[0]
                self._emit_token(seq, _sample_host(seq.req, row))

        self.ticks += 1
        self.metrics.on_tick(self.pool.occupancy(), self.sched.active)

    def _drain_tick_budget(self) -> None:
        for seq in list(self.sched.running):
            seq.req.error = "tick_budget"
            self._retire(seq)
        while self.sched.waiting:
            req = self.sched.waiting.popleft()
            req.error = req.error or "tick_budget"
            self._finalize_detached(req)

    def run(self, requests: list, max_ticks: int = 1000) -> list:
        for req in requests:
            self.submit(req)
        while self.sched.has_work() and self.ticks < max_ticks:
            self.step()
        if self.sched.has_work():
            self._drain_tick_budget()
        return self.finished


# ---------------------------------------------------------------------------
# contiguous fixed-slot engine (fallback and oracle)
# ---------------------------------------------------------------------------


class ServeEngine:
    """Continuous batching over a fixed slot grid (one full ``cache_len``
    row per request; see the module docstring).  Left-pads get negative
    positions, so the attention pos-mask makes a padded prompt score
    exactly as the unpadded one in attention layers.  SSM layers have no
    position mask: the pads' embeddings enter their conv window and
    state, as in the reference."""

    def __init__(self, model, *, slots: int = 8, cache_len: int = 512,
                 prefill_buckets=(32, 128, 512), rng_seed: int = 0):
        check_servable(model.cfg)
        self.model = model
        self.slots = slots
        self.cache_len = cache_len
        self.buckets = sorted(prefill_buckets)
        self.cache = model.init_cache(slots, cache_len)
        self.slot_req: list = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self.rng_seed = rng_seed     # kept for temperature sampling (item 9)
        self.ticks = 0

    # ------------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]          # longer prompts: round up to the
        return -(-n // top) * top       # top bucket

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def add_request(self, req: Request) -> bool:
        """Prefill into a free slot; False if every slot is taken."""
        _refuse_temperature(req)
        free = self._free_slots()
        if not free:
            return False
        plen = len(req.prompt)
        if plen == 0:
            req.error = "empty_prompt"
            req.done = True
            return True
        if plen >= self.cache_len - 1:       # cannot hold prompt + 1 decode
            req.error = "too_long"
            req.done = True
            return True
        slot = free[0]
        bucket = self._bucket(plen)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, -plen:] = req.prompt          # left-pad into the bucket
        # prefill a 1-row cache, then splice it into the grid; the pads sit
        # at negative positions (real tokens at 0..plen-1)
        small = self.model.init_cache(1, self.cache_len)
        logits, small = self.model.prefill(
            torch.from_numpy(toks).to(self.model.device), small,
            plen - bucket)
        _splice_cache(self.cache, small, slot)
        _emit(req, _sample_host(req, logits.float().cpu().numpy()[0]))
        if req.error == "callback" \
                or len(req.out_tokens) >= req.max_new_tokens:
            req.done = True                   # done (or its consumer broke):
            return True                       # the slot stays free
        self.slot_req[slot] = req
        self.slot_pos[slot] = plen
        return True

    def tick(self) -> list:
        """One decode step for every slot; returns the requests that
        retired this tick."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return []
        tokens = np.zeros((self.slots, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slot_req[i].out_tokens[-1]
        dev = self.model.device
        logits, self.cache = self.model.decode_step(
            torch.from_numpy(tokens).to(dev), self.cache,
            torch.from_numpy(self.slot_pos.copy()).to(dev))
        logits = logits.float().cpu().numpy()
        retired = []
        for i in active:
            req = self.slot_req[i]
            _emit(req, _sample_host(req, logits[i]))
            self.slot_pos[i] += 1
            if req.error == "callback" \
                    or len(req.out_tokens) >= req.max_new_tokens \
                    or self.slot_pos[i] >= self.cache_len - 1:
                req.done = True
                retired.append(req)
                self.slot_req[i] = None
        self.ticks += 1
        return retired

    def run(self, requests: list, max_ticks: int = 1000) -> list:
        """Admit while slots are free, tick until every request is done."""
        pending = deque(requests)
        done = []
        while (pending or any(r is not None for r in self.slot_req)) \
                and self.ticks < max_ticks:
            while pending and self._free_slots():
                req = pending[0]
                if not self.add_request(req):
                    break
                pending.popleft()
                if req.done:
                    done.append(req)
            done.extend(self.tick())
        return done


def _splice_cache(big: dict, small: dict, slot: int) -> None:
    """Copy a 1-row cache into row ``slot`` of the engine's cache, in
    place: every leaf of every layer along dim 0 (the port's cache is a
    per-layer list of flat dicts, with no stacked layers axis; a Mamba
    layer's leaves are its conv window and its state)."""
    for b_layer, s_layer in zip(big["layers"], small["layers"]):
        for key, val in s_layer.items():
            b_layer[key][slot:slot + 1].copy_(val)
