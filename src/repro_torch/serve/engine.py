"""Continuous-batching engines of the port.

``PagedServeEngine`` is the counterpart of
``repro.serve.engine.PagedServeEngine``: KV lives in a shared block
pool, the scheduler admits FCFS by free-block budget, prefill runs in
bucket-sized chunks written straight into the pool, one decode batch and
at most one prefill chunk run every tick, and the pool preempts by
recompute when it runs dry.  With ``prefix_cache=True`` full prompt
blocks are indexed by their tokens and later requests with the same
block-aligned prefix adopt them (shared, never written: the chunk after
them starts at a block boundary past the adopted blocks).  Requests can
be cancelled (``cancel``) and carry deadlines (``deadline_s``, swept at
the top of every tick).  ``attach_tracer`` records an event trace of
every tick (``repro_torch.obs``).

It has two tick modes over one scheduler and one cache, as the
reference:

  * ``step()``: dispatch step N with sampling on the device
    (``Model.decode_and_sample``), wait for its token ids and emit them;
  * ``step_async()``: plan against projected state, dispatch step N as
    ``step()`` does (the same sampler, so both modes draw the same
    tokens), queue its
    token ids' copy to pinned host memory and record an event, and only
    then wait on step N-1's event and emit its tokens.  The host runs
    one step behind the device.  Every upload in a tick is a
    non-blocking copy from pinned memory (a block of PyTorch's caching
    host allocator, which is not reused before the copy that reads it
    has run), so the one host wait per tick is that event.  Freeing a
    finished row's blocks at dispatch is safe because every kernel and
    copy of a tick runs in order on the current stream.

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

Sampling matches the reference's: ``temperature <= 0`` is the argmax
(ties to the lowest index); otherwise ``sample_tokens`` (top-k, then
the Gumbel-max draw) under the key of :func:`request_key`, whose words
equal ``jax.random``'s (``core/prng.py``).

With ``pretune=True`` both engines tune, before their first tick, every
GEMM call their model will launch (decode rows and each prefill bucket)
that the tuning cache does not hold yet (``repro_torch.tune``), so the
first ticks launch tuned configs rather than the heuristic's.

``PagedServeEngine(mesh=...)`` serves over a (data, model) mesh of
``torch.distributed`` ranks (``launch/mesh.py``), one process per rank
running the same program, as the reference's mesh engine serves over
devices.  The model is tensor-parallel over ``model``
(``models.model.shard_model``: its weights and each pool's kv heads, or
head width, cut per rank); decode rows are split over ``data`` when
``max_batch`` divides it, and the sampled ids gathered over ``data`` so
every rank emits every row's token.  Prefill chunks run on every data
rank (the reference's replicated ``in_shardings``), so a prompt's KV is
in every data replica of the pool, while a row's decode KV is written
only in its own replica: a row keeps its replica while it runs, and a
preempted request is recomputed by prefill.  The scheduler, block
pool, prefix cache and tables are host state, the same on every rank:
every rank submits the same requests, emits the same tokens, and takes
the deadline sweep's clock from rank 0.  A ``cancel`` must be made on
every rank.  On ``gloo`` every collective on the card is staged
through host memory, one host wait each (``mesh.host_syncs``); on
``nccl`` the async tick keeps its one host wait a tick.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.attention import (kv_entry_bytes, paged_kernel_mode,
                                          paged_prefill_mode)
from repro_torch.models.model import sample_tokens, set_block_tables
from repro_torch.models.transformer import layer_plan
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import req_track
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paging import BlockPool, PrefixCache
from repro_torch.serve.scheduler import Scheduler


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => no truncation (temperature > 0 only)
    seed: Optional[int] = None    # None: the engine seed folded with uid
    deadline_s: Optional[float] = None   # absolute, on the engine's clock
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    on_token: Optional[Callable] = None   # streaming: fn(token, request)
    error: Optional[str] = None           # "too_long" | "oom" | "callback"
                                          # | "deadline" | "cancelled" | ...


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


def _base_key(req: Request, engine_seed: int) -> torch.Tensor:
    if req.seed is not None:
        return prng.PRNGKey(req.seed)
    return prng.fold_in(prng.PRNGKey(engine_seed), req.uid)


def request_key(req: Request, index: int, engine_seed: int) -> torch.Tensor:
    """The key (int64 [2], uint32 words) of a request's ``index``-th
    sampled token: ``req.seed``'s key, else the engine seed's folded
    with the uid, folded with ``index``, as the reference derives it
    with ``jax.random``.  ``index`` counts tokens sampled so far, so a
    request preempted and recomputed draws the same tokens again."""
    return prng.fold_in(_base_key(req, engine_seed), index)


def _sample_host(req: Request, logits_row: torch.Tensor,
                 engine_seed: int) -> int:
    """The slots engine's draw of one token from ``logits_row`` [V] (any
    device): the argmax for greedy requests, else :func:`sample_tokens`
    on the row's device under :func:`request_key` at the request's next
    index."""
    if req.temperature <= 0:
        return int(torch.argmax(logits_row))
    key = request_key(req, len(req.out_tokens), engine_seed)
    dev = logits_row.device
    tok = sample_tokens(
        logits_row[None], key[None].to(dev),
        torch.full((1,), req.temperature, dtype=torch.float32, device=dev),
        torch.full((1,), req.top_k, dtype=torch.int32, device=dev))
    return int(tok[0])


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


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device without a stream sync: on a card, a copy
    into a fresh pinned block of PyTorch's caching host allocator (which
    keeps the block until the copy reading it has run), then a
    non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unsynced async step: the sampled ids on the
    device (next tick's decode input), their pinned host copy and the
    event after that copy, and what to emit."""
    tokens: torch.Tensor           # device int32 [max_batch]
    host: torch.Tensor             # host int32 [max_batch] (being copied)
    event: Optional[object]        # torch.cuda.Event after the copy
    emits: list                    # [(SeqState, row)] in sampling order
    row_of: dict                   # uid -> row
    t_dispatch: float              # engine-clock time of dispatch
    tick: int


def _mesh_model(model, mesh, shard_rules):
    """``model`` as this rank's model of ``mesh``: as it is if
    ``shard_model`` built it for that mesh, else sharded from its
    parameters (``to_params``; keep the unsharded model off the card)."""
    from repro_torch.models.model import check_meshable, shard_model, to_params
    check_meshable(model.cfg)
    if model.mesh is not None:
        if model.mesh is not mesh:
            raise ValueError("the model was sharded for another mesh")
        return model
    return shard_model(to_params(model), model.cfg, mesh, shard_rules,
                       mesh.device)


def _pretune(model, batch_sizes) -> list:
    """Tune the GEMM calls of ``model`` at ``batch_sizes`` rows into the
    default tuning cache: each linear's kernel as the backend registry
    resolves it for that weight.  Nothing to do where no weight resolves
    to a kernel (a dense model, a plain backend); refused on the CPU,
    where no kernel runs."""
    from repro_torch import tune
    from repro_torch.core.plane import PlaneBundle
    from repro_torch.quant.api import walk_linears
    from repro_torch.quant.backends import get_backend, resolve_backend
    pref = model.cfg.backend_preference
    kernels = {get_backend(resolve_backend(pref, lin.weight)).kernel
               for _, lin in walk_linears(model)
               if isinstance(lin.weight, PlaneBundle)
               and lin.weight.packed.ndim == 3} - {None}
    if not kernels:
        return []
    if model.device.type != "cuda":
        raise ValueError("pretune measures kernels on the card: the model "
                         f"lies on {model.device}")
    return tune.pretune_params(model, kernels=tuple(sorted(kernels)),
                               batch_sizes=sorted(set(batch_sizes)),
                               dtype=getattr(torch, model.cfg.dtype))


class PagedServeEngine:
    """Continuous batching over a paged KV cache (see the module
    docstring).

    ``paged_kernel`` ("auto" | "fused" | "gather", default: the model
    config's) picks the paged attention path; ``decode_path`` and
    ``prefill_path`` report the one taken.  ``prefix_cache`` turns on
    block sharing across requests with a common prompt prefix;
    ``rng_seed`` seeds the keys of requests without their own ``seed``;
    ``tracer`` (or ``attach_tracer``) records the event trace;
    ``pretune`` tunes the model's GEMM calls first (after the tracer is
    attached, so its kernel-config records land in the trace)."""

    def __init__(self, model, *, num_blocks: int = 64, block_size: int = 16,
                 max_batch: int = 8, max_seq_len: int = 0,
                 prefill_buckets=(32, 128, 512),
                 paged_kernel: Optional[str] = None,
                 prefix_cache: bool = False, rng_seed: int = 0,
                 clock=time.perf_counter, tracer=None,
                 pretune: bool = False, mesh=None,
                 shard_rules: Optional[dict] = None):
        self.mesh = mesh
        self._tp, self._rows = 1, None
        if mesh is not None:
            model = _mesh_model(model, mesh, shard_rules)
            self._tp = mesh.size("model")
            dp = mesh.size("data")
            # rows ride the data axis only where they divide it; else
            # every data rank decodes every row (correct, no DP win)
            if dp > 1 and max_batch % dp == 0:
                per = max_batch // dp
                d = mesh.index("data")
                self._rows = slice(d * per, (d + 1) * per)
        if paged_kernel is not None and paged_kernel != model.cfg.paged_kernel:
            model = model.with_config(paged_kernel=paged_kernel)
        self.model = model
        self.max_batch = max_batch
        self.block_size = block_size
        self.buckets = sorted(prefill_buckets)
        max_seq_len = max_seq_len or model.cfg.max_seq_len
        self.max_seq_len = max_seq_len
        self.max_blocks_per_seq = -(-max_seq_len // block_size)
        self.decode_path = paged_kernel_mode(model.cfg, tp=self._tp)
        self.prefill_path = paged_prefill_mode(model.cfg, tp=self._tp)
        # MLA: the latent + rotary key; int8 pools: with their scale rows
        self._kv_entry_bytes = kv_entry_bytes(model.cfg)
        self.trace = obs_trace.NULL
        self.cache = model.init_paged_cache(max_batch, num_blocks, block_size,
                                            self.max_blocks_per_seq)
        self.pool = BlockPool(num_blocks, block_size)
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        self.sched = Scheduler(self.pool, rows=max_batch, buckets=self.buckets,
                               max_blocks_per_seq=self.max_blocks_per_seq,
                               max_seq_len=max_seq_len,
                               prefix_cache=self.prefix, tracer=self.trace)
        if tracer is not None:
            self.attach_tracer(tracer)
        if pretune:
            _pretune(model, [1, max_batch, *self.buckets])
        self.clock = clock
        self.metrics = ServeMetrics(clock)
        self.tables = np.full((max_batch, self.max_blocks_per_seq), -1,
                              np.int32)
        self.rng_seed = rng_seed
        self._key_cache: dict = {}          # uid -> base key words
        self._inflight: Optional[_InFlight] = None
        self.ticks = 0
        self.finished: list = []

    # ------------------------------------------------------------------
    def attach_tracer(self, tracer) -> None:
        """Attach (or detach with ``None``) an ``obs.Tracer``; it also
        becomes the module's active tracer, for code that cannot be
        handed one."""
        self.trace = tracer if tracer is not None else obs_trace.NULL
        obs_trace.set_active(tracer)
        self.sched.trace = self.trace

    def submit(self, req: Request) -> None:
        self.metrics.on_submit(req.uid)
        self.trace.instant("submit", track=req_track(req.uid), cat="request",
                           uid=req.uid, prompt_len=len(req.prompt),
                           max_new=req.max_new_tokens)
        self.sched.submit(req)

    def _sync_tables(self) -> None:
        self.tables.fill(-1)
        for seq in self.sched.running:
            self.tables[seq.row, :len(seq.table)] = seq.table

    def _finalize_detached(self, req: Request) -> None:
        """Complete or fail a request whose blocks and row are already
        released."""
        req.done = True
        self.finished.append(req)
        self._key_cache.pop(req.uid, None)
        if req.error:
            self.metrics.on_fail(req.uid, req.error)
            self.trace.instant("fail", track=req_track(req.uid),
                               cat="request", uid=req.uid, error=req.error)
        else:
            self.metrics.on_complete(req.uid)
            self.trace.instant("complete", track=req_track(req.uid),
                               cat="request", uid=req.uid,
                               tokens=len(req.out_tokens))

    def _retire(self, seq) -> None:
        self.sched.finish(seq)
        self._finalize_detached(seq.req)

    def _fail_detached(self, req: Request, error: str) -> None:
        req.error = req.error or error
        self._finalize_detached(req)

    # ------------------------------------------------------------------
    def cancel(self, req: Request, error: str = "cancelled") -> bool:
        """Cancel a request wherever it is: waiting, running (its blocks
        and row are freed; prefix-cache references stay), or retiring
        with tokens still in flight (they are dropped at emission).
        False if it had already finished."""
        if req.done:
            return False
        if req in self.sched.waiting:
            self.sched.waiting.remove(req)
            self._fail_detached(req, error)
            return True
        for seq in self.sched.running:
            if seq.req is req:
                req.error = error
                self._retire(seq)
                return True
        self._fail_detached(req, error)
        return True

    def _check_deadlines(self) -> None:
        """Expire waiting and running requests whose deadline passed (top
        of every tick, both modes, on the engine clock; over a mesh, on
        rank 0's, so every rank expires the same requests)."""
        if self.mesh is not None:
            if not any(r.deadline_s is not None for r in self.sched.waiting) \
                    and not any(s.req.deadline_s is not None
                                for s in self.sched.running):
                return
            now = self.mesh.broadcast_float(self.clock())
        else:
            now = self.clock()
        for req in [r for r in self.sched.waiting
                    if r.deadline_s is not None and now >= r.deadline_s]:
            self.sched.waiting.remove(req)
            self.trace.instant("deadline", track=req_track(req.uid),
                               cat="request", uid=req.uid)
            self._fail_detached(req, "deadline")
        for seq in [s for s in self.sched.running
                    if s.req.deadline_s is not None
                    and now >= s.req.deadline_s]:
            seq.req.error = "deadline"
            self.trace.instant("deadline", track=req_track(seq.uid),
                               cat="request", uid=seq.uid)
            self._retire(seq)

    # ------------------------------------------------------------------
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

    def _request_key(self, req: Request, index: int) -> np.ndarray:
        """:func:`request_key` (as int64 [2] words) with the request's
        base key memoised; the fold with ``index`` runs on Python ints."""
        base = self._key_cache.get(req.uid)
        if base is None:
            base = tuple(int(w) for w in _base_key(req, self.rng_seed))
            self._key_cache[req.uid] = base
        return np.array(prng.threefry2x32(base[0], base[1], 0,
                                          index & 0xFFFFFFFF), np.int64)

    def _emit_token(self, seq, tok: int) -> None:
        _emit(seq.req, tok)
        self.metrics.on_token(seq.req.uid)
        self.trace.instant(
            "first_token" if len(seq.req.out_tokens) == 1 else "token",
            track=req_track(seq.req.uid), cat="request", uid=seq.req.uid,
            pos=seq.kv_len)
        if seq.req.error == "callback":
            self._retire(seq)
            return
        # retire at the TOKEN bound, not the block-rounded capacity
        if len(seq.req.out_tokens) >= seq.req.max_new_tokens \
                or seq.kv_len + 1 >= self.max_seq_len:
            self._retire(seq)

    # ------------------------------------------------------------------
    def _plan_and_apply(self):
        """Shared tick head: deadline sweep, plan, plan-event metrics and
        trace, table sync, and the prefix cache's write-safety checks."""
        self._check_deadlines()
        with self.trace.span("admission", track="engine/admission"):
            plan = self.sched.plan_tick()
        assert {s.uid for s in plan.admitted}.isdisjoint(
            {s.uid for s in plan.preempted}), \
            "scheduler emitted admit+preempt for one seq in one tick"
        for req in plan.rejected:
            self.metrics.on_reject(req.uid)
            self.trace.instant("reject", track=req_track(req.uid),
                               cat="request", uid=req.uid, error=req.error)
            self.finished.append(req)
        for seq in plan.admitted:
            self.metrics.on_admit(seq.req.uid)
            self.trace.instant("admit", track=req_track(seq.req.uid),
                               cat="request", uid=seq.req.uid, row=seq.row,
                               prefill_target=seq.prefill_target,
                               prefix_hit_blocks=seq.prefix_hit,
                               free_blocks=self.pool.free_blocks)
            if self.prefix is not None:
                self.metrics.on_prefix_lookup(
                    seq.req.uid, seq.prefix_queried, seq.prefix_hit,
                    seq.shared_tokens, seq.cow_tokens)
        for seq in plan.preempted:
            self.metrics.on_preempt(seq.req.uid)
            self.trace.instant("preempted", track=req_track(seq.req.uid),
                               cat="request", uid=seq.req.uid)
        for seq in plan.failed:
            self._retire(seq)
        self._sync_tables()
        if self.prefix is not None:
            # every block this tick writes is the writer's alone (shared
            # prefix blocks are read-only)
            for seq in plan.decode:
                blk = seq.table[seq.kv_len // self.block_size]
                assert self.pool.writable(blk, seq.uid), \
                    f"decode would write shared block {blk}"
            if plan.prefill is not None:
                pf = plan.prefill
                lo = pf.start // self.block_size
                hi = (pf.start + pf.length - 1) // self.block_size
                for blk in pf.seq.table[lo:hi + 1]:
                    assert self.pool.writable(blk, pf.seq.uid), \
                        f"prefill would write shared block {blk}"
        return plan

    def _masked_tables(self, decode) -> np.ndarray:
        tables = self.tables.copy()
        rows = {seq.row for seq in decode}
        for r in range(self.max_batch):
            if r not in rows:
                tables[r] = -1       # idle rows write to the trash block
        return tables

    def _decode_inputs(self, decode):
        """Host arrays of one decode batch: (tables, tokens, positions)."""
        tokens = np.zeros((self.max_batch, 1), np.int32)
        posv = np.zeros(self.max_batch, np.int32)
        for seq in decode:
            tokens[seq.row, 0] = seq.req.out_tokens[-1] \
                if seq.req.out_tokens else 0
            posv[seq.row] = seq.kv_len
        return self._masked_tables(decode), tokens, posv

    def _tick_metrics(self) -> None:
        self.ticks += 1
        if self.prefix is not None:
            self.metrics.on_tick(
                self.pool.occupancy(), self.sched.active,
                logical_blocks=sum(len(s.table) for s in self.sched.running),
                physical_blocks=self.pool.used_blocks,
                prefix_cached=len(self.prefix),
                prefix_evictions=self.prefix.evictions)
        else:
            self.metrics.on_tick(self.pool.occupancy(), self.sched.active)

    # ------------------------------------------------------------------
    # synchronous tick
    # ------------------------------------------------------------------
    def step(self) -> None:
        """One synchronous tick: plan, one decode batch and at most one
        prefill chunk, waiting on the device and sampling per request.
        An in-flight async step is flushed first, so modes can mix."""
        self.flush()
        self.trace.tick = self.ticks
        with self.trace.span("tick", track="engine/tick",
                             free_blocks=self.pool.free_blocks,
                             running=len(self.sched.running),
                             waiting=len(self.sched.waiting)):
            self._step_traced()

    def _step_traced(self) -> None:
        plan = self._plan_and_apply()
        dev = self.model.device

        if plan.decode:
            tables, tokens, posv = self._decode_inputs(plan.decode)
            cache = set_block_tables(self.cache, _to_device(tables, dev))
            t_disp = self.clock()
            with self.trace.span("decode_dispatch", track="engine/decode",
                                 rows=len(plan.decode),
                                 path=self.decode_path,
                                 uids=[s.uid for s in plan.decode]):
                ids, self.cache = self._decode_and_sample(
                    _to_device(tokens, dev), cache, _to_device(posv, dev),
                    *self._sampler_args(
                        [(seq.row, seq) for seq in plan.decode],
                        self.max_batch))
            with self.trace.span("device_sync", track="engine/sync",
                                 rows=len(plan.decode)):
                ids = ids.cpu().numpy()
            self.metrics.on_device_interval(t_disp, self.clock())
            fused_b, gathered_b = self._decode_kv_bytes(plan.decode)
            self.metrics.on_decode_step(len(plan.decode), fused_b,
                                        gathered_b, self.decode_path)
            with self.trace.span("sample", track="engine/sample",
                                 rows=len(plan.decode)):
                for seq in plan.decode:
                    seq.kv_len += 1
                    self._emit_token(seq, int(ids[seq.row]))

        if plan.prefill is not None:
            logits, seq = self._dispatch_prefill(plan.prefill)
            if seq.kv_len >= seq.prefill_target:
                with self.trace.span("sample", track="engine/sample",
                                     rows=1):
                    self._emit_token(seq, int(self._sample_last(logits, seq)))

        self._tick_metrics()

    def _decode_and_sample(self, tokens, cache, pos, keys, temps, topks):
        """``Model.decode_and_sample`` over every row; over a mesh whose
        data axis splits the rows, on this rank's rows, their ids then
        gathered over ``data`` (int32 [max_batch] on every rank)."""
        if self._rows is None:
            return self.model.decode_and_sample(tokens, cache, pos, keys,
                                                temps, topks)
        r = self._rows
        cache = set_block_tables(cache,
                                 cache["layers"][0]["block_tables"][r])
        ids, cache = self.model.decode_and_sample(
            tokens[r], cache, pos[r], None if keys is None else keys[r],
            temps[r], topks[r])
        return self.mesh.all_gather(ids, "data", dim=0), cache

    def host_state(self) -> tuple:
        """A digest of the host state every rank of a mesh must agree on:
        tables, free blocks, running and waiting requests, tokens out."""
        import hashlib
        h = hashlib.blake2b(self.tables.tobytes(), digest_size=16)
        h.update(repr((self.pool.free_blocks,
                       [(s.uid, s.row, s.kv_len)
                        for s in self.sched.running],
                       [r.uid for r in self.sched.waiting],
                       [(r.uid, r.out_tokens, r.error)
                        for r in self.finished])).encode())
        return self.ticks, h.hexdigest()

    def _sampler_args(self, rows, n: int):
        """Device (keys, temperature, top_k) of ``n`` sampler rows from
        ``rows`` [(row, seq)] (rows not listed are greedy): each sampled
        row's key is its request's next index past the tokens in flight;
        ``keys`` is None when every row is greedy (the draw is then an
        argmax).  Both tick modes sample through this."""
        dev = self.model.device
        keys = np.zeros((n, 2), np.int64)
        temps = np.zeros(n, np.float32)
        topks = np.zeros(n, np.int32)
        for row, seq in rows:
            req = seq.req
            if req.temperature > 0:
                keys[row] = self._request_key(
                    req, len(req.out_tokens) + seq.inflight)
            temps[row] = req.temperature
            topks[row] = req.top_k
        return (_to_device(keys, dev) if (temps > 0).any() else None,
                _to_device(temps, dev), _to_device(topks, dev))

    def _sample_last(self, logits, seq) -> torch.Tensor:
        """Device int32 [1]: the token after a prompt's last prefill chunk
        (``logits`` [1, V]), drawn as a decode row is."""
        keys, temps, topks = self._sampler_args([(0, seq)], 1)
        if keys is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_tokens(logits, keys, temps, topks)

    def _dispatch_prefill(self, pf):
        """Dispatch one prefill chunk (both tick modes); advances
        ``kv_len`` and returns (device logits [1, V], seq)."""
        seq, start, clen = pf.seq, pf.start, pf.length
        dev = self.model.device
        bucket = self.sched.bucket(clen)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :clen] = seq.tokens[start:start + clen]
        cache = set_block_tables(
            self.cache, _to_device(self.tables[seq.row:seq.row + 1], dev))
        with self.trace.span("prefill_chunk", track="engine/prefill",
                             uid=seq.uid, start=start, length=clen,
                             bucket=bucket):
            logits, self.cache = self.model.prefill_chunk(
                _to_device(toks, dev), cache, start, clen - 1)
        self.trace.instant("prefill_chunk", track=req_track(seq.uid),
                           cat="request", uid=seq.uid, start=start,
                           length=clen)
        fused_b, gathered_b = self._prefill_kv_bytes(seq)
        self.metrics.on_prefill_chunk(clen, fused_b, gathered_b,
                                      self.prefill_path)
        seq.kv_len += clen
        return logits, seq

    # ------------------------------------------------------------------
    # double-buffered async tick
    # ------------------------------------------------------------------
    def step_async(self) -> None:
        """One double-buffered tick: plan against projected state
        (``kv_len`` and ``inflight`` advance at dispatch), dispatch step
        N with sampling on the device, then wait for and emit step N-1's
        token ids."""
        self.trace.tick = self.ticks
        with self.trace.span("tick", track="engine/tick", mode="async",
                             free_blocks=self.pool.free_blocks,
                             running=len(self.sched.running),
                             waiting=len(self.sched.waiting),
                             inflight=self._inflight is not None):
            self._step_async_traced()

    def _step_async_traced(self) -> None:
        prev, self._inflight = self._inflight, None
        plan = self._plan_and_apply()
        dev = self.model.device
        cur = None                   # device int32 [max_batch]
        emits: list = []
        t_disp = None

        if plan.decode:
            tables, tokens, posv = self._decode_inputs(plan.decode)
            on_dev = np.zeros(self.max_batch, bool)
            for seq in plan.decode:
                if prev is not None and seq.uid in prev.row_of:
                    # the input token is still on the device (sampled
                    # last tick, not yet emitted); rows are stable while
                    # a seq keeps running
                    assert prev.row_of[seq.uid] == seq.row
                    on_dev[seq.row] = True
            inp = _to_device(tokens, dev)
            if on_dev.any():
                inp = torch.where(_to_device(on_dev, dev)[:, None],
                                  prev.tokens[:, None], inp)
            cache = set_block_tables(self.cache, _to_device(tables, dev))
            t_disp = self.clock()
            with self.trace.span("decode_dispatch", track="engine/decode",
                                 rows=len(plan.decode), mode="async",
                                 path=self.decode_path,
                                 uids=[s.uid for s in plan.decode]):
                cur, self.cache = self._decode_and_sample(
                    inp, cache, _to_device(posv, dev),
                    *self._sampler_args(
                        [(seq.row, seq) for seq in plan.decode],
                        self.max_batch))
            fused_b, gathered_b = self._decode_kv_bytes(plan.decode)
            self.metrics.on_decode_step(len(plan.decode), fused_b,
                                        gathered_b, self.decode_path)
            for seq in plan.decode:
                seq.kv_len += 1
                seq.inflight += 1
                emits.append((seq, seq.row))
                self._maybe_finish_async(seq)

        if plan.prefill is not None:
            logits, seq = self._dispatch_prefill(plan.prefill)
            if seq.kv_len >= seq.prefill_target:
                with self.trace.span("sample", track="engine/sample",
                                     rows=1, mode="async"):
                    tok = self._sample_last(logits, seq)
                if cur is None:
                    cur = torch.zeros(self.max_batch, dtype=torch.int32,
                                      device=dev)
                cur[seq.row] = tok[0]
                seq.inflight += 1
                emits.append((seq, seq.row))
                self._maybe_finish_async(seq)

        inflight = None
        if emits:
            # queue this tick's ids for the host behind its work, THEN
            # wait for the previous tick's: that order is the overlap
            if dev.type == "cuda":
                host = torch.empty(cur.shape, dtype=cur.dtype,
                                   pin_memory=True)
                host.copy_(cur, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host, event = cur, None
            inflight = _InFlight(
                tokens=cur, host=host, event=event, emits=emits,
                row_of={s.uid: row for s, row in emits},
                t_dispatch=t_disp if t_disp is not None else self.clock(),
                tick=self.ticks)
        self._sync_prev(prev)
        self._inflight = inflight
        self._tick_metrics()

    def _maybe_finish_async(self, seq) -> None:
        """Retire at dispatch: when the dispatched token is the request's
        last (by count), release its row and blocks now so the next
        tick's admission sees them; completion waits for the emission."""
        if len(seq.req.out_tokens) + seq.inflight \
                >= seq.req.max_new_tokens \
                or seq.kv_len + 1 >= self.max_seq_len:
            seq.retiring = True
            self.sched.finish(seq)

    def _sync_prev(self, prev: Optional[_InFlight]) -> None:
        """Wait for the previous async step's ids and emit them."""
        if prev is None:
            return
        with self.trace.span("device_sync", track="engine/sync",
                             rows=len(prev.emits), sync_tick=prev.tick):
            if prev.event is not None:
                prev.event.synchronize()
            toks = prev.host.numpy()
        self.metrics.on_device_interval(prev.t_dispatch, self.clock())
        with self.trace.span("emit", track="engine/sample",
                             rows=len(prev.emits)):
            for seq, row in prev.emits:
                self._emit_async(seq, int(toks[row]))

    def _emit_async(self, seq, tok: int) -> None:
        """Emit one step-N-1 token for ``seq``, which may by now be
        running, retiring or preempted (the token still belongs to the
        stream); a request cancelled or expired meanwhile drops it."""
        seq.inflight -= 1
        req = seq.req
        if req.done:
            return
        _emit(req, tok)
        self.metrics.on_token(req.uid)
        self.trace.instant(
            "first_token" if len(req.out_tokens) == 1 else "token",
            track=req_track(req.uid), cat="request", uid=req.uid,
            pos=seq.kv_len)
        if req.error == "callback":
            if seq in self.sched.running:
                self._retire(seq)
            elif req in self.sched.waiting:      # preempted victim
                self.sched.waiting.remove(req)
                self._fail_detached(req, "callback")
            else:                                # retiring: already freed
                self._fail_detached(req, "callback")
            return
        if seq.retiring and seq.inflight == 0:
            self._finalize_detached(req)

    def flush(self) -> None:
        """Wait for and emit any in-flight async step, dispatching
        nothing (the drain point for the frontend and for mode mixing)."""
        prev, self._inflight = self._inflight, None
        self._sync_prev(prev)

    @property
    def has_inflight(self) -> bool:
        return self._inflight is not None

    # ------------------------------------------------------------------
    def _drain_tick_budget(self) -> None:
        for seq in list(self.sched.running):
            seq.req.error = "tick_budget"
            self._retire(seq)
        while self.sched.waiting:
            self._fail_detached(self.sched.waiting.popleft(), "tick_budget")

    def run(self, requests: list, max_ticks: int = 1000) -> list:
        for req in requests:
            self.submit(req)
        while self.sched.has_work() and self.ticks < max_ticks:
            self.step()
        if self.sched.has_work():
            self._drain_tick_budget()
        return self.finished

    def run_async(self, requests: list, max_ticks: int = 1000) -> list:
        """Drain a batch through the double-buffered tick (the asyncio
        frontend drives ``step_async`` itself)."""
        for req in requests:
            self.submit(req)
        while (self.sched.has_work() or self._inflight is not None) \
                and self.ticks < max_ticks:
            self.step_async()
        self.flush()
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
                 prefill_buckets=(32, 128, 512), rng_seed: int = 0,
                 pretune: bool = False):
        check_servable(model.cfg)
        self.model = model
        self.slots = slots
        self.cache_len = cache_len
        self.buckets = sorted(prefill_buckets)
        self.cache = model.init_cache(slots, cache_len)
        self.slot_req: list = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self.rng_seed = rng_seed
        self.ticks = 0
        if pretune:
            _pretune(model, [1, slots, *self.buckets])

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
        _emit(req, _sample_host(req, logits[0], self.rng_seed))
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
        host = logits.float().cpu()
        retired = []
        for i in active:
            req = self.slot_req[i]
            # sampled rows draw on the device, as the paged engine's
            row = logits[i] if req.temperature > 0 else host[i]
            _emit(req, _sample_host(req, row, self.rng_seed))
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
