"""Port parity: the async tick, sampling in the engine, cancel and
deadlines, the asyncio frontend and the serving trace.

On the same f32 weights (reduced OPT), the port's ``PagedServeEngine``
must give the reference engine's token streams and counters in both
``run`` and ``run_async``, in the reference's three scenarios (mixed
greedy and seeded sampling, preemption, prefix cache); tolerance 0 on
token ids.  The reference engine runs once per scenario (its own tests
hold its sync and async ticks equal).  The rest are the reference's
lifecycle cases (``tests/test_serve.py``, ``tests/test_frontend.py``,
``tests/test_obs.py``) on the port's engine, and a traced run whose span
and instant names, in order, equal the reference engine's on the same
requests.
"""
import asyncio
import json

import numpy as np
import pytest
import torch

from repro.obs import Tracer as JTracer
from repro.obs import set_active as j_set_active
from repro.serve import Request as JRequest
from repro_torch import obs
from repro_torch.models.model import sample_tokens
from repro_torch.serve import (AsyncServeFrontend, FrontendClosedError,
                               PagedServeEngine, QueueFullError, Request,
                               ServeEngine)

from torch_port_cases import port_pair, ref_paged_engine

COUNTERS = ("admitted", "preempted", "tokens_out", "prefill_chunks",
            "prefix_lookups", "prefix_hit_blocks", "prefix_tokens_saved",
            "prefix_cow_tokens")


@pytest.fixture(scope="module")
def pair():
    """(reference Model, its f32 params, port Model): reduced OPT."""
    return port_pair("opt_6_7b")


def _by_uid(reqs):
    return {r.uid: list(r.out_tokens) for r in reqs}


def _requests(cls, vocab, lens, max_new=6, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, (int(n),)),
                max_new_tokens=max_new, **kw)
            for i, n in enumerate(lens)]


def _engine(tm, **over):
    kw = dict(num_blocks=16, block_size=8, max_batch=2, max_seq_len=64,
              prefill_buckets=(16,))
    kw.update(over)
    return PagedServeEngine(tm, **kw)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


class _ManualClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# the engine against the reference's, both tick modes
# ---------------------------------------------------------------------------


def _scenario(cls, vocab, scenario):
    if scenario == "prefix":
        rng = np.random.default_rng(5)
        prefix = rng.integers(0, vocab, (16,))
        return [cls(uid=i, prompt=np.concatenate(
                    [prefix, rng.integers(0, vocab, (3 + i,))]),
                    max_new_tokens=5) for i in range(4)]
    reqs = _requests(cls, vocab, [9, 13, 6, 11], max_new=6)
    if scenario == "mixed_sampling":
        for r in reqs[::2]:
            r.temperature, r.top_k, r.seed = 0.7, 12, 40 + r.uid
        reqs[1].temperature = 1.3          # engine seed folded with uid
    return reqs


@pytest.mark.parametrize("scenario", ["mixed_sampling", "preempt", "prefix"])
def test_engine_matches_reference_sync_and_async(pair, scenario):
    jm, params, tm = pair
    vocab = jm.cfg.vocab_size
    kw = dict(num_blocks=16, block_size=8, max_batch=3, max_seq_len=64,
              prefill_buckets=(16,), rng_seed=5,
              prefix_cache=scenario == "prefix")
    if scenario == "preempt":
        kw.update(num_blocks=10, block_size=4)
    je = ref_paged_engine(jm, params, **kw)
    want = _by_uid(je.run(_scenario(JRequest, vocab, scenario),
                          max_ticks=300))
    want_counters = {k: je.metrics.counters[k] for k in COUNTERS}
    for mode in ("sync", "async"):
        eng = PagedServeEngine(tm, **kw)
        reqs = _scenario(Request, vocab, scenario)
        done = eng.run(reqs, max_ticks=300) if mode == "sync" \
            else eng.run_async(reqs, max_ticks=300)
        assert all(r.error is None for r in done)
        assert _by_uid(done) == want, mode
        assert {k: eng.metrics.counters[k] for k in COUNTERS} == \
            want_counters, mode
        eng.pool.check()
        if eng.prefix is not None:
            eng.prefix.clear()
        assert eng.pool.free_blocks == eng.pool.capacity
    if scenario == "preempt":
        assert want_counters["preempted"] > 0
    if scenario == "prefix":
        assert want_counters["prefix_hit_blocks"] > 0


def test_decode_and_sample_is_decode_step_then_sample(pair):
    _, _, tm = pair
    eng = _engine(tm, max_batch=3)
    toks = torch.tensor([[5], [17], [3]])
    pos = torch.tensor([0, 0, 0], dtype=torch.int32)
    tables = np.full((3, eng.max_blocks_per_seq), -1, np.int32)
    tables[:, 0] = [1, 2, 3]
    from repro_torch.models.model import set_block_tables
    cache = set_block_tables(eng.cache, tables)
    logits, _ = tm.decode_step(toks, cache, pos)
    ids, _ = tm.decode_and_sample(toks, cache, pos, None, None, None)
    assert ids.dtype == torch.int32
    assert torch.equal(ids, logits.argmax(-1).to(torch.int32))
    keys = torch.tensor([[0, 7], [0, 8], [0, 9]])
    temps = torch.tensor([0.0, 0.7, 1.3])
    topk = torch.tensor([0, 1, 40], dtype=torch.int32)
    ids, _ = tm.decode_and_sample(toks, cache, pos, keys, temps, topk)
    assert torch.equal(ids, sample_tokens(logits, keys, temps, topk))
    assert ids[0] == logits[0].argmax() and ids[1] == logits[1].argmax()


def test_async_engine_overlaps_device_windows(pair):
    """The async tick's dispatch-to-sync windows cover more of the run
    than the sync tick's (an engine clock that moves 1 ms a reading)."""
    _, _, tm = pair
    busy = {}
    for mode in ("sync", "async"):
        eng = _engine(tm, max_batch=3, clock=_FakeClock())
        reqs = _requests(Request, tm.cfg.vocab_size, [5, 7, 9], max_new=12)
        done = eng.run(reqs, max_ticks=300) if mode == "sync" \
            else eng.run_async(reqs, max_ticks=300)
        assert all(r.error is None for r in done)
        busy[mode] = eng.metrics.device_busy_fraction()
    assert 0.0 < busy["sync"] < busy["async"] <= 1.0, busy


def test_seeded_sampling_deterministic_and_seed_sensitive(pair):
    _, _, tm = pair

    def run_once(base_seed, mode):
        eng = _engine(tm)
        reqs = _requests(Request, tm.cfg.vocab_size, [6, 9], max_new=8,
                         temperature=1.2)
        for r in reqs:
            r.seed = base_seed + r.uid
        return _by_uid(eng.run(reqs, max_ticks=200) if mode == "sync"
                       else eng.run_async(reqs, max_ticks=200))

    a = run_once(3, "async")
    assert a == run_once(3, "async") == run_once(3, "sync")
    assert a != run_once(123, "async")


def test_async_mode_interleaves_with_sync_mode(pair):
    _, _, tm = pair
    eng = _engine(tm)
    reqs = _requests(Request, tm.cfg.vocab_size, [5, 8], max_new=6)
    for r in reqs:
        eng.submit(r)
    for i in range(200):
        if all(r.done for r in reqs):
            break
        (eng.step_async if i % 2 else eng.step)()
    eng.flush()
    assert all(r.done and r.error is None for r in reqs)
    ref = _engine(tm).run(_requests(Request, tm.cfg.vocab_size, [5, 8],
                                    max_new=6), max_ticks=200)
    assert _by_uid(reqs) == _by_uid(ref)
    assert {len(v) for v in _by_uid(reqs).values()} == {6}


# ---------------------------------------------------------------------------
# callbacks, deadlines, cancellation
# ---------------------------------------------------------------------------


def _boom(tok, req):
    raise RuntimeError("client went away")


@pytest.mark.parametrize("mode", ["sync", "async", "slots"])
def test_callback_error_fails_only_that_request(pair, mode):
    _, _, tm = pair
    reqs = _requests(Request, tm.cfg.vocab_size, [5, 7, 6], max_new=4)
    reqs[0].on_token = _boom
    if mode == "slots":
        done = ServeEngine(tm, slots=2, cache_len=64,
                           prefill_buckets=(16,)).run(reqs, max_ticks=200)
    else:
        eng = _engine(tm)
        done = eng.run(reqs, max_ticks=200) if mode == "sync" \
            else eng.run_async(reqs, max_ticks=200)
        eng.pool.check()
        assert eng.pool.free_blocks == eng.pool.capacity
        assert eng.metrics.counters["failed"] == 1
    bad = next(r for r in done if r.uid == 0)
    assert bad.done and bad.error == "callback"
    assert all(r.error is None and len(r.out_tokens) == 4
               for r in done if r.uid != 0)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_deadline_expiry_frees_blocks_waiting_and_running(pair, mode):
    _, _, tm = pair
    eng = _engine(tm)
    step = eng.step_async if mode == "async" else eng.step
    expired, live = _requests(Request, tm.cfg.vocab_size, [5, 7], max_new=6)
    expired.deadline_s = -1.0
    eng.submit(expired)
    eng.submit(live)
    step()
    assert expired.done and expired.error == "deadline"
    assert expired.out_tokens == []
    for _ in range(4):
        step()
    assert live.out_tokens and not live.done
    live.deadline_s = -1.0
    step()
    eng.flush()
    assert live.done and live.error == "deadline"
    assert 0 < len(live.out_tokens) < 6
    eng.pool.check()
    assert eng.pool.free_blocks == eng.pool.capacity
    assert eng.metrics.counters["deadline_expired"] == 2
    assert eng.metrics.counters["failed"] == 2


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_cancel_waiting_and_running_releases_blocks(pair, mode):
    _, _, tm = pair
    eng = _engine(tm, max_batch=1)
    step = eng.step_async if mode == "async" else eng.step
    running, queued = _requests(Request, tm.cfg.vocab_size, [5, 7],
                                max_new=8)
    eng.submit(running)
    eng.submit(queued)
    for _ in range(3):
        step()
    assert running.out_tokens and not running.done
    assert eng.cancel(queued)
    assert queued.done and queued.error == "cancelled"
    assert eng.cancel(running)
    eng.flush()
    assert running.done and running.error == "cancelled"
    assert not eng.cancel(running)
    eng.pool.check()
    assert eng.pool.free_blocks == eng.pool.capacity
    assert eng.metrics.counters["cancelled"] == 2


# ---------------------------------------------------------------------------
# asyncio frontend
# ---------------------------------------------------------------------------


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n,))


def test_frontend_streams_every_token_in_order(pair):
    eng = _engine(pair[2])
    fe = AsyncServeFrontend(eng)

    async def go():
        h1 = await fe.submit(_prompt(5), max_new_tokens=4)
        h2 = await fe.submit(_prompt(9, seed=1), max_new_tokens=4,
                             temperature=0.8, top_k=8, seed=7)

        async def consume(h):
            return [tok async for tok in h]

        drain = asyncio.ensure_future(fe.drain())
        t1, t2 = await asyncio.gather(consume(h1), consume(h2))
        await drain
        return h1, h2, t1, t2

    h1, h2, t1, t2 = asyncio.run(go())
    assert h1.error is None and h2.error is None
    assert t1 == h1.out_tokens and len(t1) == 4
    assert t2 == h2.out_tokens and len(t2) == 4
    eng.pool.check()
    assert eng.pool.free_blocks == eng.pool.capacity


def test_frontend_bounded_queue_rejects_with_typed_error(pair):
    fe = AsyncServeFrontend(_engine(pair[2]), max_queue=2)

    async def go():
        hs = [await fe.submit(_prompt(5 + i, seed=i), max_new_tokens=3)
              for i in range(2)]
        with pytest.raises(QueueFullError) as ei:
            fe.submit_nowait(_prompt(7, seed=2), max_new_tokens=3)
        assert ei.value.limit == 2
        await fe.drain()
        hs.append(await fe.submit(_prompt(7, seed=2), max_new_tokens=3))
        await fe.drain()
        return hs

    hs = asyncio.run(go())
    assert all(h.done and h.error is None and len(h.out_tokens) == 3
               for h in hs)


def test_frontend_cancel_frees_blocks_and_prefix_refs(pair):
    eng = _engine(pair[2], prefix_cache=True)
    fe = AsyncServeFrontend(eng)
    prefix = _prompt(16, seed=3)

    async def go():
        hs = [await fe.submit(np.concatenate([prefix,
                                              _prompt(3 + i, seed=4 + i)]),
                              max_new_tokens=12) for i in range(3)]
        for _ in range(200):
            if len(hs[1].out_tokens) >= 2:
                break
            fe.step()
            await asyncio.sleep(0)
        assert hs[1].cancel()
        await fe.drain()
        return hs

    hs = asyncio.run(go())
    assert hs[1].error == "cancelled" and 0 < len(hs[1].out_tokens) < 12
    assert all(h.error is None and len(h.out_tokens) == 12
               for h in (hs[0], hs[2]))
    assert eng.metrics.counters["cancelled"] == 1
    eng.pool.check()
    eng.prefix.clear()
    assert eng.pool.free_blocks == eng.pool.capacity


def test_frontend_deadline_expiry_with_fake_clock(pair):
    clk = _ManualClock()
    eng = _engine(pair[2], clock=clk, max_batch=1)
    fe = AsyncServeFrontend(eng)

    async def go():
        run = await fe.submit(_prompt(5), max_new_tokens=20,
                              deadline_ms=100.0)
        queued = await fe.submit(_prompt(6, seed=1), max_new_tokens=4,
                                 deadline_ms=50.0)
        for _ in range(4):
            fe.step()
            await asyncio.sleep(0)
        assert not run.done and not queued.done and run.out_tokens
        clk.advance(0.075)
        fe.step()
        assert queued.done and queued.error == "deadline"
        assert queued.out_tokens == []
        clk.advance(0.050)
        fe.step()
        eng.flush()
        fe._reap()
        await run.wait()
        return run

    run = asyncio.run(go())
    assert run.error == "deadline" and 0 < len(run.out_tokens) < 20
    assert eng.metrics.counters["deadline_expired"] == 2
    eng.pool.check()
    assert eng.pool.free_blocks == eng.pool.capacity


def test_frontend_close_unblocks_live_handles(pair):
    eng = _engine(pair[2])
    fe = AsyncServeFrontend(eng)

    async def go():
        h = await fe.submit(_prompt(5), max_new_tokens=30)
        fe.step()
        fe.close()
        await h.wait()
        toks = [tok async for tok in h]
        with pytest.raises(FrontendClosedError):
            fe.submit_nowait(_prompt(4, seed=9))
        return h, toks

    h, toks = asyncio.run(go())
    assert h.error == "shutdown" and toks == h.out_tokens
    eng.pool.check()
    assert eng.pool.free_blocks == eng.pool.capacity


def test_frontend_serve_forever_with_concurrent_clients(pair):
    fe = AsyncServeFrontend(_engine(pair[2], max_batch=3), idle_sleep=0.0)

    async def client(i):
        h = await fe.submit(_prompt(4 + i, seed=20 + i), max_new_tokens=4,
                            deadline_ms=(60_000.0 if i % 2 else None))
        return h, [tok async for tok in h]

    async def go():
        loop = asyncio.ensure_future(fe.serve_forever())
        out = await asyncio.gather(*(client(i) for i in range(5)))
        fe.close()
        await loop
        return out

    for h, toks in asyncio.run(go()):
        assert h.error is None and toks == h.out_tokens and len(toks) == 4


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def tick(self, dt=1e-3):
        self.t += dt

    def __call__(self):
        return self.t


def test_tracer_spans_ring_and_null():
    tr = obs.Tracer(clock=_Clock(), capacity=10)
    tr.clock.tick(0.001)
    with tr.span("prefill_chunk", track="engine/prefill", uid=3):
        tr.clock.tick(0.002)
    (ev,) = tr.events
    assert ev["ph"] == "X" and ev["ts"] == pytest.approx(1000.0)
    assert ev["dur"] == pytest.approx(2000.0) and ev["args"]["uid"] == 3
    with pytest.raises(RuntimeError):
        with tr.span("tick"):
            raise RuntimeError("boom")
    assert tr.events[-1]["name"] == "tick"
    for i in range(25):
        tr.instant(f"e{i}")
    assert len(tr.events) == 10 and tr.dropped == 17
    with pytest.raises(ValueError):
        obs.Tracer(capacity=0)
    n = obs.NullTracer()
    with n.span("tick", track="engine/tick"):
        n.instant("admit", uid=1)
    assert n.events == [] and obs.NULL.now_us() == 0.0


def test_active_tracer_and_kernel_records():
    tr = obs.Tracer(clock=_Clock())
    assert obs.get_active() is None
    obs.record_kernel_unsupported("paged_decode", "window")   # no-op
    with obs.activate(tr):
        obs.record_kernel_unsupported("paged_decode", "window", h=3)

        class Cfg:
            def to_dict(self):
                return {"tile": 64}
        obs.record_kernel_config("bcq_matmul", "heuristic", Cfg(), m=8)
    assert obs.get_active() is None
    a, b = tr.events
    assert a["name"] == "kernel_unsupported:paged_decode"
    assert a["args"]["reason"] == "window" and a["track"] == "engine/kernel"
    assert b["args"]["config"] == {"tile": 64} and b["args"]["m"] == 8


def test_profiler_bridge_wraps_spans_in_record_function():
    tr = obs.Tracer(clock=_Clock(), profiler_bridge=True)
    assert tr._annotation is torch.profiler.record_function
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("decode_dispatch", track="engine/decode"):
            torch.ones(4).sum()
    assert any(e.key == "decode_dispatch" for e in prof.key_averages())


def test_chrome_export_validates_and_catches_corruption(tmp_path):
    tr = obs.Tracer(clock=_Clock(), capacity=256)
    tr.tick = 0
    with tr.span("tick", track="engine/tick"):
        tr.clock.tick()
        tr.instant("admit", track=obs.req_track(0), uid=0)
    path = obs.save_chrome(tr, str(tmp_path / "trace.json"))
    loaded = json.loads(open(path).read())
    assert obs.validate_chrome(loaded) == []
    assert obs.validate_chrome({"nope": 1}) == ["missing traceEvents"]
    bad = json.loads(json.dumps(loaded))
    next(e for e in bad["traceEvents"] if e["ph"] == "X").pop("dur")
    assert any("bad dur" in e for e in obs.validate_chrome(bad))
    rows = obs.timeline(tr, uid=0)
    assert [r["name"] for r in rows] == ["admit"]
    assert "(1 more rows)" in obs.format_timeline(tr, max_rows=1)


def test_trace_names_match_reference_engine(pair):
    """The same requests through both engines, traced: every span and
    instant, in order, has the reference's name and track; the export
    validates; an async run shows tick N's dispatch before tick N-1's
    sync."""
    jm, params, tm = pair
    kw = dict(num_blocks=16, block_size=8, max_batch=2, max_seq_len=64,
              prefill_buckets=(16,), prefix_cache=True)
    jtr = JTracer()
    ref_paged_engine(jm, params, tracer=jtr, **kw).run(
        _scenario(JRequest, jm.cfg.vocab_size, "prefix"), max_ticks=100)
    j_set_active(None)
    ttr = obs.Tracer()
    eng = PagedServeEngine(tm, tracer=ttr, **kw)
    eng.run(_scenario(Request, tm.cfg.vocab_size, "prefix"), max_ticks=100)
    names = lambda tr: [(e["name"], e["track"]) for e in
                        sorted(tr.events, key=lambda e: e["ts"])]
    assert names(ttr) == names(jtr)
    assert obs.validate_chrome(obs.to_chrome(ttr)) == []
    assert {"prefix_lookup", "decode_dispatch", "device_sync",
            "prefill_chunk", "sample"} <= {n for n, _ in names(ttr)}
    atr = obs.Tracer()
    eng.attach_tracer(atr)
    eng.run_async(_requests(Request, tm.cfg.vocab_size, [5, 7], max_new=4),
                  max_ticks=100)
    eng.attach_tracer(None)
    assert obs.get_active() is None
    assert obs.validate_chrome(obs.to_chrome(atr)) == []
    seq = [(e["name"], e["args"].get("tick"), e["args"].get("sync_tick"))
           for e in sorted(atr.events, key=lambda e: e["ts"])
           if e["name"] in ("decode_dispatch", "device_sync")]
    for i, (name, tick, sync_tick) in enumerate(seq):
        if name == "device_sync" and sync_tick is not None \
                and sync_tick < tick:
            # the wait for tick N-1 follows tick N's dispatch
            assert ("decode_dispatch", tick, None) in seq[:i]
            break
    else:
        pytest.fail("no overlapped sync in the async trace")


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv, msg", [
    (["--engine", "slots", "--prefix-cache", "on"], "--prefix-cache"),
    (["--engine", "slots", "--async"], "--async"),
    (["--deadline-ms", "5"], "--deadline-ms requires --async"),
    (["--trace-timeline", "3"], "require --trace-out"),
    (["--engine", "slots", "--trace-out", "x.json"], "--trace-out"),
])
def test_launcher_refuses_like_reference(argv, msg):
    from repro_torch.launch import serve as launch
    with pytest.raises(SystemExit, match=msg):
        launch.main(["--device", "cpu", "--bits", "0", "--requests", "1",
                     "--max-new", "1", *argv])


def test_launcher_async_deadlines_trace_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve as launch
    out = tmp_path / "trace.json"
    done = launch.main(["--device", "cpu", "--bits", "0", "--requests", "4",
                        "--max-new", "3", "--async", "--deadline-ms",
                        "60000", "--stream", "--trace-out", str(out),
                        "--trace-timeline", "4"])
    assert len(done) == 4 and all(len(r.out_tokens) == 3 for r in done)
    assert obs.validate_chrome(json.loads(out.read_text())) == []
    text = capsys.readouterr().out
    assert "[stream] req" in text and "prefix cache: hit-rate" in text
