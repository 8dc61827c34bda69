"""Port parity: paged serving.

The port's ``PagedServeEngine`` greedy stream must be token-for-token
equal to the reference engine's on the same reduced BCQ OPT and the same
requests (exact: tolerance 0 on token ids).  The reference runs
``bcq_xla`` with the gathered paged view (fast on the CPU), plus one
short case with ``paged_kernel="fused"`` interpreted.  Host logic
(``BlockPool``, ``Scheduler``) is checked for its invariants, and the
launcher must refuse to run without a GPU unless given ``--device cpu``.
"""
import pytest
import torch

from repro.serve import Request as JRequest
from repro_torch.serve import (BlockPool, PagedServeEngine, Request,
                               Scheduler)

from torch_port_cases import port_pair, prompts_of, ref_paged_engine


def _models(paged_kernel):
    return port_pair("opt_6_7b", paged_kernel=paged_kernel,
                     quant=dict(bits=3, group_size=32, iters=2,
                                backend="bcq_xla"))


def _prompts(lens, seed=0, vocab=256):
    return prompts_of(lens, seed, vocab)


def _run_both(paged_kernel, lens, max_new, **kw):
    jm, params, tm = _models(paged_kernel)
    prompts = _prompts(lens)
    je = ref_paged_engine(jm, params, **kw)
    jdone = je.run([JRequest(uid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)], max_ticks=400)
    te = PagedServeEngine(tm, **kw)
    tdone = te.run([Request(uid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)], max_ticks=400)
    return je, jdone, te, tdone


def _by_uid(reqs):
    return {r.uid: list(r.out_tokens) for r in reqs}


def test_greedy_stream_matches_reference_gathered():
    kw = dict(num_blocks=24, block_size=8, max_batch=3, max_seq_len=64,
              prefill_buckets=(8, 16))
    je, jdone, te, tdone = _run_both("gather", [3, 9, 17, 30, 5], 5, **kw)
    assert len(tdone) == len(jdone) == 5
    assert all(r.error is None for r in tdone)
    assert _by_uid(tdone) == _by_uid(jdone)
    te.pool.check()
    assert te.pool.occupancy() == 0.0
    assert te.metrics.counters["prefill_chunks"] == \
        je.metrics.counters["prefill_chunks"]
    tpk = te.metrics.summary()["paged_kernel"]
    jpk = je.metrics.summary()["paged_kernel"]
    for key in ("kv_bytes_per_token_fused", "kv_bytes_per_token_gathered"):
        assert tpk[key] == jpk[key]


def test_greedy_stream_matches_reference_fused():
    kw = dict(num_blocks=12, block_size=4, max_batch=2, max_seq_len=32,
              prefill_buckets=(8,))
    je, jdone, te, tdone = _run_both("fused", [6, 11], 3, **kw)
    assert te.decode_path == "fused" and te.prefill_path == "fused"
    assert _by_uid(tdone) == _by_uid(jdone)


def test_preemption_keeps_stream_identical():
    """A pool too small for every request forces preempt-by-recompute;
    the greedy stream must not change (reference engine as oracle)."""
    kw = dict(num_blocks=9, block_size=4, max_batch=3, max_seq_len=32,
              prefill_buckets=(8,))
    je, jdone, te, tdone = _run_both("gather", [10, 9, 8], 6, **kw)
    assert te.metrics.counters["preempted"] == \
        je.metrics.counters["preempted"]
    assert _by_uid(tdone) == _by_uid(jdone)
    te.pool.check()


# ---------------------------------------------------------------------------
# host logic
# ---------------------------------------------------------------------------


def test_block_pool_invariants():
    pool = BlockPool(num_blocks=9, block_size=4)
    got = pool.alloc("a", 5) + pool.alloc("b", 3)
    assert 0 not in got and len(set(got)) == 8
    assert pool.alloc("c", 1) is None and pool.free_blocks == 0
    pool.free(got[:5], "a")
    assert pool.used_blocks == 3 and pool.occupancy() == 3 / 8
    with pytest.raises(AssertionError):
        pool.free(got[:1], "a")                  # double free
    with pytest.raises(AssertionError):
        pool.free(got[5:6], "a")                 # wrong owner
    assert pool.alloc("d", 9) is None and pool.free_blocks == 5
    pool.check()
    assert pool.blocks_for(9) == 3 and pool.blocks_for(0) == 0


def test_scheduler_invariants():
    """Model-free drive: every plan keeps rows and blocks consistent,
    chunks stay within the largest bucket, and everything retires."""
    pool = BlockPool(num_blocks=10, block_size=4)
    sched = Scheduler(pool, rows=2, buckets=(8,), max_blocks_per_seq=8)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(_prompts([5, 13, 3, 30]))]
    for r in reqs:
        sched.submit(r)
    finished = []
    for _ in range(200):
        if not sched.has_work():
            break
        plan = sched.plan_tick()
        rows = [s.row for s in sched.running]
        assert len(rows) == len(set(rows)) <= 2
        held = [b for s in sched.running for b in s.table]
        assert len(held) == len(set(held)) and 0 not in held
        for s in plan.decode:
            assert len(s.table) >= pool.blocks_for(s.kv_len + 1)
            s.kv_len += 1
            s.req.out_tokens.append(1)
        if plan.prefill is not None:
            pf = plan.prefill
            assert pf.length <= 8 and pf.start == pf.seq.kv_len
            pf.seq.kv_len += pf.length
            if pf.seq.kv_len >= pf.seq.prefill_target:
                pf.seq.req.out_tokens.append(1)
        for s in list(sched.running):
            if len(s.req.out_tokens) >= s.req.max_new_tokens:
                sched.finish(s)
                finished.append(s.uid)
        finished += [r.uid for r in plan.rejected]
        pool.check()
    assert sorted(finished) == [0, 1, 2, 3]
    assert reqs[3].error == "too_long"           # 30 + 4 > 8 blocks * 4
    assert pool.used_blocks == 0


def test_launcher_refuses_cpu_fallback(monkeypatch):
    from repro_torch.launch import serve as launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="device"):
        launch.main(["--bits", "3", "--requests", "1", "--max-new", "2"])


def test_launcher_runs_on_cpu_when_asked(tmp_path):
    from repro_torch.launch import serve as launch
    out = tmp_path / "m.json"
    done = launch.main(["--device", "cpu", "--bits", "3", "--requests", "2",
                        "--max-new", "3", "--paged-kernel", "fused",
                        "--backend", "mxu_pallas", "--metrics-json",
                        str(out)])
    assert len(done) == 2 and all(len(r.out_tokens) == 3 for r in done)
    assert out.exists()
