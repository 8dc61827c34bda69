"""The port's prefix cache: refcounted block sharing, copy-on-write by
recompute, eviction, key collisions, and the engine on and off.

Counterparts of the reference's prefix-cache cases
(``tests/test_serve.py``), on the port's engine over a reduced f32 OPT
(no JAX needed: these are the port's own invariants; the token streams
against the reference's engine are in ``test_torch_serve_async.py``).
Prefix on must give the tokens of prefix off, and the pool bytes of
every adopted block must be unchanged by the requests that adopt it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import Model
from repro_torch.serve import (BlockPool, PagedServeEngine, PrefixCache,
                               Request, Scheduler)


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced("opt_6_7b").replace(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    return Model(cfg, device="cpu", dtype=torch.float32).init_params(gen)


def _by_uid(reqs):
    return {r.uid: list(r.out_tokens) for r in reqs}


def _shared_prefix_requests(vocab, *, prefix_len, tails, max_new=4, seed=3):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, (prefix_len,))
    return [Request(uid=i, prompt=np.concatenate(
                [prefix, rng.integers(0, vocab, (int(t),))]),
                    max_new_tokens=max_new)
            for i, t in enumerate(tails)]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


# ---------------------------------------------------------------------------
# engine: on == off, adopted blocks never written
# ---------------------------------------------------------------------------


def test_prefix_cache_on_off_token_equivalence(model):
    kw = dict(num_blocks=32, block_size=4, max_batch=3, max_seq_len=64,
              prefill_buckets=(8, 16))
    mk = lambda: _shared_prefix_requests(model.cfg.vocab_size,
                                         prefix_len=12, tails=[3, 5, 2, 7, 4])
    off = PagedServeEngine(model, **kw)
    done_off = off.run(mk(), max_ticks=400)
    on = PagedServeEngine(model, prefix_cache=True, **kw)
    done_on = on.run(mk(), max_ticks=400)
    assert _by_uid(done_on) == _by_uid(done_off)
    s = on.metrics.summary()
    assert s["prefix_cache"]["blocks_saved"] > 0
    assert s["prefix_cache"]["hit_rate"] > 0
    assert on.metrics.counters["prefill_chunks"] \
        < off.metrics.counters["prefill_chunks"]
    assert off.metrics.summary()["prefix_cache"]["blocks_saved"] == 0
    assert off.metrics.summary()["effective_capacity"]["peak"] == 1.0
    on.pool.check()
    assert on.pool.used_blocks == len(on.prefix)
    on.prefix.clear()
    assert on.pool.free_blocks == on.pool.capacity


def _block_bytes(eng, blocks):
    """Every layer's pool entries (k, v, pos) of ``blocks``, copied."""
    idx = torch.as_tensor(blocks)
    return [{k: v[idx].clone() for k, v in layer.items()
             if k != "block_tables"} for layer in eng.cache["layers"]]


def test_adopted_blocks_are_never_written(model):
    """A request's prompt blocks are registered; later requests with the
    same prefix adopt them, prefill from the block after them and decode;
    the adopted blocks' pool bytes stay as the writer left them."""
    kw = dict(num_blocks=32, block_size=4, max_batch=2, max_seq_len=64,
              prefill_buckets=(8,))
    reqs = _shared_prefix_requests(model.cfg.vocab_size, prefix_len=13,
                                   tails=[3, 6, 1], max_new=5, seed=8)
    eng = PagedServeEngine(model, prefix_cache=True, **kw)
    eng.run(reqs[:1], max_ticks=100)
    cached = sorted(e.block for e in eng.prefix.entries.values())
    assert len(cached) == 4                       # (13 + 3) // 4 full blocks
    before = _block_bytes(eng, cached)
    eng.run(reqs[1:], max_ticks=200)
    assert eng.metrics.counters["prefix_hit_blocks"] == 6   # 3 each
    after = _block_bytes(eng, cached)
    for b_layer, a_layer in zip(before, after):
        for key in b_layer:
            assert torch.equal(b_layer[key], a_layer[key]), key
    off = PagedServeEngine(model, **kw).run(
        _shared_prefix_requests(model.cfg.vocab_size, prefix_len=13,
                                tails=[3, 6, 1], max_new=5, seed=8),
        max_ticks=300)
    assert _by_uid(reqs) == _by_uid(off)


def test_prefix_cache_warm_probe_skips_prefill(model):
    eng = PagedServeEngine(model, num_blocks=16, block_size=4, max_batch=2,
                           max_seq_len=64, prefill_buckets=(8,),
                           prefix_cache=True, clock=_FakeClock())
    prompt = np.random.default_rng(5).integers(0, model.cfg.vocab_size, (16,))
    cold = Request(uid=0, prompt=prompt, max_new_tokens=3)
    eng.run([cold], max_ticks=100)
    assert eng.metrics.counters["prefill_chunks"] == 2
    warm = Request(uid=1, prompt=prompt, max_new_tokens=3)
    eng.run([warm], max_ticks=100)
    assert warm.out_tokens == cold.out_tokens
    assert eng.metrics.counters["prefill_chunks"] == 3
    # cap = (16 - 1) // 4 = 3 full blocks -> 12 of 16 prompt tokens adopted
    assert eng.metrics.counters["prefix_tokens_saved"] == 12
    assert eng.metrics.counters["prefix_hit_requests"] == 1
    eng.pool.check()


def test_prefix_cache_cow_divergent_tail_recomputed(model):
    rng = np.random.default_rng(9)
    base = rng.integers(0, model.cfg.vocab_size, (13,))
    var = base.copy()
    var[9] = (var[9] + 1) % model.cfg.vocab_size     # diverge inside block 2
    kw = dict(num_blocks=16, block_size=4, max_batch=1, max_seq_len=64,
              prefill_buckets=(8,))
    mk = lambda: [Request(uid=0, prompt=base, max_new_tokens=3),
                  Request(uid=1, prompt=var, max_new_tokens=3)]
    done_off = PagedServeEngine(model, **kw).run(mk(), max_ticks=200)
    on = PagedServeEngine(model, prefix_cache=True, **kw)
    done_on = on.run(mk(), max_ticks=200)
    assert _by_uid(done_on) == _by_uid(done_off)
    assert on.metrics.counters["prefix_cow_events"] == 1
    assert on.metrics.counters["prefix_cow_tokens"] == 1
    assert on.metrics.counters["prefix_hit_blocks"] == 2
    on.pool.check()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_prefix_cache_equivalence_under_preemption(model, mode):
    kw = dict(num_blocks=11, block_size=4, max_batch=3, max_seq_len=48,
              prefill_buckets=(8, 16))
    mk = lambda: _shared_prefix_requests(model.cfg.vocab_size, prefix_len=9,
                                         tails=[8, 2, 6, 4], max_new=5,
                                         seed=11)
    done_off = PagedServeEngine(model, **kw).run(mk(), max_ticks=600)
    on = PagedServeEngine(model, prefix_cache=True, **kw)
    reqs = mk()
    done_on = on.run(reqs, max_ticks=600) if mode == "sync" \
        else on.run_async(reqs, max_ticks=600)
    assert _by_uid(done_on) == _by_uid(done_off)
    assert on.metrics.counters["prefix_hit_blocks"] > 0
    assert on.metrics.counters["preempted"] > 0
    on.pool.check()
    on.prefix.clear()
    assert on.pool.free_blocks == on.pool.capacity


# ---------------------------------------------------------------------------
# host logic: pool sharing, budget, eviction, collisions
# ---------------------------------------------------------------------------


def test_pool_share_refcount_and_writable():
    pool = BlockPool(num_blocks=6, block_size=4)
    a = pool.alloc("a", 2)
    assert all(pool.writable(b, "a") for b in a)
    pool.share(a[:1], "b")
    assert pool.refcount(a[0]) == 2 and pool.refcount(a[1]) == 1
    assert not pool.writable(a[0], "a") and not pool.writable(a[0], "b")
    assert sorted(pool.owned_by("b")) == a[:1]
    with pytest.raises(AssertionError):
        pool.share(a[:1], "b")                    # already a holder
    with pytest.raises(AssertionError):
        pool.share([5], "c")                      # never allocated
    pool.free(a, "a")
    assert pool.free_blocks == 4 and pool.writable(a[0], "b")
    pool.free(a[:1], "b")
    pool.check()
    assert pool.free_blocks == pool.capacity


def test_prefix_keys_are_stable_across_processes():
    """Digests, not ``hash()``: a chunk chain's keys are constants, the
    same under every ``PYTHONHASHSEED`` (the reference's ``hash()`` keys
    are not)."""
    k0 = PrefixCache._key(None, (1, 2, 3, 4))
    assert k0 == 0x607d1d8d1e82853c
    assert PrefixCache._key(k0, (5, 6, 7, 8)) == 0xf3ef210150eab100
    assert PrefixCache._key(None, (5, 6, 7, 8)) != 0xf3ef210150eab100


def test_admission_budget_counts_only_new_blocks():
    pool = BlockPool(num_blocks=9, block_size=4)      # 8 usable
    cache = PrefixCache(pool)
    sched = Scheduler(pool, rows=2, buckets=(8,), max_blocks_per_seq=8,
                      prefix_cache=cache)
    prompt = np.arange(16, dtype=np.int32) % 3
    sched.submit(Request(uid=0, prompt=prompt, max_new_tokens=16))
    for _ in range(6):
        plan = sched.plan_tick()
        if plan.prefill is not None:
            plan.prefill.seq.kv_len += plan.prefill.length
        for seq in plan.decode:
            seq.kv_len += 1
            seq.req.out_tokens.append(0)
    assert sched.running and sched.running[0].kv_len > 16
    assert pool.free_blocks == 3 and cache.evictable() == 0
    sched.submit(Request(uid=1, prompt=prompt.copy(), max_new_tokens=2))
    plan = sched.plan_tick()
    assert 1 in {s.uid for s in plan.admitted}
    bseq = next(s for s in sched.running if s.uid == 1)
    assert bseq.prefix_hit == 3 and bseq.shared_tokens == 12
    assert all(pool.refcount(blk) == 3 for blk in bseq.table[:3])
    for seq in list(sched.running):
        sched.finish(seq)
    cache.clear()
    pool.check()
    assert pool.free_blocks == pool.capacity


def test_evictable_excludes_parents_pinned_under_live_children():
    pool = BlockPool(num_blocks=10, block_size=4)
    cache = PrefixCache(pool)
    A, B = (0, 1, 2, 3), (4, 5, 6, 7)
    b1, b2 = pool.alloc(1, 2)
    b3, b4 = pool.alloc(2, 2)
    k0 = cache.register(None, A, b1)
    assert cache.register(None, A, b3) == k0
    k1 = cache.register(k0, B, b4)
    assert cache.register(k0, B, b2) == k1
    pool.free([b1, b2], 1)
    assert pool.refcount(b1) == 1 and pool.refcount(b4) == 2
    assert cache.evictable() == 0
    assert cache.evict(5) == 0
    pool.free([b3, b4], 2)
    assert cache.evictable() == 2
    assert cache.evict(5) == 2 and cache.evictions == 2
    pool.check()
    assert pool.free_blocks == pool.capacity


def test_eviction_is_lru_leaf_first():
    pool = BlockPool(num_blocks=8, block_size=2)
    cache = PrefixCache(pool)
    blocks = pool.alloc("w", 3)
    k0 = cache.register(None, (1, 2), blocks[0])
    cache.register(k0, (3, 4), blocks[1])
    cache.register(None, (9, 9), blocks[2])
    pool.free(blocks, "w")                         # cache-only now
    cache.lookup([9, 9], 1)                        # touch the other root
    tokens = lambda: {e.tokens for e in cache.entries.values()}
    assert cache.evict(1) == 1                     # the chain's leaf goes
    assert tokens() == {(1, 2), (9, 9)}
    assert cache.evict(1) == 1                     # then its parent (LRU)
    assert tokens() == {(9, 9)}
    assert cache.lookup([9, 9], 1)[0] == [blocks[2]]
    cache.clear()
    pool.check()
    assert pool.free_blocks == pool.capacity


def test_prefill_defers_when_eviction_underdelivers():
    pool = BlockPool(num_blocks=5, block_size=4)      # 4 usable
    cache = PrefixCache(pool)
    sched = Scheduler(pool, rows=2, buckets=(8,), max_blocks_per_seq=4,
                      prefix_cache=cache)
    cache.evictable = lambda: 2        # promise blocks evict() cannot free
    sched.submit(Request(uid=0, prompt=np.arange(8, dtype=np.int32),
                         max_new_tokens=8))
    sched.submit(Request(uid=1, prompt=np.arange(8, dtype=np.int32) + 1,
                         max_new_tokens=1))
    plan = sched.plan_tick()
    assert {s.uid for s in plan.admitted} == {0, 1}
    assert plan.prefill is not None and plan.prefill.seq.uid == 0
    plan.prefill.seq.kv_len += plan.prefill.length
    plan = sched.plan_tick()
    assert [s.uid for s in plan.decode] == [0] and plan.prefill is None
    bseq = next(s for s in sched.running if s.uid == 1)
    assert bseq.kv_len == 0 and bseq.table == []
    sched.finish(next(s for s in sched.running if s.uid == 0))
    plan = sched.plan_tick()
    assert plan.prefill is not None and plan.prefill.seq.uid == 1
    pool.check()


def test_lookup_and_register_verify_parent_on_key_collision():
    pool = BlockPool(num_blocks=6, block_size=4)
    cache = PrefixCache(pool)
    cache._key = lambda parent, chunk: hash(chunk)    # drop the chain
    X, Y = (0, 1, 2, 3), (4, 5, 6, 7)
    b1, b2 = pool.alloc("w", 2)
    k0 = cache.register(None, X, b1)
    k1 = cache.register(k0, Y, b2)
    assert k1 is not None
    hits, last = cache.lookup(list(Y + X), 2)
    assert hits == [] and last is None
    hits, last = cache.lookup(list(X + Y), 2)
    assert hits == [b1, b2] and last == k1
    b3 = pool.alloc("v", 1)[0]
    assert cache.register(None, Y, b3) is None
    pool.free([b3], "v")
    pool.free([b1, b2], "w")
    cache.clear()
    pool.check()
    assert pool.free_blocks == pool.capacity


def test_register_with_evicted_parent_stops_chain():
    pool = BlockPool(num_blocks=6, block_size=4)
    cache = PrefixCache(pool)
    b1 = pool.alloc("w", 1)[0]
    k0 = cache.register(None, (0, 1, 2, 3), b1)
    pool.free([b1], "w")
    assert cache.evict(1) == 1
    b2 = pool.alloc("w", 1)[0]
    assert cache.register(k0, (4, 5, 6, 7), b2) is None
    assert len(cache) == 0
    assert cache.lookup([4, 5, 6, 7], 1) == ([], None)
    pool.free([b2], "w")
    pool.check()
    assert pool.free_blocks == pool.capacity
