"""Mesh serving of the port on the CPU: ``PagedServeEngine(mesh=...)``
over ``gloo`` ranks against the reference's single-device
``PagedServeEngine`` on the same numpy weights, token for token in f32.

The six scenarios mirror the reference's ``tests/test_serve_sharded.py``
(GQA + BCQ-3 fused and gather; dense under preemption pressure; narrow
GQA, whose pool shards ``head_dim`` and whose decode negotiates down to
``gather``; ``scan_layers``; async against sync with sampled rows; the
prefix cache on, sharded, against off, single-device), plus a BCQ model
whose row-parallel shard boundaries fall inside a group (those linears
fall back to replication and gather their input).  The reference runs
once per scenario in this process (module-scoped fixtures); every
scenario of one mesh runs in one spawn of 4 ranks, (2, 2) or (1, 4).
Also the launcher under ``torchrun`` at (1, 2) and its refusals.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from torch_port_cases import f32_params, ref_paged_engine, to_numpy_tree

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORKER = os.path.join(os.path.dirname(__file__), "torch_sharded_worker.py")

KW = dict(num_blocks=24, block_size=4, max_batch=4, max_seq_len=64,
          prefill_buckets=(8, 16))
GQA = dict(dtype="float32", n_heads=8, n_kv_heads=4, head_dim=16)
BCQ3 = dict(bits=3, group_size=32, iters=2, backend="bcq_xla")


def _ref_setup(over, quant=None):
    """(reference Model, params) of reduced OPT with ``over``."""
    import jax
    from repro.configs import get_reduced
    from repro.models import Model
    cfg = get_reduced("opt_6_7b").replace(remat=False, **over)
    model = Model(cfg)
    params = f32_params(model.init(jax.random.PRNGKey(0)))
    if quant:
        from repro.quant import QuantSpec, quantize_model
        spec = QuantSpec(**quant)
        params, _ = quantize_model(params, spec, model.axes())
        model = Model(cfg.replace(quant=spec))
    return model, params


def _ref_tokens(model, params, reqs, kw=KW, **eng):
    """The reference engine's tokens (``ref_paged_engine``: a copy of its
    block tables on every tick)."""
    e = ref_paged_engine(model, params, **kw, **eng)
    done = e.run(reqs)
    e.pool.check()
    return {str(r.uid): [int(t) for t in r.out_tokens] for r in done}


def _ref_requests(cfg, lens=(5, 11, 3, 17), max_new=5, sampled=False):
    from repro.serve import Request
    rng = np.random.default_rng(0)
    out = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, (int(n),)),
                   max_new_tokens=max_new)
           for i, n in enumerate(lens)]
    if sampled:
        for r in out[1::2]:
            r.temperature, r.top_k, r.seed = 0.7, 8, 99 + r.uid
    return out


def _ref_shared(cfg, base_uid=0, max_new=4):
    from repro.serve import Request
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, cfg.vocab_size, (12,))
    return [Request(uid=base_uid + i,
                    prompt=np.concatenate(
                        [prefix, rng.integers(0, cfg.vocab_size, (int(t),))]),
                    max_new_tokens=max_new)
            for i, t in enumerate((3, 6, 2, 5))]


def _spawn(tmp, mesh, scenarios):
    """Every scenario on one mesh of 4 gloo ranks; per-rank results."""
    from repro_torch.launch.mesh import spawn
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"mesh": mesh, "scenarios": scenarios}, f)
    outs = spawn([sys.executable, WORKER, job, tmp], 4,
                 env={"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"},
                 timeout=400)
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{err[-3000:]}"
    return [json.load(open(os.path.join(tmp, f"rank{r}.json")))
            for r in range(4)]


def _mesh22_scenarios():
    """(scenarios on (2, 2), reference jobs): GQA + BCQ-3, dense under
    preemption, scan_layers, sampled rows, the prefix cache."""
    gqa_m, gqa_p = _ref_setup(GQA, BCQ3)
    dense_m, dense_p = _ref_setup(GQA)
    scan_m, scan_p = _ref_setup({**GQA, "scan_layers": True})
    lens = (9, 13, 6, 11)
    dense_np = to_numpy_tree(dense_p)
    scenarios = [
        dict(name="gqa_bcq", over=GQA, quant=BCQ3,
             params=to_numpy_tree(gqa_p), kw=KW,
             runs=[dict(name=m, mode=m, kind="sync")
                   for m in ("fused", "gather")]),
        dict(name="dense_preempt", over=GQA, params=dense_np,
             kw=dict(KW, num_blocks=10), lens=lens,
             runs=[dict(name="fused", mode="fused", kind="sync")]),
        dict(name="scan", over={**GQA, "scan_layers": True},
             params=to_numpy_tree(scan_p), kw=KW,
             runs=[dict(name="fused", mode="fused", kind="sync")]),
        dict(name="sampled", over=GQA, params=dense_np, kw=KW,
             runs=[dict(name="sync", mode="fused", kind="sync",
                        sampled=True),
                   dict(name="async", mode="fused", kind="async",
                        sampled=True)]),
        dict(name="prefix", over=GQA, params=dense_np, kw=KW,
             runs=[dict(name="on", mode="fused", kind="prefix",
                        prefix=True)]),
    ]
    refs = {
        "gqa_bcq": lambda: _ref_tokens(gqa_m, gqa_p,
                                       _ref_requests(gqa_m.cfg)),
        "dense_preempt": lambda: _ref_tokens(
            dense_m, dense_p, _ref_requests(dense_m.cfg, lens),
            kw=dict(KW, num_blocks=10)),
        "scan": lambda: _ref_tokens(scan_m, scan_p,
                                    _ref_requests(scan_m.cfg)),
        "sampled": lambda: _ref_tokens(
            dense_m, dense_p, _ref_requests(dense_m.cfg, sampled=True)),
        "prefix": lambda: _ref_tokens(dense_m, dense_p,
                                      _ref_shared(dense_m.cfg)),
    }
    return scenarios, refs


def _mesh14_scenarios():
    """(scenarios on (1, 4), reference jobs): narrow GQA, and BCQ
    groups straddling the row-parallel shard boundaries."""
    narrow = dict(GQA, n_kv_heads=2)
    nm, np_ = _ref_setup(narrow)
    g64 = dict(BCQ3, group_size=64)
    gm, gp = _ref_setup(GQA, g64)
    scenarios = [
        dict(name="narrow", over=narrow, params=to_numpy_tree(np_), kw=KW,
             runs=[dict(name="fused", mode="fused", kind="sync")]),
        dict(name="group_fallback", over=GQA, quant=g64,
             params=to_numpy_tree(gp), kw=KW,
             runs=[dict(name="fused", mode="fused", kind="sync")]),
    ]
    refs = {"narrow": lambda: _ref_tokens(nm, np_, _ref_requests(nm.cfg)),
            "group_fallback": lambda: _ref_tokens(gm, gp,
                                                  _ref_requests(gm.cfg))}
    return scenarios, refs


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both meshes' ranks (spawned in threads while the reference's
    engines run here): {mesh: per-rank results}, reference tokens."""
    import threading
    out, refs, errors = {}, {}, []

    def run(key, shape, scenarios):
        try:
            tmp = str(tmp_path_factory.mktemp(key))
            out[key] = _spawn(tmp, shape, scenarios)
        except BaseException as e:          # re-raised below
            errors.append(e)
    threads = []
    for key, shape, make in (("mesh22", (2, 2), _mesh22_scenarios),
                             ("mesh14", (1, 4), _mesh14_scenarios)):
        scenarios, jobs = make()
        refs.update(jobs)
        threads.append(threading.Thread(target=run,
                                        args=(key, shape, scenarios)))
        threads[-1].start()
    ref = {name: job() for name, job in refs.items()}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, ref


@pytest.fixture(scope="module")
def mesh22(served):
    """Scenarios on (2, 2): (results by rank, reference tokens)."""
    return served[0]["mesh22"], served[1]


@pytest.fixture(scope="module")
def mesh14(served):
    """Scenarios on (1, 4): (results by rank, reference tokens)."""
    return served[0]["mesh14"], served[1]


def _every_rank(ranks, scenario, run):
    return [r[scenario][run] for r in ranks]


def _assert_equal_tokens(ranks, ref, scenario, run):
    for i, got in enumerate(_every_rank(ranks, scenario, run)):
        assert got["tokens"] == ref, (scenario, run, i, got["tokens"], ref)
        assert got["same_host_state"], (scenario, run, i)
        assert got["pool_free"], (scenario, run, i)


@pytest.mark.parametrize("mode", ["fused", "gather"])
def test_sharded_gqa_bcq_matches_single_device(mesh22, mode):
    ranks, ref = mesh22
    _assert_equal_tokens(ranks, ref["gqa_bcq"], "gqa_bcq", mode)
    for r, got in zip(ranks, _every_rank(ranks, "gqa_bcq", mode)):
        assert got["decode_path"] == mode and got["prefill_path"] == mode
        # 4 kv heads over tp 2: each rank's pool holds 2 of them
        assert got["k_spec"] == [None, None, "model"]
        assert got["k_shape"] == [24, 4, 2, 16]
        assert got["tokens_out"] > 0
        m = r["coords"][1]
        # q column-parallel, o row-parallel, up/down as the MLP's TP pair
        assert got["linears"]["q"] == [[64 * m, 64 * (m + 1)], None]
        assert got["linears"]["o"] == [None, [64 * m, 64 * (m + 1)]]
        assert got["linears"]["up"] == [[64 * m, 64 * (m + 1)], None]
        assert got["linears"]["down"] == [None, [64 * m, 64 * (m + 1)]]


def test_sharded_dense_with_preemption_pressure(mesh22):
    ranks, ref = mesh22
    _assert_equal_tokens(ranks, ref["dense_preempt"], "dense_preempt",
                         "fused")
    got = _every_rank(ranks, "dense_preempt", "fused")
    assert all(g["decode_path"] == "fused" for g in got)
    assert all(g["preempted"] > 0 for g in got)


def test_sharded_narrow_gqa_shards_head_dim_and_gathers(mesh14):
    ranks, ref = mesh14
    _assert_equal_tokens(ranks, ref["narrow"], "narrow", "fused")
    for got in _every_rank(ranks, "narrow", "fused"):
        # forced fused still negotiates down: kv_heads 2 on tp 4
        assert got["decode_path"] == "gather"
        assert got["prefill_path"] == "gather"
        assert got["k_spec"] == [None, None, None, "model"]
        assert got["k_shape"] == [24, 4, 2, 4]


def test_sharded_scan_stacked_layers(mesh22):
    ranks, ref = mesh22
    _assert_equal_tokens(ranks, ref["scan"], "scan", "fused")
    for got in _every_rank(ranks, "scan", "fused"):
        assert got["decode_path"] == "fused"
        # the stacked cache's leading layers axis moves kv_heads along
        assert got["k_spec"] == [None, None, None, "model"]
        assert got["k_shape"] == [24, 4, 2, 16]


def test_sharded_async_matches_sync_with_sampled_rows(mesh22):
    ranks, ref = mesh22
    _assert_equal_tokens(ranks, ref["sampled"], "sampled", "sync")
    _assert_equal_tokens(ranks, ref["sampled"], "sampled", "async")
    assert all(g["decode_path"] == "fused"
               for g in _every_rank(ranks, "sampled", "async"))


def test_sharded_prefix_cache_matches_single_device_off(mesh22):
    ranks, ref = mesh22
    want = {}
    for uid, toks in ref["prefix"].items():
        want[uid] = toks
        want[str(int(uid) + 10)] = toks
    _assert_equal_tokens(ranks, want, "prefix", "on")
    assert all(g["hit_blocks"] > 0
               for g in _every_rank(ranks, "prefix", "on"))


def test_sharded_bcq_group_boundary_falls_back(mesh14):
    """g 64 on tp 4: o's and down's inputs (128 wide) would split into
    32-column shards inside a group, so those linears stay replicated
    (their input gathered); q and up still split their rows."""
    ranks, ref = mesh14
    _assert_equal_tokens(ranks, ref["group_fallback"], "group_fallback",
                         "fused")
    for r, got in zip(ranks, _every_rank(ranks, "group_fallback", "fused")):
        m = r["coords"][1]
        assert got["linears"]["o"] == [None, None]
        assert got["linears"]["down"] == [None, None]
        assert got["linears"]["q"] == [[32 * m, 32 * (m + 1)], None]
        assert got["decode_path"] == "fused"


def test_mesh_ranks_and_backend(mesh22, mesh14):
    """Every rank sits at its own coordinates, runs gloo with nothing
    staged through host memory (CPU tensors), and refuses to export its
    slices as a whole tree."""
    for ranks, shape in ((mesh22[0], (2, 2)), (mesh14[0], (1, 4))):
        assert all(r[sc]["to_params_refused"] for r in ranks
                   for sc in r if isinstance(r[sc], dict))
        coords = sorted(tuple(r["coords"]) for r in ranks)
        assert coords == [(d, m) for d in range(shape[0])
                          for m in range(shape[1])]
        assert all(r["backend"] == "gloo" and r["host_syncs"] == 0
                   and r["collectives"] > 0 for r in ranks)


LAUNCH = ["--device", "cpu", "--bits", "3", "--group-size", "32",
          "--requests", "4", "--max-new", "4"]


def test_launcher_under_torchrun():
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         *LAUNCH, "--mesh", "1x2"],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "mesh {'data': 1, 'model': 2} over 2 ranks, backend gloo" in out
    assert "4 requests, 16 tokens" in out
    # only rank 0 prints the report
    assert out.count("4 requests, 16 tokens") == 1


@pytest.mark.parametrize("extra,msg", [
    (["--engine", "slots", "--mesh", "1x1"],
     "--mesh requires the paged engine"),
    (["--tp", "2"], "--tp only applies with --mesh auto"),
    (["--mesh", "auto", "--tp", "3"],
     "--tp 3 does not divide the 1 visible devices"),
    (["--mesh", "1x2"], "--mesh 1x2 needs 2 devices, found 1"),
    (["--mesh", "2by2"], "--mesh expects 'auto' or 'DxM' (e.g. 2x4), got "
                         "'2by2'"),
    (["--mesh", "1x2", "--tp", "4"],
     "--tp 4 contradicts --mesh 1x2 (model axis 2)"),
])
def test_launcher_mesh_refusals(monkeypatch, extra, msg):
    from repro_torch.launch import serve
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit) as e:
        serve.main(LAUNCH + extra)
    assert str(e.value).startswith(msg), str(e.value)
