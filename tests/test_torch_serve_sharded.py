"""Mesh serving of the port on the CPU: ``PagedServeEngine(mesh=...)``
over ``gloo`` ranks against the reference's single-device
``PagedServeEngine`` on the same numpy weights, token for token in f32.

Six scenarios mirror the reference's ``tests/test_serve_sharded.py``
(GQA + BCQ-3 fused and gather; dense under preemption pressure; narrow
GQA, whose pool shards ``head_dim`` and whose decode negotiates down to
``gather``; ``scan_layers``; async against sync with sampled rows; the
prefix cache on, sharded, against off, single-device), plus a BCQ model
whose row-parallel shard boundaries fall inside a group (those linears
fall back to replication and gather their input).  The MLA, MoE and
int8-KV configs: reduced MiniCPM3 (fused and gather at tp 2, one head a
rank at tp 4, 6 heads that tp 4 does not divide), reduced DeepSeek-V2
with its experts over the model axis at (2, 2) and (1, 4) (drops equal
to the unsharded engine's, the routed part bit for bit) and with its
experts kept whole (the mlp-TP fallback) on tp 4, reduced OPT with
ternary weights and an int8 KV cache (fused and gather), and narrow GQA
on an int8 pool.  The reference runs once per weight set in this process
(module-scoped fixtures); every scenario of one mesh runs in one spawn
of 4 ranks, (2, 2) or (1, 4).
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
F32 = dict(dtype="float32")
BCQ16 = dict(BCQ3, group_size=16)
INT8 = dict(GQA, kv_cache_bits=8)
TERNARY = dict(format="ternary", group_size=32, backend="bcq_xla")


def _ref_setup(over, quant=None, arch="opt_6_7b"):
    """(reference Model, params) of reduced ``arch`` with ``over``."""
    import jax
    from repro.configs import get_reduced
    from repro.models import Model
    cfg = get_reduced(arch).replace(remat=False, **over)
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
             params=to_numpy_tree(gqa_p), kw=KW, step_bytes=True,
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
    mla_m, mla_p = _ref_setup(F32, BCQ16, "minicpm3_4b")
    ds_m, ds_p = _ref_setup(F32, arch="deepseek_v2_236b")
    int8_m, int8_p = _ref_setup(INT8, TERNARY)
    both = [dict(name=m, mode=m, kind="sync") for m in ("fused", "gather")]
    scenarios += [
        dict(name="mla", arch="minicpm3_4b", over=F32, quant=BCQ16,
             params=to_numpy_tree(mla_p), kw=KW, runs=both),
        dict(name="deepseek", arch="deepseek_v2_236b", over=F32,
             params=to_numpy_tree(ds_p), kw=KW, routed_exact=True,
             runs=[dict(name="fused", mode="fused", kind="sync")]),
        dict(name="int8", over=INT8, quant=TERNARY,
             params=to_numpy_tree(int8_p), kw=KW, runs=both),
    ]
    refs = {
        "mla": lambda: _ref_tokens(mla_m, mla_p, _ref_requests(mla_m.cfg)),
        "deepseek": lambda: _ref_tokens(ds_m, ds_p,
                                        _ref_requests(ds_m.cfg)),
        "deepseek_drops": lambda: _port_drops(
            "deepseek_v2_236b", F32, to_numpy_tree(ds_p)),
        "int8": lambda: _ref_tokens(int8_m, int8_p,
                                    _ref_requests(int8_m.cfg)),
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


def _mesh14_scenarios(shared):
    """(scenarios on (1, 4), reference jobs): narrow GQA, BCQ groups
    straddling the row-parallel shard boundaries, MLA at heads that do
    not divide, narrow GQA on an int8 pool, and on (2, 2)'s weights
    (``shared``; their reference tokens are (2, 2)'s) MLA at one head a
    rank, DeepSeek-V2 with two experts a rank and with its experts kept
    whole (the rules' ``experts`` mapped nowhere: the mlp-TP cut inside
    each expert that experts not dividing the axis fall back to)."""
    narrow = dict(GQA, n_kv_heads=2)
    nm, np_ = _ref_setup(narrow)
    g64 = dict(BCQ3, group_size=64)
    gm, gp = _ref_setup(GQA, g64)
    odd = dict(F32, n_heads=6, n_kv_heads=6)
    om, op = _ref_setup(odd, arch="minicpm3_4b")
    i8n = dict(narrow, kv_cache_bits=8)
    im, ip = _ref_setup(i8n)
    fused = [dict(name="fused", mode="fused", kind="sync")]
    scenarios = [
        dict(name="narrow", over=narrow, params=to_numpy_tree(np_), kw=KW,
             runs=fused),
        dict(name="group_fallback", over=GQA, quant=g64,
             params=to_numpy_tree(gp), kw=KW, runs=fused),
        dict(name="mla_odd_heads", arch="minicpm3_4b", over=odd,
             params=to_numpy_tree(op), kw=KW, runs=fused),
        dict(name="int8_narrow", over=i8n, params=to_numpy_tree(ip),
             kw=KW, runs=fused),
    ] + [dict(sc, runs=fused) for sc in shared] + [
        dict(sc, name="moe_mlp_tp", rules={"experts": None}, runs=fused,
             routed_exact=False)
        for sc in shared if sc["name"] == "deepseek"]
    refs = {"narrow": lambda: _ref_tokens(nm, np_, _ref_requests(nm.cfg)),
            "group_fallback": lambda: _ref_tokens(gm, gp,
                                                  _ref_requests(gm.cfg)),
            "mla_odd_heads": lambda: _ref_tokens(om, op,
                                                 _ref_requests(om.cfg)),
            "int8_narrow": lambda: _ref_tokens(im, ip,
                                               _ref_requests(im.cfg))}
    return scenarios, refs


def _port_drops(arch, over, params):
    """The drops beyond capacity of the port's single-device engine (its
    tokens equal the reference's, and so does its routing in f32,
    ``tests/test_torch_moe.py``) on the requests the ranks serve."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import from_jax_params
    from repro_torch.serve import PagedServeEngine, Request
    cfg = get_reduced(arch).replace(**over)
    eng = PagedServeEngine(from_jax_params(params, cfg, device="cpu"),
                           paged_kernel="fused", **KW)
    eng.run([Request(uid=r.uid, prompt=np.asarray(r.prompt),
                     max_new_tokens=r.max_new_tokens)
             for r in _ref_requests(cfg)])
    return eng.moe_drops()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both meshes' ranks (spawned in threads while the reference's
    engines run here): {mesh: per-rank results}, reference tokens."""
    import threading
    out, refs, errors = {}, {}, []

    def run(key, tmp, shape, scenarios):
        try:
            out[key] = _spawn(tmp, shape, scenarios)
        except BaseException as e:          # re-raised below
            errors.append(e)
    threads = []
    s22, jobs = _mesh22_scenarios()
    refs.update(jobs)
    s14, jobs = _mesh14_scenarios(
        [sc for sc in s22 if sc["name"] in ("mla", "deepseek")])
    refs.update(jobs)
    for key, shape, scenarios in (("mesh22", (2, 2), s22),
                                  ("mesh14", (1, 4), s14)):
        tmp = str(tmp_path_factory.mktemp(key))   # not from two threads
        threads.append(threading.Thread(target=run,
                                        args=(key, tmp, shape, scenarios)))
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


@pytest.mark.parametrize("mode", ["fused", "gather"])
def test_sharded_mla_matches_single_device(mesh22, mode):
    """Reduced MiniCPM3 (BCQ-3 g 16) at tp 2: each rank's q_b rows and o
    columns are its 2 query heads' (dn + dr = 24, dv = 16 wide), the
    latent pool is whole and equal on both ranks of a model group, the
    decode runs ``mode`` on the local heads and prefill gathers."""
    ranks, ref = mesh22
    _assert_equal_tokens(ranks, ref["mla"], "mla", mode)
    for r, got in zip(ranks, _every_rank(ranks, "mla", mode)):
        m = r["coords"][1]
        assert got["decode_path"] == mode and got["prefill_path"] == "gather"
        assert got["k_shape"] == [24, 4, 16] and got["k_spec"] is None
        assert got["same_pool_leaves"]
        assert got["linears"]["q"] == [[48 * m, 48 * (m + 1)], None]
        assert got["linears"]["o"] == [None, [32 * m, 32 * (m + 1)]]


def test_sharded_mla_one_head_a_rank_and_odd_heads(mesh14):
    """MiniCPM3 at tp 4 (one head a rank: fused), and with 6 heads,
    which tp 4 does not divide: every rank attends for all heads on the
    gathered path even when ``fused`` is forced, as the reference
    negotiates."""
    ranks, ref = mesh14
    _assert_equal_tokens(ranks, ref["mla"], "mla", "fused")
    _assert_equal_tokens(ranks, ref["mla_odd_heads"], "mla_odd_heads",
                         "fused")
    for r in ranks:
        m = r["coords"][1]
        one, odd = r["mla"]["fused"], r["mla_odd_heads"]["fused"]
        assert one["decode_path"] == "fused" and one["same_pool_leaves"]
        assert one["linears"]["q"] == [[24 * m, 24 * (m + 1)], None]
        assert odd["decode_path"] == "gather" and odd["same_pool_leaves"]


@pytest.mark.parametrize("mesh", ["mesh22", "mesh14"])
def test_sharded_deepseek_expert_parallel(request, mesh):
    """Reduced DeepSeek-V2 (8 experts top-2, a shared expert, a dense
    first layer) with its experts over the model axis:
    4 a rank at tp 2, 2 at tp 4.  Tokens equal the reference's, drops
    the unsharded engine's, and the routed part of a MoE layer equals
    the unsharded layer's bit for bit."""
    ranks, ref = request.getfixturevalue(mesh)
    tp = ranks[0]["coords"] and max(r["coords"][1] for r in ranks) + 1
    _assert_equal_tokens(ranks, ref["deepseek"], "deepseek", "fused")
    for r in ranks:
        got = r["deepseek"]["fused"]
        m, per = r["coords"][1], 8 // tp
        assert r["deepseek"]["routed_exact"]
        assert got["moe_drops"] == ref["deepseek_drops"] > 0
        assert got["decode_path"] == "fused" and got["same_pool_leaves"]
        assert got["linears"]["moe"]["experts"] == [per * m, per * (m + 1)]
        assert got["linears"]["moe"]["bank_shape"][0] == per


def test_sharded_moe_falls_back_to_mlp_tp(mesh14):
    """The experts kept whole (as where they do not divide the axis):
    every rank holds all 8, each expert's gate / up rows and down
    columns split (moe_d_ff 32: 8 a rank), its output all-reduced."""
    ranks, ref = mesh14
    _assert_equal_tokens(ranks, ref["deepseek"], "moe_mlp_tp", "fused")
    for r in ranks:
        m = r["coords"][1]
        got = r["moe_mlp_tp"]["fused"]
        moe = got["linears"]["moe"]
        assert moe["experts"] is None and moe["bank_shape"] == [8, 8, 64]
        assert moe["cut"] == [8 * m, 8 * (m + 1)]
        assert got["moe_drops"] == ref["deepseek_drops"]


@pytest.mark.parametrize("mode", ["fused", "gather"])
def test_sharded_int8_kv_matches_single_device(mesh22, mode):
    """Reduced OPT, ternary weights and an int8 KV cache at tp 2: each
    rank's pool and its scale pools hold 2 of the 4 kv heads."""
    ranks, ref = mesh22
    _assert_equal_tokens(ranks, ref["int8"], "int8", mode)
    for got in _every_rank(ranks, "int8", mode):
        assert got["decode_path"] == got["prefill_path"] == mode
        assert got["k_dtype"] == "torch.int8"
        assert got["k_shape"] == [24, 4, 2, 16]
        assert got["scale_shape"] == [24, 4, 2]


def test_sharded_int8_narrow_gqa_keeps_row_scales(mesh14):
    """2 kv heads on tp 4, int8: the pool cuts head_dim, each row is
    quantized whole before the cut so its scale pools hold every head
    (equal on every rank), and the path negotiates down to gather."""
    ranks, ref = mesh14
    _assert_equal_tokens(ranks, ref["int8_narrow"], "int8_narrow", "fused")
    for got in _every_rank(ranks, "int8_narrow", "fused"):
        assert got["decode_path"] == got["prefill_path"] == "gather"
        assert got["k_shape"] == [24, 4, 2, 4]
        assert got["scale_shape"] == [24, 4, 2]
        assert got["same_pool_leaves"]


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


def test_mesh_counts_collective_bytes(mesh22):
    """One tp-2 decode step's all-reduce bytes are the TP plan's closed
    form: the vocab-parallel embedding's lookup, then each layer's two
    row-parallel linears (``o``, ``down``), each an f32 [B, d] sum; its
    all-gathers hold at least the vocab-parallel logits, f32 [B, V]."""
    from repro_torch.configs import get_reduced
    cfg = get_reduced("opt_6_7b").replace(**GQA)
    for r in mesh22[0]:
        step = r["gqa_bcq"]["step_coll"]
        b = step["rows"]
        assert step["bytes"]["all-reduce"] == \
            (1 + 2 * cfg.n_layers) * b * cfg.d_model * 4
        assert step["bytes"]["all-gather"] >= b * cfg.padded_vocab * 4


LAUNCH = ["--device", "cpu", "--bits", "3", "--group-size", "32",
          "--requests", "4", "--max-new", "4"]


@pytest.mark.parametrize("arch", [[], ["--arch", "deepseek_v2_236b",
                                         "--reduced", "1",
                                         "--group-size", "16"]])
def test_launcher_under_torchrun(arch):
    """OPT, and reduced DeepSeek-V2 (MLA + MoE): rank 0 reports every
    rank's MoE drops (equal: the routing is whole on each) and host
    syncs a decode step (0: CPU tensors)."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         *LAUNCH, "--mesh", "1x2", *arch],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "mesh {'data': 1, 'model': 2} over 2 ranks, backend gloo" in out
    assert "4 requests, 16 tokens" in out
    # only rank 0 prints the report
    assert out.count("4 requests, 16 tokens") == 1
    drops = [line.split("MoE drops ")[1].split(",")[0]
             for line in out.splitlines() if "MoE drops" in line]
    assert len(drops) == 2 and drops[0] == drops[1]
    assert (int(drops[0]) > 0) == bool(arch)
    assert out.count("host syncs a decode step 0\n") == 2


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
