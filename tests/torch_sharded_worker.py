"""One rank of the sharded-serving scenarios of
``tests/test_torch_serve_sharded.py`` and of the two-rank card test in
``tests/test_torch_cuda.py`` (run by ``launch.mesh.spawn``).

    python tests/torch_sharded_worker.py JOB.pkl OUT_DIR

``JOB.pkl`` holds the mesh shape, the device type (default the CPU),
optionally a data-parallel training job (``run_train``, for
``tests/test_torch_train_mesh.py``), a sharded training job
(``run_tp_train``, for ``tests/test_torch_train_tp.py``) and the
scenarios, each with its
OPT config (reduced, or ``full`` width) and overrides, its numpy
parameter tree (the reference's, quantized where the scenario is) and
its engine arguments; every rank serves each scenario through
``PagedServeEngine(mesh=...)`` over ``gloo`` and writes
``OUT_DIR/rank{r}.json``: per scenario and run, the greedy (or seeded)
tokens, the paths taken, the pool slice's shape and spec, and whether
every rank's host state agrees.  Imports no JAX.
"""
import json
import os
import pickle
import sys

import numpy as np
import torch

torch.set_num_threads(1)


def requests(cfg, lens=(5, 11, 3, 17), max_new=5, sampled=False):
    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    out = [Request(uid=i,
                   prompt=rng.integers(0, cfg.vocab_size, (int(n),)),
                   max_new_tokens=max_new)
           for i, n in enumerate(lens)]
    if sampled:
        for r in out[1::2]:
            r.temperature, r.top_k, r.seed = 0.7, 8, 99 + r.uid
    return out


def shared(cfg, base_uid=0, max_new=4):
    from repro_torch.serve import Request
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, cfg.vocab_size, (12,))
    return [Request(uid=base_uid + i,
                    prompt=np.concatenate(
                        [prefix, rng.integers(0, cfg.vocab_size, (int(t),))]),
                    max_new_tokens=max_new)
            for i, t in enumerate((3, 6, 2, 5))]


def tokens_of(done):
    return {str(r.uid): [int(t) for t in r.out_tokens] for r in done}


def pool_spec(cfg, mesh, rules):
    """The spec of the first layer's ``k`` pool leaf in the reference's
    cache layout (a leading ``layers`` axis under ``scan_layers``); an
    MLA layer's ``ckv`` pool has no head axis: None."""
    from repro_torch.models.module import paged_cache_axes
    from repro_torch.parallel.sharding import spec_for
    if cfg.attention == "mla":
        return None
    axes = paged_cache_axes(cfg)
    stack = axes.get("layers") or axes.get("prefix") or axes["scan"]
    k = stack[0]["self"]["k"]
    hkv = cfg.n_kv_heads * cfg.kv_replication
    shape = ((cfg.n_layers,) if k[0] == "layers" else ()) \
        + (1, 1, hkv, cfg.head_dim_)
    return list(spec_for(shape, k, mesh, rules))


def layer_cuts(model):
    """The first layer's linears' (out, in) slices (GQA: ``q``, ``o``;
    MLA: ``q_b``, ``o``), its dense MLP's (``up``, ``down``), and the
    first MoE layer's plan (``experts``, ``rows``, ``cols``)."""
    from repro_torch.models.moe import MoE
    blk = model.stack.layers[0]
    mix = blk.mixer
    mla = model.cfg.attention == "mla"
    lins = [("q", mix.q_b if mla else mix.q), ("o", mix.o)]
    if blk.mlp is not None and not isinstance(blk.mlp, MoE):
        lins += [("up", blk.mlp.up), ("down", blk.mlp.down)]
    out = {name: [lin.out_slice, lin.in_slice] for name, lin in lins}
    moe = next((b.mlp for b in model.stack.layers
                if isinstance(b.mlp, MoE)), None)
    if moe is not None:
        out["moe"] = {k: getattr(moe.tp, k) for k in ("experts", "cut")}
        out["moe"]["bank_shape"] = list(
            getattr(moe.gate.weight, "packed", moe.gate.weight).shape)
    return out


def routed_exact(sc, model, mesh):
    """Whether the first MoE layer's routed output (shared experts
    left out) on this rank equals the unsharded layer's bit for bit, on
    a seeded f32 input of 3 rows x 7 tokens."""
    import copy

    from repro_torch.models import from_jax_params
    from repro_torch.models.moe import MoE
    whole = from_jax_params(sc["params"], model.cfg, device="cpu")
    pick = lambda m: next(b.mlp for b in m.stack.layers
                          if isinstance(b.mlp, MoE))
    mine, ref = copy.copy(pick(model)), copy.copy(pick(whole))
    for mod in (mine, ref):
        mod._modules = dict(mod._modules)     # the copies' own
        mod.shared_gate = mod.shared_up = mod.shared_down = None
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 7, model.cfg.d_model)).astype(np.float32))
    return bool(torch.equal(mine(x), ref(x))
                and torch.equal(mine.last_keep, ref.last_keep))


def run_scenario(sc, mesh):
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import _lib
    from repro_torch.models import shard_model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.quant import QuantSpec
    from repro_torch.serve import PagedServeEngine
    base = get_config if sc.get("full") else get_reduced
    cfg = base(sc.get("arch", "opt_6_7b")).replace(**sc["over"])
    if sc.get("quant"):
        cfg = cfg.replace(quant=QuantSpec(**sc["quant"]))
    rules = make_rules(extra=sc.get("rules"))
    model = shard_model(sc["params"], cfg, mesh, rules, mesh.device)
    from repro_torch.models import to_params
    try:
        to_params(model)
        refused = False
    except ValueError:
        refused = True
    out = {"to_params_refused": refused}
    if sc.get("step_bytes"):
        out["step_coll"] = decode_step_bytes(model, mesh)
    if sc.get("routed_exact"):
        out["routed_exact"] = routed_exact(sc, model, mesh)
    for run in sc["runs"]:
        _lib.reset_launch_counts()
        eng = PagedServeEngine(model, mesh=mesh, paged_kernel=run["mode"],
                               prefix_cache=run.get("prefix", False),
                               **sc["kw"])
        if run["kind"] == "prefix":
            eng.run(shared(cfg))
            done = eng.run(shared(cfg, base_uid=10))
        else:
            reqs = requests(cfg, lens=sc.get("lens", (5, 11, 3, 17)),
                            sampled=run.get("sampled", False))
            done = (eng.run_async(reqs) if run["kind"] == "async"
                    else eng.run(reqs))
        eng.pool.check()
        s = eng.metrics.summary()
        if eng.prefix is not None:
            eng.prefix.clear()          # its references hold blocks
        layer = eng.cache["layers"][0]
        k = layer["k"] if "k" in layer else layer["ckv"]
        out[run["name"]] = {
            "tokens": tokens_of(done),
            "decode_path": eng.decode_path,
            "prefill_path": eng.prefill_path,
            "k_shape": list(k.shape),
            "k_dtype": str(k.dtype),
            "scale_shape": list(layer["k_scale"].shape)
            if "k_scale" in layer else None,
            "k_spec": pool_spec(cfg, mesh, rules),
            "tokens_out": s["counters"]["tokens_out"],
            "preempted": s["counters"]["preempted"],
            "hit_blocks": s["counters"].get("prefix_hit_blocks", 0),
            "pool_free": eng.pool.free_blocks == eng.pool.capacity,
            "same_host_state": mesh.same_on_all(eng.host_state()),
            "same_pool_leaves": mesh.same_within(eng.pool_state(), "model"),
            **eng.rank_report(),
            "launches": dict(_lib.launch_counts),
            "routes": dict(_lib.route_counts),
            "linears": layer_cuts(model),
        }
    return out


def decode_step_bytes(model, mesh, b=3):
    """The bytes each collective kind moved in one decode step of ``b``
    rows on a fresh paged cache (``Mesh.coll_bytes``, read through
    ``roofline.analysis.measure``)."""
    from repro_torch.models import set_block_tables
    from repro_torch.roofline.analysis import measure
    cache = model.init_paged_cache(b, num_blocks=8, block_size=4,
                                   max_blocks_per_seq=2)
    cache = set_block_tables(cache, [[2 * i, 2 * i + 1] for i in range(b)])
    tokens = torch.arange(1, b + 1, dtype=torch.int32)[:, None]
    _, _, coll = measure(model.decode_step, tokens, cache,
                         torch.zeros(b, dtype=torch.int32), mesh=mesh)
    return {"rows": b, "bytes": coll}


def run_train(tj, mesh, out_dir):
    """Train reduced OPT (f32, the job's numpy weights) data-parallel on
    ``mesh``: each rank its shard of the global batch.  Writes the
    rank's losses, grad norms and final parameters; then asks for a
    trainer on a (1, world) mesh and records its refusal."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model, from_jax_params
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = get_reduced("opt_6_7b").replace(**tj["over"])
    model = from_jax_params(tj["params"], cfg, device=mesh.device)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=tj["seq_len"],
                       global_batch=tj["global_batch"], seed=1,
                       data_shard=mesh.index("data"),
                       data_shards=mesh.size("data"))
    tr = Trainer(model, adamw.AdamWConfig(**tj["opt"]),
                 TrainConfig(steps=tj["steps"], ckpt_every=tj["steps"],
                             ckpt_dir=tj["ckpt_dir"], log_every=100),
                 mesh=mesh)
    state, hist = tr.run(pipe, state=tr.fresh_state())
    np.savez(os.path.join(out_dir, f"train{mesh.rank}.npz"),
             *[t.detach().cpu().numpy() for t in tree_leaves(state["params"])])
    out = {"hist": hist, "recoveries": tr.recoveries,
           "batch": pipe.batch_at(0)["tokens"].tolist()}
    # the checkpoint the ranks wrote, restored by a trainer off the mesh
    # (a whole model of its own) and placed on it
    before = [t.detach().clone() for t in tree_leaves(state)]
    solo = Trainer(from_jax_params(tj["params"], cfg, device=mesh.device),
                   adamw.AdamWConfig(**tj["opt"]),
                   TrainConfig(ckpt_dir=tj["ckpt_dir"]))
    restored, at = solo._restore(tj["steps"])
    placed = solo.reshard_to(mesh, restored)
    out["reshard"] = {"step": at, "on_mesh": solo.mesh is mesh, "equal": all(
        torch.equal(a, b) for a, b in zip(tree_leaves(placed), before))}
    # what a model axis still refuses, by name
    tp = make_mesh((1, mesh.size_total), ("data", "model"),
                   device_type=mesh.device.type)
    out["tp_refusals"] = {}
    for arch in ("mamba2_2_7b", "whisper_medium"):
        try:
            Trainer(Model(get_reduced(arch), device="meta"),
                    adamw.AdamWConfig(), TrainConfig(), mesh=tp)
            out["tp_refusals"][arch] = None
        except NotImplementedError as e:
            out["tp_refusals"][arch] = str(e)
    return out


class _Rows:
    """This data shard's rows of a pipeline's global batch."""

    def __init__(self, pipe, shard, shards):
        self.pipe, self.shard, self.shards = pipe, shard, shards

    def batch_at(self, step):
        t = self.pipe.batch_at(step)["tokens"]
        n = t.shape[0] // self.shards
        return {"tokens": t[self.shard * n:(self.shard + 1) * n]}


def run_tp_train(tj, mesh, out_dir):
    """Train each case's reduced config (f32, the job's numpy weights) on
    ``mesh`` under ``make_rules(fsdp, act_shard)``.  Rank 0 writes, per
    case, ``tp_{name}.npz``: the whole (gathered) gradients of the job's
    batch, then the whole params and moments after ``steps`` trainer
    steps on the global batch of ``SyntheticLM(seed=1)`` (each rank its
    data shard's rows), and with ``restore_from`` the whole state of
    that checkpoint placed on this mesh by ``reshard_to``.  Returns per
    case the loss, the history, whether the sharded init equals the
    unsharded one from the same seed, and this rank's element counts of
    every leaf's weight and moments beside the whole leaf's."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import Model, from_jax_params
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves
    d, n_data = mesh.index("data"), mesh.size("data")
    res = {}
    for case in tj["cases"]:
        cfg = get_reduced(case["arch"]).replace(**case["over"])
        rules = make_rules(fsdp=case["fsdp"], act_shard=case["act"])
        tcfg = TrainConfig(steps=tj["steps"], ckpt_every=tj["steps"],
                           ckpt_dir=case["ckpt_dir"], fsdp=case["fsdp"],
                           log_every=100)
        opt = adamw.AdamWConfig(**tj["opt"])
        out, arrays = {}, {}
        # the sharded init against the unsharded one, seed 7
        tr = Trainer(Model(cfg, device="meta", dtype=torch.float32), opt,
                     tcfg, mesh=mesh, rules=rules)
        st = tr.init_state(7)
        whole = tr.plan.whole([t.detach() for t in
                               tree_leaves(st["params"])])
        ref = Model(cfg, device="cpu", dtype=torch.float32)
        ref.init_params(torch.Generator().manual_seed(7))
        out["init_equal"] = all(torch.equal(a, b) for a, b in zip(
            whole, tree_leaves(ref.train_params())))
        del tr, st, whole, ref
        model = from_jax_params(case["params"], cfg, device=mesh.device)
        tr = Trainer(model, opt, tcfg, mesh=mesh, rules=rules)
        state = tr.fresh_state()
        plan = tr.plan
        tokens = case["tokens"]
        rows = tokens.shape[0] // n_data
        leaves = tree_leaves(state["params"])
        loss, grads = tr._value_and_grad(
            leaves, {"tokens": torch.as_tensor(
                tokens[d * rows:(d + 1) * rows])})
        if n_data > 1:
            grads, loss = tr._data_mean(grads, loss)
        out["loss"] = float(loss)
        arrays["grads"] = plan.whole(grads)
        out["sizes"] = [
            [p.numel(), m.numel(), v.numel(), w.numel(), list(axes)]
            for p, m, v, w, axes in zip(
                leaves, tree_leaves(state["opt"].m),
                tree_leaves(state["opt"].v), plan._meta, plan.cut_axes)]
        if not case.get("grads_only"):
            pipe = _Rows(SyntheticLM(vocab_size=cfg.vocab_size,
                                     seq_len=tokens.shape[1],
                                     global_batch=tokens.shape[0], seed=1),
                         d, n_data)
            state, hist = tr.run(pipe, state=state)
            out["hist"], out["recoveries"] = hist, tr.recoveries
            for key, tree in (("params", state["params"]),
                              ("m", state["opt"].m), ("v", state["opt"].v)):
                arrays[key] = plan.whole([t.detach() for t in
                                          tree_leaves(tree)])
        if case.get("restore_from"):
            restored, at, _ = ckpt.restore(case["restore_from"], mmap=True)
            back = Trainer(Model(cfg, device="meta", dtype=torch.float32),
                           opt, tcfg, rules=rules)
            placed = back.reshard_to(mesh, restored)
            out["restored_step"] = int(at)
            for key, tree in (("r_params", placed["params"]),
                              ("r_m", placed["opt"].m),
                              ("r_v", placed["opt"].v)):
                arrays[key] = back.plan.whole(tree_leaves(tree))
        if mesh.rank == 0:
            np.savez(os.path.join(out_dir, f"tp_{case['name']}.npz"), **{
                f"{key}.{i}": t.detach().cpu().numpy()
                for key, ts in arrays.items() for i, t in enumerate(ts)})
        res[case["name"]] = out
    # the reduce-scatter's values and counted bytes on this mesh
    mesh.reset_counters()
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (mesh.rank + 1)
    part = mesh.reduce_scatter(x, "data", dim=0)
    from repro_torch.roofline.analysis import collective_bytes
    res["reduce_scatter"] = {"out": part.tolist(),
                             "bytes": collective_bytes(mesh)}
    return res


def main():
    job_path, out_dir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    from repro_torch.launch.mesh import make_mesh
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"),
                     device_type=job.get("device", "cpu"))
    res = {"coords": list(mesh.coords), "backend": mesh.backend}
    for sc in job.get("scenarios", []):
        res[sc["name"]] = run_scenario(sc, mesh)
    if "train" in job:
        res["train"] = run_train(job["train"], mesh, out_dir)
    if "tp_train" in job:
        res["tp_train"] = run_tp_train(job["tp_train"], mesh, out_dir)
    res["collectives"] = mesh.collectives
    res["host_syncs"] = mesh.host_syncs
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    # every rank done, the process ends without tearing the groups down
    # (gloo's teardown has aborted a rank now and then after all its work)
    torch.distributed.barrier(group=mesh.host_group)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
