"""One rank of the sharded-serving scenarios of
``tests/test_torch_serve_sharded.py`` and of the two-rank card test in
``tests/test_torch_cuda.py`` (run by ``launch.mesh.spawn``).

    python tests/torch_sharded_worker.py JOB.pkl OUT_DIR

``JOB.pkl`` holds the mesh shape, the device type (default the CPU),
optionally a data-parallel training job (``run_train``, for
``tests/test_torch_train_mesh.py``) and the scenarios, each with its
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
    cache layout (a leading ``layers`` axis under ``scan_layers``)."""
    from repro_torch.models.module import paged_cache_axes
    from repro_torch.parallel.sharding import spec_for
    axes = paged_cache_axes(cfg)
    stack = axes.get("layers") or axes.get("prefix") or axes["scan"]
    k = stack[0]["self"]["k"]
    hkv = cfg.n_kv_heads * cfg.kv_replication
    shape = ((cfg.n_layers,) if k[0] == "layers" else ()) \
        + (1, 1, hkv, cfg.head_dim_)
    return list(spec_for(shape, k, mesh, rules))


def run_scenario(sc, mesh):
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import _lib
    from repro_torch.models import shard_model
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.quant import QuantSpec
    from repro_torch.serve import PagedServeEngine
    base = get_config if sc.get("full") else get_reduced
    cfg = base("opt_6_7b").replace(**sc["over"])
    if sc.get("quant"):
        cfg = cfg.replace(quant=QuantSpec(**sc["quant"]))
    rules = make_rules()
    model = shard_model(sc["params"], cfg, mesh, rules, mesh.device)
    from repro_torch.models import to_params
    try:
        to_params(model)
        refused = False
    except ValueError:
        refused = True
    out = {"to_params_refused": refused}
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
        k = eng.cache["layers"][0]["k"]
        out[run["name"]] = {
            "tokens": tokens_of(done),
            "decode_path": eng.decode_path,
            "prefill_path": eng.prefill_path,
            "k_shape": list(k.shape),
            "k_spec": pool_spec(cfg, mesh, rules),
            "tokens_out": s["counters"]["tokens_out"],
            "preempted": s["counters"]["preempted"],
            "hit_blocks": s["counters"].get("prefix_hit_blocks", 0),
            "pool_free": eng.pool.free_blocks == eng.pool.capacity,
            "same_host_state": mesh.same_on_all(eng.host_state()),
            "launches": dict(_lib.launch_counts),
            "routes": dict(_lib.route_counts),
            "linears": {
                name: [getattr(lin, "out_slice"), getattr(lin, "in_slice")]
                for name, lin in (
                    ("q", model.stack.layers[0].mixer.q),
                    ("o", model.stack.layers[0].mixer.o),
                    ("up", model.stack.layers[0].mlp.up),
                    ("down", model.stack.layers[0].mlp.down))},
        }
    return out


def run_train(tj, mesh, out_dir):
    """Train reduced OPT (f32, the job's numpy weights) data-parallel on
    ``mesh``: each rank its shard of the global batch.  Writes the
    rank's losses, grad norms and final parameters; then asks for a
    trainer on a (1, world) mesh and records its refusal."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import from_jax_params
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
    # the checkpoint rank 0 wrote, restored by a trainer off the mesh and
    # placed on it
    before = [t.detach().clone() for t in tree_leaves(state)]
    solo = Trainer(model, adamw.AdamWConfig(**tj["opt"]),
                   TrainConfig(ckpt_dir=tj["ckpt_dir"]))
    restored, at = solo._restore(tj["steps"])
    placed = solo.reshard_to(mesh, restored)
    out["reshard"] = {"step": at, "on_mesh": solo.mesh is mesh, "equal": all(
        torch.equal(a, b) for a, b in zip(tree_leaves(placed), before))}
    tp = make_mesh((1, mesh.size_total), ("data", "model"),
                   device_type=mesh.device.type)
    try:
        Trainer(model, adamw.AdamWConfig(), TrainConfig(), mesh=tp)
        out["tp_refusal"] = None
    except NotImplementedError as e:
        out["tp_refusal"] = str(e)
    return out


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
    res["collectives"] = mesh.collectives
    res["host_syncs"] = mesh.host_syncs
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
