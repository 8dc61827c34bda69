"""Sharded training of the port on the CPU against the reference's
unsharded training.

Ranks are spawned once per mesh for the module (``launch.mesh.spawn``
running ``tests/torch_sharded_worker.py`` ``run_tp_train``, gloo): a
(1, 2) mesh (tensor parallel), a (2, 1) mesh with fsdp and a (2, 2)
mesh with fsdp and act_shard.  Each trains reduced OPT and reduced
DeepSeek-V2 (MLA + MoE, experts over ``model``; in the ``scan_layers``
layout, so its checkpoint stacks layers) in f32 from the reference's
numpy weights, and on (1, 2) reduced Mixtral's gradients are taken at a
sequence past its sliding window.  Held against the reference:

* the loss within 1e-5 relative and every gradient leaf, gathered
  whole, within 1e-4 of that leaf's max-abs, against
  ``jax.value_and_grad(Model.loss_fn)`` on the same weights and global
  batch (each data rank its rows);
* 2 trainer steps against the reference's ``Trainer`` on the same
  global batch: each step's loss and grad_norm within 1e-5 relative,
  lr within 1e-6, the whole AdamW moments within 1e-4 of each leaf's
  max-abs, and the whole params too but for at most 1 element in 1000
  of a leaf, within 2 lr a step (a gradient near AdamW's eps:
  ``_close_but_adam_flips``);
* the sharded init equals the unsharded init from the same seed, leaf
  for leaf;
* each rank's weight and moment tensors hold the whole leaf's elements
  divided by the extents of the axes its spec cuts (half of every leaf
  cut over ``data`` on the (2, 1) fsdp mesh);
* the (2, 2) mesh's checkpoint restores in the reference
  (``repro.train.checkpoint.restore``) and in the port on (1, 1) (in
  this process) and (1, 2) (the (1, 2) ranks, run after it) through
  ``reshard_to``, equal leaf for leaf to the gathered sharded state;
* ``Mesh.reduce_scatter`` on the (2, 1) mesh: its values and the bytes
  ``roofline.analysis.collective_bytes`` reads.

The reference's gradients and trainer runs are computed once per
module, while the (2, 2) ranks run.
"""
import json
import os
import pickle
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_cases import port_pair, to_numpy_tree

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jckpt
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer

from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models.model import stack_layout, to_params
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import make_rules
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.tree import tree_leaves, tree_unflatten

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORKER = os.path.join(os.path.dirname(__file__), "torch_sharded_worker.py")
STEPS, BATCH, SEQ = 2, 4, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
# name -> (mesh, fsdp, act_shard)
MESHES = {"tp": ((1, 2), False, False), "fsdp": ((2, 1), True, False),
          "fsdp_act": ((2, 2), True, True)}
# name -> (arch, config overrides)
ARCHS = {"opt": ("opt_6_7b", {}),
         "deepseek": ("deepseek_v2_236b", {"scan_layers": True})}
# reduced Mixtral's sliding window is 32: a sequence of 48 crosses it
WINDOW = ("mixtral_8x7b", 48)
CASES = [(m, a) for m in MESHES for a in ARCHS]


def _jstate(params_np):
    params = jax.tree_util.tree_map(jnp.array, params_np)
    return {"params": params, "opt": jadamw.init_state(params),
            "step": jnp.zeros((), jnp.int32)}


def _spawn(mesh_name, cases, tmp):
    shape, fsdp, act = MESHES[mesh_name]
    out_dir = os.path.join(tmp, mesh_name)
    os.makedirs(out_dir)
    job = {"mesh": shape, "tp_train": {"steps": STEPS, "opt": OPT, "cases": [
        {**c, "fsdp": fsdp, "act": act,
         "ckpt_dir": os.path.join(out_dir, f"ckpt_{c['name']}")}
        for c in cases]}}
    with open(os.path.join(out_dir, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    from repro_torch.launch.mesh import spawn
    outs = spawn([sys.executable, WORKER, os.path.join(out_dir, "job.pkl"),
                  out_dir], shape[0] * shape[1],
                 env={"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"},
                 timeout=300)
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"{mesh_name} rank {r} failed:\n{err[-3000:]}"
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
             for r in range(len(outs))]
    arrays = {}
    for c in cases:
        npz = np.load(os.path.join(out_dir, f"tp_{c['name']}.npz"))
        got = {}
        for key in npz.files:
            name, i = key.rsplit(".", 1)
            got.setdefault(name, {})[int(i)] = npz[key]
        arrays[c["name"]] = {k: [v[i] for i in range(len(v))]
                             for k, v in got.items()}
    return ranks, arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": per arch the reference's (model, params, port model,
    tokens, loss, grads, final state, history), "ranks": per mesh the
    ranks' json, "arrays": per mesh and arch the whole arrays rank 0
    gathered, "dir": the module's scratch directory}."""
    tmp = str(tmp_path_factory.mktemp("train_tp"))
    pairs, cases = {}, {}
    rng = np.random.default_rng(0)
    for name, (arch, over) in ARCHS.items():
        jm, params, tm = port_pair(arch, perturb=3, **over)
        tokens = rng.integers(0, jm.cfg.vocab_size, (BATCH, SEQ)).astype(
            np.int32)
        pairs[name] = (jm, params, tm, tokens)
        cases[name] = dict(name=name, arch=arch, over={"dtype": "float32",
                                                        **over},
                           params=to_numpy_tree(params), tokens=tokens)
    jm, params, tm = port_pair(WINDOW[0], perturb=3)
    tokens = rng.integers(0, jm.cfg.vocab_size, (BATCH, WINDOW[1])).astype(
        np.int32)
    pairs["window"] = (jm, params, tm, tokens)
    window_case = dict(name="window", arch=WINDOW[0],
                       over={"dtype": "float32"},
                       params=to_numpy_tree(params), tokens=tokens,
                       grads_only=True)
    ranks, arrays, errors = {}, {}, []

    def run(mesh_name, mesh_cases):
        try:
            ranks[mesh_name], arrays[mesh_name] = _spawn(mesh_name,
                                                         mesh_cases, tmp)
        except BaseException as e:
            errors.append(e)
    first = threading.Thread(target=run, args=(
        "fsdp_act", [cases["opt"], cases["deepseek"]]))
    first.start()
    ref = {}
    try:
        for name, (jm, params, tm, tokens) in pairs.items():
            loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
                params, {"tokens": jnp.asarray(tokens)})
            ref[name] = dict(jm=jm, params=params, tm=tm, tokens=tokens,
                             loss=float(loss), grads=grads)
            if name == "window":
                continue
            pipe = JSyntheticLM(vocab_size=jm.cfg.vocab_size, seq_len=SEQ,
                                global_batch=BATCH, seed=1)
            jstate, jhist = JTrainer(
                jm, jadamw.AdamWConfig(**OPT),
                JTrainConfig(steps=STEPS, ckpt_every=STEPS, log_every=100,
                             ckpt_dir=os.path.join(tmp, f"ref_{name}")),
            ).run(pipe, state=_jstate(jax.tree_util.tree_map(np.array,
                                                             params)))
            ref[name].update(state=jstate, hist=jhist)
    finally:
        first.join()
    assert not errors, errors
    ckpt22 = {name: os.path.join(tmp, "fsdp_act", f"ckpt_{name}")
              for name in ARCHS}
    later = [threading.Thread(target=run, args=(
        "tp", [{**cases[n], "restore_from": ckpt22[n]} for n in ARCHS]
        + [window_case])),
        threading.Thread(target=run, args=(
            "fsdp", [cases["opt"], cases["deepseek"]]))]
    for t in later:
        t.start()
    for t in later:
        t.join()
    assert not errors, errors
    return {"ref": ref, "ranks": ranks, "arrays": arrays, "ckpt": ckpt22,
            "dir": tmp}


def _layout(tm, flat):
    """Whole arrays in the unrolled tree's leaf order -> the leaves of
    the reference's layout (``cfg.scan_layers``), as numpy."""
    tree = tree_unflatten(to_params(tm, scan_layers=False),
                          [torch.as_tensor(np.asarray(a)) for a in flat])
    return [t.numpy() for t in tree_leaves(stack_layout(tree, tm.cfg))]


def _close(want, got, tol):
    """Each leaf of ``got`` within ``tol`` of the matching leaf's
    max-abs."""
    want = [np.asarray(a, np.float32) for a in want]
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=tol * max(np.abs(a).max(), 1e-30))


def _close_but_adam_flips(want, got, tol):
    """:func:`_close` for parameters after AdamW steps.  The sharded
    gradients sum in another order (about 1e-7 relative); where an
    element's gradient is near AdamW's eps that moves its update
    m / (sqrt(v) + eps), which is about lr in size, by up to 2 lr a step.
    So at most 1 element in 1000 of a leaf may lie beyond ``tol``, each
    within 2 lr per step."""
    want = [np.asarray(a, np.float32) for a in want]
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        err = np.abs(b - a)
        assert (err > tol * max(np.abs(a).max(), 1e-30)).sum() <= \
            max(1, a.size // 1000)
        assert err.max() <= 2 * OPT["lr"] * STEPS


@pytest.mark.parametrize("mesh,arch", CASES)
def test_sharded_init_equals_unsharded(runs, mesh, arch):
    for rank in runs["ranks"][mesh]:
        assert rank["tp_train"][arch]["init_equal"]


@pytest.mark.parametrize("mesh,arch", CASES + [("tp", "window")])
def test_loss_and_grads_match_reference(runs, mesh, arch):
    ref = runs["ref"][arch]
    for rank in runs["ranks"][mesh]:
        np.testing.assert_allclose(rank["tp_train"][arch]["loss"],
                                   ref["loss"], rtol=1e-5)
    got = _layout(ref["tm"], runs["arrays"][mesh][arch]["grads"])
    _close(jax.tree_util.tree_leaves(ref["grads"]), got, 1e-4)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_trainer_matches_reference(runs, mesh, arch):
    ref = runs["ref"][arch]
    for rank in runs["ranks"][mesh]:
        res = rank["tp_train"][arch]
        assert res["recoveries"] == [] and len(res["hist"]) == STEPS
        for a, b in zip(ref["hist"], res["hist"]):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5)
            np.testing.assert_allclose(b["lr"], a["lr"], rtol=1e-6)
    arrays, jstate = runs["arrays"][mesh][arch], ref["state"]
    _close_but_adam_flips(jax.tree_util.tree_leaves(jstate["params"]),
                          _layout(ref["tm"], arrays["params"]), 1e-4)
    for key in ("m", "v"):
        _close(jax.tree_util.tree_leaves(getattr(jstate["opt"], key)),
               _layout(ref["tm"], arrays[key]), 1e-4)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_rank_holds_its_share_of_each_leaf(runs, mesh, arch):
    """From tensor sizes: each rank's weight and both moments hold the
    whole leaf's elements over the extents of the axes it is cut over;
    fsdp cuts over ``data`` (on (2, 1), half of every such leaf), and
    tensor parallelism cuts over ``model``."""
    shape = dict(zip(("data", "model"), MESHES[mesh][0]))
    cut = {"data": 0, "model": 0}
    for rank in runs["ranks"][mesh]:
        for p, m, v, whole, axes in rank["tp_train"][arch]["sizes"]:
            share = whole // int(np.prod([shape[a] for a in axes]))
            assert p == m == v == share
            for a in axes:
                cut[a] += 1
    assert bool(cut["data"]) == MESHES[mesh][1]
    assert bool(cut["model"]) == (shape["model"] > 1)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh_checkpoint_restores_in_reference(runs, arch):
    """The (2, 2) ranks' checkpoint, written slice by slice, is the
    reference's layout: its ``restore`` reads it, equal to the gathered
    state."""
    tree, step, _ = jckpt.restore(runs["ckpt"][arch])
    assert step == STEPS and int(np.asarray(tree["step"])) == STEPS
    assert int(np.asarray(tree["opt"]["count"])) == STEPS
    tm, arrays = runs["ref"][arch]["tm"], runs["arrays"]["fsdp_act"][arch]
    for key, got in (("params", tree["params"]), ("m", tree["opt"]["m"]),
                     ("v", tree["opt"]["v"])):
        want = _layout(tm, arrays[key])
        got = jax.tree_util.tree_leaves(got)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(b), a)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh_checkpoint_reshards(runs, arch):
    """The (2, 2) checkpoint placed by ``reshard_to`` on (1, 2) (its
    ranks, gathered) and on (1, 1) (here) equals the (2, 2) ranks'
    gathered state leaf for leaf."""
    want = runs["arrays"]["fsdp_act"][arch]
    got12 = runs["arrays"]["tp"][arch]
    for rank in runs["ranks"]["tp"]:
        assert rank["tp_train"][arch]["restored_step"] == STEPS
    tm = runs["ref"][arch]["tm"]
    one = Mesh((1, 1), ("data", "model"), rank=0, groups={},
               backend="gloo", device=torch.device("cpu"))
    tr = Trainer(Model(tm.cfg, device="meta", dtype=torch.float32),
                 adamw.AdamWConfig(**OPT), TrainConfig(
                     fsdp=True, ckpt_dir=os.path.join(runs["dir"], "one")),
                 rules=make_rules(fsdp=True, act_shard=True))
    state = tr.reshard_to(one, ckpt.restore(runs["ckpt"][arch])[0])
    assert tr.mesh is one and int(state["step"]) == STEPS
    got11 = {"params": tree_leaves(state["params"]),
             "m": tree_leaves(state["opt"].m),
             "v": tree_leaves(state["opt"].v)}
    for key in ("params", "m", "v"):
        assert len(want[key]) == len(got12[f"r_{key}"]) == len(got11[key])
        for a, b, c in zip(want[key], got12[f"r_{key}"], got11[key]):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(c.detach().numpy(), a)


def test_reduce_scatter_values_and_bytes(runs):
    """``Mesh.reduce_scatter`` over ``data`` on the (2, 1) mesh: each
    rank's rows of the ranks' sum, counted under its own kind."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    total = x * 1 + x * 2
    for r, rank in enumerate(runs["ranks"]["fsdp"]):
        res = rank["tp_train"]["reduce_scatter"]
        np.testing.assert_array_equal(np.asarray(res["out"]),
                                      total[2 * r:2 * r + 2])
        assert res["bytes"] == {"reduce-scatter": 2 * 6 * 4}
