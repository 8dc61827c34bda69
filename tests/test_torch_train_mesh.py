"""Data-parallel training of the port on the CPU: two ``gloo`` ranks
(``launch.mesh.spawn`` running ``tests/torch_sharded_worker.py``, once
per module) train reduced OPT in f32 for 2 steps on a (2, 1) mesh, each
on its shard of the global batch (``SyntheticLM(data_shard=rank,
data_shards=2)``), averaging gradients over ``data``.  Their losses and
final parameters must equal, within 1e-5, a single process training on
the same global batch (the two shards, concatenated) split into the
same two microbatches, so the two runs add the same two halves.  That
single process is in turn held against the reference's ``Trainer`` with
the same microbatches on the same pipeline, so the ranks' mean and the
microbatch mean are each tied to the reference, not only to one
another.  The ranks' checkpoint restores and is placed back on the mesh
(``reshard_to``); a Mamba config and an encoder-decoder on a (1, 2)
mesh are refused by name (tensor-parallel training itself is held
against the reference in ``tests/test_torch_train_tp.py``), and the
launcher trains under ``torchrun`` on (2, 1) replicated, on (1, 2) and
on (2, 1) with fsdp, and refuses a Mamba config on (1, 2).
"""
import json
import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_cases import port_pair, to_numpy_tree

from repro.optim import adamw as jadamw
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves
from repro_torch.train.trainer import TrainConfig, Trainer

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORKER = os.path.join(os.path.dirname(__file__), "torch_sharded_worker.py")
STEPS, BATCH, SEQ = 2, 4, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)


class _Shards:
    """The global batch of a (D, 1) mesh: every data shard's batch at
    the step, concatenated in rank order."""

    def __init__(self, n, **kw):
        self.parts = [SyntheticLM(data_shard=r, data_shards=n, **kw)
                      for r in range(n)]

    def batch_at(self, step):
        return {"tokens": np.concatenate(
            [p.batch_at(step)["tokens"] for p in self.parts])}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(per-rank results and final parameters, the single process's
    history and final parameters, the reference's history and final
    parameters)."""
    from repro_torch.launch.mesh import spawn
    jm, params, tm = port_pair("opt_6_7b")
    tmp = str(tmp_path_factory.mktemp("train_mesh"))
    job = {"mesh": (2, 1), "scenarios": [], "train": dict(
        over={"dtype": "float32"}, params=to_numpy_tree(params), steps=STEPS,
        global_batch=BATCH, seq_len=SEQ, opt=OPT,
        ckpt_dir=os.path.join(tmp, "ckpt"))}
    with open(os.path.join(tmp, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    outs = spawn([sys.executable, WORKER, os.path.join(tmp, "job.pkl"), tmp],
                 2, env={"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"},
                 timeout=300)
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{err[-3000:]}"
    ranks = []
    for r in range(2):
        res = json.load(open(os.path.join(tmp, f"rank{r}.json")))
        npz = np.load(os.path.join(tmp, f"train{r}.npz"))
        ranks.append((res, [npz[f"arr_{i}"] for i in range(len(npz.files))]))
    solo = Trainer(tm, adamw.AdamWConfig(**OPT),
                   TrainConfig(steps=STEPS, microbatches=2, ckpt_every=STEPS,
                               ckpt_dir=os.path.join(tmp, "solo"),
                               log_every=100))
    shards = _Shards(2, vocab_size=tm.cfg.vocab_size, seq_len=SEQ,
                     global_batch=BATCH, seed=1)
    state, hist = solo.run(shards, state=solo.fresh_state())
    jparams = jax.tree_util.tree_map(jnp.array, params)
    jstate, jhist = JTrainer(
        jm, jadamw.AdamWConfig(**OPT),
        JTrainConfig(steps=STEPS, microbatches=2, ckpt_every=STEPS,
                     ckpt_dir=os.path.join(tmp, "ref"), log_every=100),
    ).run(shards, state={"params": jparams,
                         "opt": jadamw.init_state(jparams),
                         "step": jnp.zeros((), jnp.int32)})
    return ranks, hist, [t.detach().numpy().copy()
                         for t in tree_leaves(state["params"])], \
        (jhist, [np.asarray(a) for a in
                 jax.tree_util.tree_leaves(jstate["params"])])


def test_single_process_matches_reference(trained):
    """The single process (two microbatches of the global batch) against
    the reference's trainer with ``microbatches=2`` on the same pipeline:
    each step's loss, grad_norm and lr and the final params within 1e-4."""
    _, hist, solo, (jhist, jleaves) = trained
    assert len(jhist) == len(hist) == STEPS
    for a, b in zip(jhist, hist):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-12)
    assert len(jleaves) == len(solo)
    for a, b in zip(jleaves, solo):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * np.abs(a).max())


def test_data_parallel_matches_single_process(trained):
    ranks, hist, solo, _ = trained
    for res, leaves in ranks:
        got = res["train"]
        assert got["recoveries"] == []
        assert len(got["hist"]) == STEPS
        for a, b in zip(hist, got["hist"]):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5)
        assert len(leaves) == len(solo)
        for a, b in zip(solo, leaves):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-5 * np.abs(a).max())


def test_data_parallel_ranks_agree_and_split_the_batch(trained):
    ranks = trained[0]
    (r0, p0), (r1, p1) = ranks
    assert r0["backend"] == "gloo" and [r0["coords"], r1["coords"]] == \
        [[0, 0], [1, 0]]
    for a, b in zip(p0, p1):
        np.testing.assert_array_equal(a, b)
    for r, (res, _) in enumerate(ranks):
        want = SyntheticLM(vocab_size=256, seq_len=SEQ, global_batch=BATCH,
                           seed=1, data_shard=r, data_shards=2)
        np.testing.assert_array_equal(np.asarray(res["train"]["batch"]),
                                      want.batch_at(0)["tokens"])
        assert res["train"]["reshard"] == {"step": STEPS, "on_mesh": True,
                                           "equal": True}


@pytest.mark.parametrize("arch,what", [("mamba2_2_7b", "Mamba layers"),
                                       ("whisper_medium",
                                        "an encoder-decoder")])
def test_tensor_parallel_refusals(trained, arch, what):
    """A model axis above 1 refuses, by name, the configs its plans do
    not cover, pointing at the ROADMAP entry."""
    for res, _ in trained[0]:
        msg = res["train"]["tp_refusals"][arch]
        assert msg is not None and what in msg
        assert "tensor-parallel training of Mamba and encoder-decoder " \
            "configs" in msg


def _launch(tmp_path, mesh, *extra):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--steps", "2", "--seq-len", "16",
         "--global-batch", "4", "--ckpt-dir", str(tmp_path), "--mesh", mesh,
         *extra], capture_output=True, text=True, env=env, timeout=300)


def test_launcher_under_torchrun(tmp_path):
    out = _launch(tmp_path, "2x1", "--fsdp", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "fsdp=0" in out.stdout
    assert out.stdout.count("[launch.train] finished at step 2") == 1
    out = _launch(tmp_path / "mamba", "1x2", "--arch", "mamba2_2_7b")
    assert out.returncode != 0
    assert "Mamba layers" in out.stderr


@pytest.mark.parametrize("mesh,extra", [("1x2", ()), ("2x1", ("--fsdp",
                                                              "1"))])
def test_launcher_shards_under_torchrun(tmp_path, mesh, extra):
    """``--mesh 1x2`` trains tensor-parallel and ``--mesh 2x1 --fsdp 1``
    with the state cut over ``data``: each rank holds less than the
    unsharded bytes, and the run finishes with no refusal."""
    out = _launch(tmp_path, mesh, *extra)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[launch.train] finished at step 2") == 1
    got = re.search(r"holds ([\d.]+) MB of weights and ([\d.]+) MB of "
                    r"AdamW moments, of ([\d.]+) and ([\d.]+) MB unsharded",
                    out.stdout)
    weights, moments, whole_w, whole_m = (float(x) for x in got.groups())
    assert weights < whole_w and moments < whole_m
