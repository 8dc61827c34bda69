"""The port's training path on the CPU against the reference's.

* ``data.pipeline``: ``batch_at`` bit-identical to the reference's for
  several seeds, steps and shards; ``MemmapTokens`` on one token file.
* ``optim.adamw``: ``apply_updates`` (params, m, v, grad_norm, lr within
  1e-6 relative in f32), ``schedule_lr`` for the three schedules,
  ``compress_grads`` (the same int8, scales and residuals within 1e-7).
* ``Model.loss_fn`` and its gradients, for the reduced configs of the
  eleven archs, from the reference's f32 parameters carried across: the
  loss within 1e-5 relative, every gradient leaf (reference tree layout)
  within 1e-4 of that leaf's max-abs, with ``remat`` on and off (equal
  gradients); the ``scan_layers`` layout of parameters (and an
  encoder's) and of gradients;
  ``router_aux_loss`` on reduced Mixtral within 1e-6.
* ``train.trainer``: the reference's five fault-tolerance tests
  (``tests/test_substrate.py``) on the port, the port's ``Trainer``
  against the reference's over 6 steps in f32, plain, with two
  microbatches and with int8 gradients (each step's loss, grad_norm and
  lr and the final params within 1e-4; with int8 gradients, up to the
  elements whose rounding differs), one compressed step against the
  reference's compress / decompress / AdamW on the same gradients
  (1e-6), the async
  checkpointer's write and GC, and a training run carried across
  packages through a checkpoint, both ways.
* ``launch.train`` on the CPU.
The reference's gradients and trainer runs are computed once per module.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_cases import port_pair

from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jckpt
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer

from repro_torch.configs import get_reduced
from repro_torch.data import pipeline as tpipe
from repro_torch.models import Model
from repro_torch.models.model import stack_layout, to_params, unrolled
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import TrainConfig, Trainer

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["opt_6_7b", "stablelm_1_6b", "phi4_mini_3_8b", "qwen1_5_32b",
         "minicpm3_4b", "mixtral_8x7b", "deepseek_v2_236b", "mamba2_2_7b",
         "jamba_1_5_large_398b", "pixtral_12b", "whisper_medium"]


def _np(x):
    """numpy of a leaf (bf16 tensors widened to f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _close_leaves(want, got, tol):
    """Every leaf of ``got`` within ``tol`` of the matching leaf of
    ``want``'s max-abs (both in the reference's order)."""
    want, got = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a, b = np.asarray(a, np.float32), _np(b).astype(np.float32)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=tol * max(np.abs(a).max(), 1e-30))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shards", [(0, 1), (1, 2), (7, 4)])
def test_synthetic_batches_match_reference(seed, shards):
    for shard in range(shards):
        kw = dict(vocab_size=300, seq_len=24, global_batch=8, seed=seed,
                  data_shard=shard, data_shards=shards)
        j, t = jpipe.SyntheticLM(**kw), tpipe.make_pipeline("synthetic",
                                                            **kw)
        for step in (0, 3, 101):
            a, b = j.batch_at(step)["tokens"], t.batch_at(step)["tokens"]
            assert b.dtype == np.int32 and b.shape == (8 // shards, 24)
            np.testing.assert_array_equal(a, b)


def test_memmap_batches_match_reference(tmp_path):
    f = tmp_path / "toks.bin"
    np.random.default_rng(0).integers(0, 5000, 4096).astype(
        np.int32).tofile(f)
    for shard in range(2):
        kw = dict(path=str(f), seq_len=32, global_batch=4,
                  data_shard=shard, data_shards=2)
        j, t = jpipe.MemmapTokens(**kw), tpipe.make_pipeline("memmap", **kw)
        for step in (0, 5, 77):
            np.testing.assert_array_equal(j.batch_at(step)["tokens"],
                                          t.batch_at(step)["tokens"])
    with pytest.raises(ValueError):
        tpipe.make_pipeline("csv")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _opt_case(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": {"w": (7,), "z": (3, 2, 2)},
              "c": [(4,), (2, 3)]}

    def draw(shape_tree, scale):
        if isinstance(shape_tree, dict):
            return {k: draw(v, scale) for k, v in shape_tree.items()}
        if isinstance(shape_tree, list):
            return [draw(v, scale) for v in shape_tree]
        return (rng.normal(size=shape_tree) * scale).astype(np.float32)
    params = draw(shapes, 0.5)
    grads = draw(shapes, grad_scale)
    m = draw(shapes, 0.01)
    v = jax.tree_util.tree_map(np.abs, draw(shapes, 0.001))
    return params, grads, m, v


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])   # clip off / on
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_apply_updates_matches_reference(grad_scale, schedule):
    params, grads, m, v = _opt_case(11, grad_scale)
    cfg = dict(lr=3e-3, warmup_steps=3, total_steps=20, schedule=schedule)
    jp, jst, jmet = jadamw.apply_updates(
        params, grads, jadamw.AdamWState(jnp.asarray(4, jnp.int32), m, v),
        jadamw.AdamWConfig(**cfg))
    tst = adamw.AdamWState(torch.tensor(4, dtype=torch.int32),
                           _torch_tree(m), _torch_tree(v))
    tp, tst, tmet = adamw.apply_updates(_torch_tree(params),
                                        _torch_tree(grads), tst,
                                        adamw.AdamWConfig(**cfg))
    assert int(tst.count) == 5
    for want, got in ((jp, tp), (jst.m, tst.m), (jst.v, tst.v)):
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-6 * np.abs(a).max())
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    jc = jadamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=110,
                            schedule=schedule)
    tc = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=110,
                           schedule=schedule)
    for step in (0, 5, 10, 60, 110, 150):          # warmup, middle, end
        want = float(jadamw.schedule_lr(jc, jnp.asarray(step, jnp.int32)))
        got = adamw.schedule_lr(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


def test_compress_grads_matches_reference():
    rng = np.random.default_rng(5)
    grads = {"a": rng.normal(size=(9, 7)).astype(np.float32),
             "b": [(rng.normal(size=(33,)) * 1e-3).astype(np.float32),
                   np.zeros((4,), np.float32)]}
    resid = jax.tree_util.tree_map(
        lambda g: (rng.normal(size=g.shape) * 1e-4).astype(np.float32), grads)
    for r in (None, resid):
        jq, js, jr = jadamw.compress_grads(grads, r)
        tq, ts, tr = adamw.compress_grads(
            _torch_tree(grads), None if r is None else _torch_tree(r))
        for a, b in zip(jax.tree_util.tree_leaves(jq), tree_leaves(tq)):
            assert b.dtype == torch.int8
            np.testing.assert_array_equal(_np(b), np.asarray(a))
        for want, got in ((js, ts), (jr, tr)):
            for a, b in zip(jax.tree_util.tree_leaves(want),
                            tree_leaves(got)):
                np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-7,
                                           atol=1e-7)
        jd = jadamw.decompress_grads(jq, js)
        td = adamw.decompress_grads(tq, ts)
        for a, b in zip(jax.tree_util.tree_leaves(jd), tree_leaves(td)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-7,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        batch["patch_embeds"] = rng.normal(
            size=(2, 4, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(tm, batch, remat):
    """(loss, gradients in the reference's tree layout) of the port."""
    tm.cfg = tm.cfg.replace(remat=remat)
    params = tm.train_params()
    loss = tm.loss_fn({k: torch.as_tensor(v) for k, v in batch.items()})
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return float(loss.detach()), stack_layout(tree_unflatten(params, grads),
                                              tm.cfg)


@pytest.fixture(scope="module")
def ref_grads():
    """arch -> (reference Model, its f32 params, port Model, batch, loss,
    gradients), computed once per (arch, scan_layers)."""
    cache = {}

    def get(arch, **over):
        key = (arch, tuple(sorted(over.items())))
        if key not in cache:
            jm, params, tm = port_pair(arch, perturb=3, **over)
            batch = _batch(jm.cfg)
            loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[key] = (jm, params, tm, batch, float(loss), grads)
        return cache[key]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(ref_grads, arch):
    _, _, tm, batch, jloss, jgrads = ref_grads(arch)
    by_remat = {}
    for remat in (True, False):
        loss, grads = _port_grads(tm, batch, remat)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        _close_leaves(jgrads, grads, 1e-4)
        by_remat[remat] = [_np(g) for g in tree_leaves(grads)]
    for a, b in zip(by_remat[True], by_remat[False]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["opt_6_7b", "deepseek_v2_236b",
                                  "jamba_1_5_large_398b", "whisper_medium"])
def test_scan_layers_trees(arch):
    """The stacked layout (``stack/prefix``, ``stack/scan`` with a
    leading layers axis; an encoder's stack too) against the reference's
    tree under ``scan_layers``; the layouts convert both ways."""
    _, jparams, tm = port_pair(arch, perturb=3, scan_layers=True)
    assert tm.cfg.scan_layers
    _close_leaves(jparams, to_params(tm), 0)
    flat = to_params(tm, scan_layers=False)
    assert "layers" in flat["stack"]
    _close_leaves(jparams, stack_layout(flat, tm.cfg), 0)
    _close_leaves(jax.tree_util.tree_map(_np, flat),
                  unrolled(to_params(tm), tm.cfg), 0)


@pytest.mark.parametrize("arch", ["opt_6_7b", "deepseek_v2_236b"])
def test_scan_layers_grads(ref_grads, arch):
    """Gradients listed in the stacked layout against the reference's
    under ``scan_layers`` (a prefix and a scan group on DeepSeek-V2)."""
    _, _, tm, batch, jloss, jgrads = ref_grads(arch, scan_layers=True)
    loss, grads = _port_grads(tm, batch, remat=True)
    assert "scan" in grads["stack"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _close_leaves(jgrads, grads, 1e-4)


def test_router_aux_loss_matches_reference():
    from repro.models.moe import router_aux_loss as j_aux
    from repro_torch.models.moe import MoE, router_aux_loss
    jm, params, tm = port_pair("mixtral_8x7b")
    cfg = jm.cfg
    i = next(i for i in range(cfg.n_layers) if cfg.mlp_kind(i) == "moe")
    x = np.random.default_rng(2).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    want = float(j_aux(params["stack"]["layers"][i]["mlp"], jnp.asarray(x),
                       cfg))
    mod = tm.stack.layers[i].mlp
    assert isinstance(mod, MoE)
    for p in (mod, {"router": mod.router}):
        got = router_aux_loss(p, torch.from_numpy(x), tm.cfg)
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_quantized_model_refused_for_training():
    _, _, tm = port_pair("opt_6_7b", quant=dict(bits=3, group_size=32,
                                                iters=2, backend="bcq_xla"))
    with pytest.raises(ValueError, match="only dense models train"):
        tm.train_params()


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


CFG = get_reduced("opt_6_7b").replace(remat=False)


class TestTrainerFaultTolerance:
    """The reference's ``TestTrainerFaultTolerance`` on the port."""

    def _trainer(self, tmp_path, steps=8, **kw):
        model = Model(CFG, device="cpu")
        tc = TrainConfig(steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path),
                         log_every=100, **kw)
        oc = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
        return Trainer(model, oc, tc)

    def _pipe(self):
        return tpipe.SyntheticLM(vocab_size=CFG.vocab_size, seq_len=32,
                                 global_batch=4, seed=1)

    def test_loss_decreases(self, tmp_path):
        tr = self._trainer(tmp_path, steps=20)
        _, hist = tr.run(self._pipe())
        first = np.mean([h["loss"] for h in hist[:4]])
        last = np.mean([h["loss"] for h in hist[-4:]])
        assert last < first
        assert not tr.recoveries

    def test_failure_recovery_resumes_from_checkpoint(self, tmp_path):
        tr = self._trainer(tmp_path, steps=8)
        state, hist = tr.run(self._pipe(), inject_failure_at=5)
        # failed at 5, resumed from the checkpoint at 4, finished all 8
        assert int(state["step"]) == 8
        assert len(hist) >= 8
        assert tr.recoveries == [(5, "simulated node failure")]

    def test_restart_after_kill_resumes(self, tmp_path):
        tr = self._trainer(tmp_path, steps=4)
        tr.run(self._pipe())
        # a new trainer process picks up where the old one stopped
        tr2 = self._trainer(tmp_path, steps=6)
        state, hist = tr2.run(self._pipe())
        assert int(state["step"]) == 6
        assert len(hist) == 2          # only 2 fresh steps

    def test_deterministic_resume_matches_uninterrupted(self, tmp_path):
        trA = self._trainer(tmp_path / "a", steps=6)
        stateA, _ = trA.run(self._pipe())
        la = [_np(x).astype(np.float32) for x in
              tree_leaves(stateA["params"])]
        trB = self._trainer(tmp_path / "b", steps=6)
        stateB, _ = trB.run(self._pipe(), inject_failure_at=4)
        lb = tree_leaves(stateB["params"])
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a, _np(b).astype(np.float32),
                                       atol=1e-5)

    def test_straggler_detection(self, tmp_path):
        import time as _t
        tr = self._trainer(tmp_path, steps=10, straggler_factor=2.0)
        pipe = self._pipe()
        orig = pipe.batch_at

        def slow_batch(step):
            if step == 7:
                _t.sleep(4.0)          # simulated slow host
            return orig(step)
        pipe.batch_at = slow_batch
        tr.run(pipe)
        assert 7 in tr.stragglers or 8 in tr.stragglers


def test_async_checkpointer_and_gc(tmp_path):
    """The reference's ``TestCheckpoint.test_async_and_gc`` on the port;
    the snapshot is a copy (an in-place write after ``save_async`` does
    not reach the file)."""
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        x = torch.full((3,), float(s))
        ac.save_async(s, {"x": x})
        x.add_(100.0)
    ac.wait()
    assert ckpt.list_steps(str(tmp_path)) == [3, 4]
    out, s, _ = ckpt.restore(str(tmp_path))
    assert s == 4 and float(out["x"][0]) == 4
    # a template casts, a device places
    out, _, _ = ckpt.restore(str(tmp_path), template={
        "x": torch.zeros(3, dtype=torch.bfloat16)}, placement="cpu")
    assert out["x"].dtype == torch.bfloat16


class _ShapeMesh:
    """The parts of a mesh ``shard_tree`` reads: its axes, this rank's
    coordinates and its device."""
    axis_names, shape, coords, device = ("data", "model"), (1, 2), (0, 1), \
        torch.device("cpu")

    def size(self, axis):
        return dict(zip(self.axis_names, self.shape))[axis]

    def index(self, axis):
        return dict(zip(self.axis_names, self.coords))[axis]


def test_restore_places_a_rank_slice(tmp_path):
    """``restore(placement=(mesh, specs))`` keeps this rank's slice of
    each leaf (``shard_tree``), as the reference places a restored tree
    with its shardings."""
    w = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    ckpt.save(str(tmp_path), 3, {"w": w, "b": torch.ones(5)})
    out, step, _ = ckpt.restore(str(tmp_path), placement=(
        _ShapeMesh(), {"w": (None, "model"), "b": (None,)}))
    assert step == 3
    torch.testing.assert_close(out["w"], w[:, 3:])
    torch.testing.assert_close(out["b"], torch.ones(5))


OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def _jpipe():
    return jpipe.SyntheticLM(vocab_size=CFG.vocab_size, seq_len=32,
                             global_batch=4, seed=1)


def _tpipe():
    return tpipe.SyntheticLM(vocab_size=CFG.vocab_size, seq_len=32,
                             global_batch=4, seed=1)


def _jtrainer(d, steps, **kw):
    jm, _, _ = port_pair("opt_6_7b")
    return JTrainer(jm, jadamw.AdamWConfig(**OPT_KW),
                    JTrainConfig(steps=steps, ckpt_every=2, ckpt_dir=str(d),
                                 log_every=100, **kw))


def _ttrainer(d, steps, **kw):
    _, _, tm = port_pair("opt_6_7b")
    return Trainer(tm, adamw.AdamWConfig(**OPT_KW),
                   TrainConfig(steps=steps, ckpt_every=2, ckpt_dir=str(d),
                               log_every=100, **kw))


def _jstate(params_np):
    """A fresh reference state on copies of the numpy parameters (the
    reference's step donates its state)."""
    params = jax.tree_util.tree_map(jnp.array, params_np)
    return {"params": params, "opt": jadamw.init_state(params),
            "step": jnp.zeros((), jnp.int32)}


# the trainer's step options, each run by both packages' trainers
STEP_OPTIONS = {"plain": {}, "microbatches2": dict(microbatches=2),
                "grad_compression": dict(grad_compression=True)}


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """``get(option)``: the reference's ``Trainer`` with
    ``STEP_OPTIONS[option]`` over 6 steps in f32 from reduced OPT's f32
    parameters, run once per module: (initial params as numpy, final
    state, history)."""
    _, params, _ = port_pair("opt_6_7b")
    params = jax.tree_util.tree_map(np.array, params)
    runs = {}

    def get(option):
        if option not in runs:
            tr = _jtrainer(tmp_path_factory.mktemp("ref6"), 6,
                           **STEP_OPTIONS[option])
            runs[option] = (params, *tr.run(_jpipe(), state=_jstate(params)))
        return runs[option]
    return get


@pytest.fixture(scope="module")
def ref_run(ref_runs):
    return ref_runs("plain")


def _assert_state_close(jstate, tstate, tol=1e-4):
    """Params and AdamW moments (reference layout) within ``tol`` of each
    leaf's max-abs."""
    _close_leaves(jstate["params"], tstate["params"], tol)
    for key in ("m", "v"):
        _close_leaves(getattr(jstate["opt"], key), getattr(tstate["opt"], key),
                      tol)


@pytest.mark.parametrize("option", list(STEP_OPTIONS))
def _assert_state_close_but_rounding(jstate, tstate, tol=1e-4):
    """:func:`_assert_state_close` for runs with int8 gradients.  The two
    packages' f32 gradients agree to about 1e-7 relative, and where one
    lies that close to a half-step of its tensor's int8 grid, the two
    roundings differ by one step (1/127 of the tensor's largest
    gradient).  So a few elements in a thousand may lie beyond ``tol``,
    each within 1/127 of its leaf's max-abs."""
    for want, got in ((jstate["params"], tstate["params"]),
                      (jstate["opt"].m, tstate["opt"].m),
                      (jstate["opt"].v, tstate["opt"].v)):
        want, got = jax.tree_util.tree_leaves(want), tree_leaves(got)
        assert len(want) == len(got)
        for a, b in zip(want, got):
            a, b = np.asarray(a, np.float32), _np(b).astype(np.float32)
            assert a.shape == b.shape
            scale = max(np.abs(a).max(), 1e-30)
            err = np.abs(b - a)
            assert (err > tol * scale).sum() <= 4e-3 * a.size
            assert err.max() <= scale / 127


@pytest.mark.parametrize("option", list(STEP_OPTIONS))
def test_trainer_matches_reference(ref_runs, option, tmp_path):
    """Microbatch accumulation and the int8 gradient round trip are held
    against the reference's trainer with the same option, not against
    the port's plain step."""
    params, jstate, jhist = ref_runs(option)
    tr = _ttrainer(tmp_path, 6, **STEP_OPTIONS[option])
    state, hist = tr.run(_tpipe(), state=tr.fresh_state())
    assert int(state["step"]) == 6 and len(hist) == 6
    for a, b in zip(jhist, hist):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-12)
    if STEP_OPTIONS[option].get("grad_compression"):
        _assert_state_close_but_rounding(jstate, state)
    else:
        _assert_state_close(jstate, state)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_compressed_step_matches_reference_functions(microbatches, tmp_path):
    """One step of the port's trainer with ``grad_compression``: the new
    params, moments, grad_norm and lr equal, within 1e-6 relative, the
    reference's ``compress_grads`` -> ``decompress_grads`` ->
    ``apply_updates`` applied to the port's own gradients of that state
    and batch (their f32 mean over the microbatches).  Both roundings to
    int8 then see the same numbers, so none may differ."""
    _, _, tm = port_pair("opt_6_7b")
    batch = _tpipe().batch_at(0)
    params = tm.train_params()
    leaves = tree_leaves(params)
    acc = [torch.zeros_like(p) for p in leaves]
    n = batch["tokens"].shape[0] // microbatches
    for i in range(microbatches):
        loss = tm.loss_fn({"tokens": torch.as_tensor(
            batch["tokens"][i * n:(i + 1) * n])})
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g)
    jgrads = tree_unflatten(params, [_np(a.div_(microbatches)) for a in acc])
    jparams = tree_unflatten(params, [_np(p) for p in leaves])
    q, s, _ = jadamw.compress_grads(jgrads)
    jp, jst, jmet = jadamw.apply_updates(
        jparams, jadamw.decompress_grads(q, s), jadamw.init_state(jparams),
        jadamw.AdamWConfig(**OPT_KW))
    tr = _ttrainer(tmp_path, 1, microbatches=microbatches,
                   grad_compression=True)
    state, met = tr.build_step()(tr.fresh_state(), batch)
    for want, got in ((jp, state["params"]), (jst.m, state["opt"].m),
                      (jst.v, state["opt"].v)):
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-6 * np.abs(a).max())
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-6)


def test_resume_reference_checkpoint_in_port(ref_run, tmp_path):
    """The reference trains 4 steps and checkpoints; the port resumes from
    its checkpoint and runs to step 6: the reference's own 6-step run."""
    params, jstate, _ = ref_run
    _jtrainer(tmp_path, 4).run(_jpipe(), state=_jstate(params))
    assert jckpt.latest_step(str(tmp_path)) == 4
    tr = _ttrainer(tmp_path, 6)
    state, hist = tr.run(_tpipe())
    assert int(state["step"]) == 6 and len(hist) == 2
    _assert_state_close(jstate, state)


def test_resume_port_checkpoint_in_reference(ref_run, tmp_path):
    """The port trains 4 steps and checkpoints; the reference resumes
    from its checkpoint and runs to step 6: its own 6-step run."""
    _, jstate, _ = ref_run
    tr = _ttrainer(tmp_path, 4)
    tr.run(_tpipe(), state=tr.fresh_state())
    assert ckpt.latest_step(str(tmp_path)) == 4
    state, hist = _jtrainer(tmp_path, 6).run(_jpipe())
    assert int(state["step"]) == 6 and len(hist) == 2
    _close_leaves(jstate["params"], state["params"], 1e-4)
    for key in ("m", "v"):
        _close_leaves(getattr(jstate["opt"], key), getattr(state["opt"], key),
                      1e-4)


def test_launcher_trains_on_cpu(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "opt_6_7b", "--reduced", "1", "--steps", "4", "--device", "cpu",
           "--ckpt-dir", str(tmp_path)]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[launch.train] opt-6.7b: 91,136 params")
    assert lines[-1].startswith("[launch.train] finished at step 4, "
                                "final loss ")
    assert ckpt.list_steps(str(tmp_path)) == [4]
