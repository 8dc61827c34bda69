"""Trainer: microbatch accumulation, optional int8 gradient compression,
AdamW, async checkpoints, failure recovery, straggler detection and
data-parallel training over a mesh (counterpart of
``repro.train.trainer``).

The model holds its weights (``Model.train_params``: the reference's
tree in the unrolled layout, the live tensors, autograd leaves); the
state is ``{"params": that tree, "opt": AdamWState(count, m, v), "step":
int32 scalar}`` on the model's device.  A step is the reference's
``jax.value_and_grad`` of ``Model.loss_fn`` as ``torch.autograd.grad``:
per microbatch, accumulated in f32 and divided by the microbatch count;
on a mesh, the gradients' mean over ``data`` (so every rank applies the
same update); the int8 compress -> decompress round trip where
``grad_compression``; then ``adamw.apply_updates`` in place.

Fault tolerance, as in the reference:
  * the pipeline is a pure function of the step, so a restart restores
    the latest checkpoint and continues at its step with the same
    batches;
  * ``run`` resumes from the latest complete checkpoint in
    ``ckpt_dir``, saves asynchronously every ``ckpt_every`` steps and
    at the end, and waits for the last write before it returns;
  * a ``RuntimeError`` inside a step (``inject_failure_at`` raises one
    once) restores the latest checkpoint and retries; each recovery is
    kept in ``recoveries`` (step, message), so a caller can tell an
    injected failure from a real one that recovery swallowed (a CUDA
    out-of-memory error is a ``RuntimeError`` too);
  * a step's wall time runs from the batch fetch to the host read of its
    loss (the counterpart of ``block_until_ready``); times feed an EWMA
    watermark, the first executed step kept out of it, and a step slower
    than ``straggler_factor`` times the watermark is kept in
    ``stragglers``.

On a mesh (``launch/mesh.py``) the state is cut as the reference's
``state_shardings`` cuts it, under ``rules`` (default
``make_rules(fsdp=cfg.fsdp)``, the reference's; the launcher adds
``act_shard``): ``train/sharded.py``'s :class:`TrainPlan`
holds this rank's slices of the weights and of both AdamW moments, the
layers run their tensor-parallel plans over ``model`` (autograd through
the collectives of ``launch/mesh.py``), and with ``fsdp`` each leaf cut
over ``data`` is gathered where a block runs.  Each rank's pipeline gives
its shard of the global batch.  A gradient comes out as the mean over
``data`` either way: an FSDP shard's from the reduce-scatter of its
gather's backward, every other leaf's from an all-reduce here.  The
global norm (clipping) and the int8 scales (``grad_compression``) are
taken over the whole leaves, summing (or taking the maximum of) the
slices' parts over the axes each leaf is cut over.  AdamW then updates
each slice where it is.  A checkpoint keeps the reference's layout, one
whole ``.npy`` per leaf, written slice by slice by the ranks holding
them (``AsyncCheckpointer.save_sharded_async``), so no process holds the
whole state; ``_restore`` and ``reshard_to`` read a whole checkpoint
(any mesh's, either package's) onto any mesh, each rank reading only its
slices.  A ``model`` axis above 1 covers attention-only decoders (GQA,
MLA, MoE, a sliding window); Mamba layers and an encoder-decoder are
refused by name (ROADMAP.md, tensor-parallel training of Mamba and
encoder-decoder configs), and train on a (D, 1) mesh.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.models.model import (Model, layout_path, load_params_,
                                      stack_layout, unrolled)
from repro_torch.models.transformer import layer_plan
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.sharded import TrainPlan
from repro_torch.tree import (is_namedtuple, tree_leaves, tree_map,
                              tree_unflatten)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1            # gradient accumulation factor
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    straggler_factor: float = 3.0
    grad_compression: bool = False   # int8 + error feedback
    fsdp: bool = False               # weights and moments over ``data``
    seed: int = 0


def check_trainable_mesh(mesh, cfg) -> None:
    """Refuse, by name, a mesh the trainer cannot train ``cfg`` on: a
    ``model`` axis above 1 under Mamba layers or an encoder-decoder (the
    tensor-parallel plans cover attention-only decoders)."""
    if mesh is None or mesh.size("model") == 1:
        return
    what = []
    if any(kind != "attn" for kind, _ in layer_plan(cfg)):
        what.append("Mamba layers")
    if cfg.is_encdec:
        what.append("an encoder-decoder")
    if what:
        raise NotImplementedError(
            f"{cfg.name} has {' and '.join(what)}: tensor-parallel training "
            f"over a model axis of {mesh.size('model')} covers "
            "attention-only decoders (ROADMAP.md queue 1, tensor-parallel "
            "training of Mamba and encoder-decoder configs); train it on a "
            "(D, 1) mesh, with fsdp")


class Trainer:
    def __init__(self, model, opt_cfg: adamw.AdamWConfig,
                 train_cfg: TrainConfig, mesh=None, rules=None):
        check_trainable_mesh(mesh, model.cfg)
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        self._rules = rules
        self.rules = self._rules_for(mesh)
        self.plan = (TrainPlan(model, mesh, self.rules)
                     if mesh is not None else None)
        self.ckpt = ckpt_mod.AsyncCheckpointer(train_cfg.ckpt_dir)
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self.recoveries: list[tuple] = []

    def _rules_for(self, mesh):
        from repro_torch.parallel.sharding import make_rules
        if mesh is None:
            return None
        return self._rules or make_rules(fsdp=self.cfg.fsdp)

    @property
    def _lead(self) -> bool:
        """Whether this process prints and writes checkpoints."""
        return self.mesh is None or self.mesh.rank == 0

    def _log(self, msg: str) -> None:
        if self._lead:
            print(msg, flush=True)

    # ------------------------------------------------------------------
    def init_state(self, rng=None):
        """Fresh weights from ``rng`` (a ``torch.Generator`` on the
        model's device, or a seed; default ``cfg.seed``), zero moments,
        step 0.  Over a mesh each rank keeps its slices of the
        unsharded init (``TrainPlan.init``)."""
        if not isinstance(rng, torch.Generator):
            seed = self.cfg.seed if rng is None else int(rng)
            rng = torch.Generator(device=self.model.device).manual_seed(seed)
        if self.plan is not None:
            self.plan.init(rng)
        else:
            self.model.init_params(rng)
        return self.fresh_state()

    def fresh_state(self):
        """The model's current weights as a state: zero moments, step 0
        (over a mesh, this rank's slices of a whole model's weights)."""
        if self.plan is not None and not self.plan.placed:
            from repro_torch.models.model import _params_tree
            whole = tree_leaves(_params_tree(self.model, scan=False))
            if any(t.device.type == "meta" for t in whole):
                raise ValueError("fresh_state: the model is on the meta "
                                 "device; init_state or restore first")
            self.plan.place(whole)
        params = self.model.train_params()
        return {"params": params, "opt": adamw.init_state(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.model.device)}

    # ------------------------------------------------------------------
    def _value_and_grad(self, leaves, batch):
        loss = self.model.loss_fn(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def _data_mean(self, grads, loss):
        """The mean over the mesh's ``data`` axis, in f32, of every
        gradient but an FSDP shard's (its gather's backward took it)."""
        n = self.mesh.size("data")
        grads = [g if "data" in axes else
                 self.mesh.all_reduce(g.float(), "data").div_(n)
                 for g, axes in zip(grads, self.plan.cut_axes)]
        return grads, self.mesh.all_reduce(loss, "data") / n

    def _over_slices(self, parts, op: str):
        """Per leaf, its part (a scalar of each rank's slice) summed or
        maxed over the axes the leaf is cut over: one collective per
        group of leaves cut alike, per axis."""
        out = list(parts)
        groups = {}
        for i, axes in enumerate(self.plan.cut_axes):
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            vals = torch.stack([parts[i] for i in idx])
            for a in axes:
                vals = self.mesh.all_reduce(vals, a, op=op)
            for i, v in zip(idx, vals):
                out[i] = v
        return out

    def _global_norm(self, grads):
        """The global norm of the whole gradient from the slices."""
        sq = self._over_slices([torch.sum(torch.square(g.float()))
                                for g in grads], "sum")
        return torch.sqrt(torch.sum(torch.stack(sq)))

    def build_step(self):
        """(state, batch) -> (state, metrics): one optimizer step on a
        numpy or torch batch (moved to the model's device)."""
        model, opt_cfg = self.model, self.opt_cfg
        n_micro, compress = self.cfg.microbatches, self.cfg.grad_compression
        data_par = self.mesh is not None and self.mesh.size("data") > 1
        sliced = self.plan is not None and self.plan.sharded

        def step(state, batch):
            params = state["params"]
            leaves = tree_leaves(params)
            batch = {k: torch.as_tensor(v).to(model.device)
                     for k, v in batch.items()}
            if n_micro > 1:
                gacc = [torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for p in leaves]
                lacc = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
                for i in range(n_micro):
                    mb = {k: v[i * (v.shape[0] // n_micro):
                               (i + 1) * (v.shape[0] // n_micro)]
                          for k, v in batch.items()}
                    l, g = self._value_and_grad(leaves, mb)
                    for a, x in zip(gacc, g):
                        a.add_(x)
                    del g
                    lacc = lacc + l
                grads = [a.div_(n_micro) for a in gacc]
                loss = lacc / n_micro
            else:
                loss, grads = self._value_and_grad(leaves, batch)
            if data_par:
                grads, loss = self._data_mean(grads, loss)
            absmax = None
            if compress and sliced:
                absmax = self._over_slices([g.float().abs().max()
                                            for g in grads], "max")
            grads = tree_unflatten(params, grads)
            if compress:
                # int8 on the wire: quantize -> dequantize (the residual
                # is recomputed per step, the stateless form)
                q, s, _ = adamw.compress_grads(
                    grads, absmax=None if absmax is None else
                    tree_unflatten(params, absmax))
                grads = adamw.decompress_grads(q, s)
            gnorm = (self._global_norm(tree_leaves(grads)) if sliced
                     else None)
            _, opt, metrics = adamw.apply_updates(params, grads,
                                                  state["opt"], opt_cfg,
                                                  gnorm=gnorm)
            del grads
            metrics["loss"] = loss
            return ({"params": params, "opt": opt,
                     "step": state["step"] + 1}, metrics)

        return step

    # ------------------------------------------------------------------
    def run(self, pipeline, rng=None, state=None, inject_failure_at=None):
        """Train with auto-resume; returns (state, history).

        ``inject_failure_at``: the step at which a simulated node failure
        (RuntimeError) is raised once, exercising the recovery path."""
        if isinstance(rng, torch.Generator):
            # every re-initialisation draws the same weights, as the
            # reference's key does
            gen, gen_state = rng, rng.get_state()

            def init():
                gen.set_state(gen_state)
                return self.init_state(gen)
        else:
            def init():
                return self.init_state(rng)
        start_step = 0
        if state is None:
            latest = ckpt_mod.latest_step(self.cfg.ckpt_dir)
            if latest is not None:
                state, start_step = self._restore(latest)
                self._log(f"[trainer] resumed from step {start_step}")
            else:
                state = init()
        step_fn = self.build_step()

        history = []
        failed_once = False
        t_ewma = None
        step = start_step
        while step < self.cfg.steps:
            try:
                if inject_failure_at is not None \
                        and step == inject_failure_at and not failed_once:
                    failed_once = True
                    raise RuntimeError("simulated node failure")
                # the full step, data fetch included (input stalls are a
                # straggler class too), to the host read of its loss
                t0 = time.perf_counter()
                state, metrics = step_fn(state, pipeline.batch_at(step))
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                # the first executed step carries warm-up and stays out
                # of the watermark
                if step > start_step:
                    if t_ewma is None:
                        t_ewma = dt
                    if dt > self.cfg.straggler_factor * t_ewma \
                            and step > start_step + 3:
                        self.stragglers.append(step)
                        self._log(f"[trainer] straggler at step {step}: "
                                  f"{dt*1e3:.0f}ms vs watermark "
                                  f"{t_ewma*1e3:.0f}ms")
                    t_ewma = 0.9 * t_ewma + 0.1 * dt
                self.step_times.append(dt)
                history.append({"loss": loss, **{
                    k: float(v) for k, v in metrics.items() if k != "loss"}})
                step += 1
                if step % self.cfg.ckpt_every == 0 or step == self.cfg.steps:
                    self.save_async(step, state)
                if step % self.cfg.log_every == 0:
                    self._log(f"[trainer] step {step}: loss="
                              f"{history[-1]['loss']:.4f} ({dt*1e3:.0f}ms)")
            except RuntimeError as e:
                self._log(f"[trainer] failure at step {step}: {e}; "
                          "recovering")
                self.recoveries.append((step, str(e)))
                self.ckpt.wait()
                self._barrier()
                latest = ckpt_mod.latest_step(self.cfg.ckpt_dir)
                if latest is None:
                    state, step = init(), 0
                else:
                    state, step = self._restore(latest)
        self.ckpt.wait()
        self._barrier()
        return state, history

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.size_total > 1:
            import torch.distributed as dist
            dist.barrier(group=self.mesh.host_group)

    # ------------------------------------------------------------------
    def save_async(self, step: int, state) -> None:
        """Checkpoint ``state`` in the reference's layout (the stack in
        ``cfg.scan_layers``' layout, the moments as ``AdamWState``).  The
        host snapshot is taken before this returns; the stacking, where
        the layout asks for it, runs on the host copy in the writer
        thread.  Over a mesh every rank takes part: each writes the
        slices only it holds (``save_sharded_async``)."""
        cfg = self.model.cfg
        opt = state["opt"]
        if self.mesh is not None and self.mesh.size_total > 1:
            self._save_sharded(step, state)
            return
        self.ckpt.save_async(
            step, {"params": state["params"],
                   "opt": adamw.AdamWState(opt.count, opt.m, opt.v),
                   "step": state["step"]},
            layout=lambda t: {**t, "params": stack_layout(t["params"], cfg),
                              "opt": adamw.AdamWState(
                                  t["opt"].count,
                                  stack_layout(t["opt"].m, cfg),
                                  stack_layout(t["opt"].v, cfg))})

    def _save_sharded(self, step: int, state) -> None:
        cfg, plan = self.model.cfg, self.plan
        f32 = tree_map(lambda t: t.to(torch.float32), plan.template)
        meta = {"params": stack_layout(plan.template, cfg),
                "opt": adamw.AdamWState(
                    torch.empty((), dtype=torch.int32, device="meta"),
                    stack_layout(f32, cfg), stack_layout(f32, cfg)),
                "step": torch.empty((), dtype=torch.int32, device="meta")}
        opt = state["opt"]
        groups = ((("params",), tree_leaves(state["params"])),
                  (("opt", "m"), tree_leaves(opt.m)),
                  (("opt", "v"), tree_leaves(opt.v)))
        parts = []
        for i, path in enumerate(plan.paths):
            writes, index = plan.region(i)
            if not writes:
                continue
            where, r = layout_path(path, cfg)
            if r is not None:
                index = (r,) + index
            for head, leaves in groups:
                parts.append(("/".join(map(str, head + where)), index,
                              leaves[i]))
        if self.mesh.rank == 0:
            parts += [("opt/count", (), opt.count),
                      ("step", (), state["step"])]
        self.ckpt.save_sharded_async(step, meta, parts, self.mesh)

    def _restore(self, step: int):
        """(state, step) from checkpoint ``step`` (either package's, any
        mesh's): the weights copied into the model, the moments rebuilt
        as ``AdamWState`` on the model's device; over a mesh, each rank
        reads only its slices (the files memory-mapped)."""
        if self.plan is not None:
            tree, step, _ = ckpt_mod.restore(self.cfg.ckpt_dir, step,
                                             mmap=True)
            return self._placed(tree), int(step)
        tree, step, _ = ckpt_mod.restore(self.cfg.ckpt_dir, step)
        cfg, dev = self.model.cfg, self.model.device
        load_params_(self.model, tree["params"])
        params = self.model.train_params()
        opt = tree["opt"]              # a named tuple restores as a dict

        def moments(t):
            flat = [torch.as_tensor(x).to(dev, torch.float32)
                    for x in tree_leaves(unrolled(t, cfg))]
            return tree_unflatten(params, flat)
        state = {"params": params,
                 "opt": adamw.AdamWState(
                     count=torch.as_tensor(opt["count"]).to(dev, torch.int32),
                     m=moments(opt["m"]), v=moments(opt["v"])),
                 "step": torch.as_tensor(tree["step"]).to(dev, torch.int32)}
        return state, int(step)

    def _placed(self, whole):
        """This rank's state from a whole one (a restored checkpoint, a
        state off any mesh: either stack layout, ``opt`` an
        ``AdamWState`` or its dict), cut by the plan."""
        cfg, plan = self.model.cfg, self.plan
        opt = whole["opt"]
        opt = opt._asdict() if is_namedtuple(opt) else opt
        plan.place(tree_leaves(unrolled(whole["params"], cfg)))
        params = self.model.train_params()

        def moments(t):
            return tree_unflatten(params, plan.cut(
                tree_leaves(unrolled(t, cfg)), torch.float32))
        dev = plan.device
        return {"params": params,
                "opt": adamw.AdamWState(
                    count=torch.as_tensor(opt["count"]).to(dev, torch.int32),
                    m=moments(opt["m"]), v=moments(opt["v"])),
                "step": torch.as_tensor(whole["step"]).to(dev, torch.int32)}

    def reshard_to(self, mesh, state):
        """Elastic re-mesh: place a whole state (restored, or a trainer's
        off any mesh) on ``mesh``, this rank keeping its slices under the
        trainer's rules.  A model already cut over a mesh is replaced by
        a meta-device one of the same config and dtype, planned anew."""
        model = self.model
        check_trainable_mesh(mesh, model.cfg)
        if model.mesh is not None or model.train_plan is not None:
            model = Model(model.cfg, device="meta",
                          dtype=model.embed.tok.dtype)
            self.model = model
        self.mesh = mesh
        self.rules = self._rules_for(mesh)
        self.plan = TrainPlan(model, mesh, self.rules)
        return self._placed(state)



__all__ = ["TrainConfig", "Trainer", "check_trainable_mesh"]
