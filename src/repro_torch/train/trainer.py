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

On a mesh (``launch/mesh.py``) the weights and AdamW states are
replicated over ``data``: the reference's FSDP rule (``embed`` over
``data``) is a memory layout, not a different result, and is not ported
(``TrainConfig`` has no ``fsdp``; ROADMAP.md, training's next cut).  Each rank's
pipeline gives its shard of the global batch; only rank 0 writes
checkpoints.  A mesh whose ``model`` axis is above 1 is refused
(tensor-parallel training needs autograd through the layers'
collectives: ROADMAP.md, training's next cut).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.models.model import (load_params_, stack_layout,
                                      unrolled)
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1            # gradient accumulation factor
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    straggler_factor: float = 3.0
    grad_compression: bool = False   # int8 + error feedback
    seed: int = 0


def check_trainable_mesh(mesh) -> None:
    """Refuse a mesh the trainer cannot train on."""
    if mesh is not None and mesh.size("model") > 1:
        raise NotImplementedError(
            f"training over a mesh whose model axis is {mesh.size('model')} "
            "is not ported: tensor-parallel training needs autograd through "
            "the layers' collectives (ROADMAP.md queue 1, training's next "
            "cut); train data-parallel, on a (D, 1) mesh")


class Trainer:
    def __init__(self, model, opt_cfg: adamw.AdamWConfig,
                 train_cfg: TrainConfig, mesh=None):
        check_trainable_mesh(mesh)
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        self.ckpt = ckpt_mod.AsyncCheckpointer(train_cfg.ckpt_dir)
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self.recoveries: list[tuple] = []

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
        step 0."""
        if not isinstance(rng, torch.Generator):
            seed = self.cfg.seed if rng is None else int(rng)
            rng = torch.Generator(device=self.model.device).manual_seed(seed)
        self.model.init_params(rng)
        return self.fresh_state()

    def fresh_state(self):
        """The model's current weights as a state: zero moments, step 0."""
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
        """The mean over the mesh's ``data`` axis, in f32."""
        n = self.mesh.size("data")
        grads = [self.mesh.all_reduce(g.float(), "data").div_(n)
                 for g in grads]
        return grads, self.mesh.all_reduce(loss, "data") / n

    def build_step(self):
        """(state, batch) -> (state, metrics): one optimizer step on a
        numpy or torch batch (moved to the model's device)."""
        model, opt_cfg = self.model, self.opt_cfg
        n_micro, compress = self.cfg.microbatches, self.cfg.grad_compression
        data_par = self.mesh is not None and self.mesh.size("data") > 1

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
            grads = tree_unflatten(params, grads)
            if compress:
                # int8 on the wire: quantize -> dequantize (the residual
                # is recomputed per step, the stateless form)
                q, s, _ = adamw.compress_grads(grads)
                grads = adamw.decompress_grads(q, s)
            _, opt, metrics = adamw.apply_updates(params, grads,
                                                  state["opt"], opt_cfg)
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
        ``cfg.scan_layers``' layout, the moments as ``AdamWState``);
        rank 0 only on a mesh.  The host snapshot is taken before this
        returns; the stacking, where the layout asks for it, runs on
        the host copy in the writer thread."""
        if not self._lead:
            return
        cfg = self.model.cfg
        opt = state["opt"]
        self.ckpt.save_async(
            step, {"params": state["params"],
                   "opt": adamw.AdamWState(opt.count, opt.m, opt.v),
                   "step": state["step"]},
            layout=lambda t: {**t, "params": stack_layout(t["params"], cfg),
                              "opt": adamw.AdamWState(
                                  t["opt"].count,
                                  stack_layout(t["opt"].m, cfg),
                                  stack_layout(t["opt"].v, cfg))})

    def _restore(self, step: int):
        """(state, step) from checkpoint ``step`` (either package's): the
        weights copied into the model, the moments rebuilt as
        ``AdamWState`` on the model's device."""
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

    def reshard_to(self, mesh, state):
        """Elastic re-mesh: place a (restored) state on a new
        data-parallel mesh.  Weights and moments are replicated over
        ``data``, so this moves them to the mesh's device."""
        check_trainable_mesh(mesh)
        self.mesh = mesh
        dev = mesh.device
        if self.model.device != torch.device(dev):
            raise ValueError(f"reshard_to: the model lives on "
                             f"{self.model.device}, the mesh on {dev}")
        load_params_(self.model, state["params"])
        params = self.model.train_params()
        opt = state["opt"]
        move = lambda x: x.to(dev)
        return {"params": params,
                "opt": adamw.AdamWState(move(opt.count),
                                        tree_map(move, opt.m),
                                        tree_map(move, opt.v)),
                "step": move(state["step"])}


__all__ = ["TrainConfig", "Trainer", "check_trainable_mesh"]
