"""AdamW, learning-rate schedules, gradient clipping and int8 gradient
compression (counterpart of ``repro.optim.adamw``).

The functions take the same trees the trainer holds
(``repro_torch.tree``: dicts walked in sorted key order, as
``jax.tree_util`` walks them, lists and tuples of torch tensors,
``None`` an empty subtree).  The moments ``m`` and
``v`` are f32 whatever the parameter dtype, as in the reference, which
is why ``torch.optim.AdamW`` (moments in the parameter dtype) is not
used.  ``apply_updates`` computes each update in f32 and rounds it once
to the parameter dtype, writing parameters and moments in place under
``torch.no_grad()``; it returns the same trees, so a caller may use the
reference's functional form.

Gradient compression (``compress_grads`` / ``decompress_grads``):
per-tensor symmetric int8 with an error-feedback residual, rounding
half to even (``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    count: torch.Tensor          # int32 scalar on the parameters' device
    m: object
    v: object


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"        # cosine | linear | constant


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor) as an
    f32 tensor: linear warmup, then cosine or linear decay to 0 at
    ``total_steps`` (or constant)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        decay = (0.5 * (1 + torch.cos(math.pi * frac))
                 if cfg.schedule == "cosine" else 1.0 - frac)
    return cfg.lr * warm * decay


def init_state(params) -> AdamWState:
    """Zero f32 moments beside every leaf; the count on the first leaf's
    device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig,
                  gnorm=None):
    """One AdamW step, in place: clip by the global norm, bias-corrected
    moments, decoupled weight decay.  ``gnorm`` is the global norm where
    the caller took it (over a mesh: of the whole gradient, from its
    slices); default ``global_norm(grads)``.  Returns (params, new
    state, metrics {"grad_norm", "lr"} as device scalars)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    lr = schedule_lr(cfg, count)
    countf = count.to(torch.float32)
    b1c = 1 - torch.pow(cfg.beta1, countf)
    b2c = 1 - torch.pow(cfg.beta2, countf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m.mul_(cfg.beta1).add_(g, alpha=1 - cfg.beta1)
        v.mul_(cfg.beta2).add_((1 - cfg.beta2) * g * g)
        del g
        upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        p32 = p.float()
        upd.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        p.copy_(p32.sub_(upd))
        del upd, p32
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(count, state.m, state.v), metrics


# ---------------------------------------------------------------------------
# gradient compression (int8 + error feedback)
# ---------------------------------------------------------------------------


def _compress_one(g, r, absmax=None):
    gf = g.float() + r if r is not None else g.float()
    if absmax is None:
        absmax = torch.max(torch.abs(gf))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def compress_grads(grads, residual=None, absmax=None):
    """-> (int8 tree, f32 scale tree, new f32 residual tree), g ~= int8 *
    scale.  ``absmax`` (a tree of f32 scalars, optional) is each
    tensor's largest magnitude where the caller took it: over a mesh,
    the whole tensor's, for its slice."""
    flat = tree_leaves(grads)
    flat_r = tree_leaves(residual) if residual is not None \
        else [None] * len(flat)
    flat_m = tree_leaves(absmax) if absmax is not None \
        else [None] * len(flat)
    outs = [_compress_one(g, r, m) for g, r, m in zip(flat, flat_r, flat_m)]
    return tuple(tree_unflatten(grads, [o[i] for o in outs])
                 for i in range(3))


def decompress_grads(q_tree, scale_tree):
    return tree_map(lambda q, s: q.float() * s, q_tree, scale_tree)


__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "compress_grads",
           "decompress_grads", "global_norm", "init_state", "schedule_lr"]
