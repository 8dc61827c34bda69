"""Mixture-of-Experts layer: top-k router and capacity-based dispatch.

Counterpart of ``repro.models.moe`` (``moe_desc``, ``_expert_bank`` and
``moe_apply``), step for step and cast for cast:

  1. router logits in f32 -> softmax -> top-k, the gates renormalized
     over the k (ties to the lower expert index, as ``jax.lax.top_k``:
     a stable descending sort);
  2. each (token, k) assignment gets its position inside its expert
     from a stable argsort of the row's expert ids (lower token index
     first), and assignments at or beyond the per-row capacity ``cap =
     max(4, min(int(ceil(S * k / E) * capacity_factor), S))`` are
     dropped.  Left-pads route like any token, so a padded prompt's pads
     take capacity ahead of its real tokens, as in the reference;
  3. kept assignments are scattered into ``[B, E, C, d]``;
  4. the expert FFN (SwiGLU) runs as three products per expert with
     f32 accumulation;
  5. outputs are gathered back to token order, weighted by the gates
     (rounded to the activation dtype) and summed over k in f32; shared
     experts, where the config has them, are plain linears added on top.

The reference has no Pallas kernel here: all of it is plain PyTorch.
Expert weights are banks ``[E, out, in]`` (bf16), or BCQ bundles stacked
per expert (``packed`` [E, q, out, in/8]); a quantized bank is
dequantized to bf16 one expert at a time, and only for the experts some
row routed a token to (an expert nobody routed to is never gathered, so
this is the reference's function with one expert's dense transient).
On the meta device (shape only: the dry run's FLOP count) every
expert runs its C slots, the products of the reference's batched einsum
over all E experts.  ``router_aux_loss`` is the reference's Switch-style
load-balancing loss.

Over a mesh (``MoETP``, set by ``shard_model``) the experts go over the
``model`` axis where they divide it (each rank runs only its routed
experts), else every expert's ``gate`` / ``up`` rows and ``down``
columns are cut (the rules' mlp-TP fallback); the shared experts are
column- and row-parallel linears as a dense MLP's.  The f32 router is
whole on every rank, so routing, capacity and drops are computed as
unsharded, and the gated assignments are summed over the ranks before
the k-sum: under expert parallelism that sum adds only zeros, and the
routed part equals the unsharded layer's bit for bit.  The host read
of the routed experts stays on every rank (a mesh counts it in
``host_syncs`` on the card).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.plane import PlaneBundle, dequantize
from repro_torch.launch.mesh import enter_parallel, sum_partials
from repro_torch.models.layers import Linear, _normal_, reslice


class ExpertBank(nn.Module):
    """One stacked expert weight: dense [E, out, in] or a PlaneBundle
    with a leading expert axis (``quantize_model`` swaps it in)."""

    def __init__(self, n_experts: int, out_features: int, in_features: int,
                 *, dtype, device):
        super().__init__()
        self.weight = torch.empty((n_experts, out_features, in_features),
                                  dtype=dtype, device=device)

    def init_params(self, generator: torch.Generator) -> None:
        """N(0, 0.02), one expert at a time (no f32 transient of the
        whole bank: 5 GB at DeepSeek-V2's 160 experts)."""
        for w in self.weight:
            _normal_(w, generator)

    def expert(self, e: int, dtype=torch.bfloat16) -> torch.Tensor:
        """Expert ``e``'s dense [out, in]: the stored tensor, or the
        bundle's dequantized to ``dtype`` (bf16 in ``_expert_bank``)."""
        w = self.weight
        if isinstance(w, PlaneBundle):
            if w.packed.ndim != 4:
                raise ValueError(f"an expert bank's bundle needs packed "
                                 f"[E, q, out, in/8], got "
                                 f"{tuple(w.packed.shape)}")
            if w.packed.device.type == "meta":
                # shape only (the dry run): nothing to dequantize
                return torch.empty((w.out_features, w.in_features),
                                   dtype=dtype, device="meta")
            return dequantize(w.index(e), dtype)
        return w[e]


class MoE(nn.Module):
    """``moe_desc``: the f32 router [E, d], the expert banks ``gate`` and
    ``up`` [E, f, d] and ``down`` [E, d, f], and the shared experts'
    linears where ``n_shared_experts`` > 0.

    After each call ``last_keep`` holds the call's kept-assignment mask
    [B, S, k] (False = dropped beyond capacity), for inspection.

    ``bank_dtype`` is what quantized banks dequantize to: bf16, as the
    reference (the expert input is then rounded to bf16 too).  A check
    that holds kernels against plain versions in f32 may set f32 on a
    copy of the module: with bf16 banks an f32 difference of 3e-6 flips
    bf16 roundings of the expert input, and from there the routing of
    whole tokens (measured on Mixtral at full width: first-prefill logits
    1.09 apart after 8 layers, 3.6e-5 with f32 banks)."""

    bank_dtype = torch.bfloat16

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
        self.router = torch.empty((e, d), dtype=torch.float32, device=device)
        self.gate = ExpertBank(e, f, d, dtype=dtype, device=device)
        self.up = ExpertBank(e, f, d, dtype=dtype, device=device)
        self.down = ExpertBank(e, d, f, dtype=dtype, device=device)
        self.shared_gate = self.shared_up = self.shared_down = None
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            self.shared_gate = Linear(fs, d, bias=False, dtype=dtype,
                                      device=device)
            self.shared_up = Linear(fs, d, bias=False, dtype=dtype,
                                    device=device)
            self.shared_down = Linear(d, fs, bias=False, dtype=dtype,
                                      device=device)
        self.last_keep = None
        self.tp: Optional[MoETP] = None

    def init_params(self, generator: torch.Generator) -> None:
        _normal_(self.router, generator)

    def forward(self, x: torch.Tensor, backend=None) -> torch.Tensor:
        y, self.last_keep = moe_apply(self, self.cfg, x, backend=backend)
        return y


class MoETP:
    """A MoE layer's cut over the ``model`` axis (``shard_model``).
    ``experts`` (e0, e1): the experts this rank's banks hold, where they
    divide the axis (expert parallelism); else None, and the banks are
    cut inside each expert: ``cut`` the slice of ``moe_d_ff`` this rank
    holds (its ``gate`` / ``up`` rows and ``down`` input columns), None
    where it is whole.  The router and the routing are whole on every
    rank."""

    def __init__(self, mesh, experts=None, cut=None):
        self.mesh = mesh
        self.experts = experts
        self.cut = cut

    @property
    def partial(self) -> bool:
        """Whether a rank's expert outputs are parts of a sum over the
        ranks (an expert computed elsewhere is 0 here, or a row-parallel
        ``down``)."""
        return self.experts is not None or self.cut is not None


def route(router: torch.Tensor, x: torch.Tensor, k: int):
    """(gates [B, S, k] f32 renormalized, experts [B, S, k] int64): the
    top-k of the f32 router softmax, ties to the lower expert index."""
    logits = torch.einsum("bsd,ed->bse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts


def positions_in_expert(flat_e: torch.Tensor, n_experts: int):
    """Each assignment's position inside its (row, expert) [B, n]: its rank
    among the row's assignments to the same expert, lower index first (a
    stable argsort of the expert ids)."""
    b, n = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    counts = torch.zeros((b, n_experts), dtype=torch.int64,
                         device=flat_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    sorted_e = torch.gather(flat_e, 1, order)
    ranks = (torch.arange(n, device=flat_e.device)[None]
             - torch.gather(starts, 1, sorted_e))
    return torch.zeros_like(flat_e).scatter_(1, order, ranks)


def moe_apply(mod: MoE, cfg, x: torch.Tensor, backend=None):
    """x [B, S, d] -> (y [B, S, d] in x.dtype, kept mask [B, S, k]).

    Dispatch is grouped per batch row: each row has its own capacity."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    n = s * k
    cap = int(-(-s * k // e) * cfg.capacity_factor)
    cap = max(4, min(cap, s))

    # 1. route (whole on every rank over a mesh; the tokens and gates
    # then meet the rank's experts, so their gradients are summed over
    # the ranks: ``enter_parallel``)
    tp = mod.tp
    gates, experts = route(mod.router, x, k)
    xd = x
    if tp is not None and tp.partial:
        xd, gates = (enter_parallel(t, tp.mesh) for t in (x, gates))
    flat_e = experts.reshape(b, n)

    # 2. positions within (row, expert); drop beyond capacity
    flat_pos = positions_in_expert(flat_e, e)
    keep = flat_pos < cap

    # 3. dispatch into [B, E, C, d] (dropped rows add zeros at (0, C-1))
    token_idx = torch.arange(n, device=x.device) // k
    safe_e = torch.where(keep, flat_e, torch.zeros_like(flat_e))
    safe_p = torch.where(keep, flat_pos, torch.full_like(flat_pos, cap - 1))
    contrib = torch.where(keep[..., None], xd[:, token_idx, :],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    rows = torch.arange(b, device=x.device)[:, None].expand(b, n)
    xin = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    xin.index_put_((rows, safe_e, safe_p), contrib, accumulate=True)

    # 4. the expert FFN, one routed expert at a time, f32 accumulation
    # (a meta tensor cannot say which experts were routed to: every one);
    # over a mesh only this rank's experts, or its cut of each
    if x.device.type == "meta":
        routed = range(e)
    else:
        routed = torch.unique(flat_e[keep]).tolist()
        if tp is not None and x.device.type == "cuda":
            tp.mesh.host_syncs += 1                # the host read above
    e0, e1 = tp.experts if tp is not None and tp.experts else (0, e)
    yout = torch.zeros((b, e, cap, d), dtype=torch.float32, device=x.device)
    for ex in routed:
        if not e0 <= ex < e1:
            continue
        wg = mod.gate.expert(ex - e0, mod.bank_dtype)
        wu = mod.up.expert(ex - e0, mod.bank_dtype)
        xe = xin[:, ex].to(wg.dtype).float()                 # [B, C, d]
        g = torch.matmul(xe, wg.float().T)
        u = torch.matmul(xe, wu.float().T)
        del wg, wu
        h = (F.silu(g) * u).to(x.dtype)
        wd = mod.down.expert(ex - e0, mod.bank_dtype)
        yout[:, ex] = torch.matmul(h.to(wd.dtype).float(), wd.float().T)
        del wd, g, u, h

    # 5. combine: gather back, gate (in x.dtype), sum over k in f32.  Over
    # a mesh the gated assignments are summed over the ranks first: with
    # experts cut each is computed on one rank and 0 on the others, so
    # that sum is exact and the k-sum runs as unsharded
    vals = yout[rows, safe_e, safe_p]                        # [B, n, d]
    vals = torch.where(keep[..., None], vals, torch.zeros_like(vals)) \
        * gates.reshape(b, n)[..., None].to(x.dtype)
    if tp is not None and tp.partial:
        vals = sum_partials(vals, tp.mesh)
    vals = vals.float().reshape(b, s, k, d)
    y = vals[:, :, 0]
    for j in range(1, k):
        y = y + vals[:, :, j]

    if mod.shared_gate is not None:
        sx = x
        if tp is not None and mod.shared_gate.out_slice is not None \
                and mod.shared_up.out_slice is not None:
            # one entry for the dispatch and both column-parallel linears
            sx = enter_parallel(xd, tp.mesh)
        sg = mod.shared_gate(sx, backend)
        su = mod.shared_up(sx, backend)
        sh = F.silu(sg.float()).to(x.dtype) * su
        if tp is not None:
            sh = reslice(sh, mod.shared_up.out_slice,
                         mod.shared_down.in_slice, tp.mesh)
        y = y + mod.shared_down(sh, backend).float()
    return y.to(x.dtype), keep.reshape(b, s, k)


def router_aux_loss(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e,
    f_e the share of top-k assignments to expert e and p_e its mean
    router probability over the tokens of ``x`` [B, S, d].  ``params``
    is a :class:`MoE` or a tree holding its f32 ``router`` [E, d]."""
    router = params.router if isinstance(params, MoE) else params["router"]
    d = x.shape[-1]
    logits = torch.einsum("td,ed->te", x.reshape(-1, d).float(),
                          router.float())
    probs = torch.softmax(logits, dim=-1)
    # top-k by a stable descending sort: ties to the lower expert index,
    # as ``jax.lax.top_k``
    experts = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :cfg.experts_per_token]
    frac = F.one_hot(experts, cfg.n_experts).sum(1).float().mean(0)
    return cfg.n_experts * torch.sum(frac * probs.mean(0))


__all__ = ["ExpertBank", "MoE", "MoETP", "moe_apply", "positions_in_expert", "route",
           "router_aux_loss"]
