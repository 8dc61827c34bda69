"""Shared building blocks: linears, norms, rotary positions, MLP,
embeddings.

Counterpart of ``repro.models.layers``.  Every linear weight is an
[out, in] tensor or a :class:`~repro_torch.core.plane.PlaneBundle` held
by a :class:`Linear` and executed through ``linear_apply``, the single
dispatch point of the model stack.  Weights are plain tensor attributes
on the modules, created on an explicit device; ``quantize_model``
swaps a dense weight for its bundle in place.

Tensor parallelism (``models/model.py::shard_model``): a linear whose
weight spec cuts its output rows over the mesh's ``model`` axis is
column-parallel (it holds its rows, bias included, and returns them);
one whose spec cuts its input columns is row-parallel (it holds its
columns, takes the matching slice of its input, and all-reduces its f32
partial product over ``model`` before the bias, which it holds whole,
is added once).  Either runs the same ``linear_apply`` -> kernel path
on the shard shape.  :func:`reslice` carries an activation from the
slice one linear produced to the slice the next one takes, gathering
it over ``model`` where they differ (a spec that fell back to
replication).  The embedding is vocab-parallel: ids outside the rank's
rows give 0, then an all-reduce; the head's logits are all-gathered in
vocab order.  A module without a plan (``tp is None``) runs exactly
the single-device code.

Every collective of these plans is a differentiable one of
``launch/mesh.py``, so the same plans train: a replicated activation
enters a column-parallel linear, a cut of ``reslice`` or the
vocab-parallel head through ``enter_parallel`` (its gradient summed over
``model``), partial products leave through ``sum_partials`` and
gathered slices through ``gather_replicated``.  Under
``torch.no_grad()`` (serving) each is its plain collective.
:class:`Shards` holds a module tree's FSDP leaves: weights cut over the
mesh's ``data`` axis, gathered whole where a block runs
(``Shards.gathered``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.quantized_linear import linear_apply
from repro_torch.launch.mesh import (enter_parallel, gather_replicated,
                                     gather_shards, sum_partials)

_INIT_SCALE = 0.02


def _normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 0.02) drawn in f32 then cast, as the reference's init."""
    t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                        dtype=torch.float32) * _INIT_SCALE)


def reslice(y: torch.Tensor, have, want, mesh) -> torch.Tensor:
    """``y``'s last dim moved from the column slice ``have`` to ``want``
    ((start, stop) of the full width, or None for all of it): as it is
    where they agree, else gathered over the mesh's ``model`` axis
    (every rank's slice of one width, in rank order) and cut."""
    if have == want:
        return y
    if have is not None:
        y = gather_replicated(y, mesh, "model", dim=-1)
    if want is None:
        return y
    return enter_parallel(y, mesh)[..., want[0]:want[1]]


def enter_for(x: torch.Tensor, linears, mesh) -> torch.Tensor:
    """``x`` entered once (``enter_parallel``) for ``linears`` where every
    one of them is column-parallel; as it is otherwise (each cut one then
    enters it on its own, an uncut one reads it replicated)."""
    if mesh is not None and all(lin.out_slice is not None
                                for lin in linears):
        return enter_parallel(x, mesh)
    return x


class Shards:
    """The FSDP leaves of a module tree: ``(module, attribute, dim)``,
    each tensor attribute cut along ``dim`` over the mesh's ``data``
    axis.  Inside :meth:`gathered` each attribute is the whole tensor
    (``gather_shards``: its shard's gradient is the data-parallel mean);
    outside, the shard.  Run inside a checkpointed block, the recompute
    of the backward gathers again."""

    def __init__(self, mesh, leaves):
        self.mesh = mesh
        self.leaves = list(leaves)

    @contextlib.contextmanager
    def gathered(self):
        held = [getattr(m, name) for m, name, _ in self.leaves]
        try:
            for (m, name, dim), t in zip(self.leaves, held):
                setattr(m, name, gather_shards(t, self.mesh, "data", dim))
            yield
        finally:
            for (m, name, _), t in zip(self.leaves, held):
                setattr(m, name, t)


def gathered(shards: Optional[Shards]):
    """``shards.gathered()``, or nothing to gather."""
    return shards.gathered() if shards is not None else \
        contextlib.nullcontext()


class LinearTP:
    """A linear's cut over the ``model`` axis: ``out_slice`` (rows it
    holds, column-parallel) or ``in_slice`` (input columns it holds,
    row-parallel), each (start, stop) of the full width or None."""

    def __init__(self, mesh, out_slice=None, in_slice=None):
        self.mesh = mesh
        self.out_slice = out_slice
        self.in_slice = in_slice

    def apply(self, lin, x, backend, out_dtype):
        if self.in_slice is not None:
            a, b = self.in_slice
            if x.shape[-1] != b - a:
                x = enter_parallel(x, self.mesh)[..., a:b]
            dt = out_dtype or x.dtype
            y = linear_apply(lin.weight, x, backend=backend,
                             out_dtype=torch.float32)
            y = sum_partials(y, self.mesh).to(dt)
            if lin.bias is not None:
                y = y + lin.bias.to(y.dtype)
            return y
        return linear_apply(lin.weight, enter_parallel(x, self.mesh),
                            lin.bias, backend=backend, out_dtype=out_dtype)


class Linear(nn.Module):
    """y = x @ W^T (+ bias); W dense [out, in] or a PlaneBundle.  ``tp``
    (None: the whole weight) is its tensor-parallel cut."""

    def __init__(self, out_features: int, in_features: int, *, bias: bool,
                 dtype, device):
        super().__init__()
        self.weight = torch.empty((out_features, in_features), dtype=dtype,
                                  device=device)
        self.bias = (torch.zeros(out_features, dtype=torch.float32,
                                 device=device) if bias else None)
        self.tp: Optional[LinearTP] = None

    @property
    def out_slice(self):
        return self.tp.out_slice if self.tp is not None else None

    @property
    def in_slice(self):
        return self.tp.in_slice if self.tp is not None else None

    def init_params(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, backend: Optional[str] = None,
                out_dtype=None) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.apply(self, x, backend, out_dtype)
        return linear_apply(self.weight, x, self.bias, backend=backend,
                            out_dtype=out_dtype)


class Norm(nn.Module):
    """LayerNorm (scale + bias) or RMSNorm (scale), computed in f32."""

    def __init__(self, dim: int, kind: str, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = torch.ones(dim, dtype=torch.float32, device=device)
        self.bias = (torch.zeros(dim, dtype=torch.float32, device=device)
                     if kind == "layernorm" else None)

    def init_params(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.bias is not None:
            mu = xf.mean(-1, keepdim=True)
            var = ((xf - mu) ** 2).mean(-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + self.eps)
            y = y * self.scale + self.bias
        else:
            ms = (xf * xf).mean(-1, keepdim=True)
            y = xf * torch.rsqrt(ms + self.eps) * self.scale
        return y.to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary positions, "rotate half" layout: x [B, S, H, D] (D even),
    positions [B, S] or [S].  Computed in f32, returned in x.dtype; pad
    rows at position -1 are rotated too (they are masked later)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)              # [D/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                 # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """GELU MLP with biases (OPT), or SwiGLU."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.act = cfg.mlp_act
        if self.act == "swiglu":
            self.gate = Linear(f, d, bias=False, dtype=dtype, device=device)
            self.up = Linear(f, d, bias=False, dtype=dtype, device=device)
            self.down = Linear(d, f, bias=False, dtype=dtype, device=device)
        else:
            self.up = Linear(f, d, bias=True, dtype=dtype, device=device)
            self.down = Linear(d, f, bias=True, dtype=dtype, device=device)
        self.mesh = None                  # set by shard_model

    def forward(self, x: torch.Tensor, backend=None) -> torch.Tensor:
        if self.act == "swiglu":
            x = enter_for(x, (self.gate, self.up), self.mesh)
            g = self.gate(x, backend)
            u = self.up(x, backend)
            h = F.silu(g.float()).to(x.dtype) * u
        else:
            h = self.up(x, backend)
            # jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        if self.mesh is not None:
            h = reslice(h, self.up.out_slice, self.down.in_slice, self.mesh)
        return self.down(h, backend)


class Embed(nn.Module):
    """Token embedding + learned positions (clamped at >= 0); the tied
    unembedding reuses ``tok`` with an f32 output."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.tok = torch.empty((cfg.padded_vocab, cfg.d_model), dtype=dtype,
                               device=device)
        self.pos = (torch.empty((cfg.max_seq_len, cfg.d_model), dtype=dtype,
                                device=device)
                    if cfg.pos == "learned" else None)
        self.unembed = (None if cfg.tie_embeddings else
                        Linear(cfg.padded_vocab, cfg.d_model, bias=False,
                               dtype=dtype, device=device))
        # vocab-parallel cut (set by shard_model): the mesh and the rows
        # of ``tok`` this rank holds, or None
        self.mesh = None
        self.vocab_slice = None

    def init_params(self, generator: torch.Generator) -> None:
        _normal_(self.tok, generator)
        if self.pos is not None:
            _normal_(self.pos, generator)

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.vocab_slice is None:
            return self.tok[tokens.long()]
        # ids outside this rank's rows give 0; the sum over the ranks is
        # then the one row, exactly (f32 carries any storage dtype)
        a, b = self.vocab_slice
        local = tokens.long() - a
        ok = (local >= 0) & (local < b - a)
        x = self.tok[torch.clamp(local, 0, b - a - 1)]
        x = torch.where(ok[..., None], x.float(), 0.0)
        return sum_partials(x, self.mesh).to(self.tok.dtype)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor]) -> torch.Tensor:
        x = self._lookup(tokens)
        if self.pos is not None and positions is not None:
            # clamped at both ends, as JAX clamps a gather: a chunk's pads
            # past the table (a chunk after adopted prefix blocks, rounded
            # up to its bucket) read the last row; they are dead writes
            x = x + self.pos[torch.clamp(positions, 0,
                                         self.pos.shape[0] - 1).long()]
        return x

    def logits(self, x: torch.Tensor, backend=None) -> torch.Tensor:
        if self.unembed is not None:
            y = self.unembed(x, backend, out_dtype=torch.float32)
            cut = self.unembed.out_slice
        else:
            cut = self.vocab_slice
            if cut is not None:
                x = enter_parallel(x, self.mesh)
            y = linear_apply(self.tok, x, backend=backend,
                             out_dtype=torch.float32)
        if cut is not None:
            y = reslice(y, cut, None, self.mesh)
        return y
