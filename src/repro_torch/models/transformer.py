"""Decoder blocks and the layer stack (counterpart of
``repro.models.transformer``): the stack is a Python loop over an
``nn.ModuleList`` — PyTorch runs eagerly, so there is no scan.
With ``remat`` (``cfg.remat``, passed by the model) a forward with no
cache under grad mode checkpoints each block
(``torch.utils.checkpoint``, non-reentrant), as the reference wraps
each block in ``jax.checkpoint``.

Trained over a mesh (``train/sharded.py``), a block gathers its FSDP
leaves (``Block.shards``, the weights cut over ``data``) where it runs,
inside the checkpointed function, so the backward's recompute gathers
them again and none is kept whole between the passes; and with the
``act_embed`` rule (``Stack.act_mesh``) each checkpointed block keeps
only this rank's ``model`` slice of its input's ``d_model`` columns,
gathered whole again before the recompute, as the reference shards its
remat stash.

The reference's parameter tree still stacks layers under
``scan_layers`` (``stack/prefix/i`` and ``stack/scan/j`` with a leading
layers axis); :func:`scan_grouping` and :func:`stack_path` name where a
layer's parameters sit in that tree, which quantization manifests,
mixed-precision plans and checkpoints key by.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import gather_replicated, split_replicated
from repro_torch.models.attention import (Attention, CrossAttention,
                                          MLAttention)
from repro_torch.models.layers import MLP, Norm, gathered
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM


class Block(nn.Module):
    """norm -> mixer (GQA or MLA attention, or the Mamba2 SSM, by
    ``cfg.layer_kind(layer)``) -> residual [-> norm -> cross-attention
    -> residual] [-> norm -> MLP or MoE (``cfg.mlp_kind(layer)``) ->
    residual], as ``block_desc`` / ``block_apply``.  A decoder layer of
    an encoder-decoder (``cross``) has ``ln_cross`` and ``cross``; a
    layer has no ``ln2`` and no MLP where ``d_ff`` is 0 and it is not a
    MoE layer (Mamba2: the mixer is the layer)."""

    def __init__(self, cfg, layer: int, *, dtype, device,
                 cross: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        kind, mlp_kind = cfg.layer_kind(layer), cfg.mlp_kind(layer)
        mixer = (SSM if kind == "mamba" else
                 MLAttention if cfg.attention == "mla" else Attention)
        self.mixer = mixer(cfg, dtype=dtype, device=device)
        self.ln_cross = self.cross = None
        if cross:
            self.ln_cross = Norm(cfg.d_model, cfg.norm, device)
            self.cross = CrossAttention(cfg, dtype=dtype, device=device)
        self.ln2 = self.mlp = None
        if cfg.d_ff or mlp_kind == "moe":
            self.ln2 = Norm(cfg.d_model, cfg.norm, device)
            mlp = MoE if mlp_kind == "moe" else MLP
            self.mlp = mlp(cfg, dtype=dtype, device=device)
        self.shards = None     # FSDP leaves (``layers.Shards``), training

    def forward(self, x, positions, *, cache=None, cache_at=None,
                causal=True, enc_out=None, backend=None,
                paged_kernel="auto"):
        h = self.ln1(x)
        if cache is not None:
            h, cache = self.mixer(h, positions, cache=cache,
                                  cache_at=cache_at, backend=backend,
                                  paged_kernel=paged_kernel)
        elif isinstance(self.mixer, Attention):
            h = self.mixer(h, positions, causal=causal, backend=backend)
        else:
            h = self.mixer(h, positions, backend=backend)
        x = x + h.to(x.dtype)
        if self.cross is not None:
            h = self.ln_cross(x)
            if enc_out is not None:
                # prefill: attend to the fresh K/V, keep them in the cache
                # (cast to its dtype) for the decode steps
                ck, cv = self.cross.kv(enc_out, backend)
                if cache is not None:
                    cache = {**cache,
                             "cross_k": ck.to(cache["cross_k"].dtype),
                             "cross_v": cv.to(cache["cross_v"].dtype)}
            elif cache is not None:
                ck, cv = cache["cross_k"], cache["cross_v"]
            else:
                raise ValueError("an encoder-decoder's decoder layer needs "
                                 "enc_out (frames) or a cache holding its "
                                 "cross K/V")
            h = self.cross(h, ck, cv, backend)
            x = x + h.to(x.dtype)
        if self.mlp is not None:
            h = self.mlp(self.ln2(x), backend)
            x = x + h.to(x.dtype)
        return x, cache


class Stack(nn.Module):
    """The layers of ``cfg`` in order; ``cross`` gives each one
    cross-attention (an encoder-decoder's decoder).  ``causal`` False
    runs the self-attention unmasked (the encoder)."""

    def __init__(self, cfg, *, dtype, device, cross: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(cfg, i, dtype=dtype, device=device, cross=cross)
            for i in range(cfg.n_layers))
        self.act_mesh = None   # the remat stash cut over ``model``

    def forward(self, x, positions, *, caches=None, cache_at=None,
                causal=True, enc_out=None, backend=None,
                paged_kernel="auto", remat=False):
        new = [] if caches is not None else None
        # activation checkpointing on the train path (the reference's
        # ``jax.checkpoint`` in ``_run_block``): each block keeps only its
        # input and recomputes itself in the backward pass
        ckpt = remat and caches is None and torch.is_grad_enabled()
        for i, block in enumerate(self.layers):
            if ckpt and self.act_mesh is not None:
                xs = split_replicated(x, self.act_mesh, "model", dim=-1)
                x = checkpoint(_block_from_slice, block, xs, self.act_mesh,
                               positions, causal, enc_out, backend,
                               use_reentrant=False)
                continue
            if ckpt:
                x = checkpoint(_block_out, block, x, positions, causal,
                               enc_out, backend, use_reentrant=False)
                continue
            c = caches["layers"][i] if caches is not None else None
            with gathered(block.shards):
                x, c = block(x, positions, cache=c, cache_at=cache_at,
                             causal=causal, enc_out=enc_out,
                             backend=backend, paged_kernel=paged_kernel)
            if new is not None:
                new.append(c)
        return x, ({**caches, "layers": new} if new is not None else None)


def _block_out(block, x, positions, causal, enc_out, backend):
    with gathered(block.shards):
        return block(x, positions, causal=causal, enc_out=enc_out,
                     backend=backend)[0]


def _block_from_slice(block, xs, mesh, positions, causal, enc_out, backend):
    """The block on its input gathered from this rank's column slice
    (the checkpoint keeps only ``xs``)."""
    x = gather_replicated(xs, mesh, "model", dim=-1)
    return _block_out(block, x, positions, causal, enc_out, backend)


def layer_plan(cfg):
    """(mixer kind, MLP kind) per decoder layer: ``cfg.layer_kind`` ("attn"
    or "mamba") and ``cfg.mlp_kind`` ("dense" or "moe")."""
    return [(cfg.layer_kind(i), cfg.mlp_kind(i))
            for i in range(cfg.n_layers)]


def scan_grouping(cfg):
    """(prefix, period, repeats): layers[prefix:] tile with ``period``
    (``repro/models/transformer.py::scan_grouping``)."""
    plan = layer_plan(cfg)
    pre = cfg.first_dense_layers
    body = plan[pre:]
    if not body:
        return pre, 0, 0
    for period in range(1, len(body) + 1):
        if len(body) % period:
            continue
        if all(body[i] == body[i % period] for i in range(len(body))):
            return pre, period, len(body) // period
    raise AssertionError("unreachable: period=len(body) always tiles")


def stack_path(cfg, layer: int):
    """(path of layer ``layer``'s block in the reference tree, index on
    its stacked axis or None): ``("stack", "layers", i)`` unrolled,
    ``("stack", "prefix", i)`` or ``("stack", "scan", j)`` with index r
    under ``scan_layers`` (group j stacks layers prefix + j + r*period)."""
    if not cfg.scan_layers:
        return ("stack", "layers", layer), None
    pre, period, _ = scan_grouping(cfg)
    if layer < pre:
        return ("stack", "prefix", layer), None
    j, r = (layer - pre) % period, (layer - pre) // period
    return ("stack", "scan", j), r
