"""Top-level decoder: embeddings -> stack -> final norm -> LM head.

Counterpart of ``repro.models.model`` for the paths serving uses:
``forward`` (full-sequence logits), ``prefill_chunk`` over a paged
cache, ``prefill`` (a whole prompt, left-pads at negative positions)
over a contiguous cache, and ``decode_step`` over either.  A Mamba
layer's contiguous cache is its decode state (the ``conv`` window and
the f32 ``state``, ``models/ssm.py``); a paged cache refuses a stack
that has one.  The
parameters live on the modules (created on an explicit device);
:func:`from_jax_params` carries a
reference parameter tree (numpy arrays or torch tensors, quantized
leaves as dicts) into a model, and :func:`to_params` is its inverse:
the model's parameters as the reference's tree, in the stack layout of
``cfg.scan_layers`` (what quantized checkpoints store).  MoE layers
carry ``mlp/router`` and the expert banks ``mlp/{gate,up,down}`` (dense
[E, out, in], or bundles with packed [E, q, out, in/8]; one more
leading axis under ``scan_layers``), plus ``shared_*`` linears where
the config has shared experts.  Mamba layers carry ``mixer/{in_proj,
conv_w, conv_b, A_log, D, dt_bias, out_norm, out_proj}`` and, with no
MLP, no ``ln2`` or ``mlp``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch import default_device
from repro_torch.core.plane import PlaneBundle
from repro_torch.models import attention as attn
from repro_torch.models.layers import Embed, Linear, Norm
from repro_torch.models.ssm import init_ssm_cache
from repro_torch.models.transformer import Stack, layer_plan


class Model(nn.Module):
    """Decoder-only LM.  ``dtype`` is the linears' and embeddings' storage
    type (bf16 by default, as in the reference); activations follow the
    embedding dtype and the KV pool uses ``cfg.dtype``."""

    def __init__(self, cfg, *, device=None, dtype=torch.bfloat16):
        super().__init__()
        if any(kind == "attn" for kind, _ in layer_plan(cfg)):
            attn.check_supported(cfg)
        self.cfg = cfg
        self.device = default_device(device)
        self.embed = Embed(cfg, dtype=dtype, device=self.device)
        self.stack = Stack(cfg, dtype=dtype, device=self.device)
        self.final_norm = Norm(cfg.d_model, cfg.norm, self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Random weights from ``generator``: N(0, 0.02) linears and
        embeddings, zero biases, unit norm scales."""
        for mod in self.modules():
            if mod is not self and hasattr(mod, "init_params"):
                mod.init_params(generator)
        return self

    def n_params(self) -> int:
        n = 0
        for mod in self.modules():
            for t in _tensors_of(mod):
                n += t.numel()
        return n

    def with_config(self, **kw) -> "Model":
        """A view of this model (shared weights) under a changed config,
        e.g. another backend preference or paged-kernel mode."""
        import copy
        other = copy.copy(self)
        other.cfg = self.cfg.replace(**kw)
        return other

    # ------------------------------------------------------------------
    def init_paged_cache(self, batch: int, num_blocks: int, block_size: int,
                         max_blocks_per_seq: int) -> dict:
        """Per-layer block pools + tables; attention-only decoders only
        (an SSM state is O(1) per sequence: nothing to page)."""
        if any(kind != "attn" for kind, _ in layer_plan(self.cfg)):
            raise ValueError("paged cache supports attention-only decoders "
                             f"({self.cfg.name} has Mamba layers: serve it "
                             "on the slots engine)")
        return {"layers": [
            attn.init_paged_layer_cache(self.cfg, batch, num_blocks,
                                        block_size, max_blocks_per_seq,
                                        self.device)
            for _ in range(self.cfg.n_layers)]}

    def init_cache(self, batch: int, length: int) -> dict:
        """Contiguous per-row caches of ``length`` slots (the slots
        engine's), every position empty (-1); a Mamba layer's is its
        zero decode state (``init_ssm_cache``)."""
        return {"layers": [
            init_ssm_cache(self.cfg, batch, self.device) if kind == "mamba"
            else attn.init_layer_cache(self.cfg, batch, length, self.device)
            for kind, _ in layer_plan(self.cfg)]}

    # ------------------------------------------------------------------
    def _positions(self, tokens: torch.Tensor, start_pos) -> torch.Tensor:
        b, s = tokens.shape
        start = torch.as_tensor(start_pos, dtype=torch.int32,
                                device=tokens.device)
        if start.ndim == 0:
            start = start.expand(b)
        return start[:, None] + torch.arange(s, dtype=torch.int32,
                                             device=tokens.device)[None]

    def _run(self, tokens, positions, cache, cache_at):
        cfg = self.cfg
        x = self.embed(tokens, positions if cfg.pos == "learned" else None)
        return self.stack(x, positions, caches=cache, cache_at=cache_at,
                          backend=cfg.backend_preference,
                          paged_kernel=cfg.paged_kernel)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        logits = self.embed.logits(x, backend=self.cfg.backend_preference)
        return logits[..., : self.cfg.vocab_size]

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (no cache)."""
        tokens = tokens.to(self.device)
        positions = self._positions(tokens, 0)
        x, _ = self._run(tokens, positions, None, None)
        return self._head(x)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict, start_pos=0):
        """The whole prompt through the stack, filling a contiguous cache.
        ``start_pos`` (scalar or [B]) is the first token's position; a
        negative start marks left-pads, whose negative positions are
        masked from attention and dead in the cache, so a padded prompt
        scores as the unpadded one.  Returns (last-token logits [B, V]
        f32, cache)."""
        tokens = tokens.to(self.device)
        positions = self._positions(tokens, start_pos)
        x, cache = self._run(tokens, positions, cache, positions[:, 0])
        return self._head(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, cache: dict, start_pos,
                      last_idx):
        """One chunk of a chunked prefill: tokens [B, C] at absolute
        positions ``start_pos + [0, C)``, written into the paged cache.
        ``last_idx`` [B] (or scalar) picks each row's last real token.
        Returns (logits [B, V] f32, cache)."""
        tokens = tokens.to(self.device)
        positions = self._positions(tokens, start_pos)
        x, cache = self._run(tokens, positions, cache, positions[:, 0])
        b = x.shape[0]
        idx = torch.as_tensor(last_idx, dtype=torch.long, device=x.device)
        if idx.ndim == 0:
            idx = idx.expand(b)
        x = x[torch.arange(b, device=x.device), idx][:, None]
        return self._head(x)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict, pos):
        """One decode step: tokens [B, 1]; pos scalar or [B] absolute
        position of the new token.  Returns (logits [B, V] f32, cache)."""
        tokens = tokens.to(self.device)
        b = tokens.shape[0]
        pos_arr = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        if pos_arr.ndim == 0:
            # a real [B] tensor: the decode kernels take contiguous rows
            pos_arr = pos_arr.expand(b).contiguous()
        positions = pos_arr[:, None]
        x, cache = self._run(tokens, positions, cache, pos_arr)
        return self._head(x)[:, 0], cache


def set_block_tables(cache: dict, tables) -> dict:
    """Return ``cache`` with every layer's ``block_tables`` set to
    ``tables`` [B, max_blocks_per_seq] (all layers share one table); the
    pools are shared, not copied."""
    layers = cache["layers"]
    dev = layers[0]["pos"].device if layers else None
    t = torch.as_tensor(np.asarray(tables), dtype=torch.int32, device=dev)
    return {**cache, "layers": [{**c, "block_tables": t} for c in layers]}


def _tensors_of(mod):
    for v in vars(mod).values():
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, PlaneBundle):
            yield from (t for t in (v.packed, v.alpha, v.z) if t is not None)


# ---------------------------------------------------------------------------
# reference parameter trees -> port model
# ---------------------------------------------------------------------------


def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)      # a writable copy


def _leaf(a, device):
    """A dense leaf, or a PlaneBundle leaf given as a dict of arrays +
    static fields."""
    if isinstance(a, dict):
        z = a.get("z")
        return PlaneBundle(
            packed=_to_tensor(a["packed"], device),
            alpha=_to_tensor(a["alpha"], device),
            z=None if z is None else _to_tensor(z, device),
            group_size=int(a["group_size"]),
            in_features=int(a["in_features"]),
            out_features=int(a["out_features"]),
            kind=a.get("kind", "bcq"))
    return _to_tensor(a, device)


def _arr(a):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _index(tree, r: int):
    """Slice the stacked-layers axis of every leaf (bundles included)."""
    if isinstance(tree, dict) and "packed" in tree:
        out = dict(tree)
        for k in ("packed", "alpha", "z"):
            if out.get(k) is not None:
                out[k] = _arr(out[k])[r]
        return out
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return _arr(tree)[r]


def _reps(tree) -> int:
    if isinstance(tree, dict) and "packed" in tree:
        return _arr(tree["packed"]).shape[0]
    if isinstance(tree, dict):
        return _reps(next(iter(tree.values())))
    return _arr(tree).shape[0]


def layer_trees(stack: dict, n_layers: int) -> list:
    """Per-layer parameter trees from either stack layout:
    ``{"layers": [...]}`` (unrolled) or ``{"prefix": [...], "scan":
    [group_0, ...]}`` where group j stacks layers prefix+j, prefix+j+P, ..."""
    if "layers" in stack:
        return list(stack["layers"])
    prefix = list(stack.get("prefix", []))
    groups = stack.get("scan", [])
    out = [None] * n_layers
    for i, t in enumerate(prefix):
        out[i] = t
    period = len(groups)
    for j, g in enumerate(groups):
        for r in range(_reps(g)):
            out[len(prefix) + j + r * period] = _index(g, r)
    if any(t is None for t in out):
        raise ValueError("stacked parameter tree does not cover every layer")
    return out


# an MLP's linears, or a MoE layer's expert banks and shared experts
_MLP_LINEARS = ("gate", "up", "down", "shared_gate", "shared_up",
                "shared_down")
# a Mamba mixer's FP leaves beside its two linears
_SSM_LEAVES = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "out_norm")


def _set_linear(lin: Linear, tree: dict, name: str, device) -> None:
    lin.weight = _leaf(tree[name], device)
    bias_key = f"{name}_b"
    if bias_key in tree:
        lin.bias = _leaf(tree[bias_key], device)


def _set_norm(norm: Norm, tree: dict, device) -> None:
    norm.scale = _leaf(tree["scale"], device)
    if "bias" in tree:
        norm.bias = _leaf(tree["bias"], device)


def from_jax_params(params_np: dict, cfg, *, device=None) -> Model:
    """Build a :class:`Model` holding the reference's parameters.

    ``params_np`` is the reference tree with numpy leaves (GQA: ``q``,
    ``k``, ``v``, ``o`` and their biases; MLA: ``q_a``, ``q_a_norm``,
    ``q_b``, ``kv_a``, ``kv_a_norm``, ``kv_b``, ``o``); quantized
    leaves are dicts ``{packed, alpha, z, group_size, in_features,
    out_features, kind}``.  Both stack layouts are accepted; scan-stacked
    leaves are unstacked per layer.  Leaf dtypes are kept."""
    tok = params_np["embed"]["tok"]
    dtype = _to_tensor(_arr(tok)[:1], "cpu").dtype
    model = Model(cfg, device=device, dtype=dtype)
    dev = model.device
    emb = params_np["embed"]
    model.embed.tok = _leaf(emb["tok"], dev)
    if "pos" in emb:
        model.embed.pos = _leaf(emb["pos"], dev)
    if "unembed" in emb:
        model.embed.unembed.weight = _leaf(emb["unembed"], dev)
    for (kind, _), block, tree in zip(
            layer_plan(cfg), model.stack.layers,
            layer_trees(params_np["stack"], cfg.n_layers)):
        _set_norm(block.ln1, tree["ln1"], dev)
        mixer = tree["mixer"]
        if kind == "mamba":
            for name in ("in_proj", "out_proj"):
                getattr(block.mixer, name).weight = _leaf(mixer[name], dev)
            for name in _SSM_LEAVES:
                setattr(block.mixer, name, _leaf(mixer[name], dev))
        elif cfg.attention == "mla":
            for name in ("q_a", "q_b", "kv_a", "kv_b", "o"):
                getattr(block.mixer, name).weight = _leaf(mixer[name], dev)
            for name in ("q_a_norm", "kv_a_norm"):
                setattr(block.mixer, name, _leaf(mixer[name], dev))
        else:
            for name in ("q", "k", "v", "o"):
                _set_linear(getattr(block.mixer, name), mixer, name, dev)
        if block.mlp is None:
            continue
        _set_norm(block.ln2, tree["ln2"], dev)
        for name in _MLP_LINEARS:
            if name in tree["mlp"]:
                _set_linear(getattr(block.mlp, name), tree["mlp"], name, dev)
        if "router" in tree["mlp"]:
            block.mlp.router = _leaf(tree["mlp"]["router"], dev)
    _set_norm(model.final_norm, params_np["final_norm"], dev)
    return model


# ---------------------------------------------------------------------------
# port model -> reference parameter tree
# ---------------------------------------------------------------------------


def _export(w):
    """A weight as a tree leaf: the tensor, or a bundle as a dict."""
    if isinstance(w, PlaneBundle):
        return {"packed": w.packed, "alpha": w.alpha, "z": w.z,
                "group_size": w.group_size, "in_features": w.in_features,
                "out_features": w.out_features, "kind": w.kind}
    return w


def _norm_tree(norm: Norm) -> dict:
    out = {"scale": norm.scale}
    if norm.bias is not None:
        out["bias"] = norm.bias
    return out


def _linears_tree(mod, names) -> dict:
    out = {}
    for name in names:
        lin = getattr(mod, name, None)
        if lin is None:
            continue
        out[name] = _export(lin.weight)
        if getattr(lin, "bias", None) is not None:
            out[f"{name}_b"] = lin.bias
    return out


def _block_tree(block, cfg, kind) -> dict:
    if kind == "mamba":
        mixer = _linears_tree(block.mixer, ("in_proj", "out_proj"))
        mixer.update({name: getattr(block.mixer, name)
                      for name in _SSM_LEAVES})
    elif cfg.attention == "mla":
        mixer = _linears_tree(block.mixer, ("q_a", "q_b", "kv_a", "kv_b",
                                            "o"))
        mixer["q_a_norm"] = block.mixer.q_a_norm
        mixer["kv_a_norm"] = block.mixer.kv_a_norm
    else:
        mixer = _linears_tree(block.mixer, ("q", "k", "v", "o"))
    out = {"ln1": _norm_tree(block.ln1), "mixer": mixer}
    if block.mlp is None:
        return out
    mlp = _linears_tree(block.mlp, _MLP_LINEARS)
    if hasattr(block.mlp, "router"):
        mlp["router"] = block.mlp.router
    return {**out, "ln2": _norm_tree(block.ln2), "mlp": mlp}


def _stack_trees(trees: list):
    """Stack per-layer trees on a new leading axis (bundles per field)."""
    first = trees[0]
    if isinstance(first, dict) and "packed" in first:
        out = dict(first)
        for k in ("packed", "alpha", "z"):
            if first.get(k) is not None:
                out[k] = torch.stack([t[k] for t in trees])
        return out
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def to_params(model: Model) -> dict:
    """The model's parameters as the reference's tree (torch leaves on
    the model's device, bundles as dicts): ``{"layers": [...]}`` or,
    under ``scan_layers``, ``{"prefix": [...], "scan": [...]}`` stacked
    as ``from_jax_params`` unstacks it."""
    from repro_torch.models.transformer import scan_grouping
    cfg = model.cfg
    emb = {"tok": model.embed.tok}
    if model.embed.pos is not None:
        emb["pos"] = model.embed.pos
    if model.embed.unembed is not None:
        emb["unembed"] = _export(model.embed.unembed.weight)
    blocks = [_block_tree(b, cfg, kind)
              for (kind, _), b in zip(layer_plan(cfg), model.stack.layers)]
    if not cfg.scan_layers:
        stack = {"layers": blocks}
    else:
        pre, period, reps = scan_grouping(cfg)
        stack = {}
        if pre:
            stack["prefix"] = blocks[:pre]
        if period:
            stack["scan"] = [_stack_trees([blocks[pre + j + r * period]
                                           for r in range(reps)])
                             for j in range(period)]
    return {"embed": emb, "final_norm": _norm_tree(model.final_norm),
            "stack": stack}


__all__ = ["Model", "from_jax_params", "layer_trees", "set_block_tables",
           "to_params"]
