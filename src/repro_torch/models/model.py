"""Top-level decoder: embeddings -> stack -> final norm -> LM head.

Counterpart of ``repro.models.model`` for the paths serving uses:
``forward`` (full-sequence logits), ``prefill_chunk`` over a paged
cache, ``prefill`` (a whole prompt, left-pads at negative positions)
over a contiguous cache, ``decode_step`` over either, and
``decode_and_sample`` (a decode step ending in :func:`sample_tokens`
on the device, JAX's sampling bits from ``core.prng``).  A Mamba
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

The stub frontends, as in the reference: a VLM's ``patch_embeds`` [B,
P, d] are prepended to the text embeddings, positions continuing
through them (so with left-pads at negative positions the first
patches, not the pads, take the negative positions and are masked:
the reference's behaviour, reproduced); an encoder-decoder's
``frames`` [B, Senc, d] are the encoder's input (``encode``: learned
positions, the stack unmasked, a final norm), and each decoder layer
cross-attends to the encoder output.  Its K/V are computed at prefill
and kept in the contiguous cache (``cross_k`` / ``cross_v``, bf16
[B, encoder_seq, Hkv, hd]); a decode step reads them from there.  The
paged cache refuses an encoder-decoder.  The parameter trees carry the
``encoder`` subtree (``stack``, ``final_norm``, ``pos``) and each
decoder block's ``ln_cross`` / ``cross``.

:func:`shard_model` builds one rank's model of a mesh (``launch/mesh.py``)
from a reference-layout tree: each leaf cut by its logical axes
(``models/module.py``) under the sharding rules
(``parallel/sharding.py``), only the rank's slice moved to the device,
and each module given its tensor-parallel plan (``models/layers.py``,
``models/attention.py``, ``models/moe.py``: a MoE layer's f32 router
stays whole).  Only the ``model`` axis cuts weights (the serving engine
splits rows over ``data``); a rule that maps a weight axis onto another
mesh axis leaves it replicated there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch import default_device
from repro_torch.core import prng
from repro_torch.core.plane import PlaneBundle
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Embed, Linear, Norm, _normal_,
                                       gathered)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import init_ssm_cache
from repro_torch.models.transformer import Stack, layer_plan
from repro_torch.tree import tree_leaves


def encoder_config(cfg):
    """The encoder's config: ``n_encoder_layers`` attention layers with
    dense MLPs (the reference's ``enc_cfg``)."""
    return cfg.replace(n_layers=cfg.n_encoder_layers, n_experts=0,
                       attn_layer_period=0)


class Encoder(nn.Module):
    """An encoder-decoder's encoder: learned positions ``pos``
    [encoder_seq, d] (where ``cfg.pos == "learned"``), a stack of
    unmasked self-attention layers and a final norm."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = encoder_config(cfg)
        self.pos = (torch.empty((cfg.encoder_seq, cfg.d_model), dtype=dtype,
                                device=device)
                    if cfg.pos == "learned" else None)
        self.stack = Stack(self.cfg, dtype=dtype, device=device)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device)

    def init_params(self, generator: torch.Generator) -> None:
        if self.pos is not None:
            _normal_(self.pos, generator)


class Model(nn.Module):
    """Decoder LM, with an encoder where ``cfg.is_encdec``.  ``dtype`` is
    the linears' and embeddings' storage type (bf16 by default, as in the
    reference); activations follow the embedding dtype and the KV pool
    uses ``cfg.dtype``; the cross K/V cache is bf16, as the
    reference's."""

    def __init__(self, cfg, *, device=None, dtype=torch.bfloat16):
        super().__init__()
        if any(kind == "attn" for kind, _ in layer_plan(cfg)):
            attn.check_supported(cfg)
        self.cfg = cfg
        self.device = default_device(device)
        self.embed = Embed(cfg, dtype=dtype, device=self.device)
        self.stack = Stack(cfg, dtype=dtype, device=self.device,
                           cross=cfg.is_encdec)
        self.final_norm = Norm(cfg.d_model, cfg.norm, self.device)
        self.encoder = (Encoder(cfg, dtype=dtype, device=self.device)
                        if cfg.is_encdec else None)
        self.mesh = None        # set by shard_model or a training plan
        self.kv_shape = None    # a rank's (kv heads, head width) of a pool
        self.shards = None      # FSDP leaves outside the blocks (training)
        self.train_plan = None  # ``train.sharded.TrainPlan`` over a mesh

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
        (an SSM state is O(1) per sequence: nothing to page; an
        encoder-decoder's cross K/V is a fixed per-row reservation)."""
        cfg = self.cfg
        if cfg.is_encdec or any(kind != "attn"
                                for kind, _ in layer_plan(cfg)):
            what = ("is an encoder-decoder" if cfg.is_encdec
                    else "has Mamba layers")
            raise ValueError("paged cache supports attention-only decoders "
                             f"({cfg.name} {what}: serve it on a "
                             "contiguous cache)")
        return {"layers": [
            attn.init_paged_layer_cache(cfg, batch, num_blocks,
                                        block_size, max_blocks_per_seq,
                                        self.device, self.kv_shape)
            for _ in range(cfg.n_layers)]}

    def init_cache(self, batch: int, length: int) -> dict:
        """Contiguous per-row caches of ``length`` slots (the slots
        engine's), every position empty (-1); a Mamba layer's is its
        zero decode state (``init_ssm_cache``).  An encoder-decoder's
        layers also hold zero ``cross_k`` / ``cross_v`` [B, encoder_seq,
        Hkv, hd] in bf16."""
        cfg = self.cfg
        layers = []
        for kind, _ in layer_plan(cfg):
            c = (init_ssm_cache(cfg, batch, self.device) if kind == "mamba"
                 else attn.init_layer_cache(cfg, batch, length, self.device))
            if cfg.is_encdec:
                shape = (batch, cfg.encoder_seq, cfg.n_kv_heads,
                         cfg.head_dim_)
                for key in ("cross_k", "cross_v"):
                    c[key] = torch.zeros(shape, dtype=torch.bfloat16,
                                         device=self.device)
            layers.append(c)
        return {"layers": layers}

    # ------------------------------------------------------------------
    def _positions(self, b: int, s: int, start_pos) -> torch.Tensor:
        if isinstance(start_pos, (int, np.integer)):
            # built on the device: no host-to-device copy, no stream sync
            start_pos = int(start_pos)
            return torch.arange(start_pos, start_pos + s, dtype=torch.int32,
                                device=self.device).expand(b, s).contiguous()
        start = torch.as_tensor(start_pos, dtype=torch.int32,
                                device=self.device)
        if start.ndim == 0:
            start = start.expand(b)
        return start[:, None] + torch.arange(s, dtype=torch.int32,
                                             device=self.device)[None]

    def _embed(self, tokens, start_pos, patch_embeds=None):
        """(embeddings, positions [B, S]): the text's, or with
        ``patch_embeds`` [B, P, d] the patches then the text, numbered on
        from ``start_pos`` through both (learned positions clamped at
        0)."""
        cfg = self.cfg
        b, s = tokens.shape
        if patch_embeds is None:
            positions = self._positions(b, s, start_pos)
            return self.embed(tokens, positions if cfg.pos == "learned"
                              else None), positions
        x_txt = self.embed(tokens, None)
        x = torch.cat([patch_embeds.to(self.device, x_txt.dtype), x_txt],
                      dim=1)
        positions = self._positions(b, x.shape[1], start_pos)
        if cfg.pos == "learned":
            x = x + self.embed.pos[torch.clamp(positions, min=0).long()]
        return x, positions

    def _encode_for(self, frames):
        if not self.cfg.is_encdec:
            return None
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: pass "
                             "frames= (the encoder's input)")
        return self.encode(frames)

    def _run(self, x, positions, cache, cache_at, enc_out=None):
        cfg = self.cfg
        return self.stack(x, positions, caches=cache, cache_at=cache_at,
                          enc_out=enc_out, backend=cfg.backend_preference,
                          paged_kernel=cfg.paged_kernel)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        logits = self.embed.logits(x, backend=self.cfg.backend_preference)
        return logits[..., : self.cfg.vocab_size]

    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over precomputed frame embeddings [B, S, d]: its
        learned positions added, the stack with no causal mask, the final
        norm."""
        return self._encode(frames)

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        enc = self.encoder
        x = torch.as_tensor(frames).to(self.device)
        b, s, _ = x.shape
        if enc.pos is not None:
            x = x + enc.pos[None, :s].to(x.dtype)
        positions = self._positions(b, s, 0)
        x, _ = enc.stack(x, positions, causal=False,
                         backend=self.cfg.backend_preference,
                         remat=self.cfg.remat)
        return enc.final_norm(x)

    def _logits(self, tokens, frames=None, patch_embeds=None):
        """Full-sequence logits [B, S, V] f32 under whatever grad mode the
        caller is in; each block checkpointed where ``cfg.remat``.  The
        FSDP leaves outside the blocks (embeddings, final norms) are
        gathered for the whole pass."""
        with gathered(self.shards):
            enc_out = None
            if self.cfg.is_encdec:
                if frames is None:
                    raise ValueError(f"{self.cfg.name} is an encoder-"
                                     "decoder: pass frames= (the encoder's "
                                     "input)")
                enc_out = self._encode(frames)
            if patch_embeds is not None:
                patch_embeds = torch.as_tensor(patch_embeds)
            x, positions = self._embed(
                torch.as_tensor(tokens).to(self.device), 0, patch_embeds)
            x, _ = self.stack(x, positions, enc_out=enc_out,
                              backend=self.cfg.backend_preference,
                              remat=self.cfg.remat)
            return self._head(x)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, frames=None,
                patch_embeds=None) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (no cache); S counts the
        patches where ``patch_embeds`` are given."""
        return self._logits(tokens, frames, patch_embeds)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """Next-token cross-entropy (the reference's ``loss_fn``), a scalar
        f32 tensor that autograd can differentiate: the logits over the
        real vocab (the padded rows are out of the partition function, as
        the reference's -1e30 mask leaves them), and with
        ``patch_embeds`` only the text positions count.  ``batch`` holds
        ``tokens`` [B, S] (numpy or torch) and, where the model takes
        them, ``frames`` or ``patch_embeds``."""
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        patches = batch.get("patch_embeds")
        logits = self._logits(tokens, batch.get("frames"), patches)
        if patches is not None:
            logits = logits[:, patches.shape[1]:]
        targets = tokens[:, 1:].long()
        logits = logits[:, :-1].float()
        lse = torch.logsumexp(logits, dim=-1)                    # [B, S-1]
        ltgt = torch.gather(logits, -1, targets[..., None])[..., 0]
        return (lse - ltgt).mean()

    def train_params(self) -> dict:
        """Make every parameter a leaf that autograd tracks and return
        them as the reference's tree in the unrolled layout (``stack/
        layers/i``; the live tensors, not copies): what the trainer
        holds.  Over a training mesh (``train_plan``) they are this
        rank's slices, keyed by the same paths.  Only dense models
        train, as in the reference: a quantized leaf is refused, and so
        is a model ``shard_model`` cut for serving."""
        if self.mesh is not None and self.train_plan is None:
            raise ValueError("train_params: this model holds one rank's "
                             "slices of a serving mesh; train through "
                             "Trainer(model, ..., mesh=...) on a whole or "
                             "meta-device model")
        tree = _params_tree(self, scan=False)
        if not all(isinstance(t, torch.Tensor) for t in tree_leaves(tree)):
            raise ValueError(f"{self.cfg.name} holds quantized "
                             f"(PlaneBundle) weights: only dense models "
                             f"train, as in the reference")
        for t in tree_leaves(tree):
            if not t.is_floating_point():
                raise ValueError(f"a parameter of dtype {t.dtype} cannot "
                                 "train")
            t.requires_grad_(True)
        return tree

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict, start_pos=0, *,
                frames=None, patch_embeds=None):
        """The whole prompt through the stack, filling a contiguous cache.
        ``start_pos`` (scalar or [B]) is the first token's position; a
        negative start marks left-pads, whose negative positions are
        masked from attention and dead in the cache, so a padded prompt
        scores as the unpadded one.  ``patch_embeds`` are prepended to
        the tokens; an encoder-decoder takes ``frames``, encodes them and
        writes the cross K/V into the cache.  Returns (last-token logits
        [B, V] f32, cache)."""
        enc_out = self._encode_for(frames)
        x, positions = self._embed(tokens.to(self.device), start_pos,
                                   patch_embeds)
        x, cache = self._run(x, positions, cache, positions[:, 0], enc_out)
        return self._head(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, cache: dict, start_pos,
                      last_idx, *, patch_embeds=None):
        """One chunk of a chunked prefill: tokens [B, C] (after
        ``patch_embeds``, where given) at absolute positions ``start_pos
        + [0, C)``, written into the paged cache.  ``last_idx`` [B] (or
        scalar) picks each row's last real token.  Returns (logits [B, V]
        f32, cache)."""
        x, positions = self._embed(tokens.to(self.device), start_pos,
                                   patch_embeds)
        x, cache = self._run(x, positions, cache, positions[:, 0])
        if isinstance(last_idx, (int, np.integer)):
            x = x[:, int(last_idx)][:, None]     # no host-to-device copy
        else:
            b = x.shape[0]
            idx = torch.as_tensor(last_idx, dtype=torch.long,
                                  device=x.device)
            if idx.ndim == 0:
                idx = idx.expand(b)
            x = x[torch.arange(b, device=x.device), idx][:, None]
        return self._head(x)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict, pos):
        """One decode step: tokens [B, 1]; pos scalar or [B] absolute
        position of the new token (an encoder-decoder reads its cross K/V
        from the cache).  Returns (logits [B, V] f32, cache)."""
        tokens = tokens.to(self.device)
        b = tokens.shape[0]
        pos_arr = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        if pos_arr.ndim == 0:
            # a real [B] tensor: the decode kernels take contiguous rows
            pos_arr = pos_arr.expand(b).contiguous()
        positions = pos_arr[:, None]
        x = self.embed(tokens, positions if self.cfg.pos == "learned"
                       else None)
        x, cache = self._run(x, positions, cache, pos_arr)
        return self._head(x)[:, 0], cache

    @torch.no_grad()
    def decode_and_sample(self, tokens: torch.Tensor, cache: dict, pos,
                          keys, temperature, top_k):
        """One decode step, then :func:`sample_tokens` on the device, so
        only the sampled ids (int32 [B]) leave it: both ticks of the
        paged engine.  ``keys`` int64 [B, 2] (uint32 key words; None when every
        row is greedy: then the step ends in an argmax), ``temperature``
        float [B], ``top_k`` int [B].  Returns (ids int32 [B], cache)."""
        logits, cache = self.decode_step(tokens, cache, pos)
        if keys is None:
            return torch.argmax(logits, dim=-1).to(torch.int32), cache
        return sample_tokens(logits, keys, temperature, top_k), cache


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor, temperature,
                  top_k) -> torch.Tensor:
    """Batched sampling as a pure function of each row's logits and key
    (the reference's ``sample_tokens``).  Per row: ``temperature <= 0``
    is the argmax (ties to the lowest index); otherwise logits below the
    ``top_k``-th largest are masked to ``-inf`` (every tie at the
    threshold stays; ``top_k <= 0`` keeps all), the rest divided by the
    temperature (floored at 1e-6) and drawn by the Gumbel-max trick
    under the row's key (``core.prng.categorical``: JAX's bits).

    logits [B, V]; keys int64 [B, 2]; temperature float [B]; top_k int
    [B] (tensors on the logits' device).  Returns int32 [B]."""
    logits = logits.float()
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    k = top_k.to(torch.int64)
    kk = torch.where(k <= 0, torch.full_like(k, v), k).clamp(1, v)
    order = torch.sort(logits, dim=-1, descending=True).values
    thresh = torch.gather(order, 1, (kk - 1)[:, None])
    masked = torch.where(logits < thresh,
                         torch.full_like(logits, float("-inf")), logits)
    temp = temperature.to(torch.float32)
    scaled = masked / torch.clamp_min(temp, 1e-6)[:, None]
    sampled = prng.categorical(keys, scaled)
    return torch.where(temp <= 0.0, greedy, sampled).to(torch.int32)


def set_block_tables(cache: dict, tables) -> dict:
    """Return ``cache`` with every layer's ``block_tables`` set to
    ``tables`` [B, max_blocks_per_seq] (all layers share one table); the
    pools are shared, not copied.  A tensor already on the pools' device
    is used as it is (no host copy)."""
    layers = cache["layers"]
    dev = layers[0]["pos"].device if layers else None
    if not isinstance(tables, torch.Tensor):
        tables = torch.as_tensor(np.asarray(tables))
    t = tables.to(device=dev, dtype=torch.int32)
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


def _set_block(block, kind: str, tree: dict, cfg, dev) -> None:
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
    if block.cross is not None:
        _set_norm(block.ln_cross, tree["ln_cross"], dev)
        for name in ("q", "k", "v", "o"):
            _set_linear(getattr(block.cross, name), tree["cross"], name, dev)
    if block.mlp is None:
        return
    _set_norm(block.ln2, tree["ln2"], dev)
    for name in _MLP_LINEARS:
        if name in tree["mlp"]:
            _set_linear(getattr(block.mlp, name), tree["mlp"], name, dev)
    if "router" in tree["mlp"]:
        block.mlp.router = _leaf(tree["mlp"]["router"], dev)


def _set_stack(stack, tree: dict, cfg, dev) -> None:
    for (kind, _), block, layer in zip(
            layer_plan(cfg), stack.layers,
            layer_trees(tree, cfg.n_layers)):
        _set_block(block, kind, layer, cfg, dev)


def from_jax_params(params_np: dict, cfg, *, device=None,
                    _meta: bool = False) -> Model:
    """Build a :class:`Model` holding the reference's parameters.

    ``params_np`` is the reference tree with numpy leaves (GQA: ``q``,
    ``k``, ``v``, ``o`` and their biases; MLA: ``q_a``, ``q_a_norm``,
    ``q_b``, ``kv_a``, ``kv_a_norm``, ``kv_b``, ``o``; an
    encoder-decoder's ``encoder`` subtree and its decoder blocks'
    ``ln_cross`` / ``cross``); quantized leaves are dicts ``{packed,
    alpha, z, group_size, in_features, out_features, kind}``.  Both
    stack layouts are accepted; scan-stacked leaves are unstacked per
    layer.  Leaf dtypes are kept.  With ``_meta`` the modules are built
    on the meta device, so nothing but the given leaves is allocated."""
    tok = params_np["embed"]["tok"]
    dtype = _to_tensor(_arr(tok)[:1], "cpu").dtype
    model = Model(cfg, device="meta" if _meta else device, dtype=dtype)
    if _meta:
        model.device = default_device(device)
    dev = model.device
    emb = params_np["embed"]
    model.embed.tok = _leaf(emb["tok"], dev)
    if "pos" in emb:
        model.embed.pos = _leaf(emb["pos"], dev)
    if "unembed" in emb:
        model.embed.unembed.weight = _leaf(emb["unembed"], dev)
    _set_stack(model.stack, params_np["stack"], cfg, dev)
    _set_norm(model.final_norm, params_np["final_norm"], dev)
    if model.encoder is not None:
        enc, tree = model.encoder, params_np["encoder"]
        _set_stack(enc.stack, tree["stack"], enc.cfg, dev)
        _set_norm(enc.final_norm, tree["final_norm"], dev)
        if "pos" in tree:
            enc.pos = _leaf(tree["pos"], dev)
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
    if block.cross is not None:
        out["ln_cross"] = _norm_tree(block.ln_cross)
        out["cross"] = _linears_tree(block.cross, ("q", "k", "v", "o"))
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


def _stack_tree(stack, cfg, scan: bool) -> dict:
    blocks = [_block_tree(b, cfg, kind)
              for (kind, _), b in zip(layer_plan(cfg), stack.layers)]
    return _stack_blocks(blocks, cfg) if scan else {"layers": blocks}


def _stack_blocks(blocks: list, cfg) -> dict:
    """Per-layer trees in the ``scan_layers`` layout of ``cfg``."""
    from repro_torch.models.transformer import scan_grouping
    pre, period, reps = scan_grouping(cfg)
    out = {}
    if pre:
        out["prefix"] = blocks[:pre]
    if period:
        out["scan"] = [_stack_trees([blocks[pre + j + r * period]
                                     for r in range(reps)])
                       for j in range(period)]
    return out


def to_params(model: Model, scan_layers: Optional[bool] = None) -> dict:
    """The model's parameters as the reference's tree (torch leaves on
    the model's device, bundles as dicts): each stack (the decoder's and
    an encoder's) as ``{"layers": [...]}`` or, under ``scan_layers``
    (default ``cfg.scan_layers``), ``{"prefix": [...], "scan": [...]}``
    stacked as ``from_jax_params`` unstacks it.  The unrolled layout
    holds the live tensors; the stacked one, copies.  A rank's model of
    a mesh is refused: it holds only its slices."""
    if model.mesh is not None:
        raise ValueError("to_params: this model holds one rank's slices of "
                         f"its parameters ({model.mesh}); export the tree "
                         "it was sharded from instead")
    cfg = model.cfg
    return _params_tree(model, cfg.scan_layers if scan_layers is None
                        else scan_layers)


def _params_tree(model: Model, scan: bool) -> dict:
    """``to_params``' tree of whatever the modules hold (a rank's slices
    over a mesh)."""
    cfg = model.cfg
    emb = {"tok": model.embed.tok}
    if model.embed.pos is not None:
        emb["pos"] = model.embed.pos
    if model.embed.unembed is not None:
        emb["unembed"] = _export(model.embed.unembed.weight)
    out = {"embed": emb, "final_norm": _norm_tree(model.final_norm),
           "stack": _stack_tree(model.stack, cfg, scan)}
    enc = model.encoder
    if enc is not None:
        out["encoder"] = {"stack": _stack_tree(enc.stack, enc.cfg, scan),
                          "final_norm": _norm_tree(enc.final_norm)}
        if enc.pos is not None:
            out["encoder"]["pos"] = enc.pos
    return out


# ---------------------------------------------------------------------------
# training trees: parameters, gradients and AdamW moments in either layout
# ---------------------------------------------------------------------------


def _map_stacks(tree: dict, cfg, fn) -> dict:
    """``tree`` with ``fn(stack, its config)`` applied to each layer stack
    (the decoder's, and an encoder's)."""
    out = {**tree, "stack": fn(tree["stack"], cfg)}
    if cfg.is_encdec:
        enc = tree["encoder"]
        out["encoder"] = {**enc, "stack": fn(enc["stack"],
                                             encoder_config(cfg))}
    return out


def stack_layout(tree: dict, cfg) -> dict:
    """An unrolled tree (``to_params(model, scan_layers=False)``'s
    layout; any leaves: parameters, gradients, moments) in the layout of
    ``cfg.scan_layers``: the reference's, which its checkpoints hold."""
    if not cfg.scan_layers:
        return tree
    return _map_stacks(tree, cfg, lambda st, scfg: _stack_blocks(
        list(st["layers"]), scfg))


def unrolled(tree: dict, cfg) -> dict:
    """A tree in either stack layout as the unrolled one (stacked leaves
    sliced per layer: views of torch tensors, numpy slices)."""
    return _map_stacks(tree, cfg, lambda st, scfg: {
        "layers": layer_trees(st, scfg.n_layers)})


def layout_path(path: tuple, cfg) -> tuple:
    """(path in the layout of ``cfg.scan_layers``, index on its stacked
    layers axis or None) of an unrolled tree's leaf path: where
    :func:`stack_layout` puts that leaf."""
    from repro_torch.models.transformer import stack_path
    enc = path[:1] == ("encoder",)
    head = path[:1] if enc else ()
    rest = path[len(head):]
    if not cfg.scan_layers or rest[:2] != ("stack", "layers"):
        return path, None
    scfg = encoder_config(cfg) if enc else cfg
    where, r = stack_path(scfg.replace(scan_layers=True), rest[2])
    return head + where + rest[3:], r


@torch.no_grad()
def load_params_(model: Model, tree: dict) -> None:
    """Copy a reference-layout tree (either stack layout; numpy or torch
    leaves, dense) into the model's own tensors, in place, each cast to
    the tensor's dtype."""
    mine = tree_leaves(to_params(model, scan_layers=False))
    theirs = tree_leaves(unrolled(tree, model.cfg))
    if len(mine) != len(theirs):
        raise ValueError(f"load_params_: the tree has {len(theirs)} leaves, "
                         f"the model {len(mine)}")
    for dst, src in zip(mine, theirs):
        src = _to_tensor(src, dst.device)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"load_params_: a leaf of shape "
                             f"{tuple(src.shape)} for {tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))


# ---------------------------------------------------------------------------
# one rank's model of a mesh
# ---------------------------------------------------------------------------


def check_meshable(cfg) -> None:
    """Refuse what the reference's mesh engine cannot serve: its one mesh
    engine is the paged one, and its paged cache holds attention-only
    decoders without a sliding window (``repro/models/model.py:119-122``,
    ``repro/models/attention.py:247-249``).  So Mamba layers, a sliding
    window and an encoder-decoder are refused; MLA, MoE and an int8 KV
    cache are served."""
    what = []
    if any(kind != "attn" for kind, _ in layer_plan(cfg)):
        what.append("Mamba layers")
    if cfg.sliding_window:
        what.append("a sliding window")
    if cfg.is_encdec:
        what.append("an encoder-decoder")
    if what:
        raise NotImplementedError(
            f"{cfg.name} has {', '.join(what)}: only the paged engine "
            "serves over a mesh, and a paged cache holds attention-only "
            "decoders without a sliding window, as the reference's")


def _model_axis_only(specs):
    """Keep only the ``model`` entries of a specs tree (weights never
    shard over ``data`` when serving)."""
    from repro_torch.parallel.sharding import BundleSpecs, _map

    def keep(spec):
        return tuple(e if e == "model" else None for e in spec)

    def leaf(_, sp):
        if isinstance(sp, BundleSpecs):
            return BundleSpecs(keep(sp.packed), keep(sp.alpha),
                               None if sp.z is None else keep(sp.z))
        return keep(sp) if isinstance(sp, tuple) else sp
    return _map(specs, leaf)


def _cuts(full, spec, mesh):
    """(lead, out, in) slices of a weight leaf ([*lead, out, in] dense, or
    a bundle with packed [*lead, q, out, in/8]) under its spec: each
    (start, stop) of the full width or None; an input slice past a
    bundle's real width keeps only its real columns."""
    from repro_torch.parallel.sharding import dim_slice, is_bundle
    if is_bundle(full):
        get = full.get if isinstance(full, dict) else \
            (lambda k: getattr(full, k))
        shape = tuple(get("packed").shape)
        rows, cols = int(get("out_features")), shape[-1] * 8
        in_features = int(get("in_features"))
        entries = list(spec.packed) + [None] * (len(shape) - len(spec.packed))
        lead = entries[:len(shape) - 3]
    else:
        shape = tuple(full.shape)
        rows, cols = shape[-2:]
        in_features = cols
        entries = list(spec) + [None] * (len(shape) - len(spec))
        lead = entries[:len(shape) - 2]
    lead_slice = (dim_slice(shape[0], lead[0], mesh) if lead else None)
    out_slice = dim_slice(rows, entries[-2], mesh)
    in_slice = dim_slice(cols, entries[-1], mesh)
    if in_slice is not None:
        in_slice = (in_slice[0], min(in_slice[1], in_features))
    return lead_slice, out_slice, in_slice


def _linear_tp(lin: Linear, full, spec, mesh) -> None:
    """Give ``lin`` its cut from its full leaf and spec."""
    from repro_torch.models.layers import LinearTP
    _, out_slice, in_slice = _cuts(full, spec, mesh)
    if out_slice is not None or in_slice is not None:
        lin.tp = LinearTP(mesh, out_slice, in_slice)


def _whole(spec):
    """A leaf's spec whole over ``model`` (a bundle's fields too); its
    other entries (FSDP's ``data``) kept."""
    from repro_torch.parallel.sharding import BundleSpecs

    def drop(sp):
        parts = [None if e == "model" else e for e in sp]
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)
    if isinstance(spec, BundleSpecs):
        return BundleSpecs(drop(spec.packed), drop(spec.alpha),
                           None if spec.z is None else drop(spec.z))
    return drop(spec)


def _attn_tp(cfg, mesh, rules):
    """An attention layer's plan (``AttnTP``) on ``mesh``: the query
    heads split where they divide, and a GQA pool's cut from its logical
    axes (an MLA latent pool is whole on every rank)."""
    from repro_torch.models.module import paged_layer_axes
    from repro_torch.parallel.sharding import dim_slice, spec_for
    h, tp = cfg.n_heads, mesh.size("model")
    m = mesh.index("model")
    heads = (m * h // tp, (m + 1) * h // tp) if h % tp == 0 else (0, h)
    if cfg.attention == "mla":
        return attn.AttnTP(mesh, heads, None), None
    hkv = cfg.n_kv_heads * cfg.kv_replication
    hd = cfg.head_dim_
    spec = spec_for((1, 1, hkv, hd), paged_layer_axes(cfg)["k"], mesh,
                    rules)
    spec = tuple(e if e == "model" else None for e in spec) + (None,) * 4
    pool, kv_shape = None, (hkv, hd)
    for dim, (name, size) in enumerate((("kv_heads", hkv), ("head_dim", hd))):
        cut = dim_slice(size, spec[2 + dim], mesh)
        if cut is not None:
            pool = (name, *cut)
            kv_shape = (cut[1] - cut[0], hd) if dim == 0 else \
                (hkv, cut[1] - cut[0])
    return attn.AttnTP(mesh, heads, pool), kv_shape


def _whole_leaves(cfg, specs, mesh) -> None:
    """Keep whole, in ``specs`` (in place), the leaves the plans hold
    whole: a MoE layer's f32 router (routing runs on every rank as
    unsharded), and an MLA layer's ``kv_b`` where the heads do not
    divide the model axis (every rank absorbs all of them)."""
    mla_whole = cfg.attention == "mla" and cfg.n_heads % mesh.size("model")
    for sp in specs["stack"]["layers"]:
        mlp = sp.get("mlp") or {}
        if "router" in mlp:
            mlp["router"] = _whole(mlp["router"])
        if mla_whole:
            sp["mixer"]["kv_b"] = _whole(sp["mixer"]["kv_b"])


def _moe_tp(tree, sp, mesh):
    """A MoE layer's plan from its banks' specs: the experts' slice where
    the experts claim the model axis, else each expert's cut of
    ``moe_d_ff`` (``gate`` / ``up`` rows and ``down`` columns alike)."""
    from repro_torch.models.moe import MoETP
    experts, rows, _ = _cuts(tree["gate"], sp["gate"], mesh)
    _, _, cols = _cuts(tree["down"], sp["down"], mesh)
    if rows != cols:
        raise ValueError(f"expert gate rows {rows} and down columns {cols} "
                         "are cut differently")
    return MoETP(mesh, experts, rows)


def _tensors_all(model):
    for mod in model.modules():
        yield from _tensors_of(mod)


def shard_model(params: dict, cfg, mesh, rules: Optional[dict] = None,
                device=None) -> Model:
    """One rank's :class:`Model` of ``mesh`` from the reference-layout
    tree ``params`` (``from_jax_params``' input, or a tree loaded by
    ``quant.checkpoint.load_quantized``; host leaves): every leaf cut by
    ``build_specs`` under ``rules`` (default ``make_rules()``), only this
    rank's slice moved to ``device`` (default the mesh's), the linears
    column- or row-parallel by their specs, the embedding and head
    vocab-parallel, each attention layer's heads and pool cut, each MoE
    layer's experts (or each expert's rows and columns) cut.  The full
    tree never reaches the device."""
    from repro_torch.models.module import logical_axes
    from repro_torch.parallel import sharding as shd
    check_meshable(cfg)
    rules = rules or shd.make_rules()
    device = default_device(device if device is not None else mesh.device)
    # the unrolled layout: per-layer specs, stacked leaves unstacked
    full = dict(params)
    full["stack"] = {"layers": layer_trees(params["stack"], cfg.n_layers)}
    axes = logical_axes(cfg.replace(scan_layers=False))
    specs = _model_axis_only(shd.build_specs(full, axes, mesh, rules))
    _whole_leaves(cfg, specs, mesh)
    local = shd.shard_tree(full, specs, mesh)
    model = from_jax_params(local, cfg, device=device, _meta=True)
    attach_tp(model, full, specs, mesh, rules)
    left = [t for t in _tensors_all(model) if t.device.type == "meta"]
    if left:
        raise ValueError(f"shard_model: {len(left)} parameters were not in "
                         "the tree")
    return model


def attach_tp(model: Model, full: dict, specs: dict, mesh, rules) -> None:
    """Give ``model``'s modules their tensor-parallel plans on ``mesh``:
    ``full`` is the unrolled tree of the whole leaves (anything with
    their shapes: host arrays, meta tensors), ``specs`` its specs over
    ``model`` only (``_model_axis_only``, the whole leaves' kept)."""
    from repro_torch.parallel import sharding as shd
    cfg = model.cfg
    model.mesh = mesh
    emb, emb_sp = full["embed"], specs["embed"]
    model.embed.mesh = mesh
    model.embed.vocab_slice = shd.dim_slice(
        _arr(emb["tok"]).shape[0], (list(emb_sp["tok"]) + [None])[0], mesh)
    if model.embed.unembed is not None:
        _linear_tp(model.embed.unembed, emb["unembed"], emb_sp["unembed"],
                   mesh)
    plan, kv_shape = _attn_tp(cfg, mesh, rules)
    model.kv_shape = kv_shape
    linears = (("q_a", "q_b", "kv_a", "o") if cfg.attention == "mla"
               else ("q", "k", "v", "o"))
    for block, tree, sp in zip(model.stack.layers, full["stack"]["layers"],
                               specs["stack"]["layers"]):
        block.mixer.tp = plan
        for name in linears:
            _linear_tp(getattr(block.mixer, name), tree["mixer"][name],
                       sp["mixer"][name], mesh)
        if isinstance(block.mlp, MoE):
            block.mlp.tp = _moe_tp(tree["mlp"], sp["mlp"], mesh)
            names = ("shared_gate", "shared_up", "shared_down")
        elif block.mlp is not None:
            block.mlp.mesh = mesh
            names = ("gate", "up", "down")
        else:
            names = ()
        for name in names:
            if name in tree["mlp"]:
                _linear_tp(getattr(block.mlp, name), tree["mlp"][name],
                           sp["mlp"][name], mesh)


__all__ = ["Encoder", "Model", "attach_tp", "check_meshable",
           "encoder_config", "from_jax_params", "layer_trees",
           "layout_path", "load_params_", "set_block_tables", "shard_model",
           "stack_layout", "to_params", "unrolled"]
