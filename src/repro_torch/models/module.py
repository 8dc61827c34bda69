"""Logical axes of the port's parameters and paged caches.

Counterpart of ``repro.models.module`` (and of ``Model.axes`` /
``Model.paged_cache_axes`` in ``repro.models.model``).  The reference
declares every parameter as a descriptor with logical axes; the port
builds its parameters on modules, so here the axes are given directly,
per config, in the layout of ``to_params`` (``{"layers": [...]}``
unrolled, or ``{"prefix": [...], "scan": [...]}`` under
``scan_layers``, where each scanned leaf gains a leading ``"layers"``
axis).  :func:`logical_axes` equals ``repro.models.Model(cfg).axes()``
for every config.

Logical axis names: ``embed`` (d_model), ``vocab``, ``heads``,
``kv_heads``, ``head_dim``, ``mlp`` (ffn hidden), ``experts``,
``layers`` (a scanned stack), ``lora`` (MLA latents), ``state`` (SSM),
``batch`` and ``kv_seq`` (caches); ``parallel/sharding.py`` maps them
onto mesh axes.

The reference's ``ParamDesc`` trees and ``abstract_params`` have a
simpler counterpart here: a model built on ``torch.device("meta")``
(:func:`abstract_model`) holds every parameter's shape and dtype and no
storage, and :func:`abstract_params` is its reference-layout tree.
:func:`cache_axes` gives the contiguous cache's logical axes (the
reference's ``logical_axes(model.cache_desc(...))``).
:func:`param_count` and :func:`param_bytes` count a parameter tree
(``to_params``' output: tensors, bundles as dicts or
``PlaneBundle``\\ s), meta tensors included.
"""
from __future__ import annotations

import math


# ---------------------------------------------------------------------------
# parameter axes, per block as ``repro.models`` declares them
# ---------------------------------------------------------------------------


def _norm_axes(cfg) -> dict:
    if cfg.norm == "rmsnorm":
        return {"scale": ("embed",)}
    return {"scale": ("embed",), "bias": ("embed",)}


def _attn_axes(cfg) -> dict:
    if cfg.attention == "mla":
        p = {}
        if cfg.q_lora_rank:
            p["q_a"] = ("lora", "embed")
            p["q_a_norm"] = ("lora",)
            p["q_b"] = ("heads", "lora")
        else:
            p["q"] = ("heads", "embed")
        p["kv_a"] = ("lora", "embed")
        p["kv_a_norm"] = ("lora",)
        p["kv_b"] = ("heads", "lora")
        p["o"] = ("embed", "heads")
        return p
    p = {"q": ("heads", "embed"), "k": ("kv_heads", "embed"),
         "v": ("kv_heads", "embed"), "o": ("embed", "heads")}
    if cfg.qkv_bias:
        p.update(q_b=("heads",), k_b=("kv_heads",), v_b=("kv_heads",))
    return p


def _ssm_axes(cfg) -> dict:
    return {"in_proj": ("mlp", "embed"), "conv_w": (None, "mlp"),
            "conv_b": ("mlp",), "A_log": ("heads",), "D": ("heads",),
            "dt_bias": ("heads",), "out_norm": ("mlp",),
            "out_proj": ("embed", "mlp")}


def _mlp_axes(cfg) -> dict:
    if cfg.mlp_act == "swiglu":
        return {"gate": ("mlp", "embed"), "up": ("mlp", "embed"),
                "down": ("embed", "mlp")}
    return {"up": ("mlp", "embed"), "up_b": ("mlp",),
            "down": ("embed", "mlp"), "down_b": ("embed",)}


def _moe_axes(cfg) -> dict:
    p = {"router": ("experts", "embed"),
         "gate": ("experts", "mlp", "embed"),
         "up": ("experts", "mlp", "embed"),
         "down": ("experts", "embed", "mlp")}
    if cfg.n_shared_experts:
        p.update(shared_gate=("mlp", "embed"), shared_up=("mlp", "embed"),
                 shared_down=("embed", "mlp"))
    return p


def _block_axes(cfg, kind: str, mlp_kind: str, cross: bool) -> dict:
    p = {"ln1": _norm_axes(cfg),
         "mixer": _attn_axes(cfg) if kind == "attn" else _ssm_axes(cfg)}
    if cross:
        p["ln_cross"] = _norm_axes(cfg)
        p["cross"] = _attn_axes(cfg)
    if cfg.d_ff or mlp_kind == "moe":
        p["ln2"] = _norm_axes(cfg)
        p["mlp"] = _moe_axes(cfg) if mlp_kind == "moe" else _mlp_axes(cfg)
    return p


def _map_axes(fn, tree, path=()):
    """``fn(path, axes)`` over an axes tree (tuples are its leaves)."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _stacked(tree):
    """Prepend the scanned ``layers`` axis to every leaf."""
    return _map_axes(lambda _, ax: ("layers", *ax), tree)


def _stack_axes(cfg, per_layer) -> dict:
    """``per_layer(i)`` in the stack layout of ``cfg.scan_layers``."""
    from repro_torch.models.transformer import scan_grouping
    if not cfg.scan_layers:
        return {"layers": [per_layer(i) for i in range(cfg.n_layers)]}
    pre, period, reps = scan_grouping(cfg)
    out = {}
    if pre:
        out["prefix"] = [per_layer(i) for i in range(pre)]
    if reps:
        out["scan"] = [_stacked(per_layer(pre + j)) for j in range(period)]
    return out


def _decoder_stack_axes(cfg, cross: bool) -> dict:
    return _stack_axes(cfg, lambda i: _block_axes(
        cfg, cfg.layer_kind(i), cfg.mlp_kind(i), cross))


def logical_axes(cfg) -> dict:
    """The logical-axes tree of ``cfg``'s parameters (``Model.axes()``)."""
    emb = {"tok": ("vocab", "embed")}
    if cfg.pos == "learned":
        emb["pos"] = (None, "embed")
    if not cfg.tie_embeddings:
        emb["unembed"] = ("vocab", "embed")
    out = {"embed": emb, "stack": _decoder_stack_axes(cfg, cfg.is_encdec),
           "final_norm": _norm_axes(cfg)}
    if cfg.is_encdec:
        from repro_torch.models.model import encoder_config
        enc = {"stack": _decoder_stack_axes(encoder_config(cfg), False),
               "final_norm": _norm_axes(cfg)}
        if cfg.pos == "learned":
            enc["pos"] = (None, "embed")
        out["encoder"] = enc
    return out


# ---------------------------------------------------------------------------
# abstract (shape-only) models
# ---------------------------------------------------------------------------


def abstract_model(cfg, dtype=None):
    """``cfg``'s :class:`~repro_torch.models.model.Model` on the meta
    device: shapes and dtypes, zero allocation (the dry run's model)."""
    import torch
    from repro_torch.models.model import Model
    return Model(cfg, device="meta", dtype=dtype or torch.bfloat16)


def abstract_params(cfg, dtype=None) -> dict:
    """The reference-layout parameter tree of ``cfg`` as meta tensors, in
    the stack layout of ``cfg.scan_layers`` (``Model(cfg).abstract()``)."""
    from repro_torch.models.model import to_params
    return to_params(abstract_model(cfg, dtype))


def _layer_cache_axes(cfg, kind: str) -> dict:
    """One layer's contiguous-cache axes (``cache_desc_gqa`` /
    ``cache_desc_mla`` / ``ssm_cache_desc``), in the port's leaf names."""
    if kind == "mamba":
        c = {"conv": ("batch", None, "mlp"),
             "state": ("batch", "heads", None, None)}
    elif cfg.attention == "mla":
        c = {"ckv": ("batch", "kv_seq", "lora"),
             "krope": ("batch", "kv_seq", None), "pos": ("batch", "kv_seq")}
    else:
        kv = ("batch", None, "kv_heads", "head_dim")
        c = {"k": kv, "v": kv, "pos": ("batch", None)}
        if cfg.kv_cache_bits == 8:
            c["k_scale"] = c["v_scale"] = ("batch", None, "kv_heads")
    if cfg.is_encdec:
        c["cross_k"] = c["cross_v"] = ("batch", None, "kv_heads",
                                       "head_dim")
    return c


def cache_axes(cfg) -> dict:
    """Logical axes of ``Model.init_cache``'s contiguous cache
    (``{"layers": [...]}``, one dict per layer)."""
    from repro_torch.models.transformer import layer_plan
    return {"layers": [_layer_cache_axes(cfg, kind)
                       for kind, _ in layer_plan(cfg)]}


# ---------------------------------------------------------------------------
# paged cache axes
# ---------------------------------------------------------------------------


def _paged_layer_axes(cfg) -> dict:
    """One layer's pool axes: the contiguous cache's, with ``batch`` and
    ``kv_seq`` dropped (the pool's block dim never shards over data, and
    a block is the unit the kernels read whole), and the table
    replicated host state."""
    if cfg.attention == "mla":
        c = {"ckv": (None, None, "lora"), "krope": (None, None, None),
             "pos": (None, None)}
    else:
        kv = (None, None, "kv_heads", "head_dim")
        c = {"k": kv, "v": kv, "pos": (None, None)}
        if cfg.kv_cache_bits == 8:
            c["k_scale"] = c["v_scale"] = (None, None, "kv_heads")
    c["block_tables"] = (None, None)
    return {"self": c}


def paged_cache_axes(cfg, batch: int = 0, num_blocks: int = 0,
                     block_size: int = 0, max_blocks_per_seq: int = 0):
    """Logical axes for sharding a paged cache
    (``Model.paged_cache_axes``), in the reference's cache layout (each
    layer's leaves under ``self``).  The sizes do not change the axes;
    they are taken for the reference's signature.  Attention-only
    decoders only, as ``init_paged_cache``."""
    if cfg.is_encdec or any(cfg.layer_kind(i) != "attn"
                            for i in range(cfg.n_layers)):
        raise ValueError("paged cache supports attention-only decoders")
    if cfg.sliding_window:
        raise ValueError("paged KV cache requires sliding_window == 0 "
                         "(ring caches are already fixed-size)")
    tree = _stack_axes(cfg, lambda i: _paged_layer_axes(cfg))
    # the table is replicated whole, its stacked axis too
    return _map_axes(
        lambda path, ax: (None,) * len(ax) if path[-1] == "block_tables"
        else ax, tree)


def paged_layer_axes(cfg) -> dict:
    """One layer's pool axes as the port's cache holds them (no
    ``self`` level): what ``shard_model`` slices a pool by."""
    return _paged_layer_axes(cfg)["self"]


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------


def _leaves(tree):
    from repro_torch.parallel.sharding import _walk
    for _, leaf in _walk(tree):
        if leaf is not None:
            yield leaf


def _fields(leaf):
    get = leaf.get if isinstance(leaf, dict) else \
        lambda k: getattr(leaf, k, None)
    return get


def param_count(tree) -> int:
    """Parameters of a tree: a dense leaf's elements; a bundle's dense
    weight's (``out_features * in_features`` per leading entry)."""
    from repro_torch.parallel.sharding import is_bundle
    total = 0
    for leaf in _leaves(tree):
        if is_bundle(leaf):
            get = _fields(leaf)
            lead = math.prod(get("packed").shape[:-3])
            total += lead * int(get("out_features")) * int(get("in_features"))
        elif hasattr(leaf, "shape"):
            total += math.prod(leaf.shape)
    return total


def _itemsize(t) -> int:
    if hasattr(t, "element_size"):
        return t.element_size()
    return t.dtype.itemsize


def param_bytes(tree) -> int:
    """Stored bytes of a tree: every array leaf, a bundle's packed planes,
    scale rows and offset row."""
    from repro_torch.parallel.sharding import is_bundle
    total = 0
    for leaf in _leaves(tree):
        if is_bundle(leaf):
            get = _fields(leaf)
            for k in ("packed", "alpha", "z"):
                t = get(k)
                if t is not None:
                    total += math.prod(t.shape) * _itemsize(t)
        elif hasattr(leaf, "shape"):
            total += math.prod(leaf.shape) * _itemsize(leaf)
    return total


__all__ = ["abstract_model", "abstract_params", "cache_axes",
           "logical_axes", "paged_cache_axes", "paged_layer_axes",
           "param_bytes", "param_count"]
