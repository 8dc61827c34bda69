"""Logical-axis sharding: rules -> per-dim specs with divisibility fallback.

Counterpart of ``repro.parallel.sharding``.  Every parameter and cache
leaf carries logical axis names (``models/module.py``); the rules map
them onto mesh axes, with the reference's two guards:

  * **divisibility fallback**: a dim whose size the mesh axis extent does
    not divide keeps no mapping, and a later dim may claim that axis
    (kv-head sharding when it divides, head_dim sharding otherwise);
  * **axis conflict**: dims are taken left to right and a later dim skips
    an axis an earlier one claimed.

A spec is a tuple with one entry per dim, ``None``, a mesh axis name or a
tuple of names: the reference's ``PartitionSpec`` with its trailing
``None``\\ s dropped.  Rules values may be an axis, a tuple of axes
(FSDP over ``("pod", "data")``) or ``None``.

Quantized leaves (:class:`~repro_torch.core.plane.PlaneBundle`, or a
bundle as a dict of arrays, as ``from_jax_params`` takes them) get the
specs of their ``packed`` / ``alpha`` / ``z`` fields from the logical
axes of the dense ``[*, out, in]`` weight, as the reference's
``_bcq_shardings``: every field inherits the row axis, and the packed
input dim the input axis where its byte count still divides.  One rule
is the port's own: the reference leaves ``alpha`` and ``z`` replicated
along their group axis, which GSPMD can afford; an explicit
row-parallel linear holds only its own groups' scales, so here their
group axis is sliced with the packed input dim.  Where a shard boundary
would fall inside a group (the group count does not divide), the packed
input dim falls back to replication instead.

:func:`local_shard` and :func:`shard_tree` cut a host tensor (or tree)
to this rank's slice, which GSPMD did implicitly.  The reference's
``shard_map_compat``, ``set_activation_rules`` and ``shard_act`` have
no counterpart: under explicit tensor parallelism the layers' own
collectives (``models/layers.py``) decide where activations are sharded.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# logical axis -> mesh axis (or tuple of mesh axes, or None)
DEFAULT_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": "model",       # claimed only if heads axes fell through
    "mlp": "model",
    "experts": "model",        # EP when divisible, else falls to mlp-TP
    "embed": None,
    "lora": None,
    "batch": "data",
    "layers": None,
    "state": None,
    "kv_seq": "model",          # sequence-sharded KV when heads can't shard
}


def make_rules(*, fsdp: bool = False, multi_pod: bool = False,
               act_shard: bool = False, extra: Optional[dict] = None) -> dict:
    rules = dict(DEFAULT_RULES)
    data_axes = ("pod", "data") if multi_pod else ("data",)
    rules["batch"] = data_axes
    if fsdp:
        rules["embed"] = data_axes      # 2-D weight sharding: TP x FSDP
    if act_shard:
        rules["act_embed"] = "model"
    if extra:
        rules.update(extra)
    return rules


def axis_sizes(mesh) -> dict:
    """{axis name: extent} of a mesh (anything with ``axis_names`` and
    ``shape``)."""
    return dict(zip(mesh.axis_names, mesh.shape))


def spec_for(shape, axes, mesh, rules: dict) -> tuple:
    """The spec of one array given its logical axes."""
    sizes = axis_sizes(mesh)
    used = set()
    parts = []
    axes = axes or (None,) * len(shape)
    for dim, ax in zip(shape, axes):
        target = rules.get(ax) if ax is not None else None
        if target is None:
            parts.append(None)
            continue
        tup = (target,) if isinstance(target, str) else tuple(target)
        tup = tuple(a for a in tup if a in sizes and a not in used)
        total = int(np.prod([sizes[a] for a in tup])) if tup else 1
        if not tup or dim % total != 0:
            parts.append(None)          # divisibility fallback: replicate
            continue
        used.update(tup)
        parts.append(tup if len(tup) > 1 else tup[0])
    while parts and parts[-1] is None:
        parts.pop()                      # trailing Nones are implicit
    return tuple(parts)


def _extent(entry, sizes: dict) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return int(np.prod([sizes[a] for a in names]))


def _pad(spec: tuple, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def _trim(parts: list) -> tuple:
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class BundleSpecs:
    """The specs of a quantized leaf's fields (``z`` None where the
    bundle has no offset row)."""
    packed: tuple
    alpha: tuple
    z: Optional[tuple]


def _field(leaf, name):
    return leaf.get(name) if isinstance(leaf, dict) else getattr(leaf, name)


def is_bundle(leaf) -> bool:
    from repro_torch.core.plane import PlaneBundle
    return isinstance(leaf, PlaneBundle) or (
        isinstance(leaf, dict) and "packed" in leaf)


def bundle_specs(leaf, axes, mesh, rules: dict) -> BundleSpecs:
    """Specs of a bundle's fields (``_bcq_shardings``): the dense
    weight's logical axes are ``(*lead, row, in)``, the packed planes
    insert a bits dim after the lead (stacked layers or experts).  The
    group axis of ``alpha`` / ``z`` follows the packed input dim (see
    the module docstring)."""
    packed, alpha, z = (_field(leaf, k) for k in ("packed", "alpha", "z"))
    axes = tuple(axes) if axes else ()
    nb = len(packed.shape) - 3
    lead = axes[:nb] if len(axes) >= nb + 2 else (None,) * nb
    row_ax = axes[-2] if len(axes) >= 2 else None
    in_ax = axes[-1] if len(axes) >= 1 else None
    p = spec_for(packed.shape, (*lead, None, row_ax, in_ax), mesh, rules)
    a = spec_for(alpha.shape, (*lead, None, row_ax, None), mesh, rules)
    zs = (spec_for(z.shape, (*lead, row_ax, None), mesh, rules)
          if z is not None else None)
    pp = _pad(p, len(packed.shape))
    in_entry = pp[-1]
    if in_entry is not None:
        sizes = axis_sizes(mesh)
        if alpha.shape[-1] % _extent(in_entry, sizes):
            # a shard boundary inside a group: keep the input replicated
            pp[-1] = None
        else:
            aa = _pad(a, len(alpha.shape))
            aa[-1] = in_entry
            a = _trim(aa)
            if zs is not None:
                zz = _pad(zs, len(z.shape))
                zz[-1] = in_entry
                zs = _trim(zz)
    return BundleSpecs(packed=_trim(pp), alpha=a, z=zs)


def _walk(tree, path=()):
    """(path, leaf) of a dict/list tree; bundles and tuples (specs,
    axes) are leaves."""
    if is_bundle(tree) or not isinstance(tree, (dict, list)):
        yield path, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        yield from _walk(v, path + (k,))


def _get(tree, path, default=None):
    node = tree
    try:
        for p in path:
            node = node[p]
        return node
    except (KeyError, IndexError, TypeError):
        return default


def _map(tree, fn, path=()):
    """``fn(path, leaf)`` over a dict/list tree, as :func:`_walk`."""
    if is_bundle(tree) or not isinstance(tree, (dict, list)):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]


def build_specs(tree, axes_tree, mesh, rules: dict):
    """A tree of specs matching ``tree`` (``build_shardings``): a tuple
    per array leaf (anything with ``shape``), :class:`BundleSpecs` per
    quantized leaf, ``None`` where the leaf is ``None`` or has no shape.
    ``axes_tree`` holds the logical axes at the same paths (a bundle's
    path holds the dense weight's)."""
    def leaf(path, x):
        if x is None:
            return None
        axes = _get(axes_tree, path)
        if is_bundle(x):
            return bundle_specs(x, axes, mesh, rules)
        if hasattr(x, "shape"):
            return spec_for(tuple(x.shape), axes, mesh, rules)
        return None
    return _map(tree, leaf)


def batch_specs(mesh, shapes: dict, rules: dict) -> dict:
    """Specs of an input batch: leading dim ``batch``, the rest
    replicated (``batch_shardings``); ``shapes`` maps names to anything
    with ``shape``."""
    out = {}
    for k, v in shapes.items():
        shape = tuple(v.shape)
        axes = ("batch",) + (None,) * (len(shape) - 1)
        out[k] = spec_for(shape, axes, mesh, rules)
    return out


def local_nbytes(tree, specs, mesh) -> int:
    """Bytes of one rank's slices of every leaf of ``tree`` under
    ``specs`` (``build_specs``' tree; bundles as dicts or PlaneBundles):
    each dim divided by the extent of its spec entry, shapes only, so
    meta tensors serve.  Every rank holds as many (the specs split dims
    that divide)."""
    sizes = axis_sizes(mesh)

    def one(t, spec) -> int:
        n = 1
        for size, entry in zip(t.shape, _pad(tuple(spec or ()),
                                             len(t.shape))):
            n *= size // _extent(entry, sizes)
        return n * t.element_size()

    total = 0
    for path, x in _walk(tree):
        spec = _get(specs, path)
        if x is None or not (is_bundle(x) or hasattr(x, "shape")):
            continue
        if is_bundle(x):
            for k in ("packed", "alpha", "z"):
                t = _field(x, k)
                if t is not None:
                    total += one(t, getattr(spec, k))
        else:
            total += one(x, spec)
    return total


def dim_slice(size: int, entry, mesh) -> Optional[tuple]:
    """(start, stop) of this rank's slice of a dim of ``size`` under
    spec entry ``entry`` (None: the whole dim, returned as None).  A
    tuple of axes splits major to minor, as a ``PartitionSpec`` does."""
    if entry is None:
        return None
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    sizes = axis_sizes(mesh)
    n, idx = 1, 0
    for a in names:
        idx = idx * sizes[a] + mesh.index(a)
        n *= sizes[a]
    step = size // n
    return idx * step, (idx + 1) * step


def local_shard(t, spec, mesh):
    """This rank's slice of a host tensor or array ``t`` under ``spec``
    (contiguous: a copy where the slice is not a whole block)."""
    index = []
    for size, entry in zip(t.shape, _pad(tuple(spec), len(t.shape))):
        sl = dim_slice(size, entry, mesh)
        index.append(slice(None) if sl is None else slice(*sl))
    out = t[tuple(index)]
    if hasattr(out, "contiguous"):
        return out.contiguous()
    return np.ascontiguousarray(out)


def _local_bundle(leaf, specs: BundleSpecs, mesh):
    """A bundle leaf cut to this rank: its fields sliced, ``out_features``
    and ``in_features`` to the slice's (an input slice past the real
    width keeps only its real columns)."""
    packed, alpha, z = (_field(leaf, k) for k in ("packed", "alpha", "z"))
    out = {"packed": local_shard(packed, specs.packed, mesh),
           "alpha": local_shard(alpha, specs.alpha, mesh),
           "z": None if z is None else local_shard(z, specs.z, mesh)}
    pp = _pad(specs.packed, len(packed.shape))
    rows = dim_slice(packed.shape[-2], pp[-2], mesh)
    cols = dim_slice(packed.shape[-1] * 8, pp[-1], mesh)
    in_features = int(_field(leaf, "in_features"))
    out_features = int(_field(leaf, "out_features"))
    if rows is not None:
        out_features = rows[1] - rows[0]
    if cols is not None:
        in_features = max(0, min(in_features, cols[1]) - cols[0])
    meta = dict(group_size=int(_field(leaf, "group_size")),
                in_features=in_features, out_features=out_features,
                kind=_field(leaf, "kind") or "bcq")
    if isinstance(leaf, dict):
        return {**out, **meta}
    from repro_torch.core.plane import PlaneBundle
    return PlaneBundle(**out, **meta)


def shard_tree(tree, specs, mesh, device=None):
    """This rank's slice of every leaf of ``tree`` under ``specs``
    (``build_specs``' tree), moved to ``device`` where given (only the
    slice is copied there)."""
    def move(t):
        if device is None or t is None:
            return t
        import torch
        if not isinstance(t, torch.Tensor):
            t = np.asarray(t)
            if t.dtype.name == "bfloat16":
                t = torch.from_numpy(t.view(np.uint16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(t))
        return t.to(device)

    def leaf(path, x):
        spec = _get(specs, path)
        if x is None or spec is None:
            return x
        if is_bundle(x):
            b = _local_bundle(x, spec, mesh)
            if isinstance(b, dict):
                return {k: (move(v) if k in ("packed", "alpha", "z") else v)
                        for k, v in b.items()}
            return b if device is None else b.to(device)
        return move(local_shard(x, spec, mesh))
    return _map(tree, leaf)


__all__ = ["DEFAULT_RULES", "BundleSpecs", "axis_sizes", "batch_specs",
           "build_specs", "bundle_specs", "dim_slice", "is_bundle",
           "local_nbytes", "local_shard", "make_rules", "shard_tree",
           "spec_for"]
