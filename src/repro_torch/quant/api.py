"""The public quantization entry point: ``quantize_model(model, spec)``.

Counterpart of ``repro.quant.api`` and of the leaf walk and bit-map
application of ``repro.quant.ptq`` (both live here):

  1. :func:`collect_linears` names every quantizable linear by its leaf
     in the reference's parameter tree, in the reference's (sorted
     pytree) order.  Under ``scan_layers`` one leaf stacks a projection
     over layers (``stack/scan/0/mixer/q``, [L, out, in]) and is a
     :class:`~repro_torch.core.mixed_precision.LayerStack` of the
     per-layer weights; unrolled, each layer is its own leaf
     (``stack/layers/3/mixer/q``); an encoder-decoder's encoder stack
     is keyed the same way under ``encoder/``, its decoder's
     cross-attention under ``cross/``.  Leaves are the ``Linear``\\ s
     named in ``QUANT_KEYS`` (the MLA projections and an untied
     ``unembed`` included) and a MoE layer's expert banks ([E, out,
     in], one more leading axis stacked); embeddings, positions, norms
     and the router stay FP.
  2. :func:`plan_bits` gives each leaf a width: the spec's integer
     width, a format's fixed planes, or for a fractional ``bits`` a
     sensitivity-driven mixed-precision plan (paper Fig. 17), with
     ``spec.overrides`` applied last.
  3. :func:`quantize_model` replaces each layer's dense weight, in place
     and one layer at a time on the device it lies on, by a
     :class:`PlaneBundle` at its leaf's width (below 2 bits: ternary).
     An expert bank is quantized one expert at a time, E leading
     (packed [E, q, out, in/8]), as the reference's ``_lead_batch``
     keeps its experts axis.  It returns a :class:`QuantManifest` with
     one entry per reference leaf (stacked shape, summed bytes), so the
     manifests of the two packages compare entry for entry in either
     stack layout.

:func:`abstract_quantized_params` is the shape-only counterpart of step
3 (the reference's ``abstract_quantized_params``, the dry run's): every
leaf's weight becomes a bundle of meta tensors laid out as a BCQ
``quantize_model`` lays it out, and nothing is quantized.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Iterator, Mapping, Optional, Tuple

import torch

from repro_torch.core import mixed_precision as mp
from repro_torch.core.plane import PlaneBundle
from repro_torch.quant import formats as formats_mod
from repro_torch.quant.spec import QuantSpec

QUANT_KEYS = {
    "q", "k", "v", "o", "q_a", "q_b", "kv_a", "kv_b",
    "gate", "up", "down", "shared_gate", "shared_up", "shared_down",
    "in_proj", "out_proj", "unembed",
}

# leaves that match QUANT_KEYS but must stay FP
_SKIP_KEYS = {"router", "conv_w", "conv_b", "tok", "pos"}


@dataclasses.dataclass
class QuantManifest:
    """What actually got quantized, leaf by leaf."""

    spec: dict
    layers: list
    n_layers: int = 0
    n_weights: int = 0
    dense_bytes: int = 0
    quant_bytes: int = 0
    avg_plane_bits: float = 0.0
    avg_effective_bits: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def from_dict(cls, d: Mapping) -> "QuantManifest":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def summary(self) -> str:
        comp = (self.dense_bytes / self.quant_bytes
                if self.quant_bytes else float("inf"))
        return (f"{self.n_layers} layers / {self.n_weights:,} weights "
                f"quantized: avg {self.avg_plane_bits:.2f} plane-bits "
                f"({self.avg_effective_bits:.2f} stored bits/weight incl. "
                f"scales), {self.quant_bytes/2**20:.1f} MiB vs "
                f"{self.dense_bytes/2**20:.1f} MiB bf16 ({comp:.1f}x)")


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------


def _is_quant_leaf(name: str, weight, bank: bool = False) -> bool:
    """A dense weight named in ``QUANT_KEYS``: [out, in], or [E, out, in]
    for an expert bank."""
    if name in _SKIP_KEYS or name not in QUANT_KEYS:
        return False
    return isinstance(weight, torch.Tensor) and \
        weight.ndim == (3 if bank else 2)


def walk_linears(model) -> Iterator[Tuple[str, object]]:
    """(module path, module) for every ``Linear`` and expert bank, in
    module order."""
    from repro_torch.models.layers import Linear
    from repro_torch.models.moe import ExpertBank
    for name, mod in model.named_modules():
        if isinstance(mod, (Linear, ExpertBank)):
            yield name.replace(".", "/"), mod


def linear_leaves(model) -> dict:
    """{reference leaf key: (Linears in stack order, stacked)} for every
    quantizable linear, in the reference's pytree order (sorted keys,
    list indices by number)."""
    from repro_torch.models.moe import ExpertBank
    from repro_torch.models.transformer import stack_path
    # (module path prefix, config) of each layer stack: the decoder's and
    # an encoder-decoder's encoder (``encoder/stack/...``)
    stacks = [((), model.cfg)]
    if getattr(model, "encoder", None) is not None:
        stacks.append((("encoder",), model.encoder.cfg))
    groups = {}
    for path, lin in walk_linears(model):
        if not _is_quant_leaf(path.rsplit("/", 1)[-1], lin.weight,
                              isinstance(lin, ExpertBank)):
            continue
        parts = path.split("/")
        stacked, r = False, 0
        for pre, cfg in stacks:
            n = len(pre)
            if tuple(parts[:n]) == pre and \
                    parts[n:n + 2] == ["stack", "layers"]:
                head, r = stack_path(cfg, int(parts[n + 2]))
                stacked = r is not None
                parts = [*pre, *head, *parts[n + 3:]]
                break
        key = tuple(int(p) if str(p).isdigit() else p for p in parts)
        groups.setdefault(key, (stacked, []))[1].append((r or 0, lin))
    return {"/".join(map(str, k)): ([l for _, l in sorted(
        v[1], key=lambda e: e[0])], v[0]) for k, v in sorted(groups.items())}


def collect_linears(model) -> dict:
    """{reference leaf key: dense weight [out, in] (an expert bank [E,
    out, in]), or a LayerStack for a stacked leaf}, in the reference's
    leaf order."""
    return {k: (mp.LayerStack([l.weight for l in lins]) if stacked
                else lins[0].weight)
            for k, (lins, stacked) in linear_leaves(model).items()}


# ---------------------------------------------------------------------------
# bit planning
# ---------------------------------------------------------------------------


def plan_bits(linears: Mapping[str, object], spec: QuantSpec,
              x_cal: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """Per-leaf width for a spec: uniform, or mixed for fractional bits.

    Stacked leaves are probed on the reference's row subsample; sizes
    stay parameter-weighted over the whole leaf."""
    fmt = formats_mod.get_format(spec.format)
    unknown = [k for k in spec.overrides_map if k not in linears]
    if unknown:
        raise ValueError(
            f"spec.overrides name layers that are not quantizable linears: "
            f"{unknown}; known layers: {sorted(linears)}")
    if fmt.fixed_plane_bits is not None:
        if spec.overrides:
            raise ValueError(
                f"format {spec.format!r} stores a fixed "
                f"{fmt.fixed_plane_bits} planes per layer; per-layer bit "
                "overrides are not supported")
        return {k: fmt.fixed_plane_bits for k in linears}
    if spec.bits < 1:
        raise ValueError(
            f"spec.bits={spec.bits:g}: need >= 1 bit to quantize "
            "(an unquantized model shouldn't call quantize_model)")

    if spec.is_fractional:
        # probe each candidate with the format it will be applied in
        # (below 2 bits: ternary)
        def _probe_quantize(w2, *, bits, group_size, iters):
            f = formats_mod.format_for_bits(spec.format, bits)
            return f.quantize(w2, bits=f.plane_bits(max(bits, 1)),
                              group_size=group_size, iters=iters)
        sens = functools.partial(mp.layer_sensitivity, iters=2, max_rows=192,
                                 quantizer=_probe_quantize)
        plan = mp.allocate_bits(linears, target_avg_bits=spec.bits,
                                candidates=spec.candidate_bits,
                                group_size=spec.group_size, x_cal=x_cal,
                                sensitivity_fn=sens)
    else:
        plan = {k: spec.int_bits for k in linears}

    for key, b in spec.overrides_map.items():
        if key in plan:
            plan[key] = float(b) if float(b) < 2 else int(b)
    return plan


# ---------------------------------------------------------------------------
# quantize_model
# ---------------------------------------------------------------------------


@torch.no_grad()
def quantize_model(model, spec: QuantSpec, *,
                   x_cal: Optional[Mapping[str, torch.Tensor]] = None,
                   ) -> QuantManifest:
    """Quantize every eligible linear of ``model`` per ``spec``, in place,
    on the device the weights lie on.  ``x_cal`` optionally gives
    per-leaf calibration activations to the mixed-precision probe.
    Returns the manifest."""
    leaves = linear_leaves(model)
    plan = plan_bits(collect_linears(model), spec, x_cal=x_cal)
    for key, (lins, _) in leaves.items():
        b = plan[key]
        fmt = formats_mod.format_for_bits(spec.format, b)
        quant = functools.partial(fmt.quantize, bits=fmt.plane_bits(b),
                                  group_size=spec.group_size,
                                  iters=spec.iters)
        for lin in lins:
            w = lin.weight
            lin.weight = (quant(w.float()) if w.ndim == 2
                          else _stack_bundles([quant(we.float())
                                               for we in w]))
    return build_manifest(leaves, spec)


def _abstract_bundle(shape, *, bits: int, group_size: int,
                     device="meta") -> PlaneBundle:
    """The BCQ bundle of a dense weight of ``shape`` ([*lead, out, in]) as
    ``quantize_model`` lays it out, of empty tensors: packed uint8 [*lead,
    bits, out, in_pad / 8] (in_pad: the input width padded to a whole
    group), alpha f32 [*lead, bits, out, n_groups], z f32 [*lead, out,
    n_groups]."""
    *lead, rows, cols = (int(d) for d in shape)
    n_pad = -(-cols // group_size) * group_size
    n_groups = n_pad // group_size

    def empty(shp, dtype):
        return torch.empty((*lead, *shp), dtype=dtype, device=device)
    return PlaneBundle(packed=empty((bits, rows, n_pad // 8), torch.uint8),
                       alpha=empty((bits, rows, n_groups), torch.float32),
                       z=empty((rows, n_groups), torch.float32),
                       group_size=int(group_size), in_features=cols,
                       out_features=rows)


def abstract_quantized_params(model, *, bits: int = 4,
                              group_size: int = 128) -> QuantManifest:
    """Shape-only ``quantize_model`` (the dry run's): every quantizable
    linear's weight of ``model`` (a meta model, ``models.module
    .abstract_model``) replaced in place by an empty bundle in its layout, an
    expert bank's with its expert axis leading.  No weight is read or
    allocated.  Returns the manifest."""
    leaves = linear_leaves(model)
    for lins, _ in leaves.values():
        for lin in lins:
            lin.weight = _abstract_bundle(lin.weight.shape, bits=bits,
                                          group_size=group_size,
                                          device=lin.weight.device)
    return build_manifest(leaves, QuantSpec(format="bcq", bits=bits,
                                            group_size=group_size))


def _stack_bundles(bundles: list) -> PlaneBundle:
    """Per-expert bundles stacked on a leading axis (packed [E, q, out,
    in/8])."""
    first = bundles[0]
    return dataclasses.replace(
        first, packed=torch.stack([b.packed for b in bundles]),
        alpha=torch.stack([b.alpha for b in bundles]),
        z=None if first.z is None else torch.stack([b.z for b in bundles]))


def build_manifest(leaves: Mapping[str, tuple], spec: QuantSpec
                   ) -> QuantManifest:
    """The manifest of quantized leaves (``linear_leaves`` of a quantized
    model), sorted by key as the reference sorts it."""
    layers, n_weights, dense_bytes, quant_bytes, plane_acc = [], 0, 0, 0, 0.0
    for key in sorted(leaves):
        lins, stacked = leaves[key]
        wq = lins[0].weight
        if not isinstance(wq, PlaneBundle):
            continue
        shape = [*wq.packed.shape[:-3], wq.out_features, wq.in_features]
        if stacked:
            shape = [len(lins)] + shape
        n = 1
        for s in shape:
            n *= s
        planes = int(wq.bits)
        qb = sum(int(l.weight.nbytes()) for l in lins)
        layers.append({
            "path": key,
            "format": "ternary" if wq.kind == "ternary" else spec.format,
            "plane_bits": planes,
            "effective_bits": float(wq.effective_bits),
            "group_size": int(wq.group_size), "shape": shape,
            "dense_bytes": 2 * n, "quant_bytes": qb,
        })
        n_weights += n
        dense_bytes += 2 * n
        quant_bytes += qb
        plane_acc += planes * n
    return QuantManifest(
        spec=spec.to_dict(), layers=layers, n_layers=len(layers),
        n_weights=n_weights, dense_bytes=dense_bytes,
        quant_bytes=quant_bytes,
        avg_plane_bits=plane_acc / n_weights if n_weights else 0.0,
        avg_effective_bits=(quant_bytes * 8 / n_weights) if n_weights
        else 0.0)


__all__ = ["QUANT_KEYS", "QuantManifest", "QuantSpec", "PlaneBundle",
           "abstract_quantized_params", "build_manifest", "collect_linears", "linear_leaves",
           "plan_bits", "quantize_model", "walk_linears"]
