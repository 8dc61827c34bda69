"""The public quantization entry point: ``quantize_model(model, spec)``.

Counterpart of ``repro.quant.api`` + the leaf walk of ``repro.quant.ptq``:
every :class:`~repro_torch.models.layers.Linear` whose name is in
``QUANT_KEYS`` (and not in ``_SKIP_KEYS``) — the MLA projections
``q_a``/``q_b``/``kv_a``/``kv_b`` and an untied ``unembed`` included,
as in the reference — has its dense weight replaced,
in place and one layer at a time, by a :class:`PlaneBundle`.  Embeddings
and norms stay FP.  Paths are the reference's ``/``-joined tree paths
(``stack/layers/0/mixer/q``), so manifests of the two packages compare
entry for entry.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterator, Mapping, Tuple

import torch

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
    """What actually got quantized, layer by layer."""

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


def _is_quant_leaf(name: str, weight) -> bool:
    if name in _SKIP_KEYS or name not in QUANT_KEYS:
        return False
    return isinstance(weight, torch.Tensor) and weight.ndim == 2


def walk_linears(model) -> Iterator[Tuple[str, object]]:
    """(path, Linear) for every linear module, in module order."""
    from repro_torch.models.layers import Linear
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            yield name.replace(".", "/"), mod


def collect_linears(model) -> dict:
    """{path: dense weight} for every quantizable linear."""
    return {p: m.weight for p, m in walk_linears(model)
            if _is_quant_leaf(p.rsplit("/", 1)[-1], m.weight)}


@torch.no_grad()
def quantize_model(model, spec: QuantSpec) -> QuantManifest:
    """Quantize every eligible linear of ``model`` per ``spec``, in place,
    on the device the weights lie on.  Returns the manifest."""
    fmt = formats_mod.get_format(spec.format)
    if spec.bits < 1:
        raise ValueError(
            f"spec.bits={spec.bits}: need >= 1 bit to quantize "
            "(an unquantized model shouldn't call quantize_model)")
    bits = fmt.plane_bits(spec.bits)
    layers, n_weights, dense_bytes, quant_bytes, plane_acc = [], 0, 0, 0, 0.0
    entries = []
    for path, mod in list(walk_linears(model)):
        if not _is_quant_leaf(path.rsplit("/", 1)[-1], mod.weight):
            continue
        w = mod.weight
        shape = list(w.shape)
        wq = fmt.quantize(w.float(), bits=bits, group_size=spec.group_size,
                          iters=spec.iters)
        mod.weight = wq                   # drops the dense weight
        entries.append((path, shape, wq))
    for path, shape, wq in sorted(entries, key=lambda e: e[0]):
        n = shape[0] * shape[1]
        qb = int(wq.nbytes())
        planes = int(wq.bits)
        layers.append({
            "path": path,
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
           "collect_linears", "quantize_model", "walk_linears"]
