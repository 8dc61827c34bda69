"""Quantized checkpoints on top of ``train.checkpoint``.

Counterpart of ``repro.quant.checkpoint``: :func:`save_quantized`
persists an already quantized parameter tree (bundles as the dicts
``to_params`` and ``from_jax_params`` use), or a port ``Model``
through :func:`~repro_torch.models.model.to_params`, with its
:class:`QuantSpec` and manifest in the checkpoint's ``extra``, so a
mixed-precision plan is computed once and then served.  Bundles use the
reference's encoding: ``{"__bcq_weight__": {packed, alpha, [z],
group_size, in_features, out_features, kind}}`` with the static fields
as 0-d int64 arrays and ``kind`` an index into ``plane.KINDS``.  A
checkpoint written by either package loads in the other;
:func:`load_quantized_model` builds a port model from one through
``from_jax_params``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.core.plane import KINDS
from repro_torch.quant.api import QuantManifest
from repro_torch.quant.spec import QuantSpec
from repro_torch.train import checkpoint as ckpt

_BCQ_TAG = "__bcq_weight__"


def _encode(tree):
    if isinstance(tree, dict) and "packed" in tree:
        bundle = {"packed": tree["packed"], "alpha": tree["alpha"],
                  "group_size": np.int64(tree["group_size"]),
                  "in_features": np.int64(tree["in_features"]),
                  "out_features": np.int64(tree["out_features"]),
                  "kind": np.int64(KINDS.index(tree.get("kind", "bcq")))}
        if tree.get("z") is not None:
            bundle["z"] = tree["z"]
        return {_BCQ_TAG: bundle}
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_encode(v) for v in tree]
    return tree


def _decode(tree):
    """Bundles back to the dicts ``from_jax_params`` takes."""
    if isinstance(tree, dict):
        if _BCQ_TAG in tree:
            d = tree[_BCQ_TAG]
            return {"packed": d["packed"], "alpha": d["alpha"],
                    "z": d.get("z"),
                    "group_size": int(d["group_size"]),
                    "in_features": int(d["in_features"]),
                    "out_features": int(d["out_features"]),
                    # checkpoints from before ``kind`` existed are bcq
                    "kind": KINDS[int(d.get("kind", 0))]}
        return {k: _decode(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decode(v) for v in tree]
    return tree


def save_quantized(ckpt_dir: str, params, spec: QuantSpec,
                   manifest: Optional[QuantManifest] = None,
                   step: int = 0, arch: str = "",
                   extra_meta: Optional[dict] = None) -> str:
    """Atomically persist a quantized tree (or ``Model``) with its spec
    and manifest; ``extra_meta`` (JSON) rides along in ``extra`` (the
    launcher records model dimensions there)."""
    from repro_torch.models.model import Model, to_params
    if isinstance(params, Model):
        params = to_params(params)
    extra = {"quant_spec": spec.to_dict(), "arch": arch,
             **(extra_meta or {})}
    if manifest is not None:
        extra["manifest"] = manifest.to_dict()
    return ckpt.save(ckpt_dir, step, _encode(params), extra=extra)


def load_quantized(ckpt_dir: str, step: Optional[int] = None,
                   ) -> Tuple[Any, QuantSpec, Optional[QuantManifest], dict]:
    """``(params, spec, manifest, extra)`` of a quantized checkpoint;
    params as CPU tensors with bundles as dicts."""
    tree, _, extra = ckpt.restore(ckpt_dir, step)
    if "quant_spec" not in extra:
        raise ValueError(f"{ckpt_dir} is not a quantized checkpoint "
                         "(no quant_spec in manifest extra)")
    spec = QuantSpec.from_dict(extra["quant_spec"])
    manifest = (QuantManifest.from_dict(extra["manifest"])
                if extra.get("manifest") else None)
    return _decode(tree), spec, manifest, extra


def load_quantized_model(ckpt_dir: str, cfg, *, device=None,
                         step: Optional[int] = None):
    """``(model, spec, manifest, extra)``: the checkpoint's parameters in
    a port ``Model`` of ``cfg`` with ``quant=spec``, on ``device``."""
    from repro_torch.models.model import from_jax_params
    params, spec, manifest, extra = load_quantized(ckpt_dir, step)
    model = from_jax_params(params, cfg.replace(quant=spec), device=device)
    return model, spec, manifest, extra


__all__ = ["load_quantized", "load_quantized_model", "save_quantized"]
