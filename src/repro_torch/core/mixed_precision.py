"""Sensitivity-based mixed-precision bit allocation (paper Fig. 17).

Counterpart of ``repro.core.mixed_precision``, on tensors and on the
device the weights lie on:

  1. :func:`layer_sensitivity` measures one leaf's reconstruction error
     at one width (weight MSE, or output MSE ``||(W - W_q) x_cal||^2``
     given calibration activations), optionally on a deterministic row
     subsample;
  2. :func:`allocate_bits` starts every leaf at the lowest candidate and
     greedily upgrades the leaf with the best error reduction per extra
     stored bit until the parameter-weighted budget is spent.

A reference leaf stacked over layers ([L, out, in]) is a
:class:`LayerStack` here: the port keeps one weight per layer, and the
probe gathers exactly the rows the reference's flattened
``[::stride][:max_rows]`` takes (flattened row r is row ``r % out`` of
layer ``r // out``) without stacking the layers.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence

import torch

from repro_torch.core import bcq as bcq_mod
from repro_torch.core.plane import dequantize


class LayerStack:
    """A stacked leaf [L, out, in] held as its L per-layer [out, in]
    weights (or [L, E, out, in] as L expert banks), in stack order."""

    def __init__(self, layers: Sequence[torch.Tensor]):
        self.layers = list(layers)

    @property
    def shape(self) -> tuple:
        return (len(self.layers), *self.layers[0].shape)

    def rows(self, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rows ``idx`` (ascending) of the flattened [L * out, in] view in
        f32, all rows when ``idx`` is None."""
        flat = [w.reshape(-1, w.shape[-1]) for w in self.layers]
        if idx is None:
            return torch.cat([w.float() for w in flat])
        out = flat[0].shape[0]
        layer = idx // out
        parts = []
        for i in torch.unique_consecutive(layer).tolist():
            w = flat[i]
            sel = (idx[layer == i] % out).to(w.device)
            parts.append(w[sel].float())
        return torch.cat(parts)


def _as_2d(w, max_rows: int = 0) -> torch.Tensor:
    """Flatten a stacked leaf to [rows, in] in f32 and, with ``max_rows``,
    keep rows ``[::ceil(rows / max_rows)][:max_rows]``: the probe ranks
    leaves, so a few hundred rows a leaf suffice."""
    shape = tuple(w.shape)
    n_rows = math.prod(shape[:-1])
    idx = None
    if max_rows and n_rows > max_rows:
        stride = -(-n_rows // max_rows)
        idx = torch.arange(0, n_rows, stride)[:max_rows]
    if isinstance(w, LayerStack):
        return w.rows(idx)
    w2 = w.float().reshape(-1, shape[-1])
    return w2 if idx is None else w2[idx.to(w2.device)]


def layer_sensitivity(w, bits: float, group_size: int = 128,
                      x_cal: Optional[torch.Tensor] = None, iters: int = 3,
                      max_rows: int = 0,
                      quantizer: Optional[Callable] = None) -> float:
    """Quantization error of one leaf at one width.

    ``quantizer(w2d, bits=, group_size=, iters=) -> PlaneBundle`` lets the
    probe measure the format that will be applied; default BCQ."""
    qfn = quantizer or (lambda w2, **kw: bcq_mod.quantize(w2, **kw))
    w2 = _as_2d(w, max_rows)
    wq = qfn(w2, bits=bits, group_size=group_size, iters=iters)
    err = dequantize(wq) - w2
    if x_cal is not None:
        out = torch.einsum("...n,mn->...m",
                           x_cal.to(err.device, torch.float32), err)
        return float(torch.mean(out * out))
    return float(torch.mean(err * err))


def allocate_bits(weights: Mapping[str, object], target_avg_bits: float,
                  candidates: Sequence[float] = (2, 3, 4),
                  group_size: int = 128,
                  x_cal: Optional[Mapping[str, torch.Tensor]] = None,
                  sensitivity_fn: Callable = layer_sensitivity) -> dict:
    """Greedy marginal-gain allocation; returns {name: bits}.

    The budget is parameter-weighted.  Ties go to the first leaf in
    ``weights``' order (strict ``>``), so callers pass the reference's
    leaf order.  1.585 (log2 3) is the ternary candidate, charged at its
    information rate."""
    candidates = sorted(candidates)
    names = list(weights)
    sizes = {k: math.prod(weights[k].shape) for k in names}
    total = sum(sizes.values())

    err = {
        k: {b: sensitivity_fn(weights[k], b, group_size,
                              None if x_cal is None else x_cal.get(k))
            for b in candidates}
        for k in names
    }

    bits = {k: candidates[0] for k in names}
    budget = target_avg_bits * total

    def used() -> float:
        return sum(bits[k] * sizes[k] for k in names)

    while True:
        best, best_gain = None, 0.0
        for k in names:
            cur = bits[k]
            nxt = next((b for b in candidates if b > cur), None)
            if nxt is None:
                continue
            extra = (nxt - cur) * sizes[k]
            if used() + extra > budget + 1e-9:
                continue
            gain = (err[k][cur] - err[k][nxt]) / extra
            if gain > best_gain:
                best, best_gain = (k, nxt), gain
        if best is None:
            break
        bits[best[0]] = best[1]
    return bits


def quantize_mixed(weights: Mapping[str, torch.Tensor],
                   bit_map: Mapping[str, int], group_size: int = 128,
                   iters: int = 5) -> dict:
    """Apply a plan to 2-D weights with BCQ: {name: PlaneBundle}."""
    return {k: bcq_mod.quantize(w, bits=bit_map[k], group_size=group_size,
                                iters=iters)
            for k, w in weights.items()}


def average_bits(bit_map: Mapping[str, float],
                 weights: Mapping[str, object]) -> float:
    sizes = {k: math.prod(weights[k].shape) for k in weights}
    total = sum(sizes.values())
    return sum(bit_map[k] * sizes[k] for k in weights) / total


__all__ = ["LayerStack", "allocate_bits", "average_bits",
           "layer_sensitivity", "quantize_mixed"]
