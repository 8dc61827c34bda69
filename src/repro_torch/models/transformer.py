"""Decoder blocks and the layer stack (counterpart of
``repro.models.transformer``): the stack is a Python loop over an
``nn.ModuleList`` — PyTorch runs eagerly, so there is no scan.

The reference's parameter tree still stacks layers under
``scan_layers`` (``stack/prefix/i`` and ``stack/scan/j`` with a leading
layers axis); :func:`scan_grouping` and :func:`stack_path` name where a
layer's parameters sit in that tree, which quantization manifests,
mixed-precision plans and checkpoints key by.
"""
from __future__ import annotations

from torch import nn

from repro_torch.models.attention import Attention, MLAttention
from repro_torch.models.layers import MLP, Norm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM


class Block(nn.Module):
    """norm -> mixer (GQA or MLA attention, or the Mamba2 SSM, by
    ``cfg.layer_kind(layer)``) -> residual [-> norm -> MLP or MoE
    (``cfg.mlp_kind(layer)``) -> residual].  A layer has no ``ln2`` and
    no MLP where ``d_ff`` is 0 and it is not a MoE layer (Mamba2: the
    mixer is the layer), as ``block_desc``."""

    def __init__(self, cfg, layer: int, *, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        kind, mlp_kind = cfg.layer_kind(layer), cfg.mlp_kind(layer)
        mixer = (SSM if kind == "mamba" else
                 MLAttention if cfg.attention == "mla" else Attention)
        self.mixer = mixer(cfg, dtype=dtype, device=device)
        self.ln2 = self.mlp = None
        if cfg.d_ff or mlp_kind == "moe":
            self.ln2 = Norm(cfg.d_model, cfg.norm, device)
            mlp = MoE if mlp_kind == "moe" else MLP
            self.mlp = mlp(cfg, dtype=dtype, device=device)

    def forward(self, x, positions, *, cache=None, cache_at=None,
                backend=None, paged_kernel="auto"):
        h = self.ln1(x)
        if cache is not None:
            h, cache = self.mixer(h, positions, cache=cache,
                                  cache_at=cache_at, backend=backend,
                                  paged_kernel=paged_kernel)
        else:
            h = self.mixer(h, positions, backend=backend)
        x = x + h.to(x.dtype)
        if self.mlp is not None:
            h = self.mlp(self.ln2(x), backend)
            x = x + h.to(x.dtype)
        return x, cache


class Stack(nn.Module):
    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(cfg, i, dtype=dtype, device=device)
            for i in range(cfg.n_layers))

    def forward(self, x, positions, *, caches=None, cache_at=None,
                backend=None, paged_kernel="auto"):
        new = [] if caches is not None else None
        for i, block in enumerate(self.layers):
            c = caches["layers"][i] if caches is not None else None
            x, c = block(x, positions, cache=c, cache_at=cache_at,
                         backend=backend, paged_kernel=paged_kernel)
            if new is not None:
                new.append(c)
        return x, ({**caches, "layers": new} if new is not None else None)


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
