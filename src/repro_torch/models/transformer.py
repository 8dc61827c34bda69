"""Decoder blocks and the layer stack (counterpart of
``repro.models.transformer``): the stack is a Python loop over an
``nn.ModuleList`` — PyTorch runs eagerly, so there is no scan."""
from __future__ import annotations

from torch import nn

from repro_torch.models.attention import Attention, MLAttention
from repro_torch.models.layers import MLP, Norm


class Block(nn.Module):
    """norm -> attention (GQA or MLA) -> residual -> norm -> MLP ->
    residual."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        mixer = MLAttention if cfg.attention == "mla" else Attention
        self.mixer = mixer(cfg, dtype=dtype, device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)

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
        h = self.mlp(self.ln2(x), backend)
        x = x + h.to(x.dtype)
        return x, cache


class Stack(nn.Module):
    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_layers))

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
