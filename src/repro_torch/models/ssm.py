"""Mamba2 SSD (state-space duality) mixer: chunked prefill + O(1) decode
state.

Counterpart of ``repro.models.ssm`` (``ssm_desc``, ``ssm_cache_desc``,
``ssd_chunked``, ``ssm_apply``), step for step and cast for cast:
per-head scalar decay A = -exp(A_log), input-dependent dt (softplus),
B and C shared over heads (one group).  ``in_proj`` emits [z (gate),
xBC (conv path), dt]; x, B and C pass a depthwise causal conv and SiLU;
the SSD scan runs chunk by chunk with an f32 carried state; the output
is D-skipped, gated-normed by z and projected by ``out_proj``.

Decode is the SSM recurrence on a [B, H, P, N] f32 state plus a window
of the last ``ssm_conv - 1`` conv inputs: constant memory in sequence
length, nothing to page.  ``in_proj`` and ``out_proj`` are the port's
``Linear``s (quantizable, through ``linear_apply`` and so the BCQ
tiles); ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` and
``out_norm`` stay FP.  The reference has no Pallas kernel here: all of
it is plain PyTorch.

One departure, where the reference is not finite: its intra-chunk decay
is ``exp(diff) * tri``, and ``diff = cums_q - cums_k`` is positive above
the diagonal, so at chunk 128 and dt near 1 ``exp`` overflows there and
``inf * 0`` is NaN.  Here the causal mask is applied before the
exponent, ``exp(where(tri, diff, -inf))``: the same values wherever the
reference's are finite.

A prompt left-padded into a bucket (the slots engine) runs its pads
through the conv and the scan like any token: an SSM layer has no
position mask, so the pads' embeddings enter its state, as in the
reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, _normal_


def ssm_dims(cfg):
    """(d_inner, heads)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim


def init_ssm_cache(cfg, batch: int, device) -> dict:
    """One Mamba layer's decode state (``ssm_cache_desc``): ``conv``
    [B, conv - 1, conv_dim] in ``cfg.dtype`` and ``state`` [B, H, P, N]
    f32, both zero."""
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * n),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "state": torch.zeros((batch, h, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device)}


def _split_proj(cfg, proj):
    """(z, xBC, dt) of ``in_proj``'s output."""
    d_inner, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    return (proj[..., :d_inner], proj[..., d_inner: 2 * d_inner + 2 * n],
            proj[..., 2 * d_inner + 2 * n:])


def _gated_norm(x, z, scale, eps=1e-6):
    """RMSNorm of x * silu(z), in f32 (returned in f32)."""
    xf = x.float() * F.silu(z.float())
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * scale


def ssd_chunked(xh, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD scan.

    xh [b, l, h, p]; dt [b, l, h] (after softplus); A [h] (negative); B, C
    [b, l, n] (one group, shared over heads); h0 an optional initial
    state [b, h, p, n].  The sequence is right-padded to a chunk multiple
    (the pads' dt is 0, so they leave the state alone).  Returns (y [b,
    l, h, p] f32, final state [b, h, p, n] f32)."""
    b, l, h, p = xh.shape
    n = B.shape[-1]
    nc = -(-l // chunk)
    pad = nc * chunk - l
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    xc = xh.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xh.device).tril()[None, :, :, None]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if h0 is None else h0.float())
    ys = []
    for c in range(nc):
        xi, dti, Bi, Ci = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dti * A[None, None, :]                           # [b, lc, h]
        cums = torch.cumsum(dA, dim=1)
        total = cums[:, -1, :]                                # [b, h]
        # intra-chunk: decay(q, k) = exp(cums_q - cums_k) for q >= k,
        # masked before the exponent (above the diagonal diff > 0)
        diff = cums[:, :, None, :] - cums[:, None, :, :]      # [b, q, k, h]
        decay = torch.exp(torch.where(tri, diff, float("-inf")))
        cb = torch.einsum("bqn,bkn->bqk", Ci, Bi)
        gates = cb[..., None] * decay * dti[:, None, :, :]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", gates, xi)
        # inter-chunk: the carried state, decayed to each position
        y_inter = torch.einsum("bqn,bhpn->bqhp", Ci, state) \
            * torch.exp(cums)[..., None]
        # the state at the chunk's end
        w = dti * torch.exp(total[:, None, :] - cums)         # [b, lc, h]
        s_chunk = torch.einsum("bkhp,bkn->bhpn", xi * w[..., None], Bi)
        state = torch.exp(total)[:, :, None, None] * state + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, p)
    return y[:, :l], state


class SSM(nn.Module):
    """``ssm_desc``: ``in_proj`` [2 d_inner + 2 N + H, d] and ``out_proj``
    [d, d_inner] (bf16, quantizable), ``conv_w`` [conv, conv_dim] bf16,
    and in f32 ``conv_b`` [conv_dim], ``A_log``, ``D``, ``dt_bias`` [H]
    and ``out_norm`` [d_inner]."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_inner, h = ssm_dims(cfg)
        n = cfg.ssm_state
        conv_dim = d_inner + 2 * n
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = Linear(2 * d_inner + 2 * n + h, d, bias=False,
                              dtype=dtype, device=device)
        self.conv_w = torch.empty((cfg.ssm_conv, conv_dim), dtype=dtype,
                                  device=device)
        self.conv_b = torch.zeros(conv_dim, **f32)
        self.A_log = torch.zeros(h, **f32)
        self.D = torch.ones(h, **f32)
        self.dt_bias = torch.zeros(h, **f32)
        self.out_norm = torch.ones(d_inner, **f32)
        self.out_proj = Linear(d, d_inner, bias=False, dtype=dtype,
                               device=device)

    def init_params(self, generator: torch.Generator) -> None:
        """The reference's init: N(0, 0.02) ``conv_w``, zero ``conv_b``,
        ``A_log`` and ``dt_bias``, unit ``D`` and ``out_norm`` (the
        projections are initialized as ``Linear``s)."""
        _normal_(self.conv_w, generator)
        self.conv_b.zero_()
        self.A_log.zero_()
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.out_norm.fill_(1.0)

    def forward(self, x, positions=None, *, cache: Optional[dict] = None,
                backend=None, **_):
        """x [B, S, d].  Without a cache: the output [B, S, d].  With one:
        (output, new cache), a decode step where S == 1, else a prefill
        that continues from the cache's conv window and state.
        ``positions`` is unused: an SSM layer has no position mask."""
        cfg = self.cfg
        b, s, _ = x.shape
        d_inner, h = ssm_dims(cfg)
        n, p, kw = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv
        proj = self.in_proj(x, backend)
        z, xbc, dt = _split_proj(cfg, proj)
        A = -torch.exp(self.A_log)

        if cache is not None and s == 1:
            # decode: the conv window and the recurrence, O(1) per token
            hist = cache["conv"]                          # [B, kw-1, C]
            window = torch.cat([hist.float(), xbc.float()], dim=1)
            conv_out = (window * self.conv_w.float()[None]).sum(1) \
                + self.conv_b
            xbc_t = F.silu(conv_out)                      # [B, C]
            xt = xbc_t[:, :d_inner].reshape(b, h, p)
            Bt = xbc_t[:, d_inner:d_inner + n]
            Ct = xbc_t[:, d_inner + n:]
            dtt = F.softplus(dt[:, 0] + self.dt_bias)     # [B, h]
            dA = torch.exp(dtt * A[None])
            state = dA[:, :, None, None] * cache["state"] + torch.einsum(
                "bh,bn,bhp->bhpn", dtt, Bt, xt)
            y = torch.einsum("bn,bhpn->bhp", Ct, state) \
                + self.D[None, :, None] * xt
            y = _gated_norm(y.reshape(b, 1, d_inner), z, self.out_norm)
            out = self.out_proj(y.to(x.dtype), backend)
            return out, {"conv": window[:, 1:].to(hist.dtype),
                         "state": state}

        # prefill: depthwise causal conv over the sequence, then SSD
        pad_left = (torch.zeros((b, kw - 1, xbc.shape[-1]),
                                dtype=torch.float32, device=x.device)
                    if cache is None else cache["conv"].float())
        xpad = torch.cat([pad_left, xbc.float()], dim=1)
        conv_out = 0
        for i in range(kw):
            conv_out = conv_out + xpad[:, i: i + s] \
                * self.conv_w[i].float()[None, None]
        xbc_c = F.silu(conv_out + self.conv_b)
        xh = xbc_c[..., :d_inner].reshape(b, s, h, p)
        Bm = xbc_c[..., d_inner:d_inner + n]
        Cm = xbc_c[..., d_inner + n:]
        dtm = F.softplus(dt + self.dt_bias[None, None])
        y, h_last = ssd_chunked(xh, dtm, A, Bm, Cm, cfg.ssm_chunk,
                                h0=None if cache is None
                                else cache["state"])
        y = y + self.D[None, None, :, None] * xh
        y = _gated_norm(y.reshape(b, s, d_inner), z, self.out_norm)
        out = self.out_proj(y.to(x.dtype), backend)
        if cache is None:
            return out
        new_conv = (xpad[:, -(kw - 1):].to(cache["conv"].dtype) if kw > 1
                    else cache["conv"])
        return out, {"conv": new_conv, "state": h_last}


__all__ = ["SSM", "init_ssm_cache", "ssd_chunked", "ssm_dims"]
