"""Binary-coding quantization (BCQ) — counterpart of ``repro.core.bcq``.

    w  ≈  sum_{i=1}^{q} alpha_i * b_i  +  z ,     b_i in {-1, +1}

with alpha/z per (out row, input group).  ``quantize`` is the greedy
init plus alternating least squares / nearest-codebook refinement;
``from_uniform`` maps round-to-nearest uniform quantization exactly into
BCQ(+offset) planes.  Both run on whatever device the weight lies on, so
a full-width model quantizes on the card layer by layer.  Every output
row is fitted on its own, so ``quantize`` takes a weight of more than
``QUANTIZE_CHUNK`` elements in blocks of rows: its codebook search holds
2^q f32 distances per weight (a [152064 x 5120] head at q 3 would need
~50 GB at once).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.plane import (PlaneBundle, dequantize, pack_planes,
                                    unpack_planes)

__all__ = ["PlaneBundle", "quantize", "from_uniform", "dequantize",
           "pack_planes", "unpack_planes"]


QUANTIZE_CHUNK = 1 << 27      # weights fitted at once by ``quantize``


def _grouped(w: torch.Tensor, g: int) -> torch.Tensor:
    """[out, n] -> [out, G, g], edge-replicating the ragged last group."""
    out, n = w.shape
    n_pad = -(-n // g) * g
    if n_pad != n:
        w = F.pad(w[None], (0, n_pad - n), mode="replicate")[0]
    return w.reshape(out, n_pad // g, g)


def from_uniform(w_dense: torch.Tensor, bits: int,
                 group_size: int = 128) -> PlaneBundle:
    """Exact RTN-uniform -> BCQ(+offset): alpha_i = s 2^(i-1),
    z = s ((2^q - 1)/2 - z0)."""
    w = w_dense.float()
    out, n = w.shape
    g = int(group_size)
    wg = _grouped(w, g)
    levels = (1 << bits) - 1
    wmin = wg.amin(dim=-1)
    wmax = wg.amax(dim=-1)
    scale = torch.clamp((wmax - wmin) / levels, min=1e-12)
    z0 = -wmin / scale
    code = torch.clamp(torch.round((wg - wmin[..., None]) / scale[..., None]),
                       0, levels).to(torch.int32)
    planes = torch.stack([((code >> i) & 1).float() * 2 - 1
                          for i in range(bits)])
    planes = planes.reshape(bits, out, -1)
    pow2 = (2.0 ** torch.arange(bits, dtype=torch.float32,
                                device=w.device)) / 2.0
    alpha = scale[None] * pow2[:, None, None]
    z = scale * ((levels / 2.0) - z0)
    return PlaneBundle(packed=pack_planes(planes),
                       alpha=alpha.float().contiguous(),
                       z=z.float().contiguous(), group_size=g, in_features=n,
                       out_features=out)


def _greedy_init(wg: torch.Tensor, bits: int):
    r = wg
    planes, alphas = [], []
    for _ in range(bits):
        b = torch.where(r >= 0, 1.0, -1.0)
        a = r.abs().mean(dim=-1)
        planes.append(b)
        alphas.append(a)
        r = r - a[..., None] * b
    return torch.stack(planes), torch.stack(alphas)


def _ls_alpha(wg: torch.Tensor, planes: torch.Tensor, with_offset: bool):
    """Least-squares refit of (alpha_1..alpha_q[, z]) given the planes,
    through the ridge-regularized k x k normal equations."""
    q = planes.shape[0]
    cols = planes
    if with_offset:
        cols = torch.cat([planes, torch.ones_like(planes[:1])], dim=0)
    k = cols.shape[0]
    m = torch.einsum("iogn,jogn->ogij", cols, cols)
    v = torch.einsum("iogn,ogn->ogi", cols, wg)
    g = wg.shape[-1]
    m = m + (1e-3 * g) * torch.eye(k, dtype=m.dtype, device=m.device)
    c = torch.linalg.solve(m, v[..., None])[..., 0]
    alpha = torch.movedim(c[..., :q], -1, 0)
    z = c[..., q] if with_offset else torch.zeros_like(v[..., 0])
    return alpha, z


def _reassign_planes(wg, alpha, z, bits: int):
    """Nearest of the 2^q codewords per weight, as ±1 planes."""
    codes = torch.arange(1 << bits, device=wg.device)
    shifts = torch.arange(bits, device=wg.device)
    signs = ((codes[:, None] >> shifts[None, :]) & 1).float() * 2.0 - 1.0
    vals = torch.einsum("pi,iog->ogp", signs, alpha) + z[..., None]
    idx = torch.argmin((wg[..., None] - vals[..., None, :]).abs(), dim=-1)
    bit = (idx[None] >> shifts[:, None, None, None]) & 1
    return bit.float() * 2 - 1


def quantize(w_dense: torch.Tensor, bits: int, group_size: int = 128,
             iters: int = 5, with_offset: bool = True) -> PlaneBundle:
    """BCQ-quantize a dense [out, in] weight: greedy init, then ``iters``
    rounds of (alpha, z) least squares <-> nearest-codebook planes."""
    if w_dense.ndim != 2:
        raise ValueError(f"expected 2-D weight, got "
                         f"{tuple(w_dense.shape)}")
    out, n = w_dense.shape
    rows = max(1, QUANTIZE_CHUNK // n)
    if out > rows:
        parts = [quantize(w_dense[i:i + rows], bits, group_size, iters,
                          with_offset) for i in range(0, out, rows)]
        return PlaneBundle(
            packed=torch.cat([p.packed for p in parts], dim=1),
            alpha=torch.cat([p.alpha for p in parts], dim=1),
            z=torch.cat([p.z for p in parts], dim=0),
            group_size=parts[0].group_size, in_features=n,
            out_features=out)
    w = w_dense.float()
    g = int(group_size)
    bits = int(bits)
    wg = _grouped(w, g)
    planes, alpha = _greedy_init(wg, bits)
    z = torch.zeros(wg.shape[:2], dtype=w.dtype, device=w.device)
    for _ in range(iters):
        alpha, z_new = _ls_alpha(wg, planes, with_offset)
        z = z_new if with_offset else z
        sign = torch.where(alpha < 0, -1.0, 1.0)
        alpha = alpha * sign
        planes = _reassign_planes(wg, alpha, z, bits)
    alpha, z_new = _ls_alpha(wg, planes, with_offset)
    z = z_new if with_offset else z
    sign = torch.where(alpha < 0, -1.0, 1.0)
    alpha, planes = alpha * sign, planes * sign[..., None]
    return PlaneBundle(packed=pack_planes(planes.reshape(bits, out, -1)),
                       alpha=alpha.float().contiguous(),
                       z=z.float().contiguous(), group_size=g,
                       in_features=n, out_features=out)
