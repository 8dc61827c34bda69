"""Plain versions of bcq_matmul.

  * ``bcq_matmul_ref``  — dense dequantized matmul, f32 accumulate (the
    plain version every route of the kernel is held against);
  * ``plane_group_sums`` and ``bcq_planes_ref`` — the arithmetic of the
    tensor-core tile (``csrc/bcq_mma.cu``, the ``mma`` route of both
    bcq_matmul and lut_gemm): per bit plane and alpha group the sum of
    x times the +-1 plane in f32, scaled by alpha, then z times the
    group's sum of x.  Memory grows as B x M x n_groups: a test-size
    function;
  * ``gemv_split_ref`` — the decode tile's split walk (the ``gemv`` route
    of ``csrc/bcq_decode.cu``): the same per-group terms, the padded
    reduction axis cut into ranges of whole 256-column steps, each
    range's sum a partial, the partials added in split order.  f32
    activations go through ``split_bf16x3`` first, as the tile splits
    them: the group terms are the sums of each part's terms;
  * ``split_bf16x3`` — an f32 tensor's three bf16 parts (h, m, l), each
    rounded from the residual of the ones before it.
"""
from __future__ import annotations

import torch

from repro_torch.core.plane import (PlaneBundle, dequantize, pad_operands,
                                    unpack_planes)

GEMV_STEP = 256   # reduction columns per stage of the decode tile


def bcq_matmul_ref(x: torch.Tensor, w: PlaneBundle,
                   out_dtype=None) -> torch.Tensor:
    dense = dequantize(w, dtype=torch.float32)
    y = torch.matmul(x.float(), dense.T)
    return y.to(out_dtype or x.dtype)


def plane_group_sums(x: torch.Tensor, w: PlaneBundle) -> torch.Tensor:
    """s[b, i, m, g] = sum_{k in group g} x[b, k] * (2 bit_i[m, k] - 1),
    in f32, for x [B, in_features] (zero-padded to the planes' width)."""
    x2 = pad_operands(x.reshape(-1, x.shape[-1]).float(), w)
    b = x2.shape[0]
    g, gs = w.n_groups, w.group_size
    pm1 = unpack_planes(w.packed, torch.float32)          # [q, M, N_pad]
    q, m, _ = pm1.shape
    xg = x2.reshape(b, g, gs)
    return torch.einsum("bgk,imgk->bimg", xg, pm1.reshape(q, m, g, gs))


def _group_terms(x: torch.Tensor, w: PlaneBundle) -> torch.Tensor:
    """t[b, m, g] = sum_i alpha[i, m, g] s[b, i, m, g] + z[m, g] xsum[b,
    g]: each alpha group's share of y, in f32."""
    s = plane_group_sums(x, w)                            # [B, q, M, G]
    t = torch.einsum("bimg,img->bmg", s, w.alpha.float())
    if w.z is not None:
        x2 = pad_operands(x.reshape(-1, x.shape[-1]).float(), w)
        xsum = x2.reshape(x2.shape[0], w.n_groups, w.group_size).sum(-1)
        t = t + xsum[:, None, :] * w.z.float()[None]
    return t


def bcq_planes_ref(x: torch.Tensor, w: PlaneBundle,
                   out_dtype=None) -> torch.Tensor:
    """y = sum_g (sum_i alpha[i, m, g] s[b, i, m, g] + z[m, g] xsum[b,
    g]): the tiles' order (planes, then the offset term, per group)."""
    y = _group_terms(x, w).sum(-1)
    return y.reshape(*x.shape[:-1], w.out_features).to(out_dtype or x.dtype)


def split_bf16x3(x: torch.Tensor):
    """(h, m, l) as f32 tensors: h = bf16(x), m = bf16(x - h), l = bf16(x -
    h - m).  Each residual is exact in f32, and for normal values h + m + l
    equals x (x's 24 significant bits, 8 in each part)."""
    r = x.float()
    parts = []
    for _ in range(3):
        p = r.to(torch.bfloat16).float()
        parts.append(p)
        r = r - p
    return tuple(parts)


def gemv_split_ref(x: torch.Tensor, w: PlaneBundle, splits: int,
                   out_dtype=None) -> torch.Tensor:
    """y by the decode tile's walk: the planes' width in 256-column steps
    (whole alpha groups each, group size 32-256), ``splits`` ranges of
    whole steps, each range's group terms summed into a partial, the
    partials added in split order.  f32 activations are split into
    their three bf16 parts and each group's terms summed over the
    parts."""
    gs = w.group_size
    if GEMV_STEP % gs:
        raise ValueError(f"group size {gs} does not divide the "
                         f"{GEMV_STEP}-column step")
    lead = x.shape[:-1]
    if x.dtype == torch.float32:
        h, m, l = split_bf16x3(x)
        t = _group_terms(h, w) + _group_terms(m, w) + _group_terms(l, w)
    else:
        t = _group_terms(x, w)                            # [B, M, G]
    gps = GEMV_STEP // gs
    steps = -(-w.n_groups // gps)
    per = -(-steps // splits)
    if -(-steps // per) != splits:
        raise ValueError(f"{splits} splits of {steps} steps leave one empty "
                         "by construction")
    y = torch.zeros(t.shape[:2], dtype=torch.float32)
    for sp in range(splits):
        y = y + t[..., sp * per * gps:(sp + 1) * per * gps].sum(-1)
    return y.reshape(*lead, w.out_features).to(out_dtype or x.dtype)
