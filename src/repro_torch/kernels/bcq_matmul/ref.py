"""Plain versions of bcq_matmul.

  * ``bcq_matmul_ref``  — dense dequantized matmul, f32 accumulate (the
    plain version every route of the kernel is held against);
  * ``plane_group_sums`` and ``bcq_planes_ref`` — the arithmetic of the
    tensor-core tile (``csrc/bcq_mma.cu``, the ``mma`` route of
    bcq_matmul, lut_gemm and ternary_matmul): per bit plane and alpha
    group the sum of x times the +-1 plane in f32 (a ternary bundle: one
    plane, the sum of its two derived +-1 planes), scaled by alpha
    (ternary: alpha / 2), then z times the group's sum of x.  f32
    activations go through ``split_bf16x3`` first, as both tiles split
    them: each plane's group sum is the sum of the three parts' sums,
    taken before alpha.  Memory grows as B x M x n_groups: a test-size
    function;
  * ``mma_split_ref`` — the tensor-core tile's walk: the same group
    terms, the alpha groups cut into ranges as ``ops.mma_splits`` counts
    them, each range's sum a partial, the partials added in split order;
  * ``gemv_split_ref`` — the decode tile's split walk (the ``gemv`` route
    of ``csrc/bcq_decode.cu``): the same group terms, the padded
    reduction axis cut into ranges of whole 256-column steps, each
    range's sum a partial, the partials added in split order;
  * ``dq_split_ref`` — the dequantizing tile's walk (the ``mma_dq`` route
    of ``csrc/bcq_dq.cu``): W dequantized in f32 in the reference's order,
    split into two bf16 parts, the products in the tile's order, the
    stages (``dq_step``) cut into ranges, partials added in split order;
  * ``split_bf16x3`` — an f32 tensor's three bf16 parts (h, m, l), each
    rounded from the residual of the ones before it.
"""
from __future__ import annotations

import torch

from repro_torch.core.plane import (PlaneBundle, dequantize, pad_operands,
                                    unpack_planes)
from repro_torch.kernels.lut_common import ternary_plane_bytes

GEMV_STEP = 256   # reduction columns per stage of the decode tile
# reduction columns per stage of the dequantizing tile (csrc/bcq_dq.cuh),
# above 8 rows and at 8 rows or fewer
DQ_STEP, DQ_DECODE_STEP = 64, 512


def dq_step(rows: int) -> int:
    """The dequantizing tile's stage width for a call of ``rows`` rows."""
    return DQ_DECODE_STEP if rows <= 8 else DQ_STEP


def bcq_matmul_ref(x: torch.Tensor, w: PlaneBundle,
                   out_dtype=None) -> torch.Tensor:
    dense = dequantize(w, dtype=torch.float32)
    y = torch.matmul(x.float(), dense.T)
    return y.to(out_dtype or x.dtype)


def _operand(w: PlaneBundle):
    """The tiles' weight operand: the +-1 planes [q, M, N_pad] and their
    scales [q, M, G]; a ternary bundle as one plane, (+-1 b1) + (+-1 b2)
    over the derived planes b1 = sign | ~mask, b2 = sign & mask, scaled by
    alpha / 2."""
    if w.kind == "ternary":
        b1, b2 = ternary_plane_bytes(w.packed[0], w.packed[1])
        pm1 = unpack_planes(torch.stack([b1, b2]), torch.float32)
        return (pm1[0] + pm1[1])[None], w.alpha.float() * 0.5
    return unpack_planes(w.packed, torch.float32), w.alpha.float()


def plane_group_sums(x: torch.Tensor, w: PlaneBundle) -> torch.Tensor:
    """s[b, i, m, g] = sum_{k in group g} x[b, k] * (2 bit_i[m, k] - 1),
    in f32, for x [B, in_features] (zero-padded to the planes' width); a
    ternary bundle has the one plane of ``_operand``."""
    x2 = pad_operands(x.reshape(-1, x.shape[-1]).float(), w)
    b = x2.shape[0]
    g, gs = w.n_groups, w.group_size
    pm1, _ = _operand(w)                                   # [q, M, N_pad]
    q, m, _ = pm1.shape
    xg = x2.reshape(b, g, gs)
    return torch.einsum("bgk,imgk->bimg", xg, pm1.reshape(q, m, g, gs))


def _group_terms(x: torch.Tensor, w: PlaneBundle) -> torch.Tensor:
    """t[b, m, g] = sum_i alpha[i, m, g] s[b, i, m, g] + z[m, g] xsum[b,
    g]: each alpha group's share of y, in f32.  f32 x is taken as its
    three bf16 parts: s and xsum are the parts' sums added in part
    order."""
    parts = split_bf16x3(x) if x.dtype == torch.float32 else (x,)
    s = sum(plane_group_sums(p, w) for p in parts)         # [B, q, M, G]
    _, scale = _operand(w)
    t = torch.einsum("bimg,img->bmg", s, scale)
    if w.z is not None:
        xsum = sum(pad_operands(p.reshape(-1, p.shape[-1]).float(), w)
                   .reshape(-1, w.n_groups, w.group_size).sum(-1)
                   for p in parts)
        t = t + xsum[:, None, :] * w.z.float()[None]
    return t


def _walk(x: torch.Tensor, w: PlaneBundle, per: int, splits: int,
          out_dtype) -> torch.Tensor:
    """y from the group terms: ``splits`` ranges of ``per`` alpha groups,
    each range's sum a partial, the partials added in split order."""
    t = _group_terms(x, w)                                 # [B, M, G]
    y = torch.zeros(t.shape[:2], dtype=torch.float32, device=t.device)
    for sp in range(splits):
        y = y + t[..., sp * per:(sp + 1) * per].sum(-1)
    return y.reshape(*x.shape[:-1], w.out_features).to(out_dtype or x.dtype)


def mma_split_ref(x: torch.Tensor, w: PlaneBundle, splits: int = 1,
                  out_dtype=None) -> torch.Tensor:
    """y by the tensor-core tile's walk (BCQ or ternary bundles, bf16 or
    f32 x): each alpha group's terms in the tile's order, the groups cut
    into ``splits`` ranges of ceil(n_groups / splits) (``ops.mma_splits``
    counts them; the tile adds the partials in split order)."""
    per = -(-w.n_groups // max(splits, 1))
    if splits < 1 or -(-w.n_groups // per) != splits:
        raise ValueError(f"{splits} splits of {w.n_groups} groups leave one "
                         "empty by construction")
    return _walk(x, w, per, splits, out_dtype)


def bcq_planes_ref(x: torch.Tensor, w: PlaneBundle,
                   out_dtype=None) -> torch.Tensor:
    """y = sum_g (sum_i alpha[i, m, g] s[b, i, m, g] + z[m, g] xsum[b,
    g]): the tiles' order (planes, then the offset term, per group), the
    tensor-core tile's walk without a split."""
    return mma_split_ref(x, w, 1, out_dtype)


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
    partials added in split order."""
    gs = w.group_size
    if GEMV_STEP % gs:
        raise ValueError(f"group size {gs} does not divide the "
                         f"{GEMV_STEP}-column step")
    gps = GEMV_STEP // gs
    steps = -(-w.n_groups // gps)
    per = -(-steps // splits)
    if -(-steps // per) != splits:
        raise ValueError(f"{splits} splits of {steps} steps leave one empty "
                         "by construction")
    return _walk(x, w, per * gps, splits, out_dtype)


def dq_split_ref(x: torch.Tensor, w: PlaneBundle, splits: int = 1,
                 out_dtype=None) -> torch.Tensor:
    """y by the dequantizing tile's walk (BCQ or ternary bundles, bf16 or
    f32 x): W dequantized in f32 in the reference's order (``dequantize``:
    the planes in order, then z; ternary alpha * sign * mask), split into
    hi = bf16(W) and lo = bf16(W - hi); bf16 x runs x . hi^T then
    x . lo^T, f32 x its two leading bf16 parts h, m (``split_bf16x3``) as
    h . hi^T, h . lo^T, m . hi^T (the products below 2^-16 of h . hi
    dropped), into one f32 sum per range; the padded reduction axis in
    stages of ``dq_step(rows)`` columns cut into ``splits`` ranges of
    ceil(stages / splits) (``ops.dq_splits`` counts them), the partials
    added in split order."""
    n = w.in_features
    x2 = x.reshape(-1, n)
    step = dq_step(x2.shape[0])
    stages = -(-w.packed.shape[-1] * 8 // step)
    per = -(-stages // max(splits, 1))
    if splits < 1 or -(-stages // per) != splits:
        raise ValueError(f"{splits} splits of {stages} stages leave one "
                         "empty by construction")
    dense = dequantize(w, torch.float32)                   # [M, N]
    hi = dense.to(torch.bfloat16).float()
    lo = (dense - hi).to(torch.bfloat16).float()
    if x.dtype == torch.float32:
        h, m, _ = split_bf16x3(x2)
        prods = ((h, hi), (h, lo), (m, hi))
    else:
        prods = ((x2.float(), hi), (x2.float(), lo))
    y = torch.zeros((x2.shape[0], w.out_features), dtype=torch.float32,
                    device=x.device)
    for sp in range(splits):
        c0, c1 = sp * per * step, (sp + 1) * per * step
        y = y + sum(xp[:, c0:c1] @ wp[:, c0:c1].T for xp, wp in prods)
    return y.reshape(*x.shape[:-1], w.out_features).to(out_dtype or x.dtype)
