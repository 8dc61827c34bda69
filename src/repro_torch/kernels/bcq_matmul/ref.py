"""Plain versions of bcq_matmul.

  * ``bcq_matmul_ref``  — dense dequantized matmul, f32 accumulate (the
    plain version every route of the kernel is held against);
  * ``plane_group_sums`` and ``bcq_planes_ref`` — the arithmetic of the
    tensor-core tile (``csrc/bcq_mma.cu``, the ``mma`` route of both
    bcq_matmul and lut_gemm): per bit plane and alpha group the sum of
    x times the +-1 plane in f32, scaled by alpha, then z times the
    group's sum of x.  Memory grows as B x M x n_groups: a test-size
    function.
"""
from __future__ import annotations

import torch

from repro_torch.core.plane import (PlaneBundle, dequantize, pad_operands,
                                    unpack_planes)


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


def bcq_planes_ref(x: torch.Tensor, w: PlaneBundle,
                   out_dtype=None) -> torch.Tensor:
    """y = sum_i sum_g alpha[i, m, g] s[b, i, m, g] + sum_g z[m, g]
    xsum[b, g]: the tile's order (planes, then the offset term)."""
    lead = x.shape[:-1]
    s = plane_group_sums(x, w)                            # [B, q, M, G]
    y = torch.einsum("bimg,img->bm", s, w.alpha.float())
    if w.z is not None:
        x2 = pad_operands(x.reshape(-1, x.shape[-1]).float(), w)
        xsum = x2.reshape(x2.shape[0], w.n_groups, w.group_size).sum(-1)
        y = y + xsum @ w.z.float().T
    return y.reshape(*lead, w.out_features).to(out_dtype or x.dtype)
