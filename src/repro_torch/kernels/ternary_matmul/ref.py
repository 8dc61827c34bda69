"""Plain versions of the ternary GEMM (counterpart of
``repro.kernels.ternary_matmul.ref``).

  * ``dense_ref``   — dequantize (alpha * sign * mask) to dense f32 and
                      matmul: ground truth;
  * ``ternary_ref`` — the reference kernel's algorithm, the CPU path's
                      counterpart of its ``ternary_ref``: one half LUT
                      per mu-group, the (sign, mask) bytes decoded into
                      b1 = s | ~m and b2 = s & m, both planes read from
                      the same table, y = sum_groups (alpha/2)(V1 + V2).
                      It walks the batch in row blocks so its
                      [rows, M, N/mu] reads stay bounded at full width;
  * ``ternary_planes_ref`` — the arithmetic of the tensor-core route
                      (``mma``, ``csrc/bcq_mma.cu`` with its ternary
                      flag): the table read re-associated into x against
                      the derived +-1 planes, which the tile adds into
                      one operand, summed per alpha group in f32 (f32 x
                      over its three bf16 parts), then scaled by alpha /
                      2.  Memory grows as B x M x n_groups: a test-size
                      function;
  * ``ternary_masked_ref`` — the arithmetic of the decode tile (``gemv``,
                      ``csrc/bcq_decode.cu`` with its ternary flag): the
                      derived planes' pair re-written as one {-1, 0, +1}
                      operand, mask * (+-1 sign), summed per alpha group
                      in f32, then scaled by alpha itself.  A test-size
                      function, as above.

The dequantizing route (``mma_dq``) has its plain walk in
``bcq_matmul.ref.dq_split_ref``.  On exact inputs (integer activations,
power-of-two alphas) every partial sum is an exact f32, so all of them
agree with the kernel bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.plane import (PlaneBundle, dequantize, pad_operands,
                                    unpack_planes)
from repro_torch.kernels import lut_common
from repro_torch.kernels.bcq_matmul.ref import bcq_planes_ref


def dense_ref(x: torch.Tensor, w: PlaneBundle, out_dtype=None) -> torch.Tensor:
    dense = dequantize(w, dtype=torch.float32)
    y = torch.matmul(x.float(), dense.T)
    return y.to(out_dtype or x.dtype)


def ternary_ref(x: torch.Tensor, w: PlaneBundle, mu: int = 4,
                out_dtype=None, max_elems: int = 1 << 26) -> torch.Tensor:
    if w.kind != "ternary":
        raise ValueError(f"ternary_ref needs a ternary bundle, got "
                         f"{w.kind!r}")
    if w.group_size % mu:
        raise ValueError(f"group_size {w.group_size} must be divisible "
                         f"by mu={mu}")
    lead = x.shape[:-1]
    x2 = pad_operands(x.reshape(-1, x.shape[-1]).float(), w)
    b, n_pad = x2.shape
    m = w.out_features
    b1, b2 = lut_common.ternary_plane_bytes(w.packed[0], w.packed[1])
    k1 = lut_common.extract_keys(b1, mu)                    # [M, N/mu]
    k2 = lut_common.extract_keys(b2, mu)
    n_ag = w.n_groups
    per_ag = w.group_size // mu
    half_alpha = w.alpha[0].float() * 0.5                   # [M, G]
    rows = max(1, max_elems // max(1, m * (n_pad // mu)))
    out = []
    for r0 in range(0, b, rows):
        xb = x2[r0:r0 + rows]
        table = lut_common.build_lut(xb, mu, True)          # [rb, U, P/2]
        vals = (lut_common.read_lut(table, k1, mu, True)
                + lut_common.read_lut(table, k2, mu, True))  # [rb, M, U]
        vals_ag = vals.reshape(*vals.shape[:-1], n_ag, per_ag).sum(-1)
        out.append(torch.einsum("bma,ma->bm", vals_ag, half_alpha))
    y = torch.cat(out) if out else torch.zeros((0, m), device=x.device)
    return y.reshape(*lead, m).to(out_dtype or x.dtype)


def ternary_planes_ref(x: torch.Tensor, w: PlaneBundle,
                       out_dtype=None) -> torch.Tensor:
    """y[b, m] = sum_g (alpha[m, g] / 2) s[b, m, g], with s the group sum
    of x times ((+-1 b1) + (+-1 b2)), b1 = sign | ~mask, b2 = sign & mask:
    the reference's V1 + V2 per group, as the ``mma`` route sums it (f32
    x through its three bf16 parts, as the route splits it; bcq_matmul's
    ``bcq_planes_ref`` on a ternary bundle)."""
    if w.kind != "ternary":
        raise ValueError(f"ternary_planes_ref needs a ternary bundle, got "
                         f"{w.kind!r}")
    return bcq_planes_ref(x, w, out_dtype)


def ternary_masked_ref(x: torch.Tensor, w: PlaneBundle,
                       out_dtype=None) -> torch.Tensor:
    """y[b, m] = sum_g alpha[m, g] s[b, m, g], with s the group sum of x
    times mask * (+-1 sign): per weight (+-1 b1) + (+-1 b2) is 0 where
    the mask is clear and 2 (+-1 sign) where it is set, so the
    reference's (alpha / 2)(V1 + V2) is alpha times this one product."""
    if w.kind != "ternary":
        raise ValueError(f"ternary_masked_ref needs a ternary bundle, got "
                         f"{w.kind!r}")
    lead = x.shape[:-1]
    x2 = pad_operands(x.reshape(-1, x.shape[-1]).float(), w)
    b = x2.shape[0]
    g, gs, m = w.n_groups, w.group_size, w.out_features
    pm1 = unpack_planes(w.packed, torch.float32)        # sign, mask: +-1
    op = (pm1[0] * (pm1[1] + 1) * 0.5).reshape(m, g, gs)  # {-1, 0, +1}
    s = torch.einsum("bgk,mgk->bmg", x2.reshape(b, g, gs), op)
    y = torch.einsum("bmg,mg->bm", s, w.alpha[0].float())
    return y.reshape(*lead, m).to(out_dtype or x.dtype)
