"""Plain versions of the LUT GEMM (counterpart of ``repro.kernels.lut_gemm.ref``).

  * ``dense_ref`` — dequantize to dense f32 and matmul (ground truth);
  * ``lut_ref``   — builds the LUTs and does the keyed read-accumulate per
                    plane, the algorithm the CUDA kernel runs.  It walks
                    the batch in row blocks so its [rows, M, N/mu] read
                    stays bounded at full model width.
"""
from __future__ import annotations

import torch

from repro_torch.core.plane import PlaneBundle, dequantize, pad_operands
from repro_torch.kernels import lut_common


def dense_ref(x: torch.Tensor, w: PlaneBundle, out_dtype=None) -> torch.Tensor:
    dense = dequantize(w, dtype=torch.float32)
    y = torch.matmul(x.float(), dense.T)
    return y.to(out_dtype or x.dtype)


def lut_ref(x: torch.Tensor, w: PlaneBundle, mu: int = 4,
            half_lut: bool = True, out_dtype=None,
            max_elems: int = 1 << 26) -> torch.Tensor:
    if w.group_size % mu:
        raise ValueError(f"group_size {w.group_size} must be divisible "
                         f"by mu={mu}")
    lead = x.shape[:-1]
    x2 = pad_operands(x.reshape(-1, x.shape[-1]).float(), w)
    b, n_pad = x2.shape
    m = w.out_features
    keys = lut_common.extract_keys(w.packed, mu)            # [q, M, N/mu]
    n_ag = w.n_groups
    per_ag = w.group_size // mu
    rows = max(1, max_elems // max(1, m * (n_pad // mu)))
    out = []
    for r0 in range(0, b, rows):
        xb = x2[r0:r0 + rows]
        table = lut_common.build_lut(xb, mu, half_lut)      # [rb, U, P]
        y = torch.zeros((xb.shape[0], m), dtype=torch.float32,
                        device=x.device)
        for i in range(w.bits):
            vals = lut_common.read_lut(table, keys[i], mu, half_lut)
            vals_ag = vals.reshape(*vals.shape[:-1], n_ag, per_ag).sum(-1)
            y = y + torch.einsum("bma,ma->bm", vals_ag, w.alpha[i])
        if w.z is not None:
            xsum = xb.reshape(xb.shape[0], n_ag, w.group_size).sum(-1)
            y = y + torch.einsum("ba,ma->bm", xsum, w.z)
        out.append(y)
    y = torch.cat(out) if out else torch.zeros((0, m), device=x.device)
    return y.reshape(*lead, m).to(out_dtype or x.dtype)
