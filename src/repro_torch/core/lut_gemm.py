"""Backend dispatch for executing BCQ-quantized linears.

Counterpart of ``repro.core.lut_gemm``; the backend names are the
launcher's public vocabulary and stay the same:

  * ``dense``          — dequantize to f32 and matmul in f32;
  * ``bcq_xla``        — dequantize to bf16, round x to bf16, multiply with
                         f32 accumulation (the reference's XLA path; plain
                         PyTorch here);
  * ``bcq_xla_planes`` — per-plane grouped contraction (plain PyTorch);
  * ``mxu_pallas``     — the ``bcq_matmul`` CUDA kernel;
  * ``lut_pallas``     — the ``lut_gemm`` CUDA kernel;
  * ``ternary_pallas`` — the ``ternary_matmul`` CUDA kernel (only
                         ``kind="ternary"`` bundles).

``dense`` and ``bcq_xla`` go through the kind-aware ``dequantize``, so a
ternary bundle runs on them too; ``bcq_xla_planes`` reads independent
±1 planes and refuses it, as the reference does.

Products of bf16 values are exact in f32, so ``bcq_xla`` multiplies the
bf16-rounded operands as f32: that is the reference's arithmetic
(bf16 operands, f32 accumulation) on every device.
"""
from __future__ import annotations

import torch

from repro_torch.core.plane import (PlaneBundle, dequantize, pad_operands,
                                    unpack_planes)

BACKENDS = ("dense", "bcq_xla", "bcq_xla_planes", "mxu_pallas", "lut_pallas",
            "ternary_pallas")


def bcq_xla_matmul(x: torch.Tensor, w: PlaneBundle,
                   out_dtype=None) -> torch.Tensor:
    """Per-plane grouped contraction:
    y = sum_i sum_G alpha[i,m,G] (sum_{n in G} pm1[i,m,n] x[b,n]) + z-term."""
    out_dtype = out_dtype or x.dtype
    if w.kind != "bcq":
        raise ValueError(
            f"bcq_xla_matmul reads independent ±1 planes (kind='bcq'); "
            f"got kind={w.kind!r}: use bcq_xla or ternary_pallas")
    q, m, nb = w.packed.shape
    g = w.group_size
    n_groups = w.n_groups
    lead = x.shape[:-1]
    xf = pad_operands(x.reshape(-1, x.shape[-1]).float(), w)
    xg = xf.reshape(-1, n_groups, g)
    pm1 = unpack_planes(w.packed, torch.float32).reshape(q, m, n_groups, g)
    part = torch.einsum("bGn,qmGn->qbmG", xg, pm1)
    y = torch.einsum("qbmG,qmG->bm", part, w.alpha)
    if w.z is not None:
        y = y + torch.einsum("bG,mG->bm", xg.sum(-1), w.z)
    return y.reshape(*lead, m).to(out_dtype)


def bcq_xla_matmul_fused(x: torch.Tensor, w: PlaneBundle, out_dtype=None,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize in ``compute_dtype``, then one matmul, f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    dense = dequantize(w, dtype=compute_dtype)
    y = torch.matmul(x.to(compute_dtype).float(), dense.float().T)
    return y.to(out_dtype)


def bcq_apply(x: torch.Tensor, w: PlaneBundle, backend: str = "bcq_xla",
              out_dtype=None) -> torch.Tensor:
    """Execute y = x @ dequant(w).T on the selected backend."""
    if backend == "dense":
        return bcq_xla_matmul_fused(x, w, out_dtype,
                                    compute_dtype=torch.float32)
    if backend == "bcq_xla":
        return bcq_xla_matmul_fused(x, w, out_dtype)
    if backend == "bcq_xla_planes":
        return bcq_xla_matmul(x, w, out_dtype)
    if backend == "lut_pallas":
        from repro_torch.kernels.lut_gemm import lut_gemm
        return lut_gemm(x, w, out_dtype=out_dtype)
    if backend == "mxu_pallas":
        from repro_torch.kernels.bcq_matmul import bcq_matmul
        return bcq_matmul(x, w, out_dtype=out_dtype)
    if backend == "ternary_pallas":
        from repro_torch.kernels.ternary_matmul import ternary_matmul
        return ternary_matmul(x, w, out_dtype=out_dtype)
    raise ValueError(f"unknown backend {backend!r}")
