"""Wrapper of the hand-written ``bcq_matmul`` CUDA kernel.

On a CPU tensor it runs the plain version (``ref.bcq_matmul_ref``),
because CUDA has no interpret mode; on a CUDA tensor it launches the
kernel or raises — it never falls back.  Launch geometry is fixed in
the kernel (64 weight rows per block, 8 or 32 batch rows), and ragged
edges are masked in-kernel, so no operand is padded per call.
"""
from __future__ import annotations

import torch

from repro_torch.core.plane import PlaneBundle
from repro_torch.kernels import _lib
from . import ref as _ref

_X_DTYPES = (torch.bfloat16, torch.float32)


def check_operands(x2: torch.Tensor, w: PlaneBundle, name: str) -> None:
    """Device, type, shape and contiguity checks shared by the GEMM
    wrappers (the kernels take exactly this layout)."""
    if x2.dtype not in _X_DTYPES:
        raise TypeError(f"{name}: x dtype {x2.dtype} not in {_X_DTYPES}")
    if w.kind != "bcq":
        raise ValueError(f"{name}: reads kind='bcq' planes, got {w.kind!r}")
    if w.group_size % 8:
        raise ValueError(f"{name}: group_size {w.group_size} % 8 != 0")
    q, m, nb = w.packed.shape
    if not 1 <= q <= 8:
        raise ValueError(f"{name}: {q} planes; the kernel streams 1..8")
    tensors = [w.packed, w.alpha] + ([w.z] if w.z is not None else [])
    for t in tensors:
        if t.device != x2.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: weight operands must be contiguous")
    if w.packed.dtype != torch.uint8 or w.alpha.dtype != torch.float32 or \
            (w.z is not None and w.z.dtype != torch.float32):
        raise TypeError(f"{name}: packed must be uint8, alpha/z float32")
    if w.alpha.shape != (q, m, w.n_groups) or nb * 8 != \
            w.n_groups * w.group_size:
        raise ValueError(f"{name}: inconsistent bundle shapes")


def bcq_matmul(x: torch.Tensor, w: PlaneBundle, *,
               out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(w).T.  x: [..., in_features] -> [..., out]."""
    out_dtype = out_dtype or x.dtype
    if x.shape[-1] != w.in_features:
        raise ValueError(f"x last dim {x.shape[-1]} != in_features "
                         f"{w.in_features}")
    if x.device.type == "cpu":
        return _ref.bcq_matmul_ref(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"bcq_matmul: unsupported device {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    check_operands(x2, w, "bcq_matmul")
    q, m, nb = w.packed.shape
    b = x2.shape[0]
    y = torch.empty((b, m), dtype=torch.float32, device=x.device)
    if b:
        rc = _lib.lib().launch_bcq_matmul(
            x2.data_ptr(), w.packed.data_ptr(), w.alpha.data_ptr(),
            w.z.data_ptr() if w.z is not None else None, y.data_ptr(),
            b, m, w.in_features, nb, w.n_groups, q, w.group_size,
            int(x2.dtype == torch.bfloat16), _lib.stream_ptr(x.device))
        _lib.check(rc, "bcq_matmul")
        _lib.count_launch("bcq_matmul")
    return y.reshape(*lead, m).to(out_dtype)
