"""Wrapper of the hand-written FIGLUT ``lut_gemm`` CUDA kernel.

On a CPU tensor it runs the plain version (``ref.lut_ref``, the same
table-build + keyed-read algorithm); on a CUDA tensor it launches the
kernel or raises.  ``read_mode`` is accepted for parity with the
reference wrapper: it names TPU lowerings of the keyed read and does
not change the math (a keyed shared-memory read is the RAC on the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plane import PlaneBundle
from repro_torch.kernels import _lib
from repro_torch.kernels.bcq_matmul.ops import check_operands
from repro_torch.kernels.lut_common import READ_MODES
from . import ref as _ref


def chunk_for(group_size: int, limit: int = 128) -> int:
    """Largest chunk of at most ``limit`` columns that tiles an alpha
    group and is a whole number of bytes (the kernel's reduction step)."""
    for c in range(min(group_size, limit), 7, -1):
        if group_size % c == 0 and c % 8 == 0:
            return c
    raise ValueError(f"group_size {group_size} has no byte-aligned chunk")


def lut_gemm(x: torch.Tensor, w: PlaneBundle, *, mu: int = 4,
             half_lut: Optional[bool] = None,
             read_mode: Optional[str] = None,
             out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(w).T via FIGLUT's LUT GEMM, f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    half_lut = True if half_lut is None else bool(half_lut)
    if read_mode is not None and read_mode not in READ_MODES:
        raise ValueError(f"read_mode {read_mode!r} not in {READ_MODES}")
    if mu not in (2, 4):
        raise ValueError(f"mu must be 2 or 4, got {mu}")
    if x.shape[-1] != w.in_features:
        raise ValueError(f"x last dim {x.shape[-1]} != in_features "
                         f"{w.in_features}")
    if x.device.type == "cpu":
        return _ref.lut_ref(x, w, mu=mu, half_lut=half_lut,
                            out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"lut_gemm: unsupported device {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    check_operands(x2, w, "lut_gemm")
    q, m, nb = w.packed.shape
    b = x2.shape[0]
    y = torch.empty((b, m), dtype=torch.float32, device=x.device)
    if b:
        rc = _lib.lib().launch_lut_gemm(
            x2.data_ptr(), w.packed.data_ptr(), w.alpha.data_ptr(),
            w.z.data_ptr() if w.z is not None else None, y.data_ptr(),
            b, m, w.in_features, nb, w.n_groups, q, w.group_size,
            int(x2.dtype == torch.bfloat16), mu, int(half_lut),
            chunk_for(w.group_size), _lib.stream_ptr(x.device))
        _lib.check(rc, "lut_gemm")
        _lib.count_launch("lut_gemm")
    return y.reshape(*lead, m).to(out_dtype)
