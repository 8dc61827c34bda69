"""Wrapper of the hand-written FIGLUT ``lut_gemm`` CUDA kernel.

On a CPU tensor it runs the plain version (``ref.lut_ref``, the same
table-build + keyed-read algorithm); on a CUDA tensor it launches the
kernel or raises.  ``read_mode`` is accepted for parity with the
reference wrapper: it names TPU lowerings of the keyed read and does
not change the math (a keyed shared-memory read is the RAC on the card).

The kernel has three bodies, and :func:`route_for` picks one by a fixed
rule (never by trying one and switching when it fails):

  * ``lut``    — at most 8 rows (decode), at mu 2 or 4 with the half or
    the full table (the serve path's decode is mu 4 with the half table;
    the others are the paper's LUT-size and hFFLUT ablations): the
    shared-memory LUT body, 512-column table builds, the reduction axis
    split over blocks where the row tiles alone would leave SMs idle;
  * ``mma``    — more than 8 rows of bf16 or f32 activations under
    ``bcq_matmul``'s tensor-core rule (``mma_takes``), at any mu and
    either table: the keyed read re-associated into one bf16 product per
    bit plane and alpha group (``csrc/bcq_mma.cu``, f32 activations split
    there into three bf16 parts), the same tile as bcq_matmul's prefill;
  * ``mma_dq`` — every other call above 8 rows (group sizes 8 mod 16 or
    above 256, input widths that are not a multiple of 8), at any mu and
    either table: the dequantizing tensor-core tile of
    ``csrc/bcq_dq.cu``, the keyed read re-associated as on ``mma``
    (``bcq_matmul.dq_splits`` counts its splits).

The launch counter keeps the kernel's name; ``_lib.route_counts``
counts each body under ``"lut_gemm/<route>"``.  The route, the split
count and (on ``lut``, where ``half_lut`` is not given) the table come
from ``repro_torch.tune.dispatch.launch_config``, as bcq_matmul's do;
``route=`` / ``splits=`` pin them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plane import PlaneBundle
from repro_torch.kernels import _lib
from repro_torch.kernels.bcq_matmul.ops import (DECODE_ROWS, aligned_rows,
                                               check_operands, mma_takes)
from repro_torch.kernels.lut_common import READ_MODES
from repro_torch.tune import dispatch as _dispatch
from . import ref as _ref


ROUTES = ("mma_dq", "lut", "mma")   # index = the launcher's route code
DECODE_CHUNK, DECODE_ROWS_PER_BLOCK = 512, 64   # csrc/lut_gemm.cu: DKC, DM


def route_for(rows: int, dtype, group_size: int, in_features: int,
              mu: int = 4, half_lut: bool = True) -> str:
    """The body a call of ``rows`` activation rows of ``dtype`` runs (the
    same at every ``mu`` and ``half_lut``)."""
    if rows <= DECODE_ROWS:
        return "lut"
    if mma_takes(rows, dtype, group_size, in_features):
        return "mma"
    return "mma_dq"


def decode_splits(m: int, nb: int, sms: int) -> int:
    """How many blocks share one row tile's 512-column chunks on the
    ``lut`` route: enough for about four blocks per SM, never more than
    there are chunks."""
    return _lib.split_count(-(-nb * 8 // DECODE_CHUNK),
                            -(-m // DECODE_ROWS_PER_BLOCK), sms, 4)


def lut_gemm(x: torch.Tensor, w: PlaneBundle, *, mu: int = 4,
             half_lut: Optional[bool] = None,
             read_mode: Optional[str] = None, route: Optional[str] = None,
             splits: Optional[int] = None, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(w).T via FIGLUT's LUT GEMM, f32 accumulation.
    ``route`` / ``splits`` pin the launch (CUDA only)."""
    out_dtype = out_dtype or x.dtype
    if read_mode is not None and read_mode not in READ_MODES:
        raise ValueError(f"read_mode {read_mode!r} not in {READ_MODES}")
    if mu not in (2, 4):
        raise ValueError(f"mu must be 2 or 4, got {mu}")
    if x.shape[-1] != w.in_features:
        raise ValueError(f"x last dim {x.shape[-1]} != in_features "
                         f"{w.in_features}")
    if x.device.type == "cpu":
        return _ref.lut_ref(x, w, mu=mu, half_lut=half_lut is not False,
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
        sms, device = _dispatch.device_of(x2)
        cfg = _dispatch.launch_config(
            "lut_gemm", route=route, splits=splits, b=b, m=m,
            n=w.in_features, dtype=x2.dtype, mu=mu, group_size=w.group_size,
            sms=sms, device=device, operands=(x2, w))
        route, splits = cfg.route, cfg.splits
        half_lut = cfg.half_lut if half_lut is None else bool(half_lut)
        part = None
        if route != "lut":
            x2 = aligned_rows(x2)
        if splits > 1:
            part = torch.empty((splits, b, m), dtype=torch.float32,
                               device=x.device)
        rc = _lib.lib().launch_lut_gemm(
            x2.data_ptr(), w.packed.data_ptr(), w.alpha.data_ptr(),
            w.z.data_ptr() if w.z is not None else None, y.data_ptr(),
            part.data_ptr() if part is not None else None,
            b, m, w.in_features, nb, w.n_groups, q, w.group_size,
            int(x2.dtype == torch.bfloat16), mu, int(half_lut),
            ROUTES.index(route), splits, _lib.stream_ptr(x.device))
        _lib.check(rc, "lut_gemm")
        _lib.count_launch("lut_gemm", route)
    return y.reshape(*lead, m).to(out_dtype)
