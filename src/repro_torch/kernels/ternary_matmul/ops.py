"""Wrapper of the hand-written ``ternary_matmul`` CUDA kernel.

Takes only ``kind="ternary"`` bundles (sign + mask planes, one alpha
row, no offset).  On a CPU tensor it runs the plain version
(``ref.ternary_ref``, the same half-LUT algorithm); on a CUDA tensor it
launches the kernel or raises.  ``read_mode`` is accepted for parity
with the reference wrapper and does not change the math.

The kernel has three bodies, and :func:`route_for` picks one by a fixed
rule of the call's shape and type (never by trying one and switching
when it fails):

  * ``gemv`` — at most 8 rows of bf16 or f32 activations, a group size
    of 32, 64, 128 or 256 and an input width that is a multiple of 8
    (the rule of ``bcq_matmul.gemv_takes``): the tensor-core decode tile
    of ``csrc/bcq_decode.cu`` with its ternary flag, one {-1, 0, +1}
    operand (mask times the +-1 sign) per k16 step scaled by alpha
    (decode);
  * ``mma`` — more than 8 rows of bf16 or f32 activations, a group size
    that is a multiple of 16 (at most 256) and an input width that is a
    multiple of 8 (``bcq_matmul.mma_takes``): the tensor-core tile of
    ``csrc/bcq_mma.cu``, which derives the b1 / b2 planes from the sign
    and mask words in registers (prefill; f32 activations split there
    into three bf16 parts);
  * ``mma_dq`` — every other call, at any row count (group sizes 8 mod
    16 or above 256, group sizes 8, 16, 24 and the like at decode rows,
    an input width that is not a multiple of 8): the dequantizing
    tensor-core tile of ``csrc/bcq_dq.cu`` with its ternary flag, which
    builds W = alpha mask (+-1 sign) in registers, splits it into two
    bf16 parts and runs them against x (``bcq_matmul.ref.dq_split_ref``
    the plain version of that walk).

Where the (row, batch) tiles alone would leave the card under-filled,
the reduction axis (alpha groups on ``mma`` as
``bcq_matmul.mma_splits`` counts them, 256-column steps on ``gemv`` as
``bcq_matmul.gemv_splits`` counts them, 64- or 512-column stages on
``mma_dq`` as ``bcq_matmul.dq_splits`` counts them) is split over
``splits`` blocks whose partial sums (scratch allocated here) are added
in a fixed order (a second pass, or on ``gemv`` the last block of each
row tile, counted in ``_lib.split_counters``), so the result does not
depend on scheduling.  The route and the split count come from
``repro_torch.tune.dispatch.launch_config`` (a tuned entry, else the
rules above); ``route=`` / ``splits=`` pin them.  The launch counter
keeps the kernel's name; ``_lib.route_counts`` counts each body under
``"ternary_matmul/<route>"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.plane import PlaneBundle
from repro_torch.kernels import _lib
from repro_torch.kernels.bcq_matmul.ops import (GEMV_ROWS, aligned_rows,
                                                gemv_takes, mma_takes)
from repro_torch.kernels.lut_common import READ_MODES
from repro_torch.tune import dispatch as _dispatch
from . import ref as _ref

_X_DTYPES = (torch.bfloat16, torch.float32)
ROUTES = ("mma_dq", "mma", "gemv")   # index = the launcher's route code


def route_for(rows: int, dtype, group_size: int, in_features: int) -> str:
    """The body a call of ``rows`` activation rows of ``dtype`` runs."""
    if gemv_takes(rows, dtype, group_size, in_features):
        return "gemv"
    if mma_takes(rows, dtype, group_size, in_features):
        return "mma"
    return "mma_dq"


def _check_operands(x2: torch.Tensor, w: PlaneBundle) -> None:
    if x2.dtype not in _X_DTYPES:
        raise TypeError(f"ternary_matmul: x dtype {x2.dtype} not in "
                        f"{_X_DTYPES}")
    if w.group_size % 8:
        raise ValueError(f"ternary_matmul: group_size {w.group_size} % 8 "
                         "!= 0")
    q, m, nb = w.packed.shape
    if q != 2 or w.alpha.shape != (1, m, w.n_groups) or w.z is not None:
        raise ValueError("ternary_matmul: a ternary bundle holds 2 planes, "
                         "one alpha row and no offset")
    if nb * 8 != w.n_groups * w.group_size:
        raise ValueError("ternary_matmul: inconsistent bundle shapes")
    if w.packed.dtype != torch.uint8 or w.alpha.dtype != torch.float32:
        raise TypeError("ternary_matmul: packed must be uint8, alpha "
                        "float32")
    for t in (w.packed, w.alpha):
        if t.device != x2.device:
            raise ValueError(f"ternary_matmul: operands on {t.device} and "
                             f"{x2.device}")
        if not t.is_contiguous():
            raise ValueError("ternary_matmul: weight operands must be "
                             "contiguous")


def ternary_matmul(x: torch.Tensor, w: PlaneBundle, *, mu: int = 4,
                   read_mode: Optional[str] = None,
                   route: Optional[str] = None, splits: Optional[int] = None,
                   out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(w).T for a ternary bundle, f32 accumulation (the
    half-LUT algorithm on the CPU).  x: [..., in_features] ->
    [..., out_features].  ``route`` / ``splits`` pin the launch (CUDA
    only)."""
    if w.kind != "ternary":
        raise ValueError(
            f"ternary_matmul needs a kind='ternary' bundle, got {w.kind!r}; "
            "generic BCQ weights take the lut_gemm/bcq_matmul kernels")
    out_dtype = out_dtype or x.dtype
    if read_mode is not None and read_mode not in READ_MODES:
        raise ValueError(f"read_mode {read_mode!r} not in {READ_MODES}")
    if x.shape[-1] != w.in_features:
        raise ValueError(f"x last dim {x.shape[-1]} != in_features "
                         f"{w.in_features}")
    if x.device.type == "cpu":
        return _ref.ternary_ref(x, w, mu=mu, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ternary_matmul: unsupported device {x.device}")
    if mu != 4:
        raise ValueError(f"ternary_matmul: the CUDA path takes mu=4 only "
                         f"(the reference's default), got mu={mu}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    _check_operands(x2, w)
    _, m, nb = w.packed.shape
    b = x2.shape[0]
    y = torch.empty((b, m), dtype=torch.float32, device=x.device)
    if b:
        sms, device = _dispatch.device_of(x2)
        cfg = _dispatch.launch_config(
            "ternary_matmul", route=route, splits=splits, b=b, m=m,
            n=w.in_features, dtype=x2.dtype, group_size=w.group_size,
            sms=sms, device=device, operands=(x2, w))
        route, splits = cfg.route, cfg.splits
        x2 = aligned_rows(x2)
        sem = None
        if route == "gemv" and splits > 1:
            sem = _lib.split_counters("ternary_matmul", x.device,
                                      -(-m // GEMV_ROWS))
        part = torch.empty((splits, b, m), dtype=torch.float32,
                           device=x.device) if splits > 1 else y
        rc = _lib.lib().launch_ternary_matmul(
            x2.data_ptr(), w.packed.data_ptr(), w.alpha.data_ptr(),
            y.data_ptr(), part.data_ptr(),
            sem.data_ptr() if sem is not None else None, b, m,
            w.in_features, nb, w.n_groups, w.group_size,
            int(x2.dtype == torch.bfloat16), ROUTES.index(route), splits,
            _lib.stream_ptr(x.device))
        _lib.check(rc, "ternary_matmul")
        _lib.count_launch("ternary_matmul", route)
    return y.reshape(*lead, m).to(out_dtype)
