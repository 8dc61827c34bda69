"""Wrapper of the hand-written ``bcq_matmul`` CUDA kernel.

On a CPU tensor it runs the plain version (``ref.bcq_matmul_ref``),
because CUDA has no interpret mode; on a CUDA tensor it launches the
kernel or raises — it never falls back.  Ragged edges are masked
in-kernel, so no operand is padded per call.

The kernel has three bodies, all on the tensor cores, and
:func:`route_for` picks one by a fixed rule of the call's shape and type
(never by trying one and switching when it fails):

  * ``gemv``     — at most 8 rows (decode) of bf16 or f32 activations,
    a group size of 32, 64, 128 or 256 and an input width that is a
    multiple of 8: the tensor-core decode tile of ``csrc/bcq_decode.cu``
    (the batch on the N side of one bf16 product per bit plane and alpha
    group, 64 weight rows a block; f32 activations split in the kernel
    into three bf16 parts, each product run once per part; the
    reduction axis split over blocks where the row tiles alone would
    leave SMs idle, :func:`gemv_splits`, and the partials added in split
    order by the last block of each row tile);
  * ``mma``      — more than 8 rows of bf16 or f32 activations, a group
    size that is a multiple of 16 (at most 256) and an input width that
    is a multiple of 8: the tensor-core tile of ``csrc/bcq_mma.cu``, one
    bf16 product per bit plane and alpha group (prefill; f32 activations
    split in the kernel into three bf16 parts, each A fragment run
    against all three, ``ref.mma_split_ref`` the plain version of that
    order);
  * ``mma_dq``   — every other call, at any row count (group sizes 16,
    96, 8 mod 16 or above 256, or an input width that is not a multiple
    of 8): the dequantizing tensor-core tile of ``csrc/bcq_dq.cu``, which
    builds W = sum_i alpha_i (+-1)_i + z in registers, splits it into two
    bf16 parts and runs them against x (f32 activations split into bf16
    parts; ``ref.dq_split_ref`` the plain version of that walk), the
    group size only an index; at 8 rows or fewer in 512-column stages,
    bound by the bytes of the planes and scales.

The launch counter keeps the kernel's name; ``_lib.route_counts``
counts each body under ``"bcq_matmul/<route>"``.  ``ref.gemv_split_ref``
is the plain version of the decode tile's split walk.  The tiles split
their reduction axis over blocks where the output tiles alone would
leave SMs idle (:func:`gemv_splits`, :func:`mma_splits`,
:func:`dq_splits`).

The wrapper takes its route and split count from
``repro_torch.tune.dispatch.launch_config``: a tuned cache entry where
there is one, else the rules above (``route_for`` and the split
functions, which are the tuner's heuristic); ``route=`` / ``splits=``
pin them and bypass dispatch.  Every body computes the same function;
the choice changes only the summation order and the time.
"""
from __future__ import annotations

import torch

from repro_torch.core.plane import PlaneBundle
from repro_torch.kernels import _lib
from repro_torch.tune import dispatch as _dispatch
from . import ref as _ref
from .ref import GEMV_STEP, dq_step

_X_DTYPES = (torch.bfloat16, torch.float32)

# index = the launcher's route code
ROUTES = ("mma_dq", "gemv", "mma")
DECODE_ROWS = 8                   # most rows the decode bodies take
MMA_ROWS, MMA_BATCH = 128, 64     # the mma tile's block (csrc/bcq_mma.cuh)
MMA_MAX_GROUP = 256
# the dequantizing tile's weight rows a block at 8 rows or fewer
# (csrc/bcq_dq.cu: 64, or 32 or 16 where shared memory needs it)
DQ_DECODE_ROWS = 64
# the decode tile (csrc/bcq_decode.cu): weight rows per block, and the
# group sizes it takes (whole groups in each 256-column step)
GEMV_ROWS = 64
GEMV_GROUPS = (32, 64, 128, 256)


def mma_takes(rows: int, dtype, group_size: int, in_features: int) -> bool:
    """The tensor-core tile's rule, shared with lut_gemm and
    ternary_matmul: more than 8 rows of bf16 or f32 activations,
    16 | group size <= 256, 8 | in_features (16-byte activation rows)."""
    return (rows > DECODE_ROWS and dtype in _X_DTYPES
            and group_size % 16 == 0 and group_size <= MMA_MAX_GROUP
            and in_features % 8 == 0)


def gemv_takes(rows: int, dtype, group_size: int, in_features: int) -> bool:
    """The decode tile's rule, shared with ternary_matmul: at most 8 rows
    of bf16 or f32 activations, group size 32, 64, 128 or 256,
    8 | in_features (16-byte activation rows)."""
    return (rows <= DECODE_ROWS and dtype in _X_DTYPES
            and group_size in GEMV_GROUPS and in_features % 8 == 0)


def route_for(rows: int, dtype, group_size: int, in_features: int) -> str:
    """The body a call of ``rows`` activation rows of ``dtype`` runs."""
    if gemv_takes(rows, dtype, group_size, in_features):
        return "gemv"
    if mma_takes(rows, dtype, group_size, in_features):
        return "mma"
    return "mma_dq"


def mma_splits(rows: int, m: int, n_groups: int, sms: int) -> int:
    """How many blocks share one (row, batch) tile's alpha groups on the
    mma route: none while the tiles fill every SM, else enough for about
    two blocks per SM, never more than there are groups."""
    tiles = -(-m // MMA_ROWS) * -(-rows // MMA_BATCH)
    return 1 if tiles >= sms else _lib.split_count(n_groups, tiles, sms, 2)


def dq_splits(rows: int, m: int, padded_in: int, sms: int) -> int:
    """How many blocks share one output tile's stages on the dequantizing
    tile (``ref.dq_step(rows)`` columns each; ``padded_in``: the planes'
    width): none while the output tiles (128 weight rows x 64 batch rows,
    or at 8 rows or fewer up to ``DQ_DECODE_ROWS`` weight rows) fill
    every SM, else enough for about two blocks per SM, never more than
    there are stages."""
    tiles = (-(-m // DQ_DECODE_ROWS) if rows <= DECODE_ROWS
             else -(-m // MMA_ROWS) * -(-rows // MMA_BATCH))
    if tiles >= sms:
        return 1
    return _lib.split_count(-(-padded_in // dq_step(rows)), tiles, sms, 2)


def gemv_splits(m: int, padded_in: int, sms: int) -> int:
    """How many blocks share one 64-row tile's 256-column steps on the
    decode tile (``padded_in``: the planes' width, n_groups x
    group_size): none while the row tiles give every SM a block (a split
    there measured slower: its partials and merge cost more than the
    blocks it adds), else enough for about three blocks per SM, never
    more than there are steps."""
    tiles = -(-m // GEMV_ROWS)
    if tiles >= sms:
        return 1
    return _lib.split_count(-(-padded_in // GEMV_STEP), tiles, sms, 3)


def aligned_rows(x2: torch.Tensor) -> torch.Tensor:
    """x2 itself, or a copy when its base is not 16-byte aligned (the
    tensor-core tiles stage activation rows, bf16 or f32, with 16-byte
    copies; with 8 | in_features every row then starts 16-byte aligned,
    and the dequantizing tile narrows its copies to what the width
    allows)."""
    return x2 if x2.data_ptr() % 16 == 0 else x2.clone()


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


def bcq_matmul(x: torch.Tensor, w: PlaneBundle, *, route=None, splits=None,
               out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(w).T.  x: [..., in_features] -> [..., out].
    ``route`` / ``splits`` pin the launch (CUDA only)."""
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
        sms, device = _dispatch.device_of(x2)
        cfg = _dispatch.launch_config(
            "bcq_matmul", route=route, splits=splits, b=b, m=m,
            n=w.in_features, dtype=x2.dtype, group_size=w.group_size,
            sms=sms, device=device, operands=(x2, w))
        route, splits = cfg.route, cfg.splits
        part, sem = None, None
        x2 = aligned_rows(x2)
        if splits > 1:
            part = torch.empty((splits, b, m), dtype=torch.float32,
                               device=x.device)
            if route == "gemv":
                sem = _lib.split_counters("bcq_matmul", x.device,
                                          -(-m // GEMV_ROWS))
        rc = _lib.lib().launch_bcq_matmul(
            x2.data_ptr(), w.packed.data_ptr(), w.alpha.data_ptr(),
            w.z.data_ptr() if w.z is not None else None, y.data_ptr(),
            part.data_ptr() if part is not None else None,
            sem.data_ptr() if sem is not None else None,
            b, m, w.in_features, nb, w.n_groups, q, w.group_size,
            int(x2.dtype == torch.bfloat16), ROUTES.index(route), splits,
            _lib.stream_ptr(x.device))
        _lib.check(rc, "bcq_matmul")
        _lib.count_launch("bcq_matmul", route)
    return y.reshape(*lead, m).to(out_dtype)
