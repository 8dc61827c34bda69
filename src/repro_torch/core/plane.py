"""Plane-native weight layout: the one quantize -> kernel handoff.

Counterpart of ``repro.core.plane``.  A :class:`PlaneBundle` holds
packed sign planes, per-(row, group) scale rows and layout metadata:

  * ``packed``  uint8 [q, out, in_pad // 8], 8 weights per byte,
    LSB-first along the input dim; bit 1 encodes +1;
  * ``alpha``   f32 [q, out, n_groups], one scale row per plane;
  * ``z``       f32 [out, n_groups] offset row (or ``None``).

An expert bank stacks E such bundles on a leading axis (``packed`` [E,
q, out, in_pad // 8], ``alpha`` [E, q, out, n_groups], ``z`` [E, out,
n_groups]), as the reference quantizes MoE weights per expert;
:meth:`PlaneBundle.index` takes one expert's bundle back out.  The
GEMM kernels take 2-D bundles only.

Two kinds exist, as in the reference: ``kind="bcq"`` (one ±1 plane and
one alpha row per bit) and ``kind="ternary"`` (plane 0 is the sign bit,
1 = +; plane 1 the nonzero mask, 1 = keep; a single alpha row and no
offset: w = alpha * sign * mask).  A ternary bundle stores 2 planes but
carries log2(3) bits per weight (:data:`TERNARY_BITS`).

The CUDA kernels mask ragged edges in-kernel, so :func:`pad_operands`
is only the plain versions' helper: it zero-pads the activation batch
to the weight's padded input width (what ``tile_operands`` does on the
reference side, without the per-call weight copy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["PlaneBundle", "KINDS", "TERNARY_BITS", "pack_planes",
           "unpack_planes", "dequantize", "pad_operands"]

KINDS = ("bcq", "ternary")

# the ternary format's information rate, log2(3) rounded as the
# reference spells it (``repro/core/plane.py:60``)
TERNARY_BITS = 1.585


@dataclasses.dataclass
class PlaneBundle:
    """Plane-packed quantized weight tensor (a small dataclass of tensors)."""

    packed: torch.Tensor
    alpha: torch.Tensor
    z: Optional[torch.Tensor]
    group_size: int
    in_features: int
    out_features: int
    kind: str = "bcq"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown bundle kind {self.kind!r}; known: "
                             f"{KINDS}")

    @property
    def bits(self) -> int:
        """Stored plane count (2 for ternary: sign + mask)."""
        return self.packed.shape[-3]

    @property
    def effective_bits(self) -> float:
        """Information rate in bits/weight (log2 of the level count)."""
        return TERNARY_BITS if self.kind == "ternary" else float(self.bits)

    @property
    def n_groups(self) -> int:
        return self.alpha.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def nbytes(self) -> int:
        """Stored bytes: every plane, every alpha row (one for ternary)
        and the offset row where there is one."""
        n = (self.packed.numel() * self.packed.element_size()
             + self.alpha.numel() * self.alpha.element_size())
        if self.z is not None:
            n += self.z.numel() * self.z.element_size()
        return n

    def to(self, device) -> "PlaneBundle":
        return dataclasses.replace(
            self, packed=self.packed.to(device), alpha=self.alpha.to(device),
            z=None if self.z is None else self.z.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype=dtype)

    def index(self, i: int) -> "PlaneBundle":
        """Entry ``i`` of the leading (expert or layer) axis."""
        return dataclasses.replace(
            self, packed=self.packed[i], alpha=self.alpha[i],
            z=None if self.z is None else self.z[i])


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def pack_planes(planes: torch.Tensor) -> torch.Tensor:
    """Pack {-1,+1} (or {0,1}) planes [q, out, in] into uint8 [q, out, in//8]."""
    q, out, n = planes.shape
    if n % 8 != 0:
        raise ValueError(f"input dim {n} not divisible by 8; pad first")
    bits = (planes > 0).to(torch.uint8).reshape(q, out, n // 8, 8)
    return (bits << _shifts(planes.device)).sum(dim=-1, dtype=torch.uint8)


def unpack_planes(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_planes`: returns **±1** planes [q, out, in]."""
    q, out, nb = packed.shape
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    return (bits.to(dtype) * 2 - 1).reshape(q, out, nb * 8)


def dequantize(w: PlaneBundle, dtype=torch.float32) -> torch.Tensor:
    """Dense W[out, in] from a bundle, in f32: sum_i alpha_i * b_i + z
    for BCQ, alpha * sign * mask for ternary.  A bundle with leading axes
    gives [*lead, out, in], one entry at a time.

    The plane sum runs in plane order and the offset is added last, the
    order of the reference's ``(pm1 * alpha).sum(0) + z``."""
    if w.packed.ndim > 3:
        return torch.stack([dequantize(w.index(i), dtype)
                            for i in range(w.packed.shape[0])])
    q, out, nb = w.packed.shape
    g = w.group_size
    pm1 = unpack_planes(w.packed, torch.float32)          # [q, out, in_pad]
    if w.kind == "ternary":
        a_cols = w.alpha[0].float().repeat_interleave(g, dim=-1)
        dense = a_cols * pm1[0] * ((pm1[1] + 1) * 0.5)
        return dense[:, : w.in_features].to(dtype)
    alpha_cols = w.alpha.float().repeat_interleave(g, dim=-1)
    dense = pm1[0] * alpha_cols[0]
    for i in range(1, q):
        dense = dense + pm1[i] * alpha_cols[i]
    if w.z is not None:
        dense = dense + w.z.float().repeat_interleave(g, dim=-1)
    return dense[:, : w.in_features].to(dtype)


def pad_operands(x2: torch.Tensor, w: PlaneBundle) -> torch.Tensor:
    """Zero-pad a flattened activation batch [b, in_features] to the
    weight's padded input width ``packed.shape[-1] * 8``.  Zero columns
    add nothing to LUT entries, activation sums or products."""
    n_pad = w.packed.shape[-1] * 8
    if x2.shape[-1] == n_pad:
        return x2
    return torch.nn.functional.pad(x2, (0, n_pad - x2.shape[-1]))
