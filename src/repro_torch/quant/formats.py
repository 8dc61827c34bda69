"""Weight-format registry: every format lowers into a plane bundle.

Counterpart of ``repro.quant.formats`` for ``bcq`` (alternating
non-uniform BCQ), ``rtn`` (uniform round-to-nearest mapped exactly into
BCQ(+offset) planes) and ``ternary`` ({-a, 0, +a} as a sign + mask
bundle with one alpha row and no offset).  :func:`format_for_bits` is
how a mixed-precision plan mixes formats: a width below 2 selects
ternary, any other keeps the requested format.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import bcq as bcq_mod
from repro_torch.core.plane import TERNARY_BITS, PlaneBundle, pack_planes


@dataclasses.dataclass(frozen=True)
class FormatInfo:
    """One registered format.  ``fixed_plane_bits`` pins the stored plane
    count whatever the request (ternary: 2); ``effective_bits`` is the
    information rate manifests report (ternary: log2(3)); ``None``
    means the request decides both."""

    name: str
    quantize: Callable[..., PlaneBundle]
    fixed_plane_bits: Optional[int] = None
    effective_bits: Optional[float] = None
    description: str = ""

    def plane_bits(self, requested_bits: float) -> int:
        if self.fixed_plane_bits is not None:
            return self.fixed_plane_bits
        return int(requested_bits)


_REGISTRY: Dict[str, FormatInfo] = {}


def register_format(info: FormatInfo) -> FormatInfo:
    _REGISTRY[info.name] = info
    return info


def get_format(name: str) -> FormatInfo:
    from repro_torch.quant.spec import canonical_format
    key = canonical_format(name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown quant format {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_formats() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def format_for_bits(name: str, bits: float) -> FormatInfo:
    """The format a planned width lands on: below 2 bits (the
    :data:`TERNARY_BITS` sentinel) ternary, else ``name``."""
    if bits < 2:
        return get_format("ternary")
    return get_format(name)


def _quantize_bcq(w2d, *, bits: int, group_size: int,
                  iters: int) -> PlaneBundle:
    return bcq_mod.quantize(w2d, bits=bits, group_size=group_size,
                            iters=iters)


def _quantize_rtn(w2d, *, bits: int, group_size: int,
                  iters: int = 0) -> PlaneBundle:
    del iters
    return bcq_mod.from_uniform(w2d, bits=bits, group_size=group_size)


def quantize_ternary(w_dense: torch.Tensor, *, bits: int = 2,
                     group_size: int = 128, iters: int = 0,
                     clip_iters: int = 12) -> PlaneBundle:
    """MSE-optimal ternarization as a ``kind="ternary"`` bundle.

    Per (row, group) the octav clipping fixed point, from a0 = mean|w|:
    keep = |w| > a/2, then a = mean(|w| over keep), ``clip_iters``
    times.  The ragged last group is edge-padded.  Plane 0 is the sign
    bit (w >= 0), plane 1 the nonzero mask; ``bits``/``iters`` are
    accepted for the registry's signature and ignored.  Runs on the
    device the weight lies on."""
    del bits, iters
    w = w_dense.float()
    if w.ndim != 2:
        raise ValueError(f"expected 2-D weight, got {tuple(w.shape)}")
    out, n = w.shape
    g = int(group_size)
    wg = bcq_mod._grouped(w, g)                             # [out, G, g]
    absw = wg.abs()
    a = absw.mean(dim=-1)                                   # [out, G]
    for _ in range(clip_iters):
        mask = absw > (a[..., None] / 2.0)
        cnt = torch.clamp(mask.sum(dim=-1), min=1)
        a = (absw * mask).sum(dim=-1) / cnt
    mask = absw > (a[..., None] / 2.0)
    sign = torch.where(wg >= 0, 1.0, -1.0)
    keep = torch.where(mask, 1.0, -1.0)                     # bit 1 = keep
    planes = torch.stack([sign, keep]).reshape(2, out, -1)
    return PlaneBundle(packed=pack_planes(planes),
                       alpha=a[None].float().contiguous(), z=None,
                       group_size=g, in_features=n, out_features=out,
                       kind="ternary")


register_format(FormatInfo(
    name="bcq", quantize=_quantize_bcq,
    description="alternating non-uniform BCQ (greedy init + LS refinement)"))
register_format(FormatInfo(
    name="rtn", quantize=_quantize_rtn,
    description="uniform round-to-nearest, exact BCQ(+offset) mapping"))
register_format(FormatInfo(
    name="ternary", quantize=quantize_ternary, fixed_plane_bits=2,
    effective_bits=TERNARY_BITS,
    description="octav-clipped {-a,0,+a} as a sign + mask plane bundle "
                "(1 alpha row, no offset; ternary_matmul kernel)"))
