"""Weight-format registry: every format lowers into a plane bundle.

Counterpart of ``repro.quant.formats`` for ``bcq`` (alternating
non-uniform BCQ) and ``rtn`` (uniform round-to-nearest mapped exactly
into BCQ(+offset) planes).  The ternary format waits for its kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.core import bcq as bcq_mod
from repro_torch.core.plane import PlaneBundle


@dataclasses.dataclass(frozen=True)
class FormatInfo:
    name: str
    quantize: Callable[..., PlaneBundle]
    fixed_plane_bits: Optional[int] = None
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


def _quantize_bcq(w2d, *, bits: int, group_size: int,
                  iters: int) -> PlaneBundle:
    return bcq_mod.quantize(w2d, bits=bits, group_size=group_size,
                            iters=iters)


def _quantize_rtn(w2d, *, bits: int, group_size: int,
                  iters: int = 0) -> PlaneBundle:
    del iters
    return bcq_mod.from_uniform(w2d, bits=bits, group_size=group_size)


register_format(FormatInfo(
    name="bcq", quantize=_quantize_bcq,
    description="alternating non-uniform BCQ (greedy init + LS refinement)"))
register_format(FormatInfo(
    name="rtn", quantize=_quantize_rtn,
    description="uniform round-to-nearest, exact BCQ(+offset) mapping"))
