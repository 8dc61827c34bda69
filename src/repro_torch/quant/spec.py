"""QuantSpec — the declarative description of a quantization run.

Counterpart of ``repro.quant.spec`` for the formats this slice carries:
``bcq`` and ``rtn`` (alias ``uniform``) at an integer bit width.
Fractional (mixed-precision) widths and the ``ternary`` format raise
``ValueError``: they are ROADMAP.md queue 1 items 2 and 7 of the port.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional

_FORMAT_ALIASES = {"uniform": "rtn", "int": "rtn", "nonuniform": "bcq"}
_PORTED_FORMATS = ("bcq", "rtn")


def canonical_format(name: str) -> str:
    name = (name or "bcq").strip().lower()
    return _FORMAT_ALIASES.get(name, name)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    format: str = "bcq"
    bits: Optional[int] = None        # None -> 4
    group_size: int = 128
    iters: int = 5
    backend: str = "auto"

    def __post_init__(self):
        fmt = canonical_format(self.format)
        object.__setattr__(self, "format", fmt)
        if fmt == "ternary":
            raise ValueError(
                "format 'ternary' is not ported yet (ROADMAP.md queue 1 "
                "item 7: ternary format and kernel)")
        if fmt not in _PORTED_FORMATS:
            raise ValueError(f"unknown quant format {fmt!r}; ported: "
                             f"{list(_PORTED_FORMATS)}")
        bits = 4 if self.bits is None else self.bits
        if float(bits) != int(float(bits)):
            raise ValueError(
                f"fractional bits={bits} (mixed precision) is not ported "
                "yet (ROADMAP.md queue 1 item 2: core/mixed_precision.py)")
        bits = int(float(bits))
        if bits < 0:
            raise ValueError(f"bits must be >= 0, got {bits}")
        object.__setattr__(self, "bits", bits)
        if self.group_size <= 0:
            raise ValueError(
                f"group_size must be positive, got {self.group_size}")

    @property
    def int_bits(self) -> int:
        return int(self.bits)

    def replace(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "QuantSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(f"unknown QuantSpec fields {unknown}; "
                             f"valid: {sorted(fields)}")
        return cls(**dict(d))

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "QuantSpec":
        return cls.from_dict(json.loads(s))

    def describe(self) -> str:
        return (f"{self.format}-{self.bits}bit g{self.group_size} "
                f"backend={self.backend}")
