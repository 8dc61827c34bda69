"""QuantSpec — the declarative description of a quantization run.

Counterpart of ``repro.quant.spec`` for the formats the port carries:
``bcq`` and ``rtn`` (alias ``uniform``) at an integer bit width, and
``ternary`` at log2(3) bits (``bits`` None, 2, 1.58 or 1.585 all become
:data:`TERNARY_BITS`; the bundle stores 2 planes).  A fractional width
on any other format is mixed precision, which raises ``ValueError``
naming ROADMAP.md queue 1 item 2.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional

from repro_torch.core.plane import TERNARY_BITS

_FORMAT_ALIASES = {"uniform": "rtn", "int": "rtn", "nonuniform": "bcq"}
_PORTED_FORMATS = ("bcq", "rtn", "ternary")
_TERNARY_SPELLINGS = (2.0, 1.58, TERNARY_BITS)


def canonical_format(name: str) -> str:
    name = (name or "bcq").strip().lower()
    return _FORMAT_ALIASES.get(name, name)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    format: str = "bcq"
    bits: Optional[float] = None      # None -> 4 (ternary: 1.585)
    group_size: int = 128
    iters: int = 5
    backend: str = "auto"

    def __post_init__(self):
        fmt = canonical_format(self.format)
        object.__setattr__(self, "format", fmt)
        if fmt not in _PORTED_FORMATS:
            raise ValueError(f"unknown quant format {fmt!r}; ported: "
                             f"{list(_PORTED_FORMATS)}")
        if fmt == "ternary":
            if self.bits is not None and \
                    float(self.bits) not in _TERNARY_SPELLINGS:
                raise ValueError(
                    f"format 'ternary' stores 2 planes at rate log2(3); "
                    f"bits={self.bits:g} conflicts (omit bits, or pass "
                    f"1.58/1.585/2)")
            bits = TERNARY_BITS
        else:
            bits = 4 if self.bits is None else self.bits
            if float(bits) != int(float(bits)):
                raise ValueError(
                    f"fractional bits={bits} (mixed precision) is not "
                    "ported yet (ROADMAP.md queue 1 item 2: "
                    "core/mixed_precision.py)")
            bits = int(float(bits))
            if bits < 0:
                raise ValueError(f"bits must be >= 0, got {bits}")
        object.__setattr__(self, "bits", bits)
        if self.group_size <= 0:
            raise ValueError(
                f"group_size must be positive, got {self.group_size}")

    @property
    def int_bits(self) -> int:
        """Stored planes per weight (2 for ternary: sign + mask)."""
        return 2 if self.format == "ternary" else int(self.bits)

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
