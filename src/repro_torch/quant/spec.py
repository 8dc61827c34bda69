"""QuantSpec — the declarative description of a quantization run.

Counterpart of ``repro.quant.spec`` for the formats the port carries:
``bcq`` and ``rtn`` (alias ``uniform``) and ``ternary`` (log2(3) bits
in 2 stored planes; ``bits`` None, 2, 1.58 or 1.585 all become
:data:`TERNARY_BITS`).

``bits`` is an integer width, or a fractional *average* (``2.4``) on
``bcq``/``rtn``: mixed precision, planned per reference leaf by
:func:`repro_torch.quant.api.plan_bits` through
:func:`repro_torch.core.mixed_precision.allocate_bits` over
``candidate_bits``.  Budgets below 2 admit ternary as their lowest
candidate.  ``overrides`` pins single leaves (``{'stack/scan/0/mixer/q':
3}``), stored as a sorted tuple of pairs so the spec stays hashable.
The colloquial 1.58 is canonicalized to 1.585 on every format.

Integer widths stay ``int`` (``describe`` and manifests print them
so); :meth:`from_dict` takes a dict that either package wrote, the
legacy ``method`` key included.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Mapping, Optional, Tuple

from repro_torch.core.plane import TERNARY_BITS

_FORMAT_ALIASES = {"uniform": "rtn", "int": "rtn", "nonuniform": "bcq"}
_PORTED_FORMATS = ("bcq", "rtn", "ternary")
_TERNARY_SPELLINGS = (2.0, 1.58, TERNARY_BITS)


def canonical_format(name: str) -> str:
    name = (name or "bcq").strip().lower()
    return _FORMAT_ALIASES.get(name, name)


def _width(v) -> float:
    """A per-leaf width: sub-2 widths (the ternary sentinel) keep their
    float spelling, integer widths stay ints."""
    return float(v) if float(v) < 2 else int(v)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    format: str = "bcq"
    bits: Optional[float] = None      # None -> 4 (ternary: 1.585)
    group_size: int = 128
    iters: int = 5
    backend: str = "auto"
    candidates: Tuple[float, ...] = ()
    overrides: Tuple[Tuple[str, float], ...] = ()

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
            bits = float(4 if self.bits is None else self.bits)
            if bits == 1.58:
                bits = TERNARY_BITS
            if bits < 0:
                raise ValueError(f"bits must be >= 0, got {bits:g}")
            if bits == int(bits):
                bits = int(bits)
        object.__setattr__(self, "bits", bits)
        pairs = (self.overrides.items()
                 if isinstance(self.overrides, Mapping) else self.overrides)
        object.__setattr__(self, "overrides", tuple(sorted(
            (str(k), _width(v)) for k, v in pairs)))
        object.__setattr__(self, "candidates", tuple(
            _width(c) for c in self.candidates))
        if self.group_size <= 0:
            raise ValueError(
                f"group_size must be positive, got {self.group_size}")

    @property
    def is_fractional(self) -> bool:
        """A fractional average on a non-ternary format: mixed precision
        (ternary's fractional rate names a fixed layout)."""
        return self.format != "ternary" and self.bits != int(self.bits)

    @property
    def is_mixed(self) -> bool:
        return self.is_fractional or bool(self.overrides)

    @property
    def int_bits(self) -> int:
        """Stored planes per weight of a uniform spec (2 for ternary:
        sign + mask)."""
        return 2 if self.format == "ternary" else int(self.bits)

    @property
    def candidate_bits(self) -> Tuple[float, ...]:
        """Mixed-precision candidates: explicit, or floor/ceil/ceil+1 of
        ``bits``; below 2 bits the ternary rate, then max(ceil, 2) and
        one more."""
        if self.candidates:
            return tuple(sorted(set(self.candidates)))
        hi = math.ceil(self.bits)
        if self.bits < 2:
            return tuple(sorted({TERNARY_BITS, max(hi, 2), max(hi, 2) + 1}))
        lo = max(1, math.floor(self.bits))
        return tuple(sorted({lo, hi, hi + 1}))

    @property
    def overrides_map(self) -> dict:
        return dict(self.overrides)

    def replace(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["candidates"] = list(self.candidates)
        d["overrides"] = {k: v for k, v in self.overrides}
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "QuantSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        if "format" not in kw and "method" in d:
            kw["format"] = d["method"]
        unknown = sorted(set(d) - fields - {"method"})
        if unknown:
            raise ValueError(f"unknown QuantSpec fields {unknown}; "
                             f"valid: {sorted(fields)}")
        return cls(**kw)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "QuantSpec":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2) + "\n")

    @classmethod
    def load(cls, path: str) -> "QuantSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def describe(self) -> str:
        tag = f"{self.format}-{self.bits:g}bit"
        if self.is_mixed:
            tag += f" (mixed, candidates={list(self.candidate_bits)})"
        return f"{tag} g{self.group_size} backend={self.backend}"
