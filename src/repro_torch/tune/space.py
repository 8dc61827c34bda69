"""The launch choices of the port's CUDA kernels, per call.

Counterpart of ``repro.tune.space``, re-cut for what the port's
launchers vary (the reference's tile geometry and read modes are TPU
lowerings and have no counterpart here):

  * ``route`` — the body a GEMM call runs: every body whose rule takes
    the call's (rows, dtype, group size, width) is a candidate
    (``bcq_matmul`` / ``ternary_matmul``: ``gemv``, ``mma``, ``mma_dq``;
    ``lut_gemm``: ``lut``, ``mma``, ``mma_dq``);
  * ``splits`` — how many blocks share one output tile's reduction axis
    (GEMMs) or one row's table walk (paged and MLA decode);
  * ``half_lut`` — the half or the full table, on lut_gemm's ``lut``
    body only.

Paged prefill has no launch choice: it resolves to its one config.

:func:`heuristic_config` *is* today's fixed rules: it calls each
wrapper's ``route_for`` and split function (never a copy of them), so
a cold cache or ``REPRO_TORCH_TUNE=off`` launches exactly what the
wrappers launched before the tuner existed.  A split count is legal
when every split takes a whole number of units (``_lib.split_count``'s
constraint, which the launchers check): 64- or 512-column stages
(``dq_step(rows)``) on ``mma_dq``, alpha groups on ``mma``, 256-column
steps on ``gemv``, 512-column chunks on ``lut``, 16-slot tiles on paged
decode, pages on MLA decode.

Every problem is described the reference's way: GEMMs by rows ``b``,
``m`` = out_features, ``n`` = in_features, the activation ``dtype``,
``mu`` and ``group_size``; paged decode by ``b`` rows, ``m`` = kv heads,
``n`` = the table's capacity (pages x block size), ``mu`` = the GQA
group and ``group_size`` = the block size; MLA decode as paged decode
with ``m`` = query heads and ``mu`` = 1.  ``sms`` is the card's SM
count, which the split rules read.
"""
from __future__ import annotations

import dataclasses

GEMM_KERNELS = ("bcq_matmul", "lut_gemm", "ternary_matmul")
DECODE_KERNELS = ("paged_decode", "paged_decode_int8", "paged_decode_mla")
PREFILL_KERNELS = ("paged_prefill", "paged_prefill_int8")
PAGED_KERNELS = DECODE_KERNELS + PREFILL_KERNELS
KERNELS = GEMM_KERNELS + PAGED_KERNELS

# split counts the tuner tries beside the heuristic's (each snapped to a
# legal count for the call)
SPLIT_GRID = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One launch configuration.  ``route`` is "" for the one-body
    kernels; ``half_lut`` is True wherever it does not apply (lut_gemm's
    other bodies, the other kernels), so configs compare cleanly."""

    route: str = ""
    splits: int = 1
    half_lut: bool = True

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def decode_problem(kernel: str, *, b: int, h: int, hkv: int, pages: int,
                   bs: int, dtype) -> dict:
    """The problem fields of a paged or MLA decode call (the reference's
    mapping): ``m`` the kv heads (MLA: the query heads), ``n`` the
    table's capacity, ``mu`` the GQA group (MLA: 1), ``group_size`` the
    block size."""
    mla = kernel == "paged_decode_mla"
    return dict(b=b, m=h if mla else hkv, n=pages * bs, dtype=dtype,
                mu=1 if mla else h // hkv, group_size=bs)


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; known: {KERNELS}")


def routes(kernel: str, *, b: int, n: int, dtype, group_size: int) -> tuple:
    """Every body that takes the call, the wrapper's ``route_for`` first."""
    _check_kernel(kernel)
    if kernel in PAGED_KERNELS:
        return ("",)
    from repro_torch.kernels.bcq_matmul import ops as bops
    takes = {"mma": bops.mma_takes(b, dtype, group_size, n),
             "mma_dq": True}
    if kernel == "lut_gemm":
        from repro_torch.kernels.lut_gemm import ops as lops
        first = lops.route_for(b, dtype, group_size, n)
        takes["lut"] = b <= bops.DECODE_ROWS
        order = lops.ROUTES
    else:
        from repro_torch.kernels.ternary_matmul import ops as tops
        mod = bops if kernel == "bcq_matmul" else tops
        first = mod.route_for(b, dtype, group_size, n)
        takes["gemv"] = bops.gemv_takes(b, dtype, group_size, n)
        order = mod.ROUTES
    return (first,) + tuple(r for r in order if takes[r] and r != first)


def split_units(kernel: str, route: str, *, b: int, n: int,
                group_size: int) -> int:
    """How many whole units a call's reduction axis (GEMMs) or table
    (decode) holds: a split takes a whole number of them."""
    _check_kernel(kernel)
    if kernel in PREFILL_KERNELS:
        return 1
    if kernel in DECODE_KERNELS:
        if kernel == "paged_decode_mla":
            return max(1, n // group_size)
        from repro_torch.kernels.paged_attention.ops import DECODE_TILE
        return -(-n // DECODE_TILE)
    from repro_torch.kernels.bcq_matmul.ref import GEMV_STEP, dq_step
    n_groups = -(-n // group_size)
    padded = n_groups * group_size
    if route == "mma":
        return n_groups
    if route == "gemv":
        return -(-padded // GEMV_STEP)
    if route == "lut":
        from repro_torch.kernels.lut_gemm.ops import DECODE_CHUNK
        return -(-padded // DECODE_CHUNK)
    if route == "mma_dq":
        return -(-padded // dq_step(b))
    raise ValueError(f"{kernel}: unknown route {route!r}")


def heuristic_splits(kernel: str, route: str, *, b: int, m: int, n: int,
                     mu: int, group_size: int, sms: int) -> int:
    """The wrappers' split rule for one route (``mma_splits``,
    ``gemv_splits``, ``dq_splits``, lut_gemm's and paged decode's
    ``decode_splits``, ``mla_splits``)."""
    _check_kernel(kernel)
    if kernel in PREFILL_KERNELS:
        return 1
    if kernel in DECODE_KERNELS:
        from repro_torch.kernels.paged_attention import ops as pops
        pages = max(1, n // group_size)
        if kernel == "paged_decode_mla":
            return pops.mla_splits(b, m, pages, sms)
        return pops.decode_splits(b, m, max(mu, 1), pages, group_size, sms)
    from repro_torch.kernels.bcq_matmul import ops as bops
    n_groups = -(-n // group_size)
    padded = n_groups * group_size
    if route == "mma":
        return bops.mma_splits(b, m, n_groups, sms)
    if route == "gemv":
        return bops.gemv_splits(m, padded, sms)
    if route == "mma_dq":
        return bops.dq_splits(b, m, padded, sms)
    if route == "lut":
        from repro_torch.kernels.lut_gemm.ops import decode_splits
        return decode_splits(m, padded // 8, sms)
    raise ValueError(f"{kernel}: unknown route {route!r}")


def snap_splits(units: int, splits: int) -> int:
    """The largest legal split count not above ``splits`` (every split a
    whole number of ``units``, none empty)."""
    s = max(1, min(int(splits), units))
    return -(-units // -(-units // s))


def is_legal(cfg: KernelConfig, kernel: str, *, b: int, m: int, n: int,
             dtype, group_size: int) -> bool:
    """Whether the launchers take ``cfg`` for this call."""
    if cfg.route not in routes(kernel, b=b, n=n, dtype=dtype,
                              group_size=group_size):
        return False
    units = split_units(kernel, cfg.route, b=b, n=n, group_size=group_size)
    return 1 <= cfg.splits <= units and snap_splits(units, cfg.splits) == \
        cfg.splits


def _normal(kernel: str, route: str, splits: int,
            half_lut: bool) -> KernelConfig:
    return KernelConfig(route=route, splits=int(splits),
                        half_lut=bool(half_lut) if
                        (kernel, route) == ("lut_gemm", "lut") else True)


def heuristic_config(kernel: str, *, b: int, m: int, n: int, dtype,
                     mu: int = 0, group_size: int, sms: int) -> KernelConfig:
    """Today's fixed rules: ``route_for``, then that route's split rule
    (half table on)."""
    route = routes(kernel, b=b, n=n, dtype=dtype, group_size=group_size)[0]
    return _normal(kernel, route, heuristic_splits(
        kernel, route, b=b, m=m, n=n, mu=mu, group_size=group_size,
        sms=sms), True)


def clamp_config(cfg: KernelConfig, kernel: str, *, b: int, m: int, n: int,
                 dtype, mu: int = 0, group_size: int,
                 sms: int) -> KernelConfig:
    """Snap a cached config onto a call: a route that does not take the
    call becomes the heuristic's (with its split count), a split count
    snaps to the largest legal one not above it, ``half_lut`` is
    normalized."""
    legal = routes(kernel, b=b, n=n, dtype=dtype, group_size=group_size)
    if cfg.route not in legal:
        return heuristic_config(kernel, b=b, m=m, n=n, dtype=dtype, mu=mu,
                                group_size=group_size, sms=sms)
    units = split_units(kernel, cfg.route, b=b, n=n, group_size=group_size)
    return _normal(kernel, cfg.route, snap_splits(units, cfg.splits),
                   cfg.half_lut)


def candidate_configs(kernel: str, *, b: int, m: int, n: int, dtype,
                      mu: int = 0, group_size: int, sms: int,
                      max_candidates: int = 0) -> list:
    """Every legal config of one call, de-duplicated, the heuristic's
    first (so the tuner's argmin is never slower than the untuned
    path): per route the heuristic's split count, then ``SPLIT_GRID``
    snapped to legal counts; ``half_lut`` varies fastest, so a truncated
    list (``max_candidates``) still holds both tables."""
    first = heuristic_config(kernel, b=b, m=m, n=n, dtype=dtype, mu=mu,
                             group_size=group_size, sms=sms)
    out, seen = [first], {first}
    for route in routes(kernel, b=b, n=n, dtype=dtype,
                        group_size=group_size):
        units = split_units(kernel, route, b=b, n=n, group_size=group_size)
        h = heuristic_splits(kernel, route, b=b, m=m, n=n, mu=mu,
                             group_size=group_size, sms=sms)
        tables = ((True, False) if (kernel, route) == ("lut_gemm", "lut")
                  else (True,))
        for s in (h,) + SPLIT_GRID:
            for half in tables:
                cfg = _normal(kernel, route, snap_splits(units, s), half)
                if cfg not in seen:
                    seen.add(cfg)
                    out.append(cfg)
    return out[:max_candidates] if max_candidates else out
