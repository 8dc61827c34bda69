"""Execution-backend registry: capability negotiation + fallback chain.

Counterpart of ``repro.quant.backends``, with the same registry,
``AUTO_CHAIN`` and ``FALLBACK_CHAINS``.  Each backend declares

  * ``available()`` — can it run at all here.  The CUDA kernels' wrappers
    run their plain versions on CPU tensors, so they are always available;
  * ``native()``    — is it the hardware-native path: for the kernels, a
    CUDA device with capability (9, 0) (the reference asks for a TPU);
  * ``supports(w)`` — per-weight capability, asked of the kernels'
    capability probe (``repro_torch.tune.dispatch.
    kernel_unsupported_reason``, as the reference's registry asks
    ``repro.tune.dispatch``): ``group_size % 8 == 0`` (which covers the
    LUT kernel's ``group_size % mu``), 1..8 planes, and the two-way kind
    rule: ``ternary_matmul`` takes only ternary bundles, ``bcq_matmul``
    and ``lut_gemm`` never do.

An explicit kernel preference on a host without the card resolves to
the kernel's wrapper, which runs its plain version on the CPU tensors it
is given: the one place this dispatch differs from the reference (CUDA
has no interpret mode).  Capability negotiation may still send an
unsupported *shape* down the chain; a build or launch failure never does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import lut_gemm as _lg
from repro_torch.core.plane import PlaneBundle
from repro_torch.tune.dispatch import kernel_unsupported_reason


@functools.lru_cache(maxsize=1)
def on_h100() -> bool:
    """True when a CUDA device with compute capability (9, 0) is present."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0))


@dataclasses.dataclass(frozen=True)
class BackendInfo:
    name: str
    execute: Callable[..., torch.Tensor]
    supports: Callable[[PlaneBundle], bool]
    available: Callable[[], bool]
    native: Callable[[], bool]
    kernel: Optional[str] = None
    description: str = ""


_REGISTRY: Dict[str, BackendInfo] = {}

AUTO_CHAIN: Tuple[str, ...] = ("ternary_pallas", "mxu_pallas", "lut_pallas",
                               "bcq_xla", "dense")

FALLBACK_CHAINS: Dict[str, Tuple[str, ...]] = {
    "ternary_pallas": ("ternary_pallas", "bcq_xla", "dense"),
    "mxu_pallas": ("mxu_pallas", "bcq_xla", "dense"),
    "lut_pallas": ("lut_pallas", "bcq_xla", "dense"),
    "bcq_xla": ("bcq_xla", "dense"),
    "bcq_xla_planes": ("bcq_xla_planes", "bcq_xla", "dense"),
    "dense": ("dense",),
    "auto": AUTO_CHAIN,
}


def register_backend(info: BackendInfo,
                     chain: Optional[Tuple[str, ...]] = None) -> BackendInfo:
    _REGISTRY[info.name] = info
    if chain is not None:
        FALLBACK_CHAINS[info.name] = chain
    elif info.name not in FALLBACK_CHAINS:
        FALLBACK_CHAINS[info.name] = (info.name, "bcq_xla", "dense")
    return info


def get_backend(name: str) -> BackendInfo:
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def fallback_chain(preference: Optional[str]) -> Tuple[str, ...]:
    pref = preference or "auto"
    if pref not in FALLBACK_CHAINS:
        raise KeyError(f"unknown backend preference {pref!r}; known: "
                       f"{sorted(FALLBACK_CHAINS)}")
    return FALLBACK_CHAINS[pref]


def resolve_backend(preference: Optional[str], w: PlaneBundle) -> str:
    """First backend of the preference's chain that can run ``w``: the
    head of an explicit chain needs ``available()``, every other entry
    (and all of ``auto``) needs ``native()``."""
    pref = preference or "auto"
    for i, name in enumerate(fallback_chain(pref)):
        info = get_backend(name)
        explicit = i == 0 and pref != "auto"
        usable = info.available() if explicit else info.native()
        if usable and info.supports(w):
            return name
    return "dense"


def execute_linear(x: torch.Tensor, w, *, backend: Optional[str] = None,
                   out_dtype=None) -> torch.Tensor:
    """y = x @ W^T for a dense tensor or a PlaneBundle."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, PlaneBundle) and w.packed.ndim != 3:
        # an expert bank ([E, q, out, in/8]) is no linear: ``moe_apply``
        # dequantizes it one expert at a time, as the reference does
        raise ValueError(f"execute_linear takes 2-D weights; got a bundle "
                         f"with packed {tuple(w.packed.shape)}")
    if not isinstance(w, PlaneBundle):
        # operands in x's dtype, products and sums in f32 (the reference's
        # preferred_element_type=f32), rounded once to out_dtype
        y = torch.matmul(x.float(), w.to(x.dtype).float().T)
        return y.to(out_dtype)
    return get_backend(resolve_backend(backend, w)).execute(x, w, out_dtype)


def matmul_unsupported_reason(kernel: str, w: PlaneBundle) -> Optional[str]:
    """The capability probe's answer for one weight (an expert bank's
    leading axis makes it no linear: ``lead``)."""
    return kernel_unsupported_reason(
        kernel, m=w.out_features, n=w.in_features, group_size=w.group_size,
        bits=w.bits, kind=w.kind, lead=w.packed.ndim - 3)



def _supports_any(w) -> bool:
    return True


def _supports_planes(w) -> bool:
    return w.kind == "bcq"


def _supports_kernel(kernel: str):
    return lambda w: matmul_unsupported_reason(kernel, w) is None


def _exec(name: str):
    def run(x, w, out_dtype):
        return _lg.bcq_apply(x, w, backend=name, out_dtype=out_dtype)
    return run


register_backend(BackendInfo(
    name="dense", execute=_exec("dense"), supports=_supports_any,
    available=lambda: True, native=lambda: True,
    description="dequantize to f32 and matmul"))
register_backend(BackendInfo(
    name="bcq_xla", execute=_exec("bcq_xla"), supports=_supports_any,
    available=lambda: True, native=lambda: True,
    description="bf16 dequantize + f32-accumulated matmul (plain PyTorch)"))
register_backend(BackendInfo(
    name="bcq_xla_planes", execute=_exec("bcq_xla_planes"),
    supports=_supports_planes, available=lambda: True,
    native=lambda: False,
    description="per-plane grouped contraction (plain PyTorch)"))
register_backend(BackendInfo(
    name="lut_pallas", execute=_exec("lut_pallas"),
    supports=_supports_kernel("lut_gemm"), available=lambda: True,
    native=on_h100, kernel="lut_gemm",
    description="FIGLUT LUT GEMM, hand-written CUDA kernel"))
register_backend(BackendInfo(
    name="mxu_pallas", execute=_exec("mxu_pallas"),
    supports=_supports_kernel("bcq_matmul"), available=lambda: True,
    native=on_h100, kernel="bcq_matmul",
    description="dequant-in-shared-memory GEMM, hand-written CUDA kernel"))
register_backend(BackendInfo(
    name="ternary_pallas", execute=_exec("ternary_pallas"),
    supports=_supports_kernel("ternary_matmul"), available=lambda: True,
    native=on_h100, kernel="ternary_matmul",
    description="ternary half-LUT GEMM with in-register sign decode, "
                "hand-written CUDA kernel"))
