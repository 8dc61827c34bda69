"""The one point where every kernel launch of the port picks its config.

Counterpart of ``repro.tune.dispatch``.  Each wrapper of
``kernels/{bcq_matmul,lut_gemm,ternary_matmul,paged_attention}``
resolves its launch through :func:`launch_config`: arguments the caller
pinned (``route=``, ``splits=``) bypass dispatch; otherwise
:func:`kernel_config` resolves, in the reference's order:

  1. the tuned entry in the JSON cache (``cache.cache_key``), clamped to
     the call, unless tuning is off;
  2. with ``REPRO_TORCH_TUNE=auto`` and the live operands: tune on a
     miss, store and save, and return the winner;
  3. the heuristic: the wrappers' fixed rules (``space.heuristic_config``).

``REPRO_TORCH_TUNE``: ``on`` (default: cache, then heuristic), ``off``
(heuristic only, no file read) or ``auto`` (tune on a miss).  Resolution
is host arithmetic on shapes and a dictionary lookup; it never reads the
device, so it adds no host sync to a tick (``auto`` measures, and so
syncs, on a miss only).  A resolution is kept per call shape until the
mode, the cache path or the cache's contents change, and each is
recorded once on the active tracer (``obs.record_kernel_config``, with
source ``cache``, ``tuned`` or ``heuristic``).

:func:`kernel_unsupported_reason` is the capability probe of the port's
kernels (the backend registry asks it per weight), with the specific
cap that failed; each refusal is recorded once on the active tracer
(``obs.record_kernel_unsupported``).
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.obs import trace as obs_trace

from . import cache as cache_mod
from .space import (DECODE_KERNELS, KERNELS, PAGED_KERNELS, PREFILL_KERNELS,
                    KernelConfig, clamp_config, heuristic_config,
                    heuristic_splits, is_legal, routes)

ENV_MODE = "REPRO_TORCH_TUNE"


def tune_mode() -> str:
    mode = os.environ.get(ENV_MODE, "on").strip().lower()
    if mode in ("off", "0", "heuristic", "disable", "disabled"):
        return "off"
    return "auto" if mode == "auto" else "on"


# ---------------------------------------------------------------------------
# trace records, once per distinct record and active tracer
# ---------------------------------------------------------------------------

_SEEN: set = set()
_SEEN_TRACER = None


def _record_once(key: tuple, record) -> None:
    global _SEEN_TRACER
    tracer = obs_trace.get_active()
    if tracer is None:
        return
    if tracer is not _SEEN_TRACER:
        _SEEN.clear()
        _SEEN_TRACER = tracer
    if key not in _SEEN:
        _SEEN.add(key)
        record()


# ---------------------------------------------------------------------------
# capability probe
# ---------------------------------------------------------------------------


def kernel_unsupported_reason(kernel: str, *, m: int, n: int,
                              group_size: int, bits=None,
                              **caps) -> Optional[str]:
    """``None`` when the kernel can launch the problem, else the cap that
    failed.

    GEMMs (caller: ``quant.backends``): ``(m, n)`` are the weight's
    (out, in) dims; ``lead`` the weight's leading dims (an expert bank's
    1: no linear); ``group_size % 8 == 0`` (byte-granular planes), 1..8
    planes, and the ``kind`` rule: ``ternary_matmul`` takes only ternary
    bundles, ``bcq_matmul`` and ``lut_gemm`` never do.

    Paged kernels, dims remapped as the reference's: ``m`` the query
    heads, ``n`` the per-row KV capacity, ``group_size`` the block size;
    caps ``tp`` (the model axis the kernel launches per shard of: its
    extent must divide both head counts, reason ``tp``; the rest of the
    checks see the per-shard counts), ``n_kv_heads`` (reason ``heads``), ``window`` (ring caches are
    not paged: ``window``), ``latent`` (MLA prefill decompresses through
    ``kv_b``, which no prefill kernel folds: ``latent``), ``kv_dtype``
    (float or int8 pools: ``kv_dtype``), and the port's head caps,
    ``head_dim`` (decode: a multiple of 16 up to 256; bf16 prefill: up to
    256) and ``lora`` (MLA: up to 512) (reason ``head_dim``).

    Reasons: ``unknown_kernel``, ``tp``, ``heads``, ``shape``, ``window``,
    ``kv_dtype``, ``latent``, ``head_dim``, ``group_size``, ``bits``,
    ``kind``."""
    reason = _unsupported_reason(kernel, m=m, n=n, group_size=group_size,
                                 bits=bits, **caps)
    if reason is not None:
        _record_once(("unsupported", kernel, reason, m, n),
                     lambda: obs_trace.record_kernel_unsupported(
                         kernel, reason, m=m, n=n))
    return reason


def _unsupported_reason(kernel, *, m, n, group_size, bits=None, **caps):
    if kernel not in KERNELS:
        return "unknown_kernel"
    if kernel in PAGED_KERNELS:
        from repro_torch.kernels.paged_attention import ops as pops
        hkv = int(caps.get("n_kv_heads") or m)
        tp = int(caps.get("tp", 1) or 1)
        if tp < 1 or m % tp or hkv % tp:
            return "tp"
        m, hkv = m // tp, hkv // tp            # per-shard head counts
        if m < 1 or hkv < 1 or m % hkv:
            return "heads"
        if n < 1 or group_size < 1:
            return "shape"
        if caps.get("window", 0):
            return "window"
        latent = bool(caps.get("latent", False))
        if latent and kernel in PREFILL_KERNELS:
            return "latent"
        dt = caps.get("kv_dtype")
        if dt is not None and not latent:
            import torch
            if not (dt.is_floating_point or dt == torch.int8):
                return "kv_dtype"
        d = caps.get("head_dim")
        if d is not None:
            if kernel in DECODE_KERNELS and kernel != "paged_decode_mla" \
                    and (d % 16 or d > pops.DECODE_MAX_HEAD_DIM):
                return "head_dim"
            if kernel in PREFILL_KERNELS and caps.get("bf16", True) and \
                    d > pops.MMA_MAX_HEAD_DIM:
                return "head_dim"
        lora = caps.get("lora")
        if lora is not None and lora > pops.MLA_MAX_LORA:
            return "head_dim"
        return None
    if caps.get("lead", 0) or m < 1 or n < 1:
        return "shape"
    if group_size < 8 or group_size % 8:
        return "group_size"
    if bits is not None and not 1 <= bits <= 8:
        return "bits"
    kind = caps.get("kind")
    if kind is not None and (kernel == "ternary_matmul") != (kind ==
                                                             "ternary"):
        return "kind"
    return None


def kernel_supports(kernel: str, *, m: int, n: int, group_size: int,
                    bits=None, **caps) -> bool:
    """Boolean view of :func:`kernel_unsupported_reason`."""
    return kernel_unsupported_reason(kernel, m=m, n=n, group_size=group_size,
                                     bits=bits, **caps) is None


# ---------------------------------------------------------------------------
# config resolution
# ---------------------------------------------------------------------------

_MEMO: dict = {}
_MEMO_STATE: tuple = (None, None, -1)   # (mode, cache, its generation)


def kernel_config(kernel: str, *, b: int, m: int, n: int, dtype,
                  mu: int = 0, group_size: int, sms: int, device: str,
                  operands=None) -> KernelConfig:
    """Resolve the launch config of one call (see the module docstring).
    ``sms`` and ``device`` (the cache's device tag) describe the card;
    ``operands`` (the wrapper's live tensors) allow tuning on a miss
    under ``REPRO_TORCH_TUNE=auto``."""
    global _MEMO_STATE
    mode = tune_mode()
    cache = None if mode == "off" else cache_mod.default_cache()
    gen = cache.generation if cache is not None else 0
    if (_MEMO_STATE[0], _MEMO_STATE[2]) != (mode, gen) or \
            _MEMO_STATE[1] is not cache:
        _MEMO.clear()
        _MEMO_STATE = (mode, cache, gen)
    problem = (kernel, b, m, n, str(dtype), mu, group_size, sms, device)
    hit = _MEMO.get(problem)
    if hit is None:
        hit = _resolve(kernel, mode, cache, operands, b=b, m=m, n=n,
                       dtype=dtype, mu=mu, group_size=group_size, sms=sms,
                       device=device)
        if hit[1] != "tuned":
            _MEMO[problem] = hit
    cfg, source = hit
    _record_once(("config",) + problem + (source, cfg),
                 lambda: obs_trace.record_kernel_config(
                     kernel, source, cfg, b=b, m=m, n=n))
    return cfg


def _resolve(kernel, mode, cache, operands, *, b, m, n, dtype, mu,
             group_size, sms, device):
    shape = dict(b=b, m=m, n=n, dtype=dtype, mu=mu, group_size=group_size,
                 sms=sms)
    if cache is not None:
        key = cache_mod.cache_key(kernel, b=b, m=m, n=n, dtype=dtype, mu=mu,
                                  group_size=group_size, device=device)
        tuned = cache.lookup(key)
        if tuned is not None:
            return clamp_config(tuned, kernel, **shape), "cache"
        if mode == "auto" and operands is not None:
            from . import autotune
            res = autotune.tune(kernel, *operands, mu=mu or 4, cache=cache)
            cache.save()
            return clamp_config(res.best, kernel, **shape), "tuned"
    return heuristic_config(kernel, **shape), "heuristic"


def launch_config(kernel: str, *, route: Optional[str] = None,
                  splits: Optional[int] = None, b: int, m: int, n: int,
                  dtype, mu: int = 0, group_size: int, sms: int, device: str,
                  operands=None) -> KernelConfig:
    """The config a wrapper launches.  Pinned ``route`` / ``splits``
    bypass dispatch (the other one then takes the heuristic's rule); a
    pinned config the launchers would refuse raises.  Without pins,
    :func:`kernel_config` resolves."""
    shape = dict(b=b, m=m, n=n, dtype=dtype, group_size=group_size)
    if route is None and splits is None:
        return kernel_config(kernel, mu=mu, sms=sms, device=device,
                             operands=operands, **shape)
    if route is None:
        route = routes(kernel, b=b, n=n, dtype=dtype,
                       group_size=group_size)[0]
    if splits is None:
        splits = heuristic_splits(kernel, route, b=b, m=m, n=n, mu=mu,
                                  group_size=group_size, sms=sms)
    cfg = KernelConfig(route=route, splits=int(splits))
    if not is_legal(cfg, kernel, **shape):
        raise ValueError(
            f"{kernel}: pinned route={route!r} splits={splits} does not "
            f"take rows={b} out={m} in={n} {dtype} g={group_size}; routes "
            f"{routes(kernel, b=b, n=n, dtype=dtype, group_size=group_size)}")
    return cfg


def device_of(t) -> tuple:
    """(SM count, cache device tag) of the CUDA device tensor ``t`` lies
    on."""
    from repro_torch.kernels import _lib
    index = t.device.index or 0
    return _lib.sm_count(index), cache_mod.cuda_device_tag(index)


__all__ = ["ENV_MODE", "device_of", "kernel_config",
           "kernel_supports", "kernel_unsupported_reason", "launch_config",
           "tune_mode"]
