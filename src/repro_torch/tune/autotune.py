"""Measurement-driven tuner for the port's CUDA kernels.

Counterpart of ``repro.tune.autotune``.  For one call the tuner
enumerates its legal configs (``space.candidate_configs``), holds each
against the kernel's plain version (GEMMs at 1e-3 of the output scale,
f32 out; decode at its gate for the pool's type: 1e-4 in f32, 2e-2 in
bf16, 5e-2 for int8 pools), and only then times it (``measure``: CUDA
events, L2 flushed, median of ``reps``).  Here, and only here, a
candidate that fails to launch or to validate is recorded as invalid
and skipped; the wrappers themselves never catch a launch failure.
Candidate 0 is the heuristic, so the winner is never slower than the
untuned path as measured.

``pretune_params`` walks a quantized model, collects its distinct GEMM
problems (``collect_bcq_specs``) and tunes each per row bucket that is
not in the cache yet: the warm-up the engines run with ``pretune=True``
and ``python -m repro_torch.tune`` runs for an arch.  No kernel runs on
the CPU, so :func:`tune` refuses CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from . import cache as cache_mod
from .measure import measure
from .space import (DECODE_KERNELS, GEMM_KERNELS, KernelConfig,
                    candidate_configs, decode_problem)

# the decode kernels' gates (relative to the output scale), by pool type
_DECODE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int8: 5e-2}


@dataclasses.dataclass
class Timing:
    config: KernelConfig
    seconds: float          # inf when invalid
    ok: bool
    error: str = ""


@dataclasses.dataclass
class TuneResult:
    kernel: str
    key: str
    best: KernelConfig
    best_time: float
    default_time: float
    timings: list

    @property
    def speedup(self) -> float:
        """Heuristic time over the winner's (>= 1 as measured)."""
        return self.default_time / max(self.best_time, 1e-12)


def _gemm_call(kernel: str, x: torch.Tensor, w, mu: int):
    """(problem fields, run(cfg) -> f32 output, the plain version's f32
    output) of one GEMM call."""
    from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
    from repro_torch.kernels.lut_gemm import lut_gemm, lut_ref
    from repro_torch.kernels.ternary_matmul import ternary_matmul, ternary_ref
    x2 = x.reshape(-1, x.shape[-1])
    f32 = torch.float32
    if kernel == "lut_gemm":
        want = lut_ref(x2, w, mu=mu, half_lut=True, out_dtype=f32)

        def run(cfg):
            return lut_gemm(x2, w, mu=mu, half_lut=cfg.half_lut,
                            route=cfg.route, splits=cfg.splits,
                            out_dtype=f32)
    elif kernel == "bcq_matmul":
        want = bcq_matmul_ref(x2, w, out_dtype=f32)

        def run(cfg):
            return bcq_matmul(x2, w, route=cfg.route, splits=cfg.splits,
                              out_dtype=f32)
    else:
        want = ternary_ref(x2, w, out_dtype=f32)

        def run(cfg):
            return ternary_matmul(x2, w, route=cfg.route, splits=cfg.splits,
                                  out_dtype=f32)
    problem = dict(b=x2.shape[0], m=w.out_features, n=w.in_features,
                   dtype=x2.dtype, mu=mu if kernel == "lut_gemm" else 0,
                   group_size=w.group_size)
    return problem, run, want, 1e-3


def _decode_call(kernel: str, operands, scale):
    """As :func:`_gemm_call`, for the decode kernels: ``operands`` are the
    wrapper's positional tensors."""
    from repro_torch.kernels import paged_attention as pa
    f32 = torch.float32
    if kernel == "paged_decode_mla":
        q, pool, tables = operands[0], operands[2], operands[5]
        want = pa.paged_decode_mla_ref(*operands, scale=scale)

        def run(cfg):
            return pa.paged_attention_mla(*operands, scale=scale,
                                          splits=cfg.splits)
        h, hkv, bs, dt = q.shape[1], q.shape[1], pool.shape[1], pool.dtype
    else:
        q, pool = operands[0], operands[1]
        tables = operands[-2]
        int8 = kernel == "paged_decode_int8"
        op = pa.paged_attention_int8 if int8 else pa.paged_attention
        plain = pa.paged_decode_int8_ref if int8 else pa.paged_decode_ref
        want = plain(*operands, scale=scale, out_dtype=f32)

        def run(cfg):
            return op(*operands, scale=scale, out_dtype=f32,
                      splits=cfg.splits)
        h, hkv, bs = q.shape[1], pool.shape[2], pool.shape[1]
        dt = torch.bfloat16 if int8 else pool.dtype
    problem = decode_problem(kernel, b=q.shape[0], h=h, hkv=hkv,
                             pages=tables.shape[1], bs=bs, dtype=dt)
    return problem, run, want, _DECODE_TOL[pool.dtype]


def tune(kernel: str, *operands, mu: int = 4, scale: Optional[float] = None,
         reps: int = 5, warmup: int = 2, max_candidates: int = 0,
         atol: Optional[float] = None,
         cache: Optional[cache_mod.TuneCache] = None,
         verbose: bool = False) -> TuneResult:
    """Tune one call: GEMMs take ``(x, w)`` (``mu`` for lut_gemm), the
    decode kernels their wrapper's positional tensors (``scale``: MLA's
    softmax scale, required there).  Stores the winner in ``cache`` when
    one is given.  ``atol`` overrides the validation gate."""
    if kernel not in GEMM_KERNELS + DECODE_KERNELS:
        raise ValueError(f"tune: {kernel!r} has no launch choice to tune")
    if any(isinstance(t, torch.Tensor) and t.device.type != "cuda"
           for t in operands):
        raise ValueError(f"tune({kernel}): operands must lie on a CUDA "
                         "device (no kernel runs on the CPU)")
    from . import dispatch
    if kernel in GEMM_KERNELS:
        problem, run, want, tol = _gemm_call(kernel, *operands, mu)
    else:
        problem, run, want, tol = _decode_call(kernel, operands, scale)
    tol = tol if atol is None else atol
    sms, device = dispatch.device_of(operands[0])
    key = cache_mod.cache_key(kernel, device=device, **problem)
    cands = candidate_configs(kernel, sms=sms,
                              max_candidates=max_candidates, **problem)
    scale_out = float(want.abs().max()) + 1e-6
    timings = []
    for cfg in cands:
        try:
            got = run(cfg)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max()) / scale_out
            if not err <= tol:
                raise AssertionError(f"max rel err {err:.2e} > {tol:.0e}")
            timings.append(Timing(cfg, measure(lambda c=cfg: run(c), n=reps,
                                               warmup=warmup), True))
        except (RuntimeError, ValueError, AssertionError) as e:
            timings.append(Timing(cfg, float("inf"), False,
                                  f"{type(e).__name__}: {e}"))
        if verbose:
            t = timings[-1]
            state = (f"{t.seconds * 1e3:9.4f} ms" if t.ok
                     else f"INVALID ({t.error[:60]})")
            print(f"[tune] {kernel} {cfg.to_dict()} -> {state}")
    valid = [t for t in timings if t.ok]
    if not valid:
        raise RuntimeError(f"no valid config for {key} (first error: "
                           f"{timings[0].error})")
    best = min(valid, key=lambda t: t.seconds)
    default_time = timings[0].seconds if timings[0].ok else best.seconds
    result = TuneResult(kernel=kernel, key=key, best=best.config,
                        best_time=best.seconds, default_time=default_time,
                        timings=timings)
    if cache is not None:
        cache.store(key, best.config, time_s=best.seconds,
                    default_time_s=default_time,
                    speedup=round(result.speedup, 4),
                    shape=[problem["b"], problem["m"], problem["n"]],
                    n_candidates=len(cands))
    return result


# ---------------------------------------------------------------------------
# shape-level helpers (synthetic operands: the CLI and the engines' pretune)
# ---------------------------------------------------------------------------


def tune_shape(kernel: str, *, b: int, m: int, n: int, bits: int = 3,
               group_size: int = 128, mu: int = 4, dtype=torch.bfloat16,
               seed: int = 0, device="cuda", **kw) -> TuneResult:
    """Tune a synthetic GEMM call: the config depends on shapes and
    types, not on values, so RTN weights of a seeded Gaussian (ternary
    for ternary_matmul) stand in for the layer's."""
    from repro_torch.core.bcq import from_uniform
    from repro_torch.quant.formats import quantize_ternary
    gen = torch.Generator(device=device).manual_seed(seed)
    w_dense = torch.randn((m, n), generator=gen, device=device)
    x = torch.randn((b, n), generator=gen, device=device).to(dtype)
    wq = (quantize_ternary(w_dense, group_size=group_size)
          if kernel == "ternary_matmul"
          else from_uniform(w_dense, bits=bits, group_size=group_size))
    del w_dense
    return tune(kernel, x, wq, mu=mu, **kw)


def collect_bcq_specs(model) -> list:
    """Distinct (out_features, in_features, planes, group_size, kind) of
    every 2-D plane-bundle weight of ``model``'s linears (expert banks
    run no GEMM kernel)."""
    from repro_torch.core.plane import PlaneBundle
    from repro_torch.quant.api import walk_linears
    specs = []
    for _, lin in walk_linears(model):
        w = lin.weight
        if isinstance(w, PlaneBundle) and w.packed.ndim == 3:
            spec = (w.out_features, w.in_features, int(w.packed.shape[0]),
                    w.group_size, w.kind)
            if spec not in specs:
                specs.append(spec)
    return specs


def pretune_params(model, *, kernels: Sequence[str] = ("lut_gemm",),
                   batch_sizes: Sequence[int] = (1, 8), mu: int = 4,
                   dtype=torch.bfloat16,
                   cache: Optional[cache_mod.TuneCache] = None,
                   save: bool = True, verbose: bool = False, **kw) -> list:
    """Tune every distinct GEMM call a quantized model serves, per row
    bucket of ``batch_sizes``, skipping keys the cache already holds:
    ternary weights on ``ternary_matmul``, the others on each of
    ``kernels`` that reads BCQ planes.  Returns the :class:`TuneResult`
    list and saves the cache."""
    cache = cache_mod.default_cache() if cache is None else cache
    from . import dispatch
    device = model.device
    _, tag = dispatch.device_of(torch.empty(0, device=device))
    results, done = [], set()
    for m, n, bits, group_size, kind in collect_bcq_specs(model):
        use = (("ternary_matmul",) if kind == "ternary" else
               tuple(k for k in kernels if k != "ternary_matmul"))
        for b in batch_sizes:
            for kernel in use:
                key = cache_mod.cache_key(
                    kernel, b=b, m=m, n=n, dtype=dtype,
                    mu=mu if kernel == "lut_gemm" else 0,
                    group_size=group_size, device=tag)
                if key in done or key in cache:
                    continue
                done.add(key)
                res = tune_shape(kernel, b=b, m=m, n=n, bits=bits,
                                 group_size=group_size, mu=mu, dtype=dtype,
                                 device=device, cache=cache, verbose=verbose,
                                 **kw)
                results.append(res)
                if verbose:
                    print(f"[pretune] {res.key}: {res.best_time * 1e3:.4f} "
                          f"ms (x{res.speedup:.2f} over the heuristic) "
                          f"{res.best.to_dict()}")
    if save and results:
        cache.save()
    return results
