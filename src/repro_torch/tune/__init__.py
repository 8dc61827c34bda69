"""Launch-config tuning and dispatch for the port's CUDA kernels.

Counterpart of ``repro.tune``.  Each kernel call of the port has a few
launch choices (the body a GEMM runs, how many blocks share a reduction
axis or a table walk, lut_gemm's table), and the best one moves with
the call's shape and the card.  This package makes the choice a
measured, cached decision, with today's fixed rules as the fallback:

  * :mod:`space`    — the configs of a call and the heuristic (the
                      wrappers' own ``route_for`` and split rules);
  * :mod:`measure`  — device time by CUDA events (spin kernel, L2 flush);
  * :mod:`autotune` — validate-then-time tuner, model pretuning;
  * :mod:`cache`    — JSON persistence keyed by (kernel, row bucket, M,
                      N, dtype, mu, group, card + kernel-source digest);
  * :mod:`dispatch` — the one resolution point every wrapper calls, and
                      the kernels' capability probe.

CLI: ``python -m repro_torch.tune --arch opt_6_7b --bits 3`` tunes every
distinct linear shape of an arch on the card and saves the winners
(``REPRO_TORCH_TUNE_CACHE`` names the file; ``REPRO_TORCH_TUNE=off``
forces the heuristic, ``auto`` tunes on a cache miss).
"""
from .space import (KERNELS, KernelConfig, candidate_configs, clamp_config,
                    heuristic_config)
from .cache import (TuneCache, bucket_batch, cache_key, default_cache,
                    device_tag, reset_default_cache)
from .measure import Timer, measure
from .dispatch import (kernel_config, kernel_supports,
                       kernel_unsupported_reason, launch_config, tune_mode)
from .autotune import (TuneResult, Timing, collect_bcq_specs, pretune_params,
                       tune, tune_shape)

__all__ = [
    "KERNELS", "KernelConfig", "candidate_configs", "clamp_config",
    "heuristic_config", "TuneCache", "bucket_batch", "cache_key",
    "default_cache", "device_tag", "reset_default_cache", "Timer",
    "measure", "kernel_config", "kernel_supports",
    "kernel_unsupported_reason", "launch_config", "tune_mode",
    "TuneResult", "Timing", "collect_bcq_specs", "pretune_params", "tune",
    "tune_shape",
]
