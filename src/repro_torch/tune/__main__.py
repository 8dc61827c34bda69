"""Tune the port's GEMM launches for a model's layer shapes, on the card.

    PYTHONPATH=src python -m repro_torch.tune --arch opt_6_7b --bits 3 \\
        [--batch 8 32 128 512] [--kernels bcq_matmul lut_gemm]
    PYTHONPATH=src python -m repro_torch.tune --show

Collects every distinct (out, in) linear shape of the arch from its
config (no weights are built), tunes each per row bucket with
synthetic RTN weights of those shapes, prints one CSV row per key
(the heuristic's time, the winner's, the winner's config) and saves the
winners to the cache (``--cache`` or ``REPRO_TORCH_TUNE_CACHE``, else
``~/.cache/repro_torch/tune_cache.json``).  ``--show`` prints the cache.
Tuning needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys


def model_shapes(arch: str, full: bool) -> list:
    """Distinct (out, in) of every quantizable 2-D linear of an arch's
    config, from a model built on the meta device (no memory)."""
    import torch
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import Model
    from repro_torch.quant.api import _is_quant_leaf, walk_linears
    cfg = get_config(arch) if full else get_reduced(arch)
    with torch.device("meta"):
        model = Model(cfg, device="meta")
    shapes = []
    for path, lin in walk_linears(model):
        if _is_quant_leaf(path.rsplit("/", 1)[-1], lin.weight):
            shape = tuple(int(s) for s in lin.weight.shape)
            if shape not in shapes:
                shapes.append(shape)
    return shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="opt_6_7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (default: full widths)")
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--mu", type=int, default=4)
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 32, 128, 512])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--kernels", nargs="+",
                    default=["bcq_matmul", "lut_gemm"],
                    choices=["bcq_matmul", "lut_gemm", "ternary_matmul"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--max-candidates", type=int, default=0)
    ap.add_argument("--cache", default=None, help="cache JSON path")
    ap.add_argument("--show", action="store_true", help="print the cache")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch import tune as T
    cache = T.TuneCache(args.cache) if args.cache else T.default_cache()
    if args.show:
        print(json.dumps({"path": cache.path, "entries": cache.entries},
                         indent=1, sort_keys=True))
        return 0
    import torch
    if not torch.cuda.is_available():
        ap.error("tuning measures kernels on the card: no CUDA device")
    from repro_torch.configs.base import ARCH_IDS
    arch = args.arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        ap.error(f"unknown --arch {args.arch!r}; known: {ARCH_IDS}")
    shapes = model_shapes(arch, not args.reduced)
    dtype = getattr(torch, args.dtype)
    print(f"# {arch}{' (reduced)' if args.reduced else ''}: {len(shapes)} "
          f"distinct linear shapes, {args.dtype} activations")
    print("kernel,b,m,n,candidates,heuristic_ms,best_ms,speedup,config")
    for m, n in shapes:
        for b in args.batch:
            for kernel in args.kernels:
                res = T.tune_shape(
                    kernel, b=b, m=m, n=n, bits=args.bits,
                    group_size=args.group_size, mu=args.mu, dtype=dtype,
                    cache=cache, reps=args.reps, warmup=args.warmup,
                    max_candidates=args.max_candidates,
                    verbose=args.verbose)
                print(f"{kernel},{b},{m},{n},{len(res.timings)},"
                      f"{res.default_time * 1e3:.4f},"
                      f"{res.best_time * 1e3:.4f},{res.speedup:.3f},"
                      f"\"{res.best.to_dict()}\"")
    print(f"# saved {len(cache)} entries -> {cache.save()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
