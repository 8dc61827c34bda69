#!/usr/bin/env python3
"""Time the GEMM bodies at the decode calls no served config reaches, on
one card, for one or more checkouts of the port taken in turns.

    python3 tools/gemm_bodies.py                       # this checkout
    python3 tools/gemm_bodies.py --tree build/parent --tree . \\
        --tree . --tree build/parent                   # parent, change x2

Each ``--tree`` is the root of a checkout: its ``src/repro_torch`` is
built into its own ``build/`` and imported in a process of its own, in
the order given, so two versions are compared on one card within one
call (all trees are built first, in parallel).  Every case runs through
the wrapper a user calls at [16384 x 4096] (BCQ-3 with offsets, or
ternary), logs the body it launched (the route counter), is held to 1e-3
of the output scale against the plain version and is timed with
``repro_torch.tune.measure.Timer`` (device time per call, L2 flushed)
beside one PyTorch call for the same function (``torch.matmul`` on the dense weight
in x's type, TF32 off) and the byte bound.  The LUT variants are also
set beside the decode tile (``bcq_matmul`` on the same weight and x,
route ``gemv``), which computes the same function.  The card's name and
power limit head the output; everything also goes to
``chiprun_out/gemm_bodies.json``.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

M, N, ROWS, TOL = 16384, 4096, 8, 1e-3

# name: (kernel, weight kind, group size, x dtype, lut_gemm's (mu, half))
CASES = {
    "1d bcq f32 g16": ("bcq_matmul", "bcq", 16, "float32", None),
    "1d bcq bf16 g16": ("bcq_matmul", "bcq", 16, "bfloat16", None),
    "8a ternary bf16 g8": ("ternary_matmul", "ternary", 8, "bfloat16", None),
    "2a lut bf16 mu4 half": ("lut_gemm", "bcq", 128, "bfloat16", (4, True)),
    "2d lut f32 mu2 full": ("lut_gemm", "bcq", 128, "float32", (2, False)),
    "lut f32 mu2 half": ("lut_gemm", "bcq", 128, "float32", (2, True)),
    "lut f32 mu4 full": ("lut_gemm", "bcq", 128, "float32", (4, False)),
    "lut f32 mu4 half": ("lut_gemm", "bcq", 128, "float32", (4, True)),
    "gemv f32 g128": ("bcq_matmul", "bcq", 128, "float32", None),
    "gemv bf16 g128": ("bcq_matmul", "bcq", 128, "bfloat16", None),
}


def worker(seed: int) -> dict:
    """Build and time every case with the checkout on sys.path."""
    import torch
    from chip_smoke import bound, routed
    from repro_torch.core import bcq
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels import _lib
    from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
    from repro_torch.kernels.lut_gemm import lut_gemm
    from repro_torch.kernels.ternary_matmul import dense_ref, ternary_matmul
    from repro_torch.quant.formats import quantize_ternary

    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.lib()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    try:
        from repro_torch.tune.measure import Timer
        timer = Timer(iters=20, warmup=3)
    except ImportError:          # a tree from before the tuner
        from chip_smoke import Timer
        timer = Timer(torch, iters=20, warmup=3)
    weights = {}
    out = {}
    for name, (kernel, kind, gs, dt, lut) in CASES.items():
        if (kind, gs) not in weights:
            wd = torch.randn((M, N), generator=gen, device="cuda") * 0.02
            weights[(kind, gs)] = (quantize_ternary(wd, group_size=gs)
                                   if kind == "ternary" else
                                   bcq.quantize(wd, bits=3, group_size=gs))
            del wd
        w = weights[(kind, gs)]
        dtype = getattr(torch, dt)
        x = torch.randn((ROWS, N), generator=gen, device="cuda").to(dtype)
        if kernel == "lut_gemm":
            fn = lambda: lut_gemm(x, w, mu=lut[0], half_lut=lut[1],
                                  out_dtype=torch.float32)
        elif kernel == "ternary_matmul":
            fn = lambda: ternary_matmul(x, w, out_dtype=torch.float32)
        else:
            fn = lambda: bcq_matmul(x, w, out_dtype=torch.float32)
        plain = (dense_ref if kind == "ternary" else bcq_matmul_ref)(
            x, w, torch.float32)
        got, route = routed(torch, kernel, fn)
        if got.shape != plain.shape or not torch.isfinite(got).all():
            raise SystemExit(f"{name}: bad output")
        rel = float((got - plain).abs().max()) / (
            float(plain.abs().max()) + 1e-12)
        if rel > TOL:
            raise SystemExit(f"{name} [{route}]: rel err {rel:.2e} > {TOL}")
        dense = dequantize(w, dtype)
        b_ms, b_by = bound(x.numel() * x.element_size() + w.nbytes()
                           + ROWS * M * 4, 2.0 * ROWS * M * N)
        out[name] = dict(kernel=kernel, route=route, rel_err=rel,
                         ms=timer(fn),
                         library_ms=timer(lambda: torch.matmul(x, dense.T)),
                         bound_ms=b_ms, bound_by=b_by)
        del dense
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append",
                    help="root of a checkout (repeatable; default: this one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(args.seed)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    print(card, flush=True)
    trees = [Path(t).resolve() for t in (args.tree or [str(ROOT)])]

    def env_for(tree):
        return dict(os.environ, PYTHONPATH=str(tree / "src"),
                    REPRO_TORCH_BUILD_DIR=str(tree / "build" / "repro_torch"))

    t0 = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import _lib; "
         "_lib.build()"], env=env_for(t)) for t in dict.fromkeys(trees)]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    print(f"built {len(builds)} tree(s) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = []
    for tree in trees:
        r = subprocess.run([sys.executable, __file__, "--worker", "--seed",
                            str(args.seed)], env=env_for(tree),
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-4000:], r.stderr[-4000:], sep="\n")
            raise SystemExit(f"the run of {tree} failed")
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        runs.append(dict(tree=str(tree), cases=json.loads(line[7:])))
    for name in CASES:
        cells = [f"{r['cases'][name]['route']} {r['cases'][name]['ms']:.4f}"
                 for r in runs]
        c = runs[0]["cases"][name]
        print(f"{name:22s} " + " | ".join(cells)
              + f" | library {c['library_ms']:.4f} | bound "
              f"{c['bound_ms']:.4f} ({c['bound_by']})", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gemm_bodies.json").write_text(json.dumps(
        dict(card=card, runs=runs), indent=1))


if __name__ == "__main__":
    main()
