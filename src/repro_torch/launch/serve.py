"""Serving launcher of the port: build, quantize on the device, serve.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt_6_7b \\
        --reduced 0 --bits 3 --engine paged --paged-kernel fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3_4b \\
        --reduced 0 --bits 3 --paged-kernel fused

``--arch`` is ``opt_6_7b`` or ``minicpm3_4b`` (MLA: absorbed paged
decode through its kernel; prefill on the gathered path).

Runs on the card by default; ``--device cpu`` runs every kernel's plain
version on the CPU (small shapes only).  Without a GPU and without
``--device cpu`` it stops with an error instead of falling back.
Weights are random, drawn from ``--seed``; quantization (BCQ, RTN or
ternary with ``--method ternary``) runs on the device, one linear at a
time.  The int8 KV cache is a config field (``kv_cache_bits=8``) reached
through the engine API, as in the reference: there is no flag for it.
"""
import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="opt_6_7b",
                    help="opt_6_7b | minicpm3_4b")
    ap.add_argument("--reduced", type=int, default=1)
    ap.add_argument("--bits", type=float, default=None,
                    help="weight bits (integer; 0 -> serve dense; "
                         "default 4; ternary: 1.58)")
    ap.add_argument("--method", "--format", dest="format", default=None,
                    choices=["bcq", "rtn", "uniform", "ternary"])
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--backend", default=None,
                    help="auto | dense | bcq_xla | bcq_xla_planes | "
                         "mxu_pallas (bcq_matmul kernel) | lut_pallas "
                         "(lut_gemm kernel) | ternary_pallas "
                         "(ternary_matmul kernel, ternary weights only)")
    ap.add_argument("--engine", default="paged", choices=["paged"])
    ap.add_argument("--paged-kernel", default="auto",
                    choices=["auto", "fused", "gather"])
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-json", default="")
    return ap


def build_spec(args):
    from repro_torch.quant import QuantSpec
    if args.bits is not None and args.bits == 0:
        return None
    kw = {}
    if args.bits is not None:
        kw["bits"] = args.bits
    if args.format is not None:
        kw["format"] = args.format
    if args.group_size is not None:
        kw["group_size"] = args.group_size
    if args.backend is not None:
        kw["backend"] = args.backend
    try:
        return QuantSpec(**kw)
    except ValueError as e:
        raise SystemExit(f"invalid quant flags: {e}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from repro_torch import default_device
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import Model
    from repro_torch.quant import fallback_chain, quantize_model
    from repro_torch.serve import PagedServeEngine, Request

    try:
        device = default_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[launch.serve] {e}")
    if args.backend is not None:
        try:
            fallback_chain(args.backend)
        except KeyError as e:
            raise SystemExit(f"--backend: {e.args[0]}")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(max_seq_len=max(cfg.max_seq_len, args.max_seq_len))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Model(cfg, device=device).init_params(gen)
    spec = build_spec(args)
    if spec is None:
        print("[launch.serve] serving dense FP (no quantization)")
    else:
        t0 = time.time()
        manifest = quantize_model(model, spec)
        print(f"[launch.serve] {spec.describe()} in {time.time()-t0:.1f}s "
              f"on {device}")
        print(f"[launch.serve] {manifest.summary()}")
        model = model.with_config(quant=spec)
    print(f"[launch.serve] {cfg.name}: {model.n_params():,} stored "
          f"elements, backend preference {model.cfg.backend_preference}")
    eng = PagedServeEngine(model, num_blocks=args.num_blocks,
                           block_size=args.block_size,
                           max_batch=args.max_batch,
                           max_seq_len=args.max_seq_len,
                           prefill_buckets=(16, 32, 64),
                           paged_kernel=args.paged_kernel)
    print(f"[launch.serve] paged-kernel={args.paged_kernel} -> decode path: "
          f"{eng.decode_path}  prefill path: {eng.prefill_path}")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 24)),))
               for _ in range(args.requests)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=args.max_new)
            for i, p in enumerate(prompts)]
    t0 = time.time()
    done = eng.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[launch.serve] {len(done)} requests, {toks} tokens, "
          f"{toks/dt:.1f} tok/s on {device}")
    s = eng.metrics.summary()
    print(f"[launch.serve] ttft p50={s['ttft_s']['p50']*1e3:.1f}ms  "
          f"per-token p50={s['per_token_s']['p50']*1e3:.1f}ms  "
          f"preempted={s['counters']['preempted']}")
    if args.metrics_json:
        eng.metrics.to_json(args.metrics_json)
        print(f"[launch.serve] metrics -> {args.metrics_json}")
    return done


if __name__ == "__main__":
    main()
