"""Serving launcher of the port: build, quantize on the device, serve.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt_6_7b \\
        --reduced 0 --bits 3 --engine paged --paged-kernel fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3_4b \\
        --reduced 0 --bits 3 --paged-kernel fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4_mini_3_8b \\
        --reduced 1 --device cpu --engine slots --slots 4 --cache-len 256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x7b \\
        --reduced 1 --device cpu --engine auto
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek_v2_236b --reduced 1 --device cpu --group-size 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2_7b \\
        --reduced 1 --device cpu --group-size 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba_1_5_large_398b --reduced 1 --device cpu --group-size 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral_12b \\
        --reduced 1 --device cpu --group-size 16

``--arch`` is ``opt_6_7b``, ``minicpm3_4b`` (MLA: absorbed paged decode
through its kernel; prefill on the gathered path), one of the rotary
GQA decoders ``phi4_mini_3_8b``, ``qwen1_5_32b`` and ``stablelm_1_6b``,
``mixtral_8x7b`` (sliding window and MoE layers: the slots engine;
its expert banks are quantized per expert and dequantized per call),
``deepseek_v2_236b`` (MLA and MoE layers with shared experts after a
dense layer: the paged engine), ``mamba2_2_7b`` (SSD layers, no
attention: the slots engine; its tied head is a dense bf16 matmul),
``jamba_1_5_large_398b`` (Mamba, attention and MoE layers: the slots
engine) or ``pixtral_12b`` (text-only requests: the paged engine; the
patch frontend is reached through ``Model.prefill(...,
patch_embeds=)``).  ``whisper_medium`` is refused: a request carries no
``frames`` for its encoder, on neither engine (as in the reference,
whose engines fail on it); it runs through ``Model.prefill(...,
frames=)`` and ``Model.decode_step``.
``--engine`` is ``paged`` (the block pool), ``slots`` (``ServeEngine``
over a contiguous cache of ``--slots`` rows of ``--cache-len``) or
``auto`` (paged where ``supports_paging``, else slots), as in the
reference; the paged engine's flags (``--num-blocks``,
``--block-size``, ``--max-batch``, ``--paged-kernel``) are ignored under
``slots``.

``--prefix-cache on|off`` (default on for the paged engine, as in the
reference) shares KV blocks across requests with a common
block-aligned prompt prefix (refcounted; a shared block is never
written: the first divergent or partly filled block is recomputed).
``--async`` serves through the asyncio frontend
(``serve.frontend.AsyncServeFrontend``) and the double-buffered tick:
one coroutine per request, sampling on the device, step N's host wait
after step N+1's dispatch; ``--deadline-ms`` (with ``--async``) gives
every third request that deadline.  ``--stream`` prints tokens as they
come.  ``--trace-out PATH`` writes the serving trace as Chrome
trace-event JSON (``repro_torch.obs``; ``--trace-timeline N`` also
prints N rows of the per-request timeline, ``--trace-profiler-bridge``
wraps every span in ``torch.profiler.record_function``).  These flags
need the paged engine, as in the reference.

Runs on the card by default; ``--device cpu`` runs every kernel's plain
version on the CPU (small shapes only).  Without a GPU and without
``--device cpu`` it stops with an error instead of falling back.
Weights are random, drawn from ``--seed``; quantization (BCQ, RTN or
ternary with ``--method ternary``) runs on the device, one linear at a
time.  The int8 KV cache is a config field (``kv_cache_bits=8``) reached
through the engine API, as in the reference: there is no flag for it.

The quantization spec comes from the flags, or whole from ``--spec
spec.json`` (flags override its fields), as in the reference:

  * ``--bits 2.4`` (fractional) plans mixed precision per reference leaf
    (``quant.api.plan_bits``); the printed manifest reports the achieved
    average.  Budgets below 2 mix ternary and BCQ leaves (``--bits
    1.8``); ``--bits 1.58`` leaves no room above ternary, so every leaf
    is ternary.  ``--bits 0`` serves the dense model.
  * ``--save-quantized DIR`` writes the quantized weights, spec and
    manifest as a checkpoint; ``--load-quantized DIR`` serves one (no
    quantization; checkpoints of either package load).  Weight-shape
    flags are refused with ``--load-quantized``, and the checkpoint's
    arch and model dimensions must match ``--arch``/``--reduced``;
    ``--backend`` still applies.
  * ``--manifest-json PATH`` writes the per-leaf manifest.

``--mesh auto|DxM`` serves tensor- and data-parallel over a (data,
model) mesh of ``torch.distributed`` ranks (``launch/mesh.py``), run
under ``torchrun``, the CPU included::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \
        --mesh 1x2 --bits 3 --requests 4 --max-new 4

``auto`` takes the largest (data, model) mesh over the world's ranks,
``--tp N`` pinning the model axis; ``DxM`` must multiply to the world
size.  Each rank builds the weights on the host, quantizes them there
and moves only its slice to its device; every rank runs the same
engine and only rank 0 prints, with every rank's MoE drops and host
syncs a decode step.  MLA (MiniCPM3, DeepSeek-V2), MoE (DeepSeek-V2)
and int8-KV configs serve over the mesh as GQA ones do.  The
reference's refusals hold: the mesh needs the paged engine (so no
Mamba layers, sliding window or encoder-decoder), ``--tp`` needs
``--mesh auto`` (or agrees with ``DxM``) and must divide the world
size.
"""
import argparse
import contextlib
import io
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="opt_6_7b",
                    help="opt_6_7b | minicpm3_4b | phi4_mini_3_8b | "
                         "qwen1_5_32b | stablelm_1_6b | mixtral_8x7b | "
                         "deepseek_v2_236b | mamba2_2_7b | "
                         "jamba_1_5_large_398b | pixtral_12b | "
                         "whisper_medium (refused: no engine carries "
                         "frames)")
    ap.add_argument("--reduced", type=int, default=1)
    ap.add_argument("--bits", type=float, default=None,
                    help="weight bits; fractional (e.g. 2.4) -> mixed "
                         "precision; sub-2 budgets (e.g. 1.58) mix "
                         "ternary/2/3-bit layers; 0 -> serve dense FP "
                         "(default: 4)")
    ap.add_argument("--method", "--format", dest="format", default=None,
                    choices=["bcq", "rtn", "uniform", "ternary"])
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None,
                    help="BCQ alternating-refinement rounds (default 5)")
    ap.add_argument("--spec", default="",
                    help="QuantSpec JSON file; explicit flags override")
    ap.add_argument("--save-quantized", default="",
                    help="write the quantized weights + spec/manifest to "
                         "this checkpoint dir after quantizing")
    ap.add_argument("--load-quantized", default="",
                    help="serve pre-quantized weights from this checkpoint "
                         "dir (no quantization; spec from the checkpoint)")
    ap.add_argument("--manifest-json", default="",
                    help="write the quantization manifest to this path")
    ap.add_argument("--backend", default=None,
                    help="auto | dense | bcq_xla | bcq_xla_planes | "
                         "mxu_pallas (bcq_matmul kernel) | lut_pallas "
                         "(lut_gemm kernel) | ternary_pallas "
                         "(ternary_matmul kernel, ternary weights only)")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "paged", "slots"],
                    help="auto picks paged where the model supports it "
                         "(attention-only, no SWA/enc-dec), else slots "
                         "(Mixtral, Mamba2, Jamba)")
    ap.add_argument("--slots", type=int, default=4,
                    help="[slots engine] fixed cache rows")
    ap.add_argument("--cache-len", type=int, default=256,
                    help="[slots engine] per-row KV reservation (also the "
                         "paged engine's default --max-seq-len)")
    ap.add_argument("--paged-kernel", default="auto",
                    choices=["auto", "fused", "gather"],
                    help="[paged engine] paged attention path")
    ap.add_argument("--num-blocks", type=int, default=64,
                    help="[paged engine] shared KV pool size")
    ap.add_argument("--block-size", type=int, default=16,
                    help="[paged engine] tokens per block")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="[paged engine] concurrent sequences")
    ap.add_argument("--max-seq-len", type=int, default=0,
                    help="[paged engine] per-sequence context cap "
                         "(default: --cache-len)")
    ap.add_argument("--prefix-cache", default=None, choices=["on", "off"],
                    help="[paged engine] share KV blocks across requests "
                         "with a common block-aligned prompt prefix "
                         "(default: on for the paged engine)")
    ap.add_argument("--mesh", default="",
                    help="[paged engine] serve sharded over a (data, "
                         "model) mesh of torch.distributed ranks (run "
                         "under torchrun): 'auto' (largest divisor mesh "
                         "over the world; --tp pins the model axis) or "
                         "an explicit DxM shape like 2x4")
    ap.add_argument("--tp", type=int, default=0,
                    help="model-parallel extent for --mesh auto")
    ap.add_argument("--async", dest="async_engine", action="store_true",
                    help="[paged engine] serve through the asyncio "
                         "frontend and the double-buffered tick")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="with --async: give every third request this "
                         "deadline (0: no deadlines)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated")
    ap.add_argument("--trace-out", default="",
                    help="[paged engine] write the serving trace as "
                         "Chrome trace-event JSON to this path")
    ap.add_argument("--trace-timeline", type=int, default=0, metavar="N",
                    help="with --trace-out: also print the first N rows "
                         "of the per-request timeline")
    ap.add_argument("--trace-profiler-bridge", action="store_true",
                    help="with --trace-out: wrap host spans in "
                         "torch.profiler.record_function")
    ap.add_argument("--pretune", action="store_true",
                    help="tune every GEMM call of the model into the tuning "
                         "cache (REPRO_TORCH_TUNE_CACHE) before serving; "
                         "needs the card")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-json", default="")
    return ap


def build_spec(args):
    """The QuantSpec from ``--spec`` and the flags (flags win); None for a
    dense serve (``--bits 0``)."""
    from repro_torch.quant import QuantSpec, canonical_format
    if args.bits is not None and args.bits == 0:
        return None
    try:
        base = QuantSpec.load(args.spec) if args.spec else QuantSpec()
        kw = {}
        if args.bits is not None:
            kw["bits"] = args.bits
        elif args.format is not None and \
                canonical_format(args.format) != base.format:
            # a new format without --bits takes that format's default
            kw["bits"] = None
        if args.format is not None:
            kw["format"] = args.format
        if args.group_size is not None:
            kw["group_size"] = args.group_size
        if args.iters is not None:
            kw["iters"] = args.iters
        if args.backend is not None:
            kw["backend"] = args.backend
        spec = base.replace(**kw) if kw else base
    except ValueError as e:
        raise SystemExit(f"invalid quant flags: {e}")
    return None if spec.bits == 0 else spec


def load_checkpoint(args, cfg, device):
    """(model, spec, manifest) from ``--load-quantized``, refusing the
    flags that describe stored weights and a checkpoint of another arch
    or size."""
    from repro_torch.quant.checkpoint import load_quantized
    from repro_torch.models import from_jax_params
    fixed = {"--bits": args.bits, "--method": args.format,
             "--group-size": args.group_size, "--iters": args.iters,
             "--spec": args.spec or None,
             "--save-quantized": args.save_quantized or None}
    bad = [k for k, v in fixed.items() if v is not None]
    if bad:
        raise SystemExit(f"{', '.join(bad)} cannot be combined with "
                         "--load-quantized: the checkpoint's weights are "
                         "already quantized (re-quantize without "
                         "--load-quantized instead)")
    params, spec, manifest, extra = load_quantized(args.load_quantized)
    if extra.get("arch") and extra["arch"] != cfg.name:
        raise SystemExit(f"checkpoint arch {extra['arch']!r} does not "
                         f"match --arch {cfg.name!r}")
    # reduced and full configs share a name: compare dimensions too
    dims = {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
            "vocab_size": cfg.vocab_size}
    bad = {k: (extra[k], v) for k, v in dims.items()
           if k in extra and extra[k] != v}
    if bad:
        raise SystemExit(
            "checkpoint model dims do not match --arch/--reduced: "
            + ", ".join(f"{k}: ckpt {a} vs cfg {b}"
                        for k, (a, b) in bad.items()))
    if args.backend is not None:
        spec = spec.replace(backend=args.backend)
    model = from_jax_params(params, cfg.replace(quant=spec), device=device)
    print(f"[launch.serve] loaded quantized checkpoint "
          f"{args.load_quantized} ({spec.describe()})")
    return model, spec, manifest


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.mesh or int(os.environ.get("RANK", "0")) == 0:
        return _main(args)
    # every rank runs the same program; only rank 0 prints the report
    with contextlib.redirect_stdout(io.StringIO()):
        return _main(args)


def _main(args):
    import numpy as np
    import torch

    from repro_torch import default_device, obs
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import Model
    from repro_torch.quant import (fallback_chain, quantize_model,
                                   save_quantized)
    from repro_torch.serve import (PagedServeEngine, Request, ServeEngine,
                                   check_servable, supports_paging)

    try:
        device = default_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[launch.serve] {e}")
    # over a mesh the full weights stay on the host: each rank moves only
    # its slice to its device
    rank_device = device
    if args.mesh:
        device = torch.device("cpu")
    if args.backend is not None:
        try:
            fallback_chain(args.backend)
        except KeyError as e:
            raise SystemExit(f"--backend: {e.args[0]}")
    if args.pretune and rank_device.type != "cuda":
        raise SystemExit("--pretune measures kernels on the card; no "
                         "kernel runs on the CPU")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    try:
        check_servable(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"[launch.serve] {e}")
    max_seq_len = args.max_seq_len or args.cache_len
    cfg = cfg.replace(max_seq_len=max(cfg.max_seq_len, max_seq_len))
    manifest = None
    if args.load_quantized:
        model, spec, manifest = load_checkpoint(args, cfg, device)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = Model(cfg, device=device).init_params(gen)
        spec = build_spec(args)
        if spec is None:
            if args.save_quantized:
                raise SystemExit("--save-quantized requires quantization "
                                 "(remove --bits 0)")
            print("[launch.serve] serving dense FP (no quantization)")
        else:
            t0 = time.time()
            try:
                manifest = quantize_model(model, spec)
            except ValueError as e:
                raise SystemExit(f"invalid quant spec: {e}")
            print(f"[launch.serve] {spec.describe()} in "
                  f"{time.time()-t0:.1f}s on {device}")
            print(f"[launch.serve] {manifest.summary()}")
            model = model.with_config(quant=spec)
            if args.save_quantized:
                path = save_quantized(
                    args.save_quantized, model, spec, manifest,
                    arch=cfg.name,
                    extra_meta={"d_model": cfg.d_model,
                                "n_layers": cfg.n_layers,
                                "vocab_size": cfg.vocab_size})
                print(f"[launch.serve] quantized checkpoint -> {path}")
    if args.manifest_json:
        if manifest is not None:
            manifest.save(args.manifest_json)
            print(f"[launch.serve] manifest -> {args.manifest_json}")
        else:
            print("[launch.serve] warning: --manifest-json ignored (no "
                  "manifest: dense serve, or checkpoint saved without one)")
    print(f"[launch.serve] {cfg.name}: {model.n_params():,} stored "
          f"elements, backend preference {model.cfg.backend_preference}")
    engine = args.engine
    if engine == "auto":
        engine = "paged" if supports_paging(cfg) else "slots"
        print(f"[launch.serve] engine=auto -> {engine}")
    # the reference's refusals
    mesh = None
    if args.mesh:
        if engine != "paged":
            raise SystemExit("--mesh requires the paged engine "
                             "(SSM/hybrid, enc-dec and sliding-window "
                             "models serve single-device for now)")
        from repro_torch.launch.mesh import make_mesh, parse_mesh_shape
        try:
            shape = parse_mesh_shape(args.mesh, tp=args.tp)
        except ValueError as e:
            raise SystemExit(str(e))
        mesh = make_mesh(shape, ("data", "model"),
                         device_type=rank_device.type)
        print(f"[launch.serve] mesh {dict(zip(mesh.axis_names, mesh.shape))}"
              f" over {mesh.size_total} ranks, backend {mesh.backend}")
    elif args.tp:
        raise SystemExit("--tp only applies with --mesh auto")
    if args.prefix_cache is not None and engine != "paged":
        raise SystemExit("--prefix-cache requires the paged engine "
                         "(the slots engine has no shared KV pool)")
    if args.async_engine and engine != "paged":
        raise SystemExit("--async requires the paged engine (the slots "
                         "engine has no double-buffered tick)")
    if args.deadline_ms and not args.async_engine:
        raise SystemExit("--deadline-ms requires --async")
    tracer = None
    if args.trace_out:
        if engine != "paged":
            raise SystemExit("--trace-out requires the paged engine "
                             "(the slots engine has no trace hooks)")
        tracer = obs.Tracer(profiler_bridge=args.trace_profiler_bridge)
    elif args.trace_timeline or args.trace_profiler_bridge:
        raise SystemExit("--trace-timeline/--trace-profiler-bridge "
                         "require --trace-out")
    if engine == "paged":
        eng = PagedServeEngine(model, num_blocks=args.num_blocks,
                               block_size=args.block_size,
                               max_batch=args.max_batch,
                               max_seq_len=max_seq_len,
                               prefill_buckets=(16, 32, 64),
                               paged_kernel=args.paged_kernel,
                               prefix_cache=args.prefix_cache != "off",
                               rng_seed=args.seed, tracer=tracer,
                               pretune=args.pretune, mesh=mesh)
        print(f"[launch.serve] paged-kernel={args.paged_kernel} -> decode "
              f"path: {eng.decode_path}  prefill path: {eng.prefill_path}")
    else:
        eng = ServeEngine(model, slots=args.slots, cache_len=args.cache_len,
                          prefill_buckets=(16, 32, 64), rng_seed=args.seed,
                          pretune=args.pretune)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 24)),))
               for _ in range(args.requests)]
    on_token = None
    if args.stream:
        on_token = lambda tok, req: print(f"  [stream] req {req.uid} "
                                          f"+tok {tok}")
    t0 = time.time()
    if args.async_engine:
        done = _run_async_demo(eng, prompts, args)
    else:
        done = eng.run([Request(uid=i, prompt=p, max_new_tokens=args.max_new,
                                on_token=on_token)
                        for i, p in enumerate(prompts)])
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[launch.serve] {len(done)} requests, {toks} tokens, "
          f"{toks/dt:.1f} tok/s on {rank_device}")
    if mesh is not None:
        if not mesh.same_on_all(eng.host_state()):
            raise SystemExit("[launch.serve] the ranks' host state diverged")
        if not mesh.same_within(eng.pool_state(), "model"):
            raise SystemExit("[launch.serve] the pool leaves a model group "
                             "holds whole diverged")
        print(f"[launch.serve] rank 0: {mesh.collectives} collectives "
              f"({mesh.comm_s:.3f} s), {mesh.host_syncs} staged through "
              f"host memory; decode path {eng.decode_path}")
        for r, rep in enumerate(mesh.gather_objects(eng.rank_report())):
            print(f"[launch.serve] rank {r}: MoE drops {rep['moe_drops']}, "
                  f"host syncs a decode step "
                  f"{rep['host_syncs_per_step']:g}")
    if engine == "paged":
        s = eng.metrics.summary()
        print(f"[launch.serve] ttft p50={s['ttft_s']['p50']*1e3:.1f}ms  "
              f"per-token p50={s['per_token_s']['p50']*1e3:.1f}ms  "
              f"preempted={s['counters']['preempted']}")
        print(f"[launch.serve] device busy fraction="
              f"{s['device_busy_fraction']:.2f}  "
              f"cancelled={s['counters']['cancelled']} "
              f"deadline-expired={s['counters']['deadline_expired']}")
        if eng.prefix is not None:
            pc = s["prefix_cache"]
            print(f"[launch.serve] prefix cache: hit-rate "
                  f"{pc['hit_rate']:.2f}  blocks saved {pc['blocks_saved']}"
                  f"  tokens saved {pc['tokens_saved']}")
        if args.metrics_json:
            eng.metrics.to_json(args.metrics_json)
            print(f"[launch.serve] metrics -> {args.metrics_json}")
        if tracer is not None:
            obs.save_chrome(tracer, args.trace_out)
            print(f"[launch.serve] trace -> {args.trace_out} "
                  f"({len(tracer.events)} events, {tracer.dropped} "
                  f"dropped)")
            if args.trace_timeline:
                print(obs.format_timeline(tracer,
                                          max_rows=args.trace_timeline))
    elif args.metrics_json:
        print("[launch.serve] warning: --metrics-json ignored (the slots "
              "engine keeps no serving metrics, as in the reference)")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return done


def _run_async_demo(eng, prompts, args):
    """Serve ``prompts`` through :class:`AsyncServeFrontend`: one
    submitting coroutine per request beside the engine loop, every token
    read from its handle's stream, and with ``--deadline-ms`` a deadline
    on every third request."""
    import asyncio

    from repro_torch.serve import AsyncServeFrontend

    fe = AsyncServeFrontend(eng, max_queue=max(8, 2 * len(prompts)))

    async def client(i, prompt):
        dl = args.deadline_ms if args.deadline_ms and i % 3 == 2 else None
        h = await fe.submit(prompt, max_new_tokens=args.max_new,
                            deadline_ms=dl)
        async for tok in h:
            if args.stream:
                print(f"  [stream] req {h.uid} +tok {tok}")
        return await h.wait()

    async def run():
        loop = asyncio.ensure_future(fe.serve_forever())
        try:
            return await asyncio.gather(
                *(client(i, p) for i, p in enumerate(prompts)))
        finally:
            fe.close()
            await loop

    done = asyncio.run(run())
    expired = [r.uid for r in done if r.error == "deadline"]
    if expired:
        print(f"[launch.serve] deadline expired: {len(expired)} requests "
              f"{expired}")
    return done


if __name__ == "__main__":
    main()
