"""Dry run: every (arch x shape) cell at full size, on the meta device.

Counterpart of ``repro.launch.dryrun``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral_8x7b \\
        --shape decode_32k [--multi-pod] [--quant 4] [--backend bcq_xla] \\
        [--fsdp 1] [--no-roofline] [--json-out F] [--remat 1] \\
        [--seq-shard 0] [--kv-bits 8] [--mesh DxM]

The reference lowers and compiles each cell on 256 or 512 fake XLA
devices.  Here a cell is built on ``torch.device("meta")``: the model at
full size (its quantized leaves as meta bundles laid out as
``quantize_model`` lays them out), the contiguous cache, the inputs and,
for training, the AdamW moments.  Nothing is compiled and no weight is
allocated.  Per cell:

  train_4k    -> loss, backward and the AdamW update (dense bf16 weights,
                 the reference's FSDP rules: ``embed`` over ``data``)
  prefill_32k -> ``Model.prefill`` (quantized weights, fills the cache)
  decode_32k  -> ``Model.decode_step`` (quantized, 1 token vs a 32k cache)
  long_500k   -> ``Model.decode_step`` (sub-quadratic archs only)

What it reports, per rank of the mesh (the production mesh, 16 x 16 or 2
x 16 x 16, as a shape-only stand-in: ``parallel/sharding.build_specs``
needs only ``axis_names`` and ``shape``; ``--mesh DxM`` another one):

  * argument bytes: every parameter, cache, moment and input leaf cut by
    its spec under the sharding rules (exact for what the rules split;
    the reference's GSPMD numbers include buffers the port's program may
    not hold);
  * output bytes: the logits (or training metrics) cut over the data
    axes, plus the cache (or parameters and moments) updated in place,
    which count once (``alias_bytes``);
  * ``temp_bytes``: absent (``None``).  Temporaries need a compiler's
    buffer assignment; meta tensors have none, and no figure is made up;
  * FLOPs: ``FlopCounterMode`` over one call of the step on meta tensors
    (the matmul family only), at the global batch, on two unrolled
    depths one layer-period apart, extrapolated to the full depth as the
    reference does; per rank the global count over the mesh's devices
    (an even split: replicated work is not in it).  A quantized linear
    counts as its dense product, through the plain ``bcq_xla`` path (the
    reference's default backend; a CUDA kernel is no op the counter
    sees); a MoE layer counts every expert's C capacity slots, the
    products of the reference's batched dispatch;
  * collectives: not counted.  The meta program is the unsharded one; the
    mesh's byte counters (``launch/mesh.py``) see a real mesh's run only;
  * the roofline row (H100 constants, ``roofline/analysis.py``) and
    ``useful_flops_ratio`` = MODEL_FLOPS / counted FLOPs.

``long_500k`` on a full-attention arch exits with the reference's
``SKIP:`` message.  ``train_4k`` reports the trainer's own layout too:
``launch/train.py`` still replicates the weights and moments on each rank
(ROADMAP.md queue 1, training's next cut), so the FSDP per-rank bytes
are what that cut would reach, not what the trainer holds today.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time


def _parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True,
                   help="train_4k|prefill_32k|decode_32k|long_500k")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--quant", type=int, default=4,
                   help="BCQ bits for serving shapes (0 = dense)")
    p.add_argument("--backend", default="bcq_xla",
                   help="gemm backend for quantized serving")
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--no-roofline", action="store_true",
                   help="per-rank bytes only (no FLOP count)")
    p.add_argument("--json-out", default="")
    p.add_argument("--remat", type=int, default=1)
    p.add_argument("--seq-shard", type=int, default=0,
                   help="shard train sequence dim over the model axis (SP)")
    p.add_argument("--kv-bits", type=int, default=16,
                   help="8 -> int8 KV cache (serve shapes)")
    p.add_argument("--mesh", default="",
                   help="DxM mesh instead of the production mesh (1x1: "
                        "one card)")
    return p.parse_args(argv)


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh's shape alone (what ``build_specs`` reads)."""
    shape: tuple
    axis_names: tuple

    @property
    def size_total(self) -> int:
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)


def production_mesh(multi_pod: bool = False) -> ShapeMesh:
    """16x16 (one pod, 256 devices) or 2x16x16 (two pods, 512)."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def parse_mesh(spec: str, multi_pod: bool = False) -> ShapeMesh:
    if not spec:
        return production_mesh(multi_pod)
    data, model = (int(x) for x in spec.lower().split("x"))
    return ShapeMesh((data, model), ("data", "model"))


def active_params(cfg, model) -> tuple:
    """(n_active, n_total) excluding token / position embeddings; inactive
    routed experts removed (MODEL_FLOPS convention: 6*N_active*D).
    ``model`` may hold quantized leaves: a bundle counts its dense
    weight's parameters."""
    from repro_torch.models.model import to_params
    from repro_torch.models.module import param_count
    total = param_count(to_params(model, scan_layers=False))
    embed = cfg.vocab_size * cfg.d_model
    if cfg.pos == "learned":
        embed += cfg.max_seq_len * cfg.d_model
    n_eff = total - embed
    if cfg.tie_embeddings:
        n_eff += cfg.vocab_size * cfg.d_model      # head matmul still runs
    inactive = 0
    if cfg.n_experts:
        f = cfg.moe_d_ff or cfg.d_ff
        per_expert = 3 * f * cfg.d_model
        n_moe_layers = sum(1 for i in range(cfg.n_layers)
                           if cfg.mlp_kind(i) == "moe")
        inactive = n_moe_layers * per_expert * \
            (cfg.n_experts - cfg.experts_per_token)
    return n_eff - inactive, total


def _skip_long(arch, cfg, shape_name):
    if shape_name == "long_500k" and not cfg.supports_long_context():
        raise SystemExit(f"SKIP: {arch} has no sub-quadratic path for "
                         f"long_500k (full attention) — see DESIGN.md")


def _count_backend(backend: str) -> str:
    """The backend the meta step runs: a plain one as given, a kernel
    backend through the plain path its kernel computes (``bcq_xla``)."""
    return backend if backend in ("dense", "bcq_xla", "bcq_xla_planes") \
        else "bcq_xla"


@dataclasses.dataclass
class Cell:
    """One built cell: the step (``run()`` executes it once on meta
    tensors) and the per-rank bytes of what it holds."""
    shape: object
    mesh: ShapeMesh
    rules: dict
    model: object
    run: object
    bytes: dict                  # per rank: params, cache/moments, inputs
    out_bytes: float             # per rank, outputs not updated in place
    alias_bytes: float           # per rank, outputs updated in place


def _data_extent(mesh, rules) -> int:
    axes = rules["batch"]
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.size(a) for a in axes if a in mesh.axis_names)


def build_cell(arch: str, shape_name: str, *, quant=4, backend="bcq_xla",
               fsdp=True, multi_pod=False, remat=True, scan=True,
               n_layers=None, seq_shard=False, kv_bits=16, mesh=None):
    """Everything one cell needs, on the meta device.  ``n_layers``
    overrides the depth (the FLOP extrapolation's unrolled models)."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.model import to_params
    from repro_torch.models.module import (abstract_model, cache_axes,
                                           logical_axes)
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.quant.api import abstract_quantized_params
    from repro_torch.quant.spec import QuantSpec
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    _skip_long(arch, cfg, shape_name)
    mesh = mesh or production_mesh(multi_pod)
    train = shape.kind == "train"
    rules = shd.make_rules(fsdp=fsdp and train, multi_pod=multi_pod,
                           act_shard=train)
    if seq_shard:
        rules["seq"] = "model"

    overrides = dict(remat=remat, scan_layers=scan)
    if n_layers is not None:
        overrides.update(n_layers=n_layers, scan_layers=False)
    if not train and quant:
        overrides["quant"] = QuantSpec(bits=quant,
                                       backend=_count_backend(backend))
    if not train and kv_bits != 16:
        overrides["kv_cache_bits"] = kv_bits
    model_par = mesh.size("model")
    if not train and cfg.attention == "gqa" and cfg.n_kv_heads \
            and cfg.n_kv_heads < model_par \
            and model_par % cfg.n_kv_heads == 0:
        # kv-head replication so the cache shards over TP > n_kv_heads
        # (serve shapes only; the q-head grouping must stay integral)
        r = model_par // cfg.n_kv_heads
        if cfg.n_heads % (cfg.n_kv_heads * r) == 0:
            overrides["kv_replication"] = r
    cfg = cfg.replace(**overrides)
    model = abstract_model(cfg)
    if not train and quant:
        abstract_quantized_params(model, bits=quant)

    tree = to_params(model)
    axes = logical_axes(cfg)
    n_data = _data_extent(mesh, rules)
    local = lambda t, ax: shd.local_nbytes(
        t, shd.build_specs(t, ax, mesh, rules), mesh)
    held = {"params": local(tree, axes)}
    specs = cfg.input_specs(shape)
    b = shape.global_batch
    if shape.kind == "decode":
        specs["pos"] = torch.empty((b,), dtype=torch.int32, device="meta")
    held["inputs"] = shd.local_nbytes(
        specs, shd.batch_specs(mesh, specs, rules), mesh)

    if train:
        params = model.train_params()
        opt = adamw.init_state(params)
        # the trainer's tree is the unrolled layout
        held["moments"] = 2 * local(opt.m, logical_axes(
            cfg.replace(scan_layers=False)))
        opt_cfg = adamw.AdamWConfig()

        def run():
            loss = model.loss_fn(specs)
            grads = torch.autograd.grad(loss, tree_leaves(params))
            gtree = tree_unflatten(params, list(grads))
            _, _, metrics = adamw.apply_updates(params, gtree, opt, opt_cfg)
            return metrics
        out_b = 0.0                                   # two scalars
        alias_b = held["params"] + held["moments"]
    else:
        cache = model.init_cache(b, shape.seq_len)
        held["cache"] = local(cache, cache_axes(cfg))
        if shape.kind == "prefill":
            extra = {k: v for k, v in specs.items() if k != "tokens"}

            def run():
                return model.prefill(specs["tokens"], cache, 0, **extra)
        else:
            def run():
                return model.decode_step(specs["tokens"], cache,
                                         specs["pos"])
        # the last-token logits [B, V] f32, cut over the data axes
        out_b = b * cfg.vocab_size * 4 / n_data
        alias_b = held["cache"]
    return Cell(shape=shape, mesh=mesh, rules=rules, model=model,
                run=run, bytes=held, out_bytes=out_b, alias_bytes=alias_b)


def cell_roofline(cell, flops: float):
    """The per-rank :class:`Roofline` of a built cell given the step's
    global FLOPs."""
    from repro_torch.roofline import analysis as ra
    arg_b = float(sum(cell.bytes.values()))
    out_b = cell.out_bytes + cell.alias_bytes
    return ra.Roofline(
        flops=flops / cell.mesh.size_total,
        bytes_accessed=arg_b + out_b - cell.alias_bytes,
        coll_bytes=0.0, coll_breakdown={}, arg_bytes=arg_b,
        temp_bytes=None, out_bytes=out_b, alias_bytes=cell.alias_bytes)


@functools.lru_cache(maxsize=None)
def step_flops(arch: str, shape_name: str, n_layers: int, quant: int,
               backend: str, remat: bool, kv_bits: int) -> float:
    """Global FLOPs of one step of ``arch`` at ``n_layers`` (unrolled),
    counted on the meta device; the same for every mesh."""
    from repro_torch.roofline.analysis import measure
    cell = build_cell(arch, shape_name, quant=quant, backend=backend,
                      remat=remat, n_layers=n_layers, kv_bits=kv_bits,
                      mesh=ShapeMesh((1, 1), ("data", "model")))
    _, flops, _ = measure(cell.run)
    if flops <= 0:
        raise RuntimeError(f"{arch}/{shape_name} at {n_layers} layers "
                           "counted 0 FLOPs")
    return flops


def run_cell(arch, shape_name, *, quant=4, backend="bcq_xla", fsdp=True,
             multi_pod=False, remat=True, roofline=True, seq_shard=False,
             kv_bits=16, mesh=None, capacity_bytes=None, verbose=True):
    """Build the full-size cell (per-rank bytes) and, if asked, count the
    FLOPs of two unrolled depths one layer-period apart and extrapolate.
    ``capacity_bytes`` (a card's memory) adds ``fits``.  Returns a result
    dict."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import scan_grouping
    from repro_torch.roofline import analysis as ra

    t0 = time.perf_counter()
    cfg0 = get_config(arch)
    kw = dict(quant=quant, backend=backend, fsdp=fsdp, multi_pod=multi_pod,
              remat=remat, seq_shard=seq_shard, kv_bits=kv_bits)
    mesh = mesh or production_mesh(multi_pod)
    cell = build_cell(arch, shape_name, mesh=mesh, **kw)
    shape = cell.shape
    full = cell_roofline(cell, 0.0)
    train = shape.kind == "train"
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "quant": 0 if train else quant, "mesh": list(mesh.shape),
        "per_rank_bytes": dict(cell.bytes),
        "arg_bytes": full.arg_bytes, "out_bytes": full.out_bytes,
        "alias_bytes": full.alias_bytes, "temp_bytes": None,
        "device_mem_gb": full.device_memory_gb(),
        "built": True,
    }
    if capacity_bytes:
        need = full.arg_bytes + full.out_bytes - full.alias_bytes
        result["fits"] = bool(need <= capacity_bytes)
    if train:
        result["note"] = ("per-rank bytes under the FSDP rules; the "
                          "trainer (launch/train.py) still replicates "
                          "weights and moments on every rank")
    if verbose:
        print(f"[dryrun] {arch}/{shape_name} on {mesh.shape}: per rank "
              f"{full.device_memory_gb():.2f} GiB without temporaries "
              f"({', '.join(f'{k} {v / 2**30:.2f}' for k, v in cell.bytes.items())})")

    if roofline:
        pre, period, _ = scan_grouping(cfg0)
        q = 0 if train else quant
        fl = [step_flops(arch, shape_name, pre + k * period, q, backend,
                         remat, kv_bits) for k in (1, 2)]
        rl = [dataclasses.replace(full, flops=f / mesh.size_total)
              for f in fl]
        roof = ra.extrapolate(rl[0], rl[1], 1, 2,
                              (cfg0.n_layers - pre) / period, mem=full)
        n_act, n_tot = active_params(cfg0, cell.model)
        mf = ra.model_flops(cfg0, shape, n_act, n_tot)
        useful = mf / max(roof.flops * mesh.size_total, 1e-9)
        row = roof.row()
        row.update({"model_flops_global": mf, "useful_flops_ratio": useful,
                    "n_active_params": n_act, "n_total_params": n_tot,
                    "flops_counted_at_layers": [pre + period,
                                                pre + 2 * period],
                    "collectives": "not counted (meta program unsharded)"})
        if shape.kind == "decode":
            row["analytic"] = ra.serve_analytic_bytes(
                cfg0, shape, n_act, quant or 4, n_model=mesh.size("model"),
                n_data=_data_extent(mesh, cell.rules))
        result["roofline"] = row
        if verbose:
            print(f"[dryrun] roofline (extrapolated to {cfg0.n_layers}L): "
                  f"t_comp={roof.t_compute * 1e3:.2f}ms "
                  f"t_mem={roof.t_memory * 1e3:.2f}ms -> "
                  f"{roof.bottleneck}-bound, "
                  f"useful_flops={useful:.3f}")
    result["seconds"] = time.perf_counter() - t0
    return result


def main(argv=None):
    args = _parse(argv)
    res = run_cell(args.arch, args.shape, quant=args.quant,
                   backend=args.backend, fsdp=bool(args.fsdp),
                   multi_pod=args.multi_pod, remat=bool(args.remat),
                   roofline=not args.no_roofline,
                   seq_shard=bool(args.seq_shard), kv_bits=args.kv_bits,
                   mesh=parse_mesh(args.mesh, args.multi_pod))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=2, default=str)
    print(json.dumps(res, indent=2, default=str))


if __name__ == "__main__":
    main()
