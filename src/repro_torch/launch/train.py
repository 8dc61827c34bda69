"""Training launcher of the port (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch opt_6_7b \\
        --reduced 1 --steps 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt_6_7b \\
        --reduced 0 --layers 8 --steps 20 --global-batch 8 --seq-len 512
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --reduced 1 --device cpu --mesh 2x1

Random weights (``TrainConfig.seed``), the synthetic corpus
(``SyntheticLM``, seed 0), AdamW at lr 3e-4 with the reference's warmup
(``min(100, steps // 10 + 1)``) and cosine decay to ``--steps``, an
async checkpoint every 50 steps and at the end into ``--ckpt-dir``
(resumed from where one is found).  ``--layers N`` keeps the full width
at a cut depth; ``--device`` is ``cuda`` by default (an error without a
card) or ``cpu``.  ``--mesh DxM`` runs under ``torchrun`` (one process a
rank) with the reference's rules, ``make_rules(fsdp=bool(--fsdp),
act_shard=True)``: the global batch is split over ``data``, the layers
run tensor-parallel over ``model``, with ``--fsdp 1`` (the default) the
weights and both AdamW moments are cut over ``data`` too, and each
checkpointed block keeps only its ``model`` slice of its input.  The
model is built on the meta device and each rank draws only its slices
of the seed's weights.  Mamba and encoder-decoder configs train on a
(D, 1) mesh only (refused by name otherwise).  Only rank 0 prints.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --reduced 1 --device cpu --mesh 2x2
"""
import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt_6_7b")
    ap.add_argument("--reduced", type=int, default=1,
                    help="1 = reduced config (CPU), 0 = full config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (full width kept)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="e.g. '2x1' for a data x model mesh (torchrun)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import default_device
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           check_trainable_mesh)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    mesh = rules = None
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh
        try:
            mesh = parse_mesh(args.mesh,
                              device_type=torch.device(args.device).type)
            check_trainable_mesh(mesh, cfg)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        rules = make_rules(fsdp=bool(args.fsdp), act_shard=True)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)

    # over a mesh the model starts on the meta device: each rank keeps
    # only its slices of the weights it draws
    model = Model(cfg, device="meta" if mesh is not None
                  else default_device(args.device))
    say(f"[launch.train] {cfg.name}: {model.n_params():,} params "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}) on "
        f"{mesh.device if mesh is not None else model.device}")
    data_shard, data_shards = 0, 1
    if mesh is not None:
        data_shard, data_shards = mesh.index("data"), mesh.size("data")
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                       global_batch=args.global_batch, seed=0,
                       data_shard=data_shard, data_shards=data_shards)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=50,
                       ckpt_dir=args.ckpt_dir,
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression,
                       fsdp=bool(args.fsdp))
    ocfg = adamw.AdamWConfig(lr=3e-4,
                             warmup_steps=min(100, args.steps // 10 + 1),
                             total_steps=args.steps)
    trainer = Trainer(model, ocfg, tcfg, mesh=mesh, rules=rules)
    if mesh is not None:
        plan = trainer.plan
        say(f"[launch.train] mesh {dict(zip(mesh.axis_names, mesh.shape))}"
            f", fsdp={args.fsdp}, act_shard on: global batch "
            f"{args.global_batch} split over data; this rank holds "
            f"{plan.nbytes() / 1e6:.2f} MB of weights and "
            f"{2 * plan.nbytes(dtype=torch.float32) / 1e6:.2f} MB of AdamW "
            f"moments, of {plan.nbytes(whole=True) / 1e6:.2f} and "
            f"{2 * plan.nbytes(whole=True, dtype=torch.float32) / 1e6:.2f}"
            " MB unsharded")
    state, hist = trainer.run(pipe)
    final = f"final loss {hist[-1]['loss']:.4f}" if hist else "no new steps"
    say(f"[launch.train] finished at step {int(state['step'])}, {final}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
