#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught to keep going):

  1. environment: card name and power limit, torch/CUDA versions,
     compute capability (must be (9, 0));
  2. build: compiles ``src/repro_torch/csrc/*.cu`` for sm_90a;
  3. kernels: each of the eight CUDA kernels against its plain PyTorch
     version at the main-path shapes (OPT-6.7B; MiniCPM3-4B for the MLA
     decode kernel and for bcq_matmul at the MiniCPM3 widths; the GEMMs
     at rows 1 and 8 and at the serve's prefill buckets 32, 128 and 512,
     each case logged with the body its wrapper routed it to), with its
     time, the plain version's time, one PyTorch library call's time and
     the card's least possible time for the same work (bytes or
     operations); ternary_matmul also to 0 error on exact inputs, on
     its three bodies, the int8 paged kernels also to 1e-4 in f32 with
     power-of-two scales; the chunked-prefill kernels (tensor cores in
     bf16) also with 8 kv heads (GQA) at C 512 and on a ragged B 3,
     C 200 chunk; the split-table decode kernels (float and int8) also
     with 8 kv heads (GQA) and with every row near max_seq_len 512;
     the float paged decode and chunked-prefill kernels also at the rotary
     GQA decoders' serve shapes (Phi-4-mini: 24 heads over 8, GQA rep 3;
     Qwen1.5-32B: 40 heads, MHA), and bcq_matmul at their GEMM shapes
     (rows 1, 8 and 512; Qwen's untied head at rows 1 and 8; Phi-4-mini's
     tied head, a dense matmul, timed) and at Mixtral-8x7B's attention
     GEMMs (rows 1, 8 and 512) and head (rows 1 and 8), DeepSeek-V2's
     GEMMs (MLA, the dense layer's MLP, the shared experts: rows 1, 8
     and 512; its head rows 1 and 8) and Mamba2-2.7B's (in_proj, a
     ragged out-tile, and out_proj: rows 1, 8 and 512; its tied head, a
     dense matmul, timed), and at Jamba-1.5-Large's, Pixtral-12B's and
     Whisper-medium's GEMMs (rows 1, 8 and 512; their untied heads rows 1
     and 8; Pixtral's paged attention shape, 32 heads over 8, is the GQA
     rep-4 case above); the MLA decode kernel also at DeepSeek-V2's
     widths (128 heads in four head tiles, lora 512, rope 64);
     the decode rows of bcq_matmul (bf16, and f32 rows 8 of every OPT and
     MiniCPM3 weight, timed beside ``torch.matmul`` in f32 and on
     bf16-cast x) and of ternary_matmul (bf16) on the tensor-core decode
     tile (route ``gemv``, each case logged with its split count); f32
     activations above 8 rows on the tensor-core tile (route ``mma``, x
     split in the kernel into three bf16 parts) for bcq_matmul, lut_gemm
     (mu 2 full table, mu 4 half table) and ternary_matmul at rows 512 on
     [16384 x 4096] and 12,000 on Whisper's [4096 x 1024], beside
     ``torch.matmul`` in f32; the bodies the tiles leave calls to, each
     held and timed at [16384 x 4096] at calls it takes: the
     dequantizing tensor-core tile (route ``mma_dq``) of bcq_matmul (f32
     and bf16 rows 8 at group size 16, its decode stage; f32 and bf16
     rows 512 at group size 8) and of ternary_matmul (bf16 rows 8, f32
     and bf16 rows 512, all at group size 8; also to 0 on exact inputs),
     each also against its walk's plain version (``dq_split_ref``), and
     lut_gemm's LUT body (route ``lut``) at the paper's LUT-size and
     hFFLUT variants (f32 rows 8: mu 2 with the full and the half table,
     mu 4 with the full table), each timed beside the decode tile on the
     same call, and its ``mma_dq`` (f32 rows 512 at group size 8); the
     split-table MLA decode kernel logged with its split count and held
     to repeat itself exactly;
  4. serve (random weights from ``--seed``; the paged engine with fused
     paged attention unless said otherwise): full-width OPT-6.7B
     BCQ-quantized on the card
     at 3 bits, g = 128, with ``--backend auto`` (bcq_matmul) and
     ``--backend lut_pallas`` (lut_gemm); OPT-6.7B ternary-quantized
     (g = 128) with an int8 KV cache and ``--backend auto``
     (ternary_matmul, int8 paged decode and prefill); full-width,
     full-depth MiniCPM3-4B, BCQ 3-bit g = 128, ``--backend auto``
     (bcq_matmul, MLA paged decode; MLA prefill is gathered, as in the
     reference).  Each run's first prefill logits are held against the
     plain path, and every kernel must have launched during the runs;
     each run prints its prefill kernel's time (phase-3 time x
     launches) beside its TTFT, and the GEMM bodies its decode steps and
     prefill chunks launched: no decode step may run the tensor-core
     tile, every bcq_matmul and ternary_matmul decode step must run the
     tensor-core decode tile (``gemv``) and nothing else, and every
     prefill chunk must run
     its linears on the tensor-core tile (all but the head's one row per
     request).  The MiniCPM3 run also reports,
     by depth, the plain bf16 path against the plain f32 path (how much
     of its bf16 logit error is bf16 rounding alone).  Two more runs
     serve full-width, full-depth OPT-6.7B under mixed-precision BCQ
     (``QuantSpec(bits=2.4)``, the paper's 2.4-bit point, and
     ``bits=1.8``, which mixes ternary and BCQ leaves), each printing its
     plan (leaf -> width), manifest and achieved average: the plan must
     hold more than one width (1.8: ternary and BCQ leaves), and every
     decode step must run all 192 linears on the decode tile
     (``bcq_matmul/gemv``, and ``ternary_matmul/gemv`` at 1.8) and every
     prefill chunk all 192 on the tensor-core tile.  Then the rotary GQA
     decoders, BCQ-3 g 128 through bcq_matmul: full-width, full-depth
     Phi-4-mini-3.8B through the paged engine (the OPT ``auto`` run's
     route gates, every decode step's 224 linears on the decode tile and
     every chunk's 224 on the tensor-core tile; the logits gated, as
     MiniCPM3's, on the f32 view, the bf16 error printed by depth) and,
     on the same weights, through the slots engine (``ServeEngine``, 8
     slots of 512: the same route and logit gates, no paged kernel
     launched; the share of greedy tokens equal to the paged run's is
     printed, not gated), then both engines again on its f32 view (the
     share of equal greedy tokens printed, not gated); and Qwen1.5-32B at
     full width and 8 of its 64 layers through the paged engine, with
     the same gates (its untied head on the decode tile); last,
     Mixtral-8x7B at full width and 8 of its 32 layers (sliding window
     4096, 8 experts top-2), BCQ-3 g 128, through the slots engine (8
     slots of 4608, a ring of 4096): the 8-request mix plus one
     4200-token prompt with 64 new tokens, whose prefill is masked by
     the window and whose decode writes past the ring's wrap; its f32
     view (expert banks dequantized to f32 too) gated within 1e-3
     against the plain path at the first prefill and at a decode step
     after the wrap, the bf16 error printed; every decode step's 33 BCQ
     linears on the decode tile and every prefill's 32 on the
     tensor-core tile (gated); the expert path (no kernel of the port:
     the reference dequantizes the banks) timed per layer at batch-8
     decode and a 512-row prefill; the assignments dropped beyond expert
     capacity in each prefill printed; DeepSeek-V2 at full width and 4
     of its 60 layers (layer 0 dense, layers 1-3 MoE: 160 experts top-6
     and 2 shared experts), BCQ-3 g 128, through the paged engine with
     the fused MLA decode kernel (its prefill gathered, as MiniCPM3's),
     gated as MiniCPM3 (f32 view within 1e-3), its expert path timed and
     its drops beyond expert capacity printed per chunk; last,
     Mamba2-2.7B at full width and depth (64 SSD layers, chunk 128),
     BCQ-3 g 128, through the slots engine (8 slots of 512): its f32
     view's first prefill gated within 1e-3, every decode step's 128
     linears on the decode tile and every prefill's 128 on the
     tensor-core tile; Jamba-1.5-Large at full width and 5 of its 72
     layers (Mamba 0-3, MoE at 1 and 3 with 16 experts top-2, attention
     at 4), BCQ-3 g 128, through the slots engine (8 slots of 512, 8 new
     tokens a request): f32 view gated within 1e-3, 22 linears a step on
     the decode tile and 21 a prefill on the tensor-core tile, its
     expert path timed and its drops printed (``serve_jamba``);
     Pixtral-12B at full width and depth (40 layers, 32 heads over 8),
     BCQ-3 g 128: text through the paged engine, gated as Phi-4-mini
     (``pixtral_paged``: 281 linears a step on the decode tile, 280 a
     chunk on the tensor-core tile, paged decode once a layer a step and
     paged prefill once a layer a chunk), then on the same weights its
     stub frontend (``pixtral_vlm``): 8 rows of 1024 random patch
     embeddings and 76 tokens through ``Model.prefill`` into a contiguous
     cache of 2048 (280 linears on the tensor-core tile at 8,800 rows)
     and 16 greedy decode steps, the f32 view's prefill gated within
     1e-3; last, Whisper-medium at full width and depth (24 encoder + 24
     decoder layers), BCQ-3 g 128, through the model API (neither engine
     serves an encoder-decoder, as in the reference): 8 rows of 1500
     random frames and a 4-token prompt through ``Model.prefill``, then
     32 greedy decode steps (``serve_whisper``): the f32 view gated
     within 1e-3 at the prefill and at the last step, 384 linears on the
     tensor-core tile in the prefill (the encoder's and the cross k/v at
     12,000 rows), 193 a step on the decode tile (the cross K/V read from
     the cache), encoder, prefill and decode-step times printed;
  5. checkpoint round trip: the 2.4-bit plan on OPT-6.7B at full width
     and 4 layers, saved by ``save_quantized`` and read back by
     ``load_quantized_model`` into a fresh model: every leaf
     bit-identical and the first prompt's greedy tokens identical; the
     write and read times and the bytes on disk are printed;
  6. training (``train_phase``; no kernel of the port: the reference
     trains dense weights, so every linear is the dense matmul and the
     backward is autograd's): OPT-6.7B at full width, ``TRAIN_LAYERS``
     (8) of 32 layers, bf16, remat, on ``SyntheticLM`` (vocab 50272, 8
     x 512 tokens), ``TRAIN_STEPS`` steps of AdamW through
     ``Trainer.run`` with one async checkpoint at the end: every loss
     finite and the mean of the last three below the first three's,
     no recovery; step p50 ms, tokens/s, the AdamW update's ms (CUDA
     events), the checkpoint's snapshot and write s and the peak
     device memory printed beside the card.  Then at full width and
     ``TRAIN_CHECK_LAYERS`` (2): the first step on the card against the
     host in f32 (1 x 64 tokens; loss and grad_norm within 1e-4); a run
     that fails at step 3 (``inject_failure_at``) and resumes from its
     async checkpoint against an uninterrupted one (final params bit for
     bit, at most one bf16 ulp on the embedding leaves, whose gradient
     ``index_put_`` accumulates; exactly the one injected recovery); and
     two ranks sharing the card over gloo on a (2, 1) mesh
     (``chip_smoke.py --train-rank-job JOB``, run beside the two
     checks before), each on its shard of the batch, against one process
     training the same global batch as two microbatches (losses and
     params within 1e-5).  Last, alone on the card (``train_sharded``):
     four ranks sharing the card over gloo on a (2, 2) mesh
     (``chip_smoke.py --train-tp-rank-job JOB``), full width,
     ``TRAIN_CHECK_LAYERS`` deep, f32, tensor parallel over ``model``,
     weights and AdamW moments cut over ``data`` (fsdp) and the remat
     stash over ``model`` (act_shard), ``TP_STEPS`` (2) steps of
     ``TP_BATCH`` x ``TP_SEQ`` tokens, against one unsharded process on
     the same global batch: each rank's init slices bit-equal to the
     unsharded init's, losses and grad norms within 1e-5 relative and
     params within ``TP_PARAM_BOUND`` (derived from the learning rate);
     each rank's slice bytes of weights and moments against the
     unsharded bytes, its collectives' count, bytes and host seconds and
     the run's seconds are printed.  Checkpoints go to
     ``build/train/`` and are deleted.  ``--train-only`` runs phase 1
     and this phase alone (``chiprun_out/train.json``);
  7. analysis (``analysis_phase``; no kernel of its own: the reference
     has none in these modules): (a) FIGLUT-I (``core/prealign.py``) at
     OPT-6.7B's three layer shapes, BCQ-3 g 128, rows 8 and 512,
     mantissa bits 11 (fp16) and 8 (bf16), TF32 off: the card's integer
     mantissas, scales and partial sums bit-identical to the host's and
     its output within the f32 rounding bound of the alpha / z
     contraction (any summation order) of the host's; the Table IV rows, FIGLUT-I and FIGLUT-F (the
     ``bcq_matmul`` kernel) against the dense dequantized product in
     f32, printed and gated at the reference's 5e-3 at mantissa bits 11;
     the plain function's time beside the card, taken after (b) has
     finished (no speed claim); (b), run in a thread beside (a)'s checks:
     ``launch/dryrun.run_cell`` for every (arch x shape) an arch
     supports (``long_500k`` only on sub-quadratic archs), at full size
     on the meta device, on the production 16 x 16 mesh and on one card
     (1 x 1), BCQ-3: one line a cell with the per-rank GB, whether it
     fits in this card's memory, FLOPs, bottleneck and roofline terms
     (no cell may count 0 FLOPs); (c) the meta prediction of OPT-6.7B
     BCQ-3 g 128's parameter bytes exactly equal to the bytes of the
     model phase 4 built on the card and to the dry run's one-card cell,
     and the ``serve_analytic_bytes`` decode bound at batch 8 printed as
     a share of phase 4's OPT ``auto`` decode-step p50.
     ``--analysis-only`` runs phase 1, the build and this phase, (c) on
     that one model built alone (``chiprun_out/analysis.json``).

``--train-mesh DxM`` (D x M cards, one rank a card over NCCL) runs
phase 1 and OPT-6.7B's training at full width and full depth (32
layers), bf16, fsdp and act_shard, ``MESH_TRAIN_STEPS`` steps of 8 x
512 tokens: per rank the step p50, tokens/s, the collectives' share of
the step's device time (CUDA events around each collective), peak
memory and its slice bytes; then one checkpoint written slice by slice
and restored on a (D x M, 1) mesh, every leaf's sum equal, where the
disk holds it (``chiprun_out/train_mesh.json``).

Every serve run gates the count of linears on the tiles: each decode
step runs all of them on the decode tile, each prefill chunk all but an
untied head's on the tensor-core tile, and so does each f32 view's
prefill (its time printed; no CUDA-core body); every logit row of every
decode step and prefill is finite; a paged run's decode step launches its
decode attention kernel once per layer, and each of its prefill chunks
its prefill kernel (where it has one) once per layer.

Phase 3 also holds bcq_matmul at q 2 and q 4 (the widths the mixed
plans use beside q 3) at OPT's three shapes on the decode tile (rows 1
and 8) and the tensor-core tile (rows 512).

Launch-config tuning (``repro_torch.tune``; every phase but these reads
a cold cache under ``build/``, so launches the wrappers' fixed rules):
phase 4 starts by tuning OPT-6.7B BCQ-3 g 128's three layer shapes at
rows 8, 32, 128 and 512 for bcq_matmul and lut_gemm (mu 4) and paged
decode at the phase-3 B 8 case (``tune_phase``: each key's heuristic
and winner times and the winner's config printed; every winner, after
the cache is reloaded from disk, resolved from it and held against its
plain version again); the first OPT run's weights are then served
through the paged engine with ``pretune=True`` on that cache and with
``REPRO_TORCH_TUNE=off``, in bf16 and on the f32 view (``serve_tuned``:
the trace holds ``cache`` config records, ``off`` only heuristic ones;
f32 greedy tokens identical; the bf16 share of equal tokens and each
run's step-kernel ms printed).  Last, OPTQ (``optq_phase``): OPT-6.7B
at full width, 4 of 32 layers, calibrated on 2 seeded random batches
(256 rows a linear) and quantized at 3 bits, g 64 on the card (seconds
per linear printed; OPTQ's calibration error at most RTN's on every
linear), served through bcq_matmul and lut_gemm with ``serve_one``'s
gates: bf16 first-prefill logits within 5e-2, the f32 view within
1e-3.

Mesh serving (``serve_sharded``, on the first OPT run's weights):
OPT-6.7B BCQ-3 at full width and ``SHARDED_SERVE_LAYERS`` deep, written
once through ``quant/checkpoint.py`` to ``build/serve_sharded/`` (deleted
after) and served over a (1, 2) mesh by two processes that share the
card over gloo (``chip_smoke.py --rank-job JOB``, each loading its
shard), through bcq_matmul, lut_gemm and on the f32 view, beside the
same requests served unsharded: every rank's decode steps and prefill
chunks on the kernels at the shard shapes (route counters), the paged
kernels once a layer on 16 heads, the pool shard's shape, finite
logits, the f32 view's first-prefill logits within 1e-3 of the
unsharded f32 view's scale; the share of equal greedy tokens (f32,
bf16), and per rank tok/s, TTFT p50, decode-step p50 and the
collectives' share of a step printed.  The same phase then serves, 4
requests x 16 new tokens in bf16 and on the f32 view, the weights of
the ternary + int8-KV OPT run (``TERNARY_SHARDED_LAYERS`` deep; 16 of 32
heads, int8 pools and their scale pools cut by kv heads), of
MiniCPM3-4B (``MINICPM3_SHARDED_LAYERS`` of 62 layers; 20 of 40 query
heads a rank on the MLA decode kernel, the latent pool whole) and of
DeepSeek-V2's 4 layers (64 of 128 heads, 80 of 160 experts a
rank, the router whole): each rank's cuts gated (``shard_gates``), the
decode attention kernel once a layer a step at the shard's heads, the
pool leaves a model group holds whole equal on its ranks, and the MoE
drops equal to the unsharded run's (on the f32 view exactly, in bf16
within ``BF16_DROPS_TOL``); per rank the host syncs a step and the
drops printed.  Phase 3 holds both BCQ GEMMs at
the tp-2 shard shapes (rows 8 and 512), the paged kernels (float and
int8) on the 16-head slice and MLA decode at 20 and 64 heads.
``--sharded-mesh DxM`` runs only the build and this phase
(``--sharded-kinds``: OPT, MiniCPM3 and DeepSeek-V2 by default) on a
DxM mesh, one rank a card (NCCL) where there are D*M cards, adding an
async OPT run whose decode-only ticks run under sync debug mode
"error".

The line before the last is a JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  Full results also go to
``chiprun_out/chip_smoke.json``.
"""
import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
# the MiniCPM3 and rotary GQA runs' gate on their f32 view
# (``serve_model``): the reference's GEMM gate, 1e-3 of the output scale
F32_LOGIT_TOL = 1e-3
# Qwen1.5-32B's serve depth (of 64): at full depth its dense bf16 weights,
# built before quantization, take ~67 GB
QWEN_SERVE_LAYERS = 8
# Mixtral-8x7B's serve depth (of 32): ~2.9 GB of bf16 weights a layer
# before quantization (the experts 2.82 GB), ~93 GB at full depth
MIXTRAL_SERVE_LAYERS = 8
# its slots engine reserves 4608 positions a row, so the ring holds the
# window (4096); one prompt of 4200 tokens is masked by the window in
# its prefill and writes past the ring's wrap in decode
MIXTRAL_CACHE_LEN = 4608
LONG_PROMPT, LONG_NEW = 4200, 64
# DeepSeek-V2's serve depth (of 60): layer 0 dense, layers 1-3 MoE; its
# 160 experts are ~7.5 GB of bf16 a layer before quantization
DEEPSEEK_SERVE_LAYERS = 4
# Jamba-1.5-Large's serve depth (of 72): layers 0-3 are Mamba layers (1
# and 3 MoE: 16 experts [24576 x 8192], ~19 GB of bf16 a layer before
# quantization), layer 4 the first attention layer; its plain expert
# path takes most of a decode step, so its requests get fewer new tokens
JAMBA_SERVE_LAYERS = 5
JAMBA_NEW_TOKENS = 8
# Pixtral-12B's VLM prefill: 8 rows of its 1024 patches and 76 text
# tokens (1100 positions a row) into a contiguous cache of 2048, then
# greedy decode steps
PIXTRAL_TEXT, PIXTRAL_CACHE_LEN, PIXTRAL_VLM_STEPS = 76, 2048, 16
# Whisper-medium: 8 rows of 1500 frames and a 4-token decoder prompt,
# then greedy decode steps
WHISPER_PROMPT, WHISPER_STEPS = 4, 32
# the engines' prefill buckets (a longer prompt rounds up to a multiple
# of the top one)
BUCKETS = (32, 128, 512)
# serving breadth: the shared prompt prefix, in 16-token blocks
PREFIX_BLOCKS = 16
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
# the kernels with several bodies, chosen by their wrappers' route_for
ROUTED = ("bcq_matmul", "lut_gemm", "ternary_matmul")


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bound(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------


def check_gemms(torch, timer, gen, results):
    from repro_torch.core import bcq
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels import _lib
    from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
    from repro_torch.kernels.bcq_matmul.ops import gemv_splits
    from repro_torch.kernels.lut_gemm import dense_ref, lut_gemm, lut_ref

    tol = 1e-3          # relative to max |plain|: the reference's gate
    # decode rows (1, 8) and the serve's prefill buckets (32, 128, 512),
    # which the wrappers route to the tensor-core tile
    rows_list = (1, 8, 32, 128, 512)
    shapes = ((4096, 4096), (16384, 4096), (4096, 16384))
    out = {"bcq_matmul": [], "lut_gemm": []}
    for m, n in shapes:
        w_dense = torch.randn((m, n), generator=gen, device="cuda") * 0.02
        w = bcq.quantize(w_dense, bits=3, group_size=128)
        del w_dense
        dense_bf16 = dequantize(w, torch.bfloat16)
        q = w.bits
        wbytes = w.nbytes()
        for rows in rows_list:
            x = (torch.randn((rows, n), generator=gen, device="cuda")
                 ).to(torch.bfloat16)
            plain = bcq_matmul_ref(x, w, out_dtype=torch.float32)
            scale = float(plain.abs().max()) + 1e-12
            nbytes = rows * n * 2 + wbytes + rows * m * 4
            flops = 2.0 * rows * m * n
            b_ms, b_by = bound(nbytes, flops)
            t_plain = timer(lambda: bcq_matmul_ref(x, w, torch.float32))
            t_lib = timer(lambda: torch.matmul(x, dense_bf16.T))
            for name, fn in (
                    ("bcq_matmul",
                     lambda: bcq_matmul(x, w, out_dtype=torch.float32)),
                    ("lut_gemm",
                     lambda: lut_gemm(x, w, out_dtype=torch.float32))):
                got, route = routed(torch, name, fn)
                if got.shape != plain.shape or not torch.isfinite(got).all():
                    fail(f"{name} [{rows}x{n}]x[{m}x{n}]^T: bad output")
                err = float((got - plain).abs().max())
                rel = err / scale
                if name == "lut_gemm" and rows == 1:
                    lr = lut_ref(x, w, mu=4, half_lut=True,
                                 out_dtype=torch.float32)
                    rel = max(rel, float((got - lr).abs().max()) / scale)
                ok = rel <= tol
                t = timer(fn)
                rec = dict(m=m, n=n, rows=rows, bits=q, route=route,
                           max_abs_err=err, rel_err=rel, tol=tol, ms=t,
                           plain_ms=t_plain, library_ms=t_lib,
                           bound_ms=b_ms, bound_by=b_by)
                split = ""
                if route == "gemv":
                    rec["splits"] = gemv_splits(m, w.n_groups * 128,
                                                _lib.sm_count(0))
                    split = f", {rec['splits']} splits"
                out[name].append(rec)
                log(f"{name:10s} rows={rows:4d} M={m:5d} N={n:5d} "
                    f"[{route}{split}]: "
                    f"err {err:.3e} (rel {rel:.2e} <= {tol:g}: {ok})  "
                    f"kernel {t:.4f} ms  plain {t_plain:.4f} ms  "
                    f"torch.matmul {t_lib:.4f} ms  bound {b_ms:.4f} ms "
                    f"({b_by})")
                if not ok:
                    fail(f"{name} disagrees with its plain version")
        f32_decode_case(torch, timer, gen, w, dense_bf16, results,
                        model="opt_6_7b")
        del w, dense_bf16
    # lut_gemm also at mu = 2 and with the full table, small and ragged
    w = bcq.from_uniform(torch.randn((33, 136), generator=gen,
                                     device="cuda"), bits=3, group_size=8)
    x = torch.randn((5, 136), generator=gen, device="cuda")
    for mu in (2, 4):
        for half in (True, False):
            got, route = routed(torch, "lut_gemm", lambda: lut_gemm(
                x, w, mu=mu, half_lut=half, out_dtype=torch.float32))
            want = dense_ref(x, w, torch.float32)
            torch.cuda.synchronize()
            rel = float((got - want).abs().max()) / float(want.abs().max())
            log(f"lut_gemm ragged mu={mu} half={half} [{route}]: "
                f"rel {rel:.2e}")
            if rel > tol:
                fail(f"lut_gemm mu={mu} half={half} disagrees")
    got, route = routed(torch, "bcq_matmul",
                        lambda: bcq_matmul(x, w, out_dtype=torch.float32))
    want = bcq_matmul_ref(x, w, torch.float32)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max()) / float(want.abs().max())
    log(f"bcq_matmul ragged f32 [{route}]: rel {rel:.2e}")
    if rel > tol:
        fail("bcq_matmul ragged f32 disagrees")
    results.update(out)


def f32_decode_case(torch, timer, gen, w, dense_bf16, results, model):
    """bcq_matmul on f32 activations at 8 rows (MiniCPM3's f32 view): the
    tensor-core decode tile (route ``gemv``, x split into three bf16
    parts in the kernel), 1e-3 of the output scale (the split leaves only
    the f32 summation order: ~1e-6 is expected), timed beside two
    library calls: ``torch.matmul`` of bf16-cast x with the dense bf16
    weight, and of the f32 x with the dense f32 weight (TF32 off), which
    computes the same function."""
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels import _lib
    from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
    from repro_torch.kernels.bcq_matmul.ops import gemv_splits
    tol, rows = 1e-3, 8
    m, n = w.out_features, w.in_features
    x = torch.randn((rows, n), generator=gen, device="cuda")
    fn = lambda: bcq_matmul(x, w, out_dtype=torch.float32)
    plain = bcq_matmul_ref(x, w, out_dtype=torch.float32)
    got, route = routed(torch, "bcq_matmul", fn)
    if route != "gemv":
        fail(f"bcq_matmul f32 rows 8 ran {route}, not gemv")
    if got.shape != plain.shape or not torch.isfinite(got).all():
        fail(f"bcq_matmul f32 [{rows}x{n}]x[{m}x{n}]^T: bad output")
    err = float((got - plain).abs().max())
    rel = err / (float(plain.abs().max()) + 1e-12)
    splits = gemv_splits(m, w.n_groups * w.group_size, _lib.sm_count(0))
    b_ms, b_by = bound(rows * n * 4 + w.nbytes() + rows * m * 4,
                       2.0 * rows * m * n)
    t = timer(fn)
    t_plain = timer(lambda: bcq_matmul_ref(x, w, torch.float32))
    t_lib = timer(lambda: torch.matmul(x.to(torch.bfloat16), dense_bf16.T))
    dense_f32 = dequantize(w, torch.float32)
    t_f32 = timer(lambda: torch.matmul(x, dense_f32.T))
    del dense_f32
    results.setdefault("bcq_matmul_f32", []).append(dict(
        m=m, n=n, rows=rows, dtype="float32", model=model, route=route,
        splits=splits, max_abs_err=err, rel_err=rel, tol=tol, ms=t,
        plain_ms=t_plain, library_ms=t_f32, library_bf16_ms=t_lib,
        bound_ms=b_ms, bound_by=b_by))
    log(f"bcq_matmul rows={rows:4d} M={m:5d} N={n:5d} f32 [{route}, "
        f"{splits} splits]: err {err:.3e} (rel {rel:.2e} <= {tol:g}: "
        f"{rel <= tol})  kernel {t:.4f} ms  plain {t_plain:.4f} ms  "
        f"torch.matmul f32 {t_f32:.4f} ms  torch.matmul (bf16) "
        f"{t_lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
    if rel > tol:
        fail("bcq_matmul f32 decode rows disagree with the plain version")


def odd_shape_cases(torch, timer, gen, results):
    """The bodies the tiles leave calls to, each held to 1e-3 of the
    output scale and timed at [16384 x 4096] at calls it takes:
    bcq_matmul's ``mma_dq`` (f32 and bf16 rows 8 at group size 16, which
    the decode tile does not take: the tile's decode stage; rows 512 at
    group size 8, which the tensor-core tile does not take; f32 and
    bf16), lut_gemm's ``lut`` at its ablation variants (f32 rows 8 at mu
    2 with the full and the half table, mu 4 with the full table; each
    also timed beside the decode tile, ``bcq_matmul`` route ``gemv``, on
    the same call, which computes the same function) and ``mma_dq`` (f32
    rows 512 at group size 8, mu 2, full table) and
    ternary_matmul's ``mma_dq`` (group size 8: bf16 rows 8, f32 and bf16
    rows 512).  The ``mma_dq`` cases are also held to 1e-3 against the
    tile's walk (``dq_split_ref`` at the wrapper's split count)."""
    from repro_torch.core import bcq
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels import _lib
    from repro_torch.kernels.bcq_matmul import (bcq_matmul, bcq_matmul_ref,
                                                dq_split_ref)
    from repro_torch.kernels.bcq_matmul.ops import dq_splits
    from repro_torch.kernels.lut_gemm import lut_gemm
    from repro_torch.kernels.ternary_matmul import dense_ref, ternary_matmul
    from repro_torch.quant.formats import quantize_ternary
    tol, m, n = 1e-3, 16384, 4096
    f32, bf16 = torch.float32, torch.bfloat16
    bcq_fn = lambda x, w: bcq_matmul(x, w, out_dtype=torch.float32)
    tern_fn = lambda x, w: ternary_matmul(x, w, out_dtype=torch.float32)
    lut_fn = lambda mu, half: lambda x, w: lut_gemm(
        x, w, mu=mu, half_lut=half, out_dtype=torch.float32)
    weights = {}
    for key, gs, rows, dtype, name, want, fn in (
            ("bcq_matmul_mma_dq_decode", 16, 8, f32, "bcq_matmul", "mma_dq",
             bcq_fn),
            ("bcq_matmul_mma_dq_decode_bf16", 16, 8, bf16, "bcq_matmul",
             "mma_dq", bcq_fn),
            ("bcq_matmul_mma_dq", 8, 512, f32, "bcq_matmul", "mma_dq",
             bcq_fn),
            ("bcq_matmul_mma_dq_bf16", 8, 512, bf16, "bcq_matmul", "mma_dq",
             bcq_fn),
            ("lut_gemm_lut_mu2_full", 128, 8, f32, "lut_gemm", "lut",
             lut_fn(2, False)),
            ("lut_gemm_lut_mu2_half", 128, 8, f32, "lut_gemm", "lut",
             lut_fn(2, True)),
            ("lut_gemm_lut_mu4_full", 128, 8, f32, "lut_gemm", "lut",
             lut_fn(4, False)),
            ("lut_gemm_mma_dq", 8, 512, f32, "lut_gemm", "mma_dq",
             lut_fn(2, False)),
            ("ternary_matmul_mma_dq", 8, 8, bf16, "ternary_matmul",
             "mma_dq", tern_fn),
            ("ternary_matmul_mma_dq_f32", 8, 512, f32, "ternary_matmul",
             "mma_dq", tern_fn),
            ("ternary_matmul_mma_dq_bf16", 8, 512, bf16, "ternary_matmul",
             "mma_dq", tern_fn)):
        tern = name == "ternary_matmul"
        if (tern, gs) not in weights:
            wd = torch.randn((m, n), generator=gen, device="cuda") * 0.02
            weights[(tern, gs)] = (
                quantize_ternary(wd, group_size=gs) if tern
                else bcq.quantize(wd, bits=3, group_size=gs))
            del wd
        w = weights[(tern, gs)]
        plain_fn = dense_ref if tern else bcq_matmul_ref
        x = torch.randn((rows, n), generator=gen, device="cuda").to(dtype)
        plain = plain_fn(x, w, torch.float32)
        got, route = routed(torch, name, lambda: fn(x, w))
        if route != want:
            fail(f"{name} {key}: ran {route}, not {want}")
        if got.shape != plain.shape or not torch.isfinite(got).all():
            fail(f"{name} {key}: bad output")
        scale = float(plain.abs().max()) + 1e-12
        err = float((got - plain).abs().max())
        rel = err / scale
        rec = dict(m=m, n=n, rows=rows, group_size=gs,
                   dtype=str(dtype).split(".")[1], route=route)
        walk = ""
        if route == "mma_dq":
            splits = dq_splits(rows, m, w.n_groups * gs, _lib.sm_count(0))
            dq_rel = float((got - dq_split_ref(x, w, splits, torch.float32)
                            ).abs().max()) / scale
            rec.update(splits=splits, dq_rel_err=dq_rel)
            walk = (f", {splits} splits; walk rel {dq_rel:.2e} <= {tol:g}: "
                    f"{dq_rel <= tol}")
            rel = max(rel, dq_rel)
        xb = x.numel() * x.element_size()
        b_ms, b_by = bound(xb + w.nbytes() + rows * m * 4,
                           2.0 * rows * m * n)
        t = timer(lambda: fn(x, w))
        t_plain = timer(lambda: plain_fn(x, w, torch.float32))
        dense = dequantize(w, dtype)
        t_lib = timer(lambda: torch.matmul(x, dense.T))
        del dense
        rec.update(max_abs_err=err, rel_err=rel, tol=tol, ms=t,
                   plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                   bound_by=b_by)
        gemv = ""
        if route == "lut":
            _, g_route = routed(torch, "bcq_matmul", lambda: bcq_fn(x, w))
            if g_route != "gemv":
                fail(f"bcq_matmul {key}'s call ran {g_route}, not gemv")
            rec["gemv_ms"] = timer(lambda: bcq_fn(x, w))
            gemv = f"  decode tile {rec['gemv_ms']:.4f} ms"
        results[key] = [rec]
        log(f"{name} rows={rows:4d} M={m:5d} N={n:5d} {rec['dtype']} "
            f"g={gs} [{route}{walk}]: err {err:.3e} (rel {rel:.2e} <= "
            f"{tol:g}: {rel <= tol})  kernel {t:.4f} ms  plain "
            f"{t_plain:.4f} ms  torch.matmul {rec['dtype']} {t_lib:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by}){gemv}")
        if rel > tol:
            fail(f"{name} {route} disagrees with its plain version")
    del weights


def f32_mma_cases(torch, timer, gen, results):
    """f32 activations above 8 rows on the tensor-core tile (route
    ``mma``, x split into three bf16 parts in the kernel), BCQ-3 g 128:
    bcq_matmul, lut_gemm at mu 2 with the full table and at mu 4 with the
    half table (the same tile), and ternary_matmul (g 128), at rows 512
    on [16384 x 4096] and at Whisper's encoder rows (12,000) on its MLP
    up projection [4096 x 1024]; each held to 1e-3 of the output scale
    (~1e-6 is expected: only the f32 summation order differs) and timed
    beside the plain version, ``torch.matmul`` in f32 (TF32 off) on the
    dense f32 weight, and the bound (operations at the bf16 rate, as for
    every GEMM row here)."""
    from repro_torch.core import bcq
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
    from repro_torch.kernels.lut_gemm import lut_gemm
    from repro_torch.kernels.ternary_matmul import dense_ref, ternary_matmul
    from repro_torch.quant.formats import quantize_ternary
    tol, out = 1e-3, []
    for m, n, rows in ((16384, 4096, 512), (4096, 1024, 12000)):
        wd = torch.randn((m, n), generator=gen, device="cuda") * 0.02
        ws = {"bcq": bcq.quantize(wd, bits=3, group_size=128),
              "ternary": quantize_ternary(wd, group_size=128)}
        del wd
        x = torch.randn((rows, n), generator=gen, device="cuda")
        for name, variant, kind, fn, plain_fn in (
                ("bcq_matmul", "", "bcq",
                 lambda w: bcq_matmul(x, w, out_dtype=torch.float32),
                 bcq_matmul_ref),
                ("lut_gemm", "mu 2, full table", "bcq",
                 lambda w: lut_gemm(x, w, mu=2, half_lut=False,
                                    out_dtype=torch.float32),
                 bcq_matmul_ref),
                ("lut_gemm", "mu 4, half table", "bcq",
                 lambda w: lut_gemm(x, w, mu=4, half_lut=True,
                                    out_dtype=torch.float32),
                 bcq_matmul_ref),
                ("ternary_matmul", "", "ternary",
                 lambda w: ternary_matmul(x, w, out_dtype=torch.float32),
                 dense_ref)):
            w = ws[kind]
            plain = plain_fn(x, w, torch.float32)
            got, route = routed(torch, name, lambda: fn(w))
            if route != "mma":
                fail(f"{name} f32 rows {rows} [{m}x{n}] ran {route}, not "
                     "mma")
            if got.shape != plain.shape or not torch.isfinite(got).all():
                fail(f"{name} f32 [{rows}x{n}]x[{m}x{n}]^T: bad output")
            err = float((got - plain).abs().max())
            rel = err / (float(plain.abs().max()) + 1e-12)
            del got, plain
            b_ms, b_by = bound(rows * n * 4 + w.nbytes() + rows * m * 4,
                               2.0 * rows * m * n)
            t = timer(lambda: fn(w))
            t_plain = timer(lambda: plain_fn(x, w, torch.float32))
            dense_f32 = dequantize(w, torch.float32)
            t_lib = timer(lambda: torch.matmul(x, dense_f32.T))
            del dense_f32
            out.append(dict(name=name, variant=variant, m=m, n=n,
                            rows=rows, dtype="float32", route=route,
                            max_abs_err=err, rel_err=rel, tol=tol, ms=t,
                            plain_ms=t_plain, library_ms=t_lib,
                            bound_ms=b_ms, bound_by=b_by))
            log(f"{name} {variant + ' ' if variant else ''}rows={rows:5d} "
                f"M={m:5d} N={n:5d} f32 [{route}]: err {err:.3e} (rel "
                f"{rel:.2e} <= {tol:g}: {rel <= tol})  kernel {t:.4f} ms  "
                f"plain {t_plain:.4f} ms  torch.matmul f32 {t_lib:.4f} ms  "
                f"bound {b_ms:.4f} ms ({b_by})")
            if rel > tol:
                fail(f"{name} f32 mma disagrees with its plain version")
        del ws, x
        torch.cuda.empty_cache()
    results["f32_mma"] = out


def check_bcq_widths(torch, timer, gen, results):
    """bcq_matmul at q 2 and q 4 (the widths a mixed-precision plan puts
    beside q 3) at OPT's three shapes: the decode tile (rows 1 and 8,
    route ``gemv``) and the tensor-core tile (rows 512, route ``mma``),
    each held to 1e-3 of the output scale, timed beside ``torch.matmul``
    on the dense bf16 weight and the bound of its bytes at that q."""
    from repro_torch.core import bcq
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels import _lib
    from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
    from repro_torch.kernels.bcq_matmul.ops import gemv_splits
    tol, out = 1e-3, []
    for q in (2, 4):
        for m, n in ((4096, 4096), (16384, 4096), (4096, 16384)):
            w = bcq.quantize(torch.randn((m, n), generator=gen,
                                         device="cuda") * 0.02,
                             bits=q, group_size=128)
            dense_bf16 = dequantize(w, torch.bfloat16)
            for rows in (1, 8, 512):
                x = torch.randn((rows, n), generator=gen,
                                device="cuda").to(torch.bfloat16)
                fn = lambda: bcq_matmul(x, w, out_dtype=torch.float32)
                plain = bcq_matmul_ref(x, w, out_dtype=torch.float32)
                got, route = routed(torch, "bcq_matmul", fn)
                want = "gemv" if rows <= 8 else "mma"
                if route != want:
                    fail(f"bcq_matmul q {q} rows {rows} ran {route}, not "
                         f"{want}")
                if got.shape != plain.shape or not torch.isfinite(got).all():
                    fail(f"bcq_matmul q {q} [{rows}x{n}]x[{m}x{n}]^T: bad "
                         "output")
                err = float((got - plain).abs().max())
                rel = err / (float(plain.abs().max()) + 1e-12)
                b_ms, b_by = bound(rows * n * 2 + w.nbytes() + rows * m * 4,
                                   2.0 * rows * m * n)
                t = timer(fn)
                t_plain = timer(lambda: bcq_matmul_ref(x, w, torch.float32))
                t_lib = timer(lambda: torch.matmul(x, dense_bf16.T))
                rec = dict(m=m, n=n, rows=rows, bits=q, route=route,
                           max_abs_err=err, rel_err=rel, tol=tol, ms=t,
                           plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms,
                           bound_by=b_by, weight_bytes=w.nbytes())
                split = ""
                if route == "gemv":
                    rec["splits"] = gemv_splits(m, w.n_groups * 128,
                                                _lib.sm_count(0))
                    split = f", {rec['splits']} splits"
                out.append(rec)
                log(f"bcq_matmul q={q} rows={rows:4d} M={m:5d} N={n:5d} "
                    f"[{route}{split}]: err {err:.3e} (rel {rel:.2e} <= "
                    f"{tol:g}: {rel <= tol})  kernel {t:.4f} ms  plain "
                    f"{t_plain:.4f} ms  torch.matmul {t_lib:.4f} ms  bound "
                    f"{b_ms:.4f} ms ({b_by})")
                if rel > tol:
                    fail(f"bcq_matmul q {q} disagrees with its plain version")
            del w, dense_bf16
    results["bcq_matmul_widths"] = out


def routed(torch, name, fn):
    """Run ``fn`` (one call of kernel ``name``'s wrapper) and return its
    output and the body it launched, read from the route counter."""
    from repro_torch.kernels import _lib
    before = dict(_lib.route_counts)
    got = fn()
    torch.cuda.synchronize()
    ran = [k.split("/", 1)[1] for k, n in _lib.route_counts.items()
           if k.startswith(name + "/") and n != before.get(k, 0)]
    if len(ran) != 1:
        fail(f"{name}: expected one body to launch, saw {ran}")
    return got, ran[0]


def pool_case(torch, gen, seed, *, b, h, d, nb, bs, pages, dtype,
              prefill_c=0, hkv=None, long=False, shared=0):
    """Scrambled paged problem: random live lengths, -1 table pads, a
    recycled block with stale positions, an idle row (decode) or pad
    query rows (prefill); ``hkv`` kv heads (default ``h``); ``long``:
    every decode row live to within a block of the table's end;
    ``shared``: every row's first ``shared`` table entries are the same
    blocks (a prefix-cache hit) and the prefill chunk starts right after
    them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    k = torch.randn((nb, bs, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((nb, bs, hkv, d), generator=gen, device="cuda").to(dtype)
    pos, tables, positions = paged_tables(torch, rng, b=b, nb=nb, bs=bs,
                                          pages=pages, prefill_c=prefill_c,
                                          long=long, shared=shared)
    q_shape = (b, prefill_c, h, d) if prefill_c else (b, h, d)
    q = torch.randn(q_shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, pos, tables, positions


def paged_tables(torch, rng, *, b, nb, bs, pages, prefill_c=0,
                 idle_row=True, long=False, shared=0):
    """(pos pool, tables, positions) on the card for a scrambled paged
    problem drawn from numpy ``rng`` (see ``pool_case``)."""
    import numpy as np
    tables = np.full((b, pages), -1, np.int32)
    pos = np.full((nb, bs), -1, np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    common = [free.pop() for _ in range(shared)]
    cap = pages * bs
    if prefill_c:
        positions = np.full((b, prefill_c), -1, np.int32)
    else:
        positions = np.zeros(b, np.int32)
    for row in range(b):
        if prefill_c:
            ctx = shared * bs if shared else \
                int(rng.integers(0, cap - prefill_c + 1))
            real = prefill_c - (int(rng.integers(1, 9)) if row == b - 1
                                else 0)
            live = ctx + real
            positions[row, :real] = ctx + np.arange(real)
        elif long:
            live = cap - int(rng.integers(0, bs))
            positions[row] = live - 1
        else:
            if row == 0 and idle_row:
                continue                    # idle decode row
            live = int(rng.integers(1, cap + 1))
            positions[row] = live - 1
        for j in range(-(-live // bs)):
            blk = common[j] if j < shared else free.pop()
            tables[row, j] = blk
            pos[blk] = j * bs + np.arange(bs)
    stale = free.pop()
    pos[stale] = np.arange(bs)
    row = b - 1
    j = int(np.argmax(tables[row] < 0)) if (tables[row] < 0).any() else 0
    if j > 0:
        tables[row, j] = stale
    t = lambda a: torch.as_tensor(a, device="cuda")
    return t(pos), t(tables), t(positions)


def _visited(tables, positions, bs):
    """(pairs, pages): the (row, page) pairs the kernels read (allocated
    and not past the row's last query position), which set the FLOPs,
    and the distinct pages among them, which set the bytes (a page that
    rows share is read from memory once at least)."""
    import numpy as np
    tables = np.asarray(tables.cpu())
    qmax = np.asarray(positions.cpu()).reshape(tables.shape[0], -1).max(1)
    n, pages = 0, set()
    for r in range(tables.shape[0]):
        if qmax[r] < 0:
            continue
        last = min(tables.shape[1] - 1, qmax[r] // bs)
        row = tables[r, :last + 1]
        n += int((row >= 0).sum())
        pages.update(int(p) for p in row[row >= 0])
    return n, len(pages)


def paged_cases(decode, prefill, h):
    """(kernel, B, C, kv heads, long tables) of the paged phase-3 checks:
    decode at the serve batch (MHA, GQA rep 4, every row near
    max_seq_len), prefill at C 128, C 512 (MHA and GQA) and a ragged
    B 3, C 200."""
    return [(decode, 8, 0, h, False), (decode, 8, 0, 8, False),
            (decode, 8, 0, h, True), (prefill, 2, 128, h, False),
            (prefill, 1, 512, h, False), (prefill, 1, 512, 8, False),
            (prefill, 3, 200, h, False)]


def dense_attn_cases():
    """(kernel, B, C, query heads, kv heads) of the float paged kernels at
    the rotary GQA decoders' serve shapes: Phi-4-mini (24 heads over 8,
    GQA rep 3) and Qwen1.5-32B (40 heads, MHA as the reference has it),
    decode at B 8 and the C 512 prefill chunk."""
    return [("paged_decode", 8, 0, 24, 8), ("paged_prefill", 1, 512, 24, 8),
            ("paged_decode", 8, 0, 40, 40),
            ("paged_prefill", 1, 512, 40, 40),
            # OPT-6.7B's 16-head slice at tp 2 (serve_sharded)
            ("paged_decode", 8, 0, 16, 16),
            ("paged_prefill", 1, 512, 16, 16)]


def check_paged(torch, timer, gen, results, args_seed):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (gather_view,
                                                     paged_attention,
                                                     paged_decode_ref,
                                                     paged_prefill,
                                                     paged_prefill_ref)
    from repro_torch.kernels import _lib
    from repro_torch.kernels.paged_attention.ops import decode_splits
    h0, d, bs, pages, nb = 32, 128, 16, 32, 257
    out = {"paged_decode": [], "paged_prefill": []}
    # (kernel, B, C, heads, kv heads, long tables): decode at the serve
    # batch, then GQA (rep 4) and every row near max_seq_len 512; prefill
    # at C 128 and at OPT's C 512 chunk, then GQA (rep 4) at C 512 and a
    # ragged B 3, C 200 whose last row ends in pads; then the rotary GQA
    # decoders' serve shapes (dense_attn_cases)
    cases = [(name, b, c, h0, hkv, long, 0) for name, b, c, hkv, long
             in paged_cases("paged_decode", "paged_prefill", h0)] + \
        [(name, b, c, h, hkv, False, 0)
         for name, b, c, h, hkv in dense_attn_cases()] + \
        [("paged_prefill", 2, 144, h0, h0, False, PREFIX_BLOCKS)]
    # the last: a prefix-cache hit, two rows whose tables share their
    # first 16 blocks (256 tokens) and a chunk of the 144-token tail
    # starting past them (the second row ragged)
    for name, b, c, h, hkv, long, shared in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            # OPT's cases keep their earlier seeds
            seed = args_seed + b + c + (hkv if hkv != h else 0) \
                + 1000 * long + (h if h != h0 else 0)
            q, k, v, pos, tables, positions = pool_case(
                torch, gen, seed, b=b, h=h, d=d, nb=nb + long, bs=bs,
                pages=pages, dtype=dtype, prefill_c=c, hkv=hkv, long=long,
                shared=shared)
            if c:
                kern = lambda: paged_prefill(q, k, v, pos, tables,
                                             positions,
                                             out_dtype=torch.float32)
                plain = lambda: paged_prefill_ref(q, k, v, pos, tables,
                                                  positions,
                                                  out_dtype=torch.float32)
            else:
                kern = lambda: paged_attention(q, k, v, pos, tables,
                                               positions,
                                               out_dtype=torch.float32)
                plain = lambda: paged_decode_ref(q, k, v, pos, tables,
                                                 positions,
                                                 out_dtype=torch.float32)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{name}: bad output")
            err = float((got - want).abs().max())
            ok = err <= tol
            tag = (f"{name:13s} B={b} C={max(c, 1):3d} H={h} Hkv={hkv:2d} "
                   f"{str(dtype)[6:]:8s}{' long' if long else ''}"
                   f"{f' after {shared} shared blocks' if shared else ''}")
            if dtype == torch.float32:
                log(f"{tag}: err {err:.3e} <= {tol:g}: {ok}")
                if not ok:
                    fail(f"{name} (f32 pool) disagrees with its plain version")
                continue
            # bf16 pools: the main path's type — check and time
            visited, distinct = _visited(tables, positions, bs)
            slots = visited * bs
            kv_bytes = distinct * bs * hkv * d * 2 * 2 + distinct * bs * 4
            nq = b * max(c, 1)
            nbytes = kv_bytes + nq * h * d * 2 + nq * h * d * 4 \
                + tables.numel() * 4 + positions.numel() * 4
            flops = 4.0 * max(c, 1) * h * slots * d
            b_ms, b_by = bound(nbytes, flops)
            kv = gather_view(k, tables).permute(0, 2, 1, 3)   # [B, H, L, D]
            vv = gather_view(v, tables).permute(0, 2, 1, 3)
            vpos = gather_view(pos, tables)
            L = vpos.shape[1]
            iota = torch.arange(L, device="cuda")[None]
            live = torch.repeat_interleave(tables >= 0, bs, dim=1) & \
                (vpos == iota)
            qpos = positions.reshape(b, -1)
            mask = (live[:, None, :] & (vpos[:, None, :] <= qpos[:, :, None])
                    )[:, None]                                  # [B,1,Q,L]
            qs = (q.reshape(b, -1, h, d) if c else q[:, None]).permute(
                0, 2, 1, 3)
            t_lib = timer(lambda: F.scaled_dot_product_attention(
                qs, kv, vv, attn_mask=mask, enable_gqa=hkv != h))
            t_k, t_p = timer(kern), timer(plain)
            rec = dict(b=b, c=max(c, 1), h=h, hkv=hkv, d=d, block_size=bs,
                       long=long, shared_blocks=shared, max_abs_err=err,
                       tol=tol, ms=t_k,
                       plain_ms=t_p, library_ms=t_lib, bound_ms=b_ms,
                       bound_by=b_by, visited_pages=visited,
                       distinct_pages=distinct)
            if not c:
                rec["splits"] = decode_splits(b, hkv, h // hkv, pages, bs,
                                              _lib.sm_count(0))
            out[name].append(rec)
            log(f"{tag}: err {err:.3e} <= {tol:g}: {ok}  kernel {t_k:.4f} "
                f"ms  plain {t_p:.4f} ms  sdpa {t_lib:.4f} ms  bound "
                f"{b_ms:.4f} ms ({b_by}, {visited} live pages, {distinct} "
                f"distinct"
                + (f", {rec['splits']} splits)" if not c else ")"))
            if not ok:
                fail(f"{name} (bf16 pool) disagrees with its plain version")
    results.update(out)


def check_ternary(torch, timer, gen, results):
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels import _lib
    from repro_torch.kernels.bcq_matmul.ops import gemv_splits
    from repro_torch.kernels.ternary_matmul import dense_ref, ternary_matmul
    from repro_torch.quant.formats import quantize_ternary

    tol = 1e-3          # relative to max |plain|: the reference's gate
    out = []
    for m, n in ((4096, 4096), (16384, 4096), (4096, 16384)):
        w_dense = torch.randn((m, n), generator=gen, device="cuda") * 0.02
        w = quantize_ternary(w_dense, group_size=128)
        del w_dense
        dense_bf16 = dequantize(w, torch.bfloat16)
        wbytes = w.nbytes()
        # decode rows (1, 8: the tensor-core decode tile) and the serve's
        # prefill buckets (32, 128, 512: the tensor-core tile)
        for rows in (1, 8, 32, 128, 512):
            x = (torch.randn((rows, n), generator=gen, device="cuda")
                 ).to(torch.bfloat16)
            plain = dense_ref(x, w, torch.float32)
            scale = float(plain.abs().max()) + 1e-12
            fn = lambda: ternary_matmul(x, w, out_dtype=torch.float32)
            got, route = routed(torch, "ternary_matmul", fn)
            want = "gemv" if rows <= 8 else "mma"
            if route != want:
                fail(f"ternary_matmul rows {rows} [{m}x{n}] ran {route}, "
                     f"not {want}")
            if got.shape != plain.shape or not torch.isfinite(got).all():
                fail(f"ternary_matmul [{rows}x{n}]x[{m}x{n}]^T: bad output")
            err = float((got - plain).abs().max())
            rel = err / scale
            ok = rel <= tol
            b_ms, b_by = bound(rows * n * 2 + wbytes + rows * m * 4,
                               2.0 * rows * m * n)
            t = timer(fn)
            t_plain = timer(lambda: dense_ref(x, w, torch.float32))
            t_lib = timer(lambda: torch.matmul(x, dense_bf16.T))
            rec = dict(m=m, n=n, rows=rows, route=route, max_abs_err=err,
                       rel_err=rel, tol=tol, ms=t, plain_ms=t_plain,
                       library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                       weight_bytes=wbytes)
            split = ""
            if route == "gemv":
                rec["splits"] = gemv_splits(m, w.n_groups * 128,
                                            _lib.sm_count(0))
                split = f", {rec['splits']} splits"
            out.append(rec)
            log(f"ternary_matmul rows={rows:4d} M={m:5d} N={n:5d} "
                f"[{route}{split}]: "
                f"err {err:.3e} (rel {rel:.2e} <= {tol:g}: {ok})  "
                f"kernel {t:.4f} ms  plain {t_plain:.4f} ms  "
                f"torch.matmul {t_lib:.4f} ms  bound {b_ms:.4f} ms "
                f"({b_by})")
            if not ok:
                fail("ternary_matmul disagrees with its plain version")
        del w, dense_bf16
        # exact inputs: 0.5 * {-1, 0, +1} weights (alpha 0.5), integer
        # activations; every partial sum is exact, so the error must be 0
        # on both tensor-core bodies (8 rows: the decode tile; 512: the
        # prefill tile)
        exact_err(torch, gen, m, n, 8, 128, out, "gemv")
        exact_err(torch, gen, m, n, 512, 128, out, "mma")
    # ragged M, N and B on the dequantizing tile (group size 8 at 19
    # rows; a part-full last stage), decode rows the decode tile does not
    # take (group size 8: split stages), prefill rows at group size 512,
    # a ragged decode-tile case (split steps, padded planes) and a ragged
    # mma case (split alpha groups, padded planes)
    exact_err(torch, gen, 1000, 1032, 19, 8, out, "mma_dq")
    exact_err(torch, gen, 4096, 4096, 8, 8, out, "mma_dq")
    exact_err(torch, gen, 4096, 4096, 512, 512, out, "mma_dq")
    exact_err(torch, gen, 1000, 1016, 5, 64, out, "gemv")
    exact_err(torch, gen, 1000, 1016, 77, 64, out, "mma")
    results["ternary_matmul"] = out


def exact_err(torch, gen, m, n, rows, g, out, want):
    from repro_torch.kernels.ternary_matmul import (dense_ref, ternary_matmul,
                                                    ternary_ref)
    from repro_torch.quant.formats import quantize_ternary
    we = torch.randint(-1, 2, (m, n), generator=gen, device="cuda").float()
    wq = quantize_ternary(we * 0.5, group_size=g)
    xe = torch.randint(-8, 9, (rows, n), generator=gen,
                       device="cuda").to(torch.bfloat16)
    got, route = routed(torch, "ternary_matmul", lambda: ternary_matmul(
        xe, wq, out_dtype=torch.float32))
    if route != want:
        fail(f"ternary_matmul exact rows {rows} g {g} ran {route}, not "
             f"{want}")
    err = max(float((got - ternary_ref(xe, wq, out_dtype=torch.float32)
                     ).abs().max()),
              float((got - dense_ref(xe, wq, torch.float32)).abs().max()))
    torch.cuda.synchronize()
    out.append(dict(m=m, n=n, rows=rows, group_size=g, route=route,
                    exact_inputs=True, max_abs_err=err, tol=0.0))
    log(f"ternary_matmul exact inputs rows={rows} M={m} N={n} g={g} "
        f"[{route}]: err {err:.3e} == 0: {err == 0.0}")
    if err != 0.0:
        fail("ternary_matmul is not exact on exact inputs")


def check_paged_int8(torch, timer, gen, results, args_seed):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (gather_view,
                                                     paged_attention_int8,
                                                     paged_decode_int8_ref,
                                                     paged_prefill,
                                                     paged_prefill_ref)
    from repro_torch.models.attention import _quantize_kv
    from repro_torch.kernels import _lib
    from repro_torch.kernels.paged_attention.ops import decode_splits
    h0, d, bs, pages, nb = 32, 128, 16, 32, 257
    out = {"paged_decode_int8": [], "paged_prefill_int8": []}
    # the cases of check_paged, then OPT-6.7B's 16-head slice at tp 2
    # (serve_sharded's ternary + int8-KV run): decode at B 8, the C 512
    # prefill chunk
    cases = [(name, b, c, h0, hkv, long) for name, b, c, hkv, long in
             paged_cases("paged_decode_int8", "paged_prefill_int8", h0)] + [
        ("paged_decode_int8", 8, 0, 16, 16, False),
        ("paged_prefill_int8", 1, 512, 16, 16, False)]
    for name, b, c, h, hkv, long in cases:
        seed = args_seed + b + c + (hkv if hkv != h else 0) + 1000 * long \
            + (h if h != h0 else 0)
        q, k, v, pos, tables, positions = pool_case(
            torch, gen, seed, b=b, h=h, d=d, nb=nb + long, bs=bs,
            pages=pages, dtype=torch.float32, prefill_c=c, hkv=hkv,
            long=long)

        def run(kq, vq, ks, vs, cdt):
            if c:
                kern = lambda: paged_prefill(
                    q, kq, vq, pos, tables, positions, k_scale=ks,
                    v_scale=vs, out_dtype=torch.float32, compute_dtype=cdt)
                plain = lambda: paged_prefill_ref(
                    q, kq, vq, pos, tables, positions, k_scale=ks,
                    v_scale=vs, out_dtype=torch.float32, compute_dtype=cdt)
            else:
                kern = lambda: paged_attention_int8(
                    q, kq, vq, ks, vs, pos, tables, positions,
                    out_dtype=torch.float32, compute_dtype=cdt)
                plain = lambda: paged_decode_int8_ref(
                    q, kq, vq, ks, vs, pos, tables, positions,
                    out_dtype=torch.float32, compute_dtype=cdt)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{name}: bad output")
            err = float((got - want).abs().max())
            return kern, plain, err, err / (float(want.abs().max()) + 1e-12)

        tag = (f"{name:18s} B={b} C={max(c, 1):3d} H={h} Hkv={hkv:2d}"
               f"{' long' if long else ''}")
        # f32 compute with power-of-two scales: the arithmetic is exact up
        # to f32 rounding, so kernel and plain agree within 1e-4
        shape = tuple(k.shape)
        kq = torch.randint(-127, 128, shape, generator=gen,
                           device="cuda").to(torch.int8)
        vq = torch.randint(-127, 128, shape, generator=gen,
                           device="cuda").to(torch.int8)
        ks, vs = (2.0 ** torch.randint(-9, -5, shape[:3], generator=gen,
                                       device="cuda").float()
                  for _ in range(2))
        _, _, err, rel = run(kq, vq, ks, vs, torch.float32)
        log(f"{tag} f32, pow2 scales: rel err {rel:.3e} <= 1e-4: "
            f"{rel <= 1e-4}")
        if rel > 1e-4:
            fail(f"{name} (f32 compute) disagrees with its plain version")
        # the main path: pools quantized by the serve path's _quantize_kv,
        # bf16 compute; bound 5e-2 of the output scale (the reference's
        # int8 gate: the kernel rounds p * v_scale before normalizing)
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        kern, plain, err, rel = run(kq, vq, ks, vs, None)
        ok = rel <= 5e-2
        visited, distinct = _visited(tables, positions, bs)
        slots = visited * bs
        kv_slots = distinct * bs
        kv_bytes = kv_slots * hkv * d * 2 + kv_slots * hkv * 4 * 2 \
            + kv_slots * 4
        nq = b * max(c, 1)
        nbytes = kv_bytes + nq * h * d * 2 + nq * h * d * 4 \
            + tables.numel() * 4 + positions.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * max(c, 1) * h * slots * d)
        deq = lambda t, s_: (gather_view(t, tables).float() * gather_view(
            s_, tables)[..., None]).to(torch.bfloat16).permute(0, 2, 1, 3)
        kv, vv = deq(kq, ks), deq(vq, vs)                    # [B, H, L, D]
        vpos = gather_view(pos, tables)
        L = vpos.shape[1]
        iota = torch.arange(L, device="cuda")[None]
        live = torch.repeat_interleave(tables >= 0, bs, dim=1) & \
            (vpos == iota)
        qpos = positions.reshape(b, -1)
        mask = (live[:, None, :] & (vpos[:, None, :] <= qpos[:, :, None])
                )[:, None]                                    # [B,1,Q,L]
        qb = q.to(torch.bfloat16)
        qs = (qb.reshape(b, -1, h, d) if c else qb[:, None]).permute(
            0, 2, 1, 3)
        t_lib = timer(lambda: F.scaled_dot_product_attention(
            qs, kv, vv, attn_mask=mask, enable_gqa=hkv != h))
        t_k, t_p = timer(kern), timer(plain)
        rec = dict(
            b=b, c=max(c, 1), h=h, hkv=hkv, d=d, block_size=bs, long=long,
            max_abs_err=err,
            rel_err=rel, tol=5e-2, ms=t_k, plain_ms=t_p, library_ms=t_lib,
            bound_ms=b_ms, bound_by=b_by, visited_pages=visited,
            bytes=nbytes)
        if not c:
            rec["splits"] = decode_splits(b, hkv, h // hkv, pages, bs,
                                          _lib.sm_count(0))
        out[name].append(rec)
        log(f"{tag} bf16: err {err:.3e} (rel {rel:.2e} <= 5e-2: {ok})  "
            f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  sdpa {t_lib:.4f} ms"
            f"  bound {b_ms:.4f} ms ({b_by}, {visited} live pages, "
            f"{nbytes / 1e6:.1f} MB"
            + (f", {rec['splits']} splits)" if not c else ")"))
        if not ok:
            fail(f"{name} (bf16 compute) disagrees with its plain version")
        del kv, vv
    results.update(out)


def check_paged_mla(torch, timer, gen, results, args_seed):
    """Absorbed MLA decode at the MiniCPM3-4B widths (H 40, lora 256,
    rope 32) and at DeepSeek-V2's (H 128: head tiles of 40, 40, 40 and 8;
    lora 512; rope 64), bf16 latent pools, block 16, against its plain
    version at B 8 (the serve batch), B 1 and a ragged B 3 case, and at
    both models' tp-2 shards (H 20; H 64: tiles of 40 and 24) at B 8,
    within
    1e-4 of the output scale (the reference's ``paged_attention_mla_maxerr``
    gate: both compute in f32 from the same pools)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import _lib
    from repro_torch.kernels.paged_attention import (gather_view,
                                                     paged_attention_mla,
                                                     paged_decode_mla_ref)
    from repro_torch.kernels.paged_attention.ops import mla_splits
    bs, pages, nb = 16, 32, 257
    tol = 1e-4
    out = []
    # (model, heads, lora, rope, qk_nope) x (B, seed, idle row 0): the
    # serve batch with an idle row; one live row; a ragged case (idle
    # row, stale recycled block, -1 pads)
    for (model, h, lora, dr, dn), (b, seed, idle) in [
            (w, c) for w in (("minicpm3_4b", 40, 256, 32, 64),
                             ("deepseek_v2_236b", 128, 512, 64, 128))
            for c in ((8, args_seed + 8, True), (1, args_seed + 1, False),
                      (3, args_seed + 3, True))] + [
            # the tp-2 shards serve_sharded runs: 20 and 64 query heads
            (w, (8, args_seed + 8 + w[1], True))
            for w in (("minicpm3_4b", 20, 256, 32, 64),
                      ("deepseek_v2_236b", 64, 512, 64, 128))]:
        kd = lora + dr
        scale = (dn + dr) ** -0.5           # (qk_nope + qk_rope)^-0.5
        rng = np.random.default_rng(seed)
        ckv = torch.randn((nb, bs, lora), generator=gen,
                          device="cuda").to(torch.bfloat16)
        kr = torch.randn((nb, bs, dr), generator=gen,
                         device="cuda").to(torch.bfloat16)
        pos, tables, positions = paged_tables(torch, rng, b=b, nb=nb, bs=bs,
                                              pages=pages, idle_row=idle)
        qe = torch.randn((b, h, lora), generator=gen, device="cuda")
        # q_rope arrives as bf16-rounded values (apply_rope's output)
        qr = torch.randn((b, h, dr), generator=gen,
                         device="cuda").to(torch.bfloat16).float()
        kern = lambda: paged_attention_mla(qe, qr, ckv, kr, pos, tables,
                                           positions, scale=scale)
        plain = lambda: paged_decode_mla_ref(qe, qr, ckv, kr, pos, tables,
                                             positions, scale=scale)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail("paged_decode_mla: bad output")
        err = float((got - want).abs().max())
        rel = err / (float(want.abs().max()) + 1e-12)
        ok = rel <= tol
        visited, distinct = _visited(tables, positions, bs)
        slots = visited * bs
        nbytes = distinct * bs * (kd * 2 + 4) + b * h * kd * 4 \
            + b * h * lora * 4 \
            + tables.numel() * 4 + positions.numel() * 4
        flops = slots * h * (2.0 * kd + 2.0 * lora)
        b_ms, b_by = bound(nbytes, flops)
        splits = mla_splits(b, h, pages, _lib.sm_count(0))
        tag = f"paged_decode_mla B={b} H={h} lora={lora} ({splits} splits)"
        if not torch.equal(got, kern()):
            fail("paged_decode_mla: a repeated call differs")
        if b != 8:
            log(f"{tag}: err {err:.3e} (rel {rel:.2e} <= {tol:g}: {ok}) "
                f"({visited} live pages)")
            out.append(dict(b=b, h=h, lora=lora, dr=dr, block_size=bs,
                            splits=splits, max_abs_err=err, rel_err=rel,
                            tol=tol, visited_pages=visited, model=model))
            if not ok:
                fail("paged_decode_mla disagrees with its plain version")
            continue
        # the library yardstick: one SDPA call on the gathered view, q =
        # [q_eff | q_rope], k = [ckv | krope], v = ckv, the one latent head
        # broadcast over the query heads (a stride-0 view, no copy)
        L = pages * bs
        kcat = torch.cat([gather_view(ckv, tables), gather_view(kr, tables)],
                         dim=-1)                              # [B, L, kd]
        kk = kcat[:, None].expand(b, h, L, kd)
        vv = gather_view(ckv, tables)[:, None].expand(b, h, L, lora)
        vpos = gather_view(pos, tables)
        iota = torch.arange(L, device="cuda")[None]
        live = torch.repeat_interleave(tables >= 0, bs, dim=1) & \
            (vpos == iota) & (vpos <= positions[:, None])
        mask = live[:, None, None, :]                         # [B,1,1,L]
        qs = torch.cat([qe, qr], dim=-1).to(torch.bfloat16)[:, :, None]
        t_lib = timer(lambda: F.scaled_dot_product_attention(
            qs, kk, vv, attn_mask=mask, scale=scale))
        t_k, t_p = timer(kern), timer(plain)
        out.append(dict(b=b, h=h, lora=lora, dr=dr, block_size=bs,
                        splits=splits, max_abs_err=err, rel_err=rel,
                        tol=tol, ms=t_k,
                        plain_ms=t_p, library_ms=t_lib, bound_ms=b_ms,
                        bound_by=b_by, visited_pages=visited, bytes=nbytes,
                        model=model))
        log(f"{tag}: err {err:.3e} (rel {rel:.2e} <= {tol:g}: {ok})  "
            f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  sdpa {t_lib:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by}, {visited} live pages, "
            f"{nbytes / 1e6:.2f} MB)")
        if not ok:
            fail("paged_decode_mla disagrees with its plain version")
        del kk, vv, kcat
    results["paged_decode_mla"] = out


def layer_gemm_shapes(cfg, i):
    """[out x in] of the quantized GEMMs one decode step runs in layer
    ``i``: the mixer's (GQA q, k, v, o; MLA q_a, q_b, kv_a, o, its kv_b
    absorbed and run as no GEMM; Mamba in_proj, out_proj), an
    encoder-decoder's cross-attention q and o (its k and v ran at
    prefill: the decode step reads them from the cache), then a dense
    MLP's (GELU up, down; SwiGLU gate, up, down) or a MoE layer's shared
    experts' (its routed expert banks run no kernel: ``moe_apply``
    dequantizes them, as the reference does).  A layer with ``d_ff`` 0
    (Mamba2's) has no MLP."""
    d, h = cfg.d_model, cfg.n_heads
    if cfg.layer_kind(i) == "mamba":
        d_inner = cfg.ssm_expand * d
        heads = d_inner // cfg.ssm_head_dim
        out = [(2 * d_inner + 2 * cfg.ssm_state + heads, d), (d, d_inner)]
    elif cfg.attention == "mla":
        out = [(cfg.q_lora_rank, d),
               (h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
                cfg.q_lora_rank),
               (cfg.kv_lora_rank + cfg.qk_rope_head_dim, d),
               (d, h * cfg.v_head_dim)]
    else:
        hkv, hd = cfg.n_kv_heads, cfg.head_dim_
        out = [(h * hd, d), (hkv * hd, d), (hkv * hd, d), (d, h * hd)]
        if cfg.n_encoder_layers:
            out += [(h * hd, d), (d, h * hd)]
    if cfg.mlp_kind(i) == "moe":
        f = (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts
        return out + ([(f, d), (f, d), (d, f)] if f else [])
    if cfg.d_ff:
        f = cfg.d_ff
        out += ([(f, d)] if cfg.mlp_act == "swiglu" else []) \
            + [(f, d), (d, f)]
    return out


def gemm_shapes(cfg):
    """(every distinct layer GEMM shape of ``cfg``, in order of first use;
    the untied head's, or None for a tied head: a dense matmul on the
    token table)."""
    shapes = []
    for i in range(cfg.n_layers):
        for sh in layer_gemm_shapes(cfg, i):
            if sh not in shapes:
                shapes.append(sh)
    head = None if cfg.tie_embeddings else (cfg.padded_vocab, cfg.d_model)
    return shapes, head


def check_bcq_model_shapes(torch, timer, gen, results, arch, cases,
                           f32_rows8=False, repeats=1):
    """bcq_matmul, BCQ-3 g 128 on bf16 activations, at a model's GEMM
    shapes: ``cases`` is [((out, in), rows)], each shape's rows in order
    from rows 1 (where its weight is drawn).  Rows <= 8 run the
    tensor-core decode tile, more rows (512, the largest prefill bucket,
    or a model-API prefill's) the tensor-core tile, each logged with its
    split count; 1e-3 of the output
    scale as in ``check_gemms``, timed beside the plain version,
    ``torch.matmul`` and the bound.  With ``f32_rows8`` each shape's rows
    8 also run on f32 activations (``f32_decode_case``).  With
    ``repeats`` > 1 the decode tile is timed that many times and the
    median kept, every time recorded (``ms_runs``)."""
    from repro_torch.core import bcq
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels import _lib
    from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
    from repro_torch.kernels.bcq_matmul.ops import gemv_splits, mma_splits

    tol = 1e-3
    for (m, n), rows in cases:
        if rows == 1:
            w_dense = torch.randn((m, n), generator=gen,
                                  device="cuda") * 0.02
            w = bcq.quantize(w_dense, bits=3, group_size=128)
            del w_dense
            dense_bf16 = dequantize(w, torch.bfloat16)
        x = torch.randn((rows, n), generator=gen,
                        device="cuda").to(torch.bfloat16)
        fn = lambda: bcq_matmul(x, w, out_dtype=torch.float32)
        plain = bcq_matmul_ref(x, w, out_dtype=torch.float32)
        got, route = routed(torch, "bcq_matmul", fn)
        if got.shape != plain.shape or not torch.isfinite(got).all():
            fail(f"bcq_matmul [{rows}x{n}]x[{m}x{n}]^T: bad output")
        err = float((got - plain).abs().max())
        rel = err / (float(plain.abs().max()) + 1e-12)
        b_ms, b_by = bound(rows * n * 2 + w.nbytes() + rows * m * 4,
                           2.0 * rows * m * n)
        runs = sorted(timer(fn) for _ in range(
            repeats if route == "gemv" else 1))
        t = runs[len(runs) // 2]
        t_plain = timer(lambda: bcq_matmul_ref(x, w, torch.float32))
        t_lib = timer(lambda: torch.matmul(x, dense_bf16.T))
        rec = dict(
            m=m, n=n, rows=rows, bits=w.bits, model=arch, route=route,
            max_abs_err=err, rel_err=rel, tol=tol, ms=t, plain_ms=t_plain,
            library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)
        split = ""
        if route in ("gemv", "mma"):
            rec["splits"] = (
                gemv_splits(m, w.n_groups * 128, _lib.sm_count(0))
                if route == "gemv" else
                mma_splits(rows, m, w.n_groups, _lib.sm_count(0)))
            split = f", {rec['splits']} splits"
            if len(runs) > 1:
                rec["ms_runs"] = runs
                split += (f"; median of {len(runs)}: "
                          + " ".join(f"{r:.4f}" for r in runs))
        results["bcq_matmul"].append(rec)
        log(f"bcq_matmul rows={rows:4d} M={m:6d} N={n:5d} ({arch}) "
            f"[{route}{split}]: err {err:.3e} (rel {rel:.2e} <= {tol:g}: "
            f"{rel <= tol})  kernel {t:.4f} ms  plain {t_plain:.4f} ms  "
            f"torch.matmul {t_lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        if rel > tol:
            fail(f"bcq_matmul disagrees with its plain version at a {arch} "
                 "shape")
        if rows == 8 and f32_rows8:
            f32_decode_case(torch, timer, gen, w, dense_bf16, results,
                            model=arch)


def check_bcq_minicpm3(torch, timer, gen, results):
    """bcq_matmul on every MiniCPM3-4B GEMM shape (new widths: out 288 and
    73,472, in 768 and 6400) at rows 1, 8 and 512, and on f32 activations
    at rows 8 (the f32 view: the decode tile, x split into three bf16
    parts)."""
    from repro_torch.configs import get_config
    layer, unembed = gemm_shapes(get_config("minicpm3_4b"))
    check_bcq_model_shapes(
        torch, timer, gen, results, "minicpm3_4b",
        [(sh, r) for sh in sorted(set(layer)) + [unembed]
         for r in (1, 8, 512)], f32_rows8=True)


def step_linears(cfg):
    """(quantized linears a decode step runs, those a prefill chunk runs
    on the tensor-core tile): every layer's GEMMs, plus the untied head in
    a decode step (a prefill chunk runs the head on one row per request,
    on the decode tile)."""
    n = sum(len(layer_gemm_shapes(cfg, i)) for i in range(cfg.n_layers))
    return n + (gemm_shapes(cfg)[1] is not None), n


def check_bcq_mixtral(torch, timer, gen, results):
    """bcq_matmul at Mixtral-8x7B's attention GEMMs (q, o [4096 x 4096];
    k, v [1024 x 4096]) at rows 1, 8 and 512, and its untied head [32000
    x 4096] at rows 1 and 8 (``check_bcq_model_shapes``, each
    decode-tile case timed five times, median kept).  Its expert banks
    run no kernel: their time is taken in the serve run
    (``expert_path_times``)."""
    from repro_torch.configs import get_config
    layer, head = gemm_shapes(get_config("mixtral_8x7b"))
    cases = [(sh, r) for sh in sorted(set(layer)) for r in (1, 8, 512)]
    cases += [(head, r) for r in (1, 8)]
    check_bcq_model_shapes(torch, timer, gen, results, "mixtral_8x7b",
                           cases, repeats=5)
    torch.cuda.empty_cache()


def served_prefill_rows(cfg):
    """The activation rows of each layer GEMM in a model-API prefill of
    phase 4 (8 rows a batch), beyond the engines' buckets: Whisper's
    decoder prompt (8 x ``WHISPER_PROMPT``) and its encoder and cross
    k/v (8 x 1500 frames); Pixtral's VLM prefill (8 x (1024 patches +
    ``PIXTRAL_TEXT`` tokens)); none for a text-only model."""
    if cfg.is_encdec:
        return (8 * WHISPER_PROMPT, 8 * cfg.encoder_seq)
    if cfg.num_patches:
        return (8 * (cfg.num_patches + PIXTRAL_TEXT),)
    return ()


def check_bcq_dense_archs(torch, timer, gen, results):
    """bcq_matmul at the GEMM shapes of the models served without a
    phase-3 check of their own (``check_bcq_model_shapes``): rows 1, 8
    and 512 at every layer shape of Phi-4-mini-3.8B ([3072 x 3072], [1024
    x 3072], [8192 x 3072], [3072 x 8192]), Qwen1.5-32B ([5120 x 5120],
    [27392 x 5120], [5120 x 27392]), DeepSeek-V2 (q_a [1536 x 5120], q_b
    [24576 x 1536], kv_a [576 x 5120], o [5120 x 16384], the dense
    layer's MLP [12288 x 5120] and [5120 x 12288], the shared experts'
    [3072 x 5120] and [5120 x 3072]; its kv_b is absorbed) and
    Mamba2-2.7B (in_proj [10576 x 2560], a ragged out-tile, and out_proj
    [2560 x 5120]), Jamba-1.5-Large (in_proj [33024 x 8192], out_proj
    [8192 x 16384], q/o [8192 x 8192], k/v [1024 x 8192], the dense MLP
    [24576 x 8192] and [8192 x 24576]), Pixtral-12B (q [4096 x 5120],
    k/v [1024 x 5120], o [5120 x 4096], the MLP [14336 x 5120] and [5120
    x 14336]) and Whisper-medium ([1024 x 1024], [4096 x 1024], [1024 x
    4096], its encoder's too), and the untied heads (Qwen's [152064 x
    5120], DeepSeek's [102400 x 5120], Jamba's [65536 x 8192], Pixtral's
    [131072 x 5120], Whisper's [51968 x 1024]) at rows 1 and 8 (a decode
    step; a prefill chunk runs the head on one row).  A tied head
    (Phi-4-mini's, Mamba2's) is a dense matmul on the bf16 token table
    (``linear_apply``, as the reference leaves it to XLA): timed at rows
    8 beside its bound, no kernel of the port.  Routed expert banks run no kernel
    (``expert_path_times``).  Each decode-tile case is timed five times
    and its median kept.  Every layer shape of Whisper and Pixtral also
    runs at the row counts their model-API prefills give the tensor-core
    tile (``served_prefill_rows``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantized_linear import linear_apply

    results["dense_head"] = []
    for arch in ("phi4_mini_3_8b", "qwen1_5_32b", "deepseek_v2_236b",
                 "mamba2_2_7b", "jamba_1_5_large_398b", "pixtral_12b",
                 "whisper_medium"):
        cfg = get_config(arch)
        layer, head = gemm_shapes(cfg)
        rows = (1, 8, 512) + served_prefill_rows(cfg)
        cases = [(sh, r) for sh in sorted(set(layer)) for r in rows]
        if head is not None:
            cases += [(head, r) for r in (1, 8)]
        check_bcq_model_shapes(torch, timer, gen, results, arch, cases,
                               repeats=5)
        if head is None:
            tok = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                              device="cuda").to(torch.bfloat16)
            x = torch.randn((8, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            t = timer(lambda: linear_apply(tok, x, out_dtype=torch.float32))
            b_ms, b_by = bound(tok.numel() * 2 + x.numel() * 2
                               + 8 * tok.shape[0] * 4,
                               2.0 * 8 * tok.numel())
            results["dense_head"].append(dict(
                model=arch, m=tok.shape[0], n=tok.shape[1], rows=8, ms=t,
                bound_ms=b_ms, bound_by=b_by))
            log(f"tied head ({arch}) rows=8 [{tok.shape[0]}x{tok.shape[1]}] "
                f"bf16, linear_apply (dense, f32 out): {t:.4f} ms  bound "
                f"{b_ms:.4f} ms ({b_by})")
            del tok
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serve OPT-6.7B, MiniCPM3-4B, Phi-4-mini-3.8B, Qwen1.5-32B,
# Mixtral-8x7B, DeepSeek-V2, Mamba2-2.7B, Jamba-1.5-Large, Pixtral-12B
# and Whisper-medium
# ---------------------------------------------------------------------------


def attn_record(results, name, cfg, **want):
    """The phase-3 record of attention kernel ``name`` at ``cfg``'s heads
    (MLA: its query heads) among those matching ``want``."""
    h = cfg.n_heads
    hkv = h if cfg.attention == "mla" else cfg.n_kv_heads
    return [r for r in results[name] if "ms" in r and r["h"] == h
            and r.get("hkv", h) == hkv and not r.get("long")
            and all(r.get(k) == v for k, v in want.items())][0]


def step_kernel_ms(results, gemm, attn, cfg):
    """Device time of one decode step's kernels at batch 8: the phase-3
    per-call times times the step's launches (each layer's GEMMs,
    ``layer_gemm_shapes``, + 1 decode attention per attention layer; the
    untied unembedding once), for comparison with the measured step
    time.  A tied head is no kernel of the port (``dense_head``), nor is
    a MoE layer's routed expert path (``expert_path_times``).  The cases
    timed for another model (``model`` set to another arch) are left
    out: Mixtral's q and o share OPT's [4096 x 4096]."""
    arch = cfg.name.replace("-", "_").replace(".", "_")
    t = {(r["m"], r["n"]): r["ms"] for r in results[gemm]
         if r["rows"] == 8 and "ms" in r and r.get("model", arch) == arch}
    attn_ms = attn_record(results, attn, cfg, b=8)["ms"] if attn else 0.0
    head = gemm_shapes(cfg)[1]
    return sum(sum(t[sh] for sh in layer_gemm_shapes(cfg, i))
               + (attn_ms if cfg.layer_kind(i) == "attn" else 0.0)
               for i in range(cfg.n_layers)) + (t[head] if head else 0.0)


def first_logits(torch, m, toks):
    """Logits of one 128-token prefill chunk into a scrambled block table."""
    import numpy as np
    from repro_torch.models import set_block_tables
    cache = m.init_paged_cache(1, 64, 16, 32)
    table = np.full((1, 32), -1, np.int32)
    table[0, :8] = [9, 2, 17, 5, 33, 11, 40, 3]
    cache = set_block_tables(cache, table)
    logits, _ = m.prefill_chunk(toks, cache, 0, toks.shape[1] - 1)
    torch.cuda.synchronize()
    return logits


def depth_view(m, k):
    """A view of model ``m`` (shared weights) that runs only its first
    ``k`` layers, then the final norm and head."""
    import copy
    from torch import nn
    v = copy.copy(m)
    v._modules = dict(m._modules)
    stack = copy.copy(m.stack)
    stack._modules = dict(m.stack._modules)
    stack.layers = nn.ModuleList(list(m.stack.layers)[:k])
    v.stack = stack
    v.cfg = m.cfg.replace(n_layers=k)
    return v


def f32_view(m):
    """A view of model ``m`` whose activations and KV pool are f32 (the
    embedding table, a learned position table, an encoder's positions
    copied to f32, and an encoder-decoder's cross K/V cache in f32): the
    GEMMs then round nothing to bf16,
    so kernel and plain paths differ only in f32 summation order.  MoE
    layers (copies of them) dequantize their expert banks to f32 as
    well (``MoE.bank_dtype``; the served path rounds the expert inputs
    to bf16, as the reference does, and there an f32 difference reroutes
    tokens)."""
    import copy
    import torch
    from torch import nn
    from repro_torch.models.moe import MoE
    v = m.with_config(dtype="float32")
    v._modules = dict(m._modules)
    embed = copy.copy(m.embed)
    embed.tok = m.embed.tok.float()
    if m.embed.pos is not None:
        embed.pos = m.embed.pos.float()
    v.embed = embed
    if m.encoder is not None:
        # the encoder's positions and the cross K/V cache in f32 too
        enc = copy.copy(m.encoder)
        if enc.pos is not None:
            enc.pos = m.encoder.pos.float()
        v.encoder = enc

        def init_cache(batch, length):
            c = type(m).init_cache(v, batch, length)
            return {**c, "layers": [
                {**l, **{k: l[k].float() for k in ("cross_k", "cross_v")}}
                for l in c["layers"]]}
        v.init_cache = init_cache
    if any(isinstance(b.mlp, MoE) for b in m.stack.layers):
        stack = copy.copy(m.stack)
        stack._modules = dict(m.stack._modules)
        blocks = []
        for b in m.stack.layers:
            b = copy.copy(b)
            b._modules = dict(b._modules)
            if isinstance(b.mlp, MoE):
                b.mlp = copy.copy(b.mlp)
                b.mlp.bank_dtype = torch.float32
            blocks.append(b)
        stack.layers = nn.ModuleList(blocks)
        v.stack = stack
    return v


# the bodies a prefill of more than 8 rows must not reach: those the
# tiles leave odd shapes to
ODD_SHAPE_BODIES = ("bcq_matmul/mma_dq", "lut_gemm/mma_dq",
                    "ternary_matmul/mma_dq")


def f32_on_tiles(torch, tag, fn):
    """Run ``fn``, a kernel-path call on an f32 view that prefills more
    than 8 rows a linear, and gate the GEMM bodies it launched: its BCQ
    linears on the tensor-core tile (``mma``; an untied head's rows of 8
    or fewer on the decode tile), no body of the odd shapes.  Returns (fn's
    result, its route counts, its wall time in ms between two
    synchronizes)."""
    from repro_torch.kernels import _lib
    before = dict(_lib.route_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ran = {k: n - before.get(k, 0) for k, n in _lib.route_counts.items()
           if n != before.get(k, 0)}
    if any(k in ODD_SHAPE_BODIES for k in ran) or not any(
            k.endswith("/mma") for k in ran):
        fail(f"serve[{tag}]: the f32 view's prefill ran {ran}, not its "
             "linears on the tensor-core tile")
    return got, ran, ms


def logit_error_by_depth(torch, kern, plain, toks, depths):
    """First-prefill logit error (relative to the logit scale) of the
    kernel path against the plain path after the first k layers, in the
    served bf16 model and in its f32 view: how the error grows with
    depth, and what is left without bf16 rounding.  A third column holds
    the plain bf16 path against the plain f32 path, with whether their
    argmax agrees: the error bf16 rounding alone makes, no kernel on
    either side.  The f32 view's kernel-path prefill must run its linears
    on the tensor-core tile (``f32_on_tiles``); its time is recorded."""
    out = {}
    for k in depths:
        row, logits = {}, {}
        for name, view in (("bf16", lambda x: x), ("f32", f32_view)):
            if name == "f32":
                got, row["f32_routes"], row["f32_prefill_ms"] = f32_on_tiles(
                    torch, f"{kern.cfg.name} f32, {k} layers",
                    lambda: first_logits(torch, view(depth_view(kern, k)),
                                         toks))
            else:
                got = first_logits(torch, view(depth_view(kern, k)), toks)
            want = first_logits(torch, view(depth_view(plain, k)), toks)
            row[name] = float((got - want).abs().max()) / float(
                want.abs().max())
            logits[name] = want
            del got
        bf, f32 = logits["bf16"].float(), logits["f32"].float()
        row["plain_bf16_vs_f32"] = float((bf - f32).abs().max()) / float(
            f32.abs().max())
        row["plain_argmax_equal"] = int(bf.argmax()) == int(f32.argmax())
        del logits, bf, f32
        out[k] = row
        log(f"first-prefill logit error after {k:2d} layers: bf16 "
            f"{row['bf16']:.3e}, f32 {row['f32']:.3e}; plain bf16 vs "
            f"plain f32 {row['plain_bf16_vs_f32']:.3e} (argmax equal: "
            f"{row['plain_argmax_equal']}); the f32 view's kernel prefill "
            f"{row['f32_prefill_ms']:.1f} ms, GEMM bodies "
            f"{row['f32_routes']}")
    torch.cuda.empty_cache()
    return out


def instrument(torch, model, prefill):
    """Wrap ``model``'s ``decode_step`` (timed between two synchronizes)
    and its ``prefill`` method (by name: ``prefill_chunk`` or
    ``prefill``) on that object.  Returns the lists they fill, one entry
    per call: step times (ms), each step's kernel launches, and the GEMM
    bodies each step and each prefill launched (route counter
    differences); and a dict of two more lists: ``finite``, whether every
    logit row of each call was finite, and ``drops``, per prefill of a
    model with MoE layers, its (real-token, pad) assignments dropped
    beyond expert capacity (``moe_drops``: a chunk's pads follow its
    ``last_idx``, a whole prompt's left-pads precede ``-start_pos``)."""
    from repro_torch.kernels import _lib
    from repro_torch.models.moe import MoE
    step_ms, step_launches, step_routes, chunk_routes = [], [], [], []
    extra = {"finite": [], "drops": []}
    has_moe = any(isinstance(b.mlp, MoE) for b in model.stack.layers)
    inner_decode, inner_prefill = model.decode_step, getattr(model, prefill)

    def route_diff(before):
        return {k: n - before.get(k, 0) for k, n in _lib.route_counts.items()
                if n != before.get(k, 0)}

    def timed_decode(*a, **kw):
        before = dict(_lib.launch_counts)
        routes = dict(_lib.route_counts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = inner_decode(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        extra["finite"].append(bool(torch.isfinite(r[0]).all()))
        step_launches.append({k: _lib.launch_counts[k] - before[k]
                              for k in before})
        step_routes.append(route_diff(routes))
        return r

    def counted_prefill(tokens, cache, start_pos, *last_idx, **inputs):
        routes = dict(_lib.route_counts)
        r = inner_prefill(tokens, cache, start_pos, *last_idx, **inputs)
        chunk_routes.append(route_diff(routes))
        extra["finite"].append(bool(torch.isfinite(r[0]).all()))
        if has_moe:
            real = (slice(0, int(last_idx[0]) + 1) if last_idx
                    else slice(max(0, -int(start_pos)), None))
            extra["drops"].append(moe_drops(model, real))
        return r
    model.decode_step = timed_decode
    setattr(model, prefill, counted_prefill)
    return step_ms, step_launches, step_routes, chunk_routes, extra


def serve_one(torch, tag, m, want, toks, prompts, eng_kw, results, gemm,
              attn, prefill, required, totals, power_line, manifest,
              by_depth=None, mixed=None, kern_ms=None):
    """One serve run of the 8-request mix on model view ``m``: the first
    prefill's logits against the plain path's ``want``, then the engine
    with the launch counters set to 0 just before and read just after;
    every kernel in ``required`` must have launched.  With ``by_depth``
    (MiniCPM3 and the rotary GQA decoders) the gate is the full-depth f32
    view's error (see ``serve_model``) and the bf16 error is reported
    beside it.  With
    ``mixed`` (a mixed-precision plan, ``mixed_plan``) ``gemm`` is the
    plan's kernels, every decode step and prefill chunk must run all of
    its linears on them, and the step's kernel time sums the plan's
    widths.  ``kern_ms``, where given, is the step's kernel time (for
    weights phase 3 did not time)."""
    from repro_torch.kernels import _lib
    from repro_torch.models.attention import kv_entry_bytes
    from repro_torch.serve import PagedServeEngine, Request

    cfg = m.cfg
    # each GEMM and attention kernel agrees with its plain version to
    # ~1e-5 of its output scale (phase 3; int8 attention to its bf16
    # rounding), but the residual stream is re-rounded to bf16 twice per
    # layer, and over 32 (OPT) layers single-ulp flips compound: the
    # stated tolerance is 5e-2 of the largest |logit| (``by_depth``
    # replaces it where deeper or wider stacks outgrow it).
    tol = 5e-2
    got = first_logits(torch, m, toks)
    if not torch.isfinite(got).all() or got.shape != want.shape:
        fail(f"serve[{tag}]: first-prefill logits not finite")
    rel = float((got - want).abs().max()) / float(want.abs().max())
    gate = "not gated" if by_depth else f"<= {tol:g}: {rel <= tol}"
    log(f"serve[{tag}] first prefill logits vs plain path "
        f"(dense dequant + gathered attention): rel err {rel:.3e} "
        f"({gate}); argmax equal: {int(got.argmax())} vs "
        f"{int(want.argmax())}")
    if by_depth is not None:
        f32_rel = by_depth[cfg.n_layers]["f32"]
        log(f"serve[{tag}] gate: the f32 view's first-prefill logits "
            f"{f32_rel:.3e} <= {F32_LOGIT_TOL:g}: {f32_rel <= F32_LOGIT_TOL}"
            f"; the bf16 error above, {rel:.3e}, is reported, not gated "
            f"(it grows with depth: "
            + ", ".join(f"{k} layers {v['bf16']:.2e}"
                        for k, v in sorted(by_depth.items())) + ")")
        if not f32_rel <= F32_LOGIT_TOL:
            fail(f"serve[{tag}]: kernel path disagrees with plain path "
                 "(f32 view)")
    elif rel > tol:
        fail(f"serve[{tag}]: kernel path disagrees with plain path")
    # the engine runs a view of m, so the wrappers do not outlive the run
    eng = PagedServeEngine(m.with_config(), paged_kernel="fused", **eng_kw)
    step_ms, step_launches, step_routes, chunk_routes, extra = instrument(
        torch, eng.model, "prefill_chunk")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs, max_ticks=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_lib.launch_counts)
    for k in totals:
        totals[k] += counts[k]
    bad = [r.uid for r in done if r.error or len(r.out_tokens) != 32]
    if len(done) != len(reqs) or bad:
        fail(f"serve[{tag}]: requests incomplete: {bad}")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        fail(f"serve[{tag}]: token outside the vocabulary")
    for k in required:
        if counts[k] <= 0:
            fail(f"serve[{tag}]: {k} never launched on the main path")
    finite_gate(tag, extra)
    # the decode attention kernel once per layer in every decode step, the
    # prefill kernel once per layer in every chunk
    if any(n[attn] != cfg.n_layers for n in step_launches):
        fail(f"serve[{tag}]: a decode step did not launch {attn} once per "
             f"layer ({cfg.n_layers}): "
             f"{sorted({n[attn] for n in step_launches})}")
    if prefill and counts[prefill] != cfg.n_layers * len(chunk_routes):
        fail(f"serve[{tag}]: {counts[prefill]} launches of {prefill} in "
             f"{len(chunk_routes)} prefill chunks of {cfg.n_layers} layers")
    step_lin, chunk_lin = (mixed["linears"],) * 2 if mixed \
        else step_linears(cfg)
    routes = route_totals(tag, gemm, step_routes, chunk_routes,
                          dict(_lib.route_counts), linears=step_lin,
                          chunk_linears=chunk_lin)
    s = eng.metrics.summary()
    toks_out = s["counters"]["tokens_out"]
    steps = sorted(step_ms)
    p50 = steps[len(steps) // 2] if steps else float("nan")
    if kern_ms is None:
        kern_ms = (mixed["kern_ms"] if mixed
                   else step_kernel_ms(results, gemm, attn, cfg))
    per_step = step_launches[len(step_launches) // 2] \
        if step_launches else {}
    kv_tok = kv_entry_bytes(cfg) * cfg.n_layers
    # the prefill kernel's share of the run: its phase-3 time at the C 512
    # chunk (MHA) times its launches (chunks of 32-512 rows, so an
    # estimate from above)
    pre_ms, pre_line = None, ""
    if prefill:
        t1 = attn_record(results, prefill, cfg, c=512)["ms"]
        pre_ms = t1 * counts[prefill]
        pre_line = (f"; prefill kernel {prefill} {counts[prefill]} launches "
                    f"x {t1:.4f} ms = {pre_ms:.2f} ms beside TTFT p50 "
                    f"{s['ttft_s']['p50'] * 1e3:.1f} ms")
    out = dict(
        requests=len(done), prompt_lens=[len(p) for p in prompts],
        tokens_out=toks_out, wall_s=wall, tokens_per_s=toks_out / wall,
        ttft_p50_ms=s["ttft_s"]["p50"] * 1e3, decode_step_ms_p50=p50,
        decode_steps=len(steps), launches=counts,
        launches_per_decode_step=per_step, decode_path=eng.decode_path,
        prefill_path=eng.prefill_path, first_prefill_rel_err=rel,
        step_kernel_ms=kern_ms, weight_bytes=manifest.quant_bytes,
        kv_bytes_per_token=kv_tok, kv_cache_bits=cfg.kv_cache_bits,
        prefill_kernel_ms=pre_ms, routes=routes,
        arch=cfg.name, layers=cfg.n_layers, finite_logit_calls=len(
            extra["finite"]),
        tokens={r.uid: list(r.out_tokens) for r in done})
    if extra["drops"]:
        out["dropped_per_chunk"] = [list(d) for d in extra["drops"]]
        log(f"serve[{tag}]: assignments dropped beyond expert capacity "
            f"per prefill chunk (real, pads): {extra['drops']}")
    head = [r for r in results.get("dense_head", [])
            if (r["m"], r["n"]) == (cfg.padded_vocab, cfg.d_model)]
    if head and cfg.tie_embeddings:
        out["tied_head_ms"] = head[0]["ms"]
        kern_ms_line = (f"{kern_ms:.2f} ms of device time by the phase-3 "
                        f"times, + the tied head's dense matmul "
                        f"{head[0]['ms']:.4f} ms")
    else:
        kern_ms_line = f"{kern_ms:.2f} ms of device time by the phase-3 times"
    log(f"serve[{tag}]: {len(done)} requests, {toks_out} tokens in "
        f"{wall:.2f} s = {toks_out / wall:.1f} tok/s; TTFT p50 "
        f"{s['ttft_s']['p50'] * 1e3:.1f} ms; decode step p50 "
        f"{p50:.2f} ms over {len(steps)} steps (its kernels: "
        f"{kern_ms_line}); "
        f"weights {manifest.quant_bytes / 1e9:.3f} GB; KV "
        f"{kv_tok} B per token"
        f"{'' if cfg.attention == 'mla' else f' ({cfg.kv_cache_bits}-bit)'}; "
        f"launches {counts}; per decode step {per_step}{pre_line}; GEMM "
        f"bodies: decode steps {routes['decode']}, prefill chunks "
        f"{routes['prefill']} ({routes['prefill_mma_share']:.1%} of the "
        f"chunks' {gemm if isinstance(gemm, str) else ' + '.join(gemm)} "
        f"launches on the tensor cores); card {power_line}")
    del eng
    torch.cuda.empty_cache()
    return out


def build_quantized(torch, cfg, spec, seed):
    """``cfg`` on the card with random weights from ``seed``, quantized to
    ``spec`` there (a MoE layer's banks one expert at a time).  Returns
    (the model, its manifest, its parameter count before quantization,
    the generator for later draws)."""
    from repro_torch.models import Model
    from repro_torch.quant import quantize_model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init_params(gen)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = model.n_params()
    t0 = time.perf_counter()
    manifest = quantize_model(model, spec)
    torch.cuda.synchronize()
    log(f"init {t_init:.1f} s ({n_params / 1e9:.3f} G parameters); "
        f"{spec.format} on the card {time.perf_counter() - t0:.1f} s: "
        f"{manifest.summary()}")
    return model, manifest, n_params, gen


def contiguous_prefill_gate(torch, tag, kern, plain, toks, cache_len,
                            reference=None, inputs=None):
    """First-prefill logits of ``toks`` [B, S] on the kernel path ``kern``
    through the contiguous cache (``Model.prefill``: the GEMM kernels;
    attention or the SSD scan plain PyTorch over the cache, as the
    reference leaves them to XLA) against the plain path ``plain``: its
    own contiguous prefill, or ``reference(view)`` where given, in bf16
    and in both f32 views.  ``inputs`` are ``Model.prefill``'s keyword
    tensors (``patch_embeds``, ``frames``), cast to f32 for the f32
    views.  Gate: the f32 views within ``F32_LOGIT_TOL`` of the logit
    scale, the kernel path's f32 prefill on the tensor-core tile
    (``f32_on_tiles``); the bf16 error is printed beside it, not gated.
    Fails on a non-finite logit on either path.  Returns {"bf16": rel,
    "f32": rel, "f32_prefill_ms": the f32 kernel prefill's wall time,
    "f32_routes": its GEMM bodies}."""
    def contiguous(view, kw):
        got, _ = view.prefill(toks, view.init_cache(toks.shape[0],
                                                    cache_len), 0, **kw)
        torch.cuda.synchronize()
        return got
    rel, argmax = {}, {}
    for name, view in (("bf16", lambda v: v), ("f32", f32_view)):
        kw = {k: (t.float() if name == "f32" else t)
              for k, t in (inputs or {}).items()}
        if name == "f32":
            got, routes, ms = f32_on_tiles(
                torch, tag, lambda: contiguous(view(kern), kw))
        else:
            got = contiguous(view(kern), kw)
        want = (reference(view(plain)) if reference
                else contiguous(view(plain), kw))
        if (got.shape != want.shape or not torch.isfinite(got).all()
                or not torch.isfinite(want).all()):
            fail(f"serve[{tag}]: first-prefill logits not finite")
        rel[name] = float((got - want).abs().max()) / float(want.abs().max())
        argmax[name] = int(got.argmax()) == int(want.argmax())
        del got, want
    log(f"serve[{tag}] first prefill logits (contiguous cache) vs plain "
        f"path (dense dequant{', gathered paged attention' if reference else ''}"
        f"): gate: the f32 view's {rel['f32']:.3e} <= {F32_LOGIT_TOL:g}: "
        f"{rel['f32'] <= F32_LOGIT_TOL}; bf16 rel err {rel['bf16']:.3e} "
        f"(reported, not gated); argmax equal: bf16 {argmax['bf16']}, f32 "
        f"{argmax['f32']}; the f32 view's kernel prefill {ms:.1f} ms, GEMM "
        f"bodies {routes}")
    if not rel["f32"] <= F32_LOGIT_TOL:
        fail(f"serve[{tag}]: kernel path disagrees with plain path (f32 "
             "view)")
    torch.cuda.empty_cache()
    return dict(rel, f32_prefill_ms=ms, f32_routes=routes)


def serve_slots(torch, tag, m, plain, toks, prompts, results, gemm, totals,
                power_line, manifest, paged_tokens):
    """The 8-request mix through the slots engine (``ServeEngine``, 8 slots
    of 512, buckets 32/128/512) on model view ``m``: the contiguous
    path's first-prefill logits in the f32 views of ``m`` and of the
    plain paged path ``plain`` within ``F32_LOGIT_TOL`` of the logit
    scale (``contiguous_prefill_gate``; ``serve_one``'s gate for the
    rotary GQA decoders), the bf16 error reported beside it; then the
    engine with the launch
    counters set to 0 just before and read just after.  Every decode
    step must run all of the model's linears on the decode tile and
    every prompt's prefill all of them on the tensor-core tile
    (``route_totals``), and no paged attention kernel may launch.  The
    share of greedy tokens equal to the paged run's (``paged_tokens``)
    is printed, not gated: at bf16 and full depth, random weights turn
    single roundings into different argmaxes (the MiniCPM3 finding)."""
    from repro_torch.models.attention import kv_entry_bytes
    from repro_torch.serve import Request

    cfg = m.cfg
    cache_len = 512
    rel = contiguous_prefill_gate(
        torch, tag, m, plain, toks, cache_len,
        reference=lambda view: first_logits(torch, view, toks))
    out, _ = run_slots(torch, tag, m, [
        Request(uid=i, prompt=p, max_new_tokens=32)
        for i, p in enumerate(prompts)], cache_len, totals, gemm)
    tokens = out["tokens"]
    same = sum(a == b for uid, toks_ in tokens.items()
               for a, b in zip(toks_, paged_tokens[uid]))
    share = same / sum(len(t) for t in tokens.values())
    kern_ms = step_kernel_ms(results, gemm, "paged_decode", cfg)
    out.update(
        first_prefill_rel_err=rel["bf16"],
        first_prefill_f32_rel_err=rel["f32"],
        gate_f32_prefill_ms=rel["f32_prefill_ms"],
        gate_f32_routes=rel["f32_routes"],
        weight_bytes=manifest.quant_bytes,
        kv_bytes_per_token=kv_entry_bytes(cfg) * cfg.n_layers,
        tokens_equal_to_paged=share,
        gemm_kernel_ms_per_step=kern_ms - cfg.n_layers * attn_record(
            results, "paged_decode", cfg, b=8)["ms"])
    log(f"serve[{tag}]: {out['requests']} requests, {out['tokens_out']} "
        f"tokens in {out['wall_s']:.2f} s = {out['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {out['ttft_p50_ms']:.1f} ms; decode step p50 "
        f"{out['decode_step_ms_p50']:.2f} ms over {out['decode_steps']} "
        f"steps (its GEMM kernels: "
        f"{out['gemm_kernel_ms_per_step']:.2f} ms by the phase-3 times; "
        f"attention is plain PyTorch over the contiguous cache); launches "
        f"{out['launches']}; GEMM bodies: decode steps "
        f"{out['routes']['decode']}, prefills {out['routes']['prefill']}; "
        f"greedy tokens equal to the paged run's: {share:.1%} (not gated); "
        f"card {power_line}")
    torch.cuda.empty_cache()
    return out


def run_slots(torch, tag, m, reqs, cache_len, totals, gemm="bcq_matmul"):
    """``reqs`` through the slots engine (``ServeEngine``, 8 slots of
    ``cache_len``, buckets 32/128/512) on a view of model ``m`` (the
    timing wrappers live on the view), the launch counters set to 0 just
    before and read just after (and added to ``totals``).  Gates: every
    request done with its ``max_new_tokens`` tokens, all inside the
    vocabulary; ``gemm`` launched; every logit row finite; no paged
    kernel; every decode step's linears on the decode tile and every
    prefill's on the tensor-core tile (``route_totals``).  Returns (the
    run's numbers, ``instrument``'s dict of finiteness and MoE drops)."""
    from repro_torch.kernels import _lib
    from repro_torch.serve import ServeEngine

    cfg = m.cfg
    view = m.with_config()
    eng = ServeEngine(view, slots=8, cache_len=cache_len,
                      prefill_buckets=BUCKETS)
    step_ms, _, step_routes, chunk_routes, extra = instrument(
        torch, view, "prefill")
    first = {}
    for r in reqs:
        r.on_token = lambda tok, req: first.setdefault(req.uid,
                                                       time.perf_counter())
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs, max_ticks=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_lib.launch_counts)
    for k in totals:
        totals[k] += counts[k]
    bad = [r.uid for r in done
           if r.error or len(r.out_tokens) != r.max_new_tokens]
    if len(done) != len(reqs) or bad:
        fail(f"serve[{tag}]: requests incomplete: {bad}")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        fail(f"serve[{tag}]: token outside the vocabulary")
    if counts[gemm] <= 0:
        fail(f"serve[{tag}]: {gemm} never launched on the main path")
    finite_gate(tag, extra)
    paged = {k: n for k, n in counts.items() if k.startswith("paged_")
             and n}
    if paged:
        fail(f"serve[{tag}]: the slots engine launched paged kernels "
             f"{paged}")
    step_lin, chunk_lin = step_linears(cfg)
    routes = route_totals(tag, gemm, step_routes, chunk_routes,
                          dict(_lib.route_counts), linears=step_lin,
                          chunk_linears=chunk_lin)
    ttft = sorted(first[r.uid] - t0 for r in done)
    steps = sorted(step_ms)
    toks_out = sum(len(r.out_tokens) for r in done)
    out = dict(
        engine="slots", slots=8, cache_len=cache_len, requests=len(done),
        prompt_lens=[len(r.prompt) for r in reqs], tokens_out=toks_out,
        wall_s=wall, tokens_per_s=toks_out / wall,
        ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
        decode_step_ms_p50=steps[len(steps) // 2], decode_steps=len(steps),
        launches=counts, routes=routes, arch=cfg.name, layers=cfg.n_layers,
        finite_logit_calls=len(extra["finite"]),
        tokens={r.uid: list(r.out_tokens) for r in done})
    del eng, view
    return out, extra


def finite_gate(tag, extra):
    """Fail unless every logit row of every decode step and prefill of
    the run was finite (``instrument``)."""
    if not extra["finite"] or not all(extra["finite"]):
        bad = [i for i, ok in enumerate(extra["finite"]) if not ok]
        fail(f"serve[{tag}]: non-finite logits in calls {bad} of "
             f"{len(extra['finite'])}")
    log(f"serve[{tag}]: every logit row finite in all "
        f"{len(extra['finite'])} decode steps and prefills")


def route_totals(tag, gemm, step_routes, chunk_routes, total, linears=None,
                 chunk_linears=None):
    """The GEMM bodies of one serve run, split into decode steps and
    prefill chunks.  ``gemm`` is the run's GEMM kernel, or a tuple of them
    (a mixed-precision plan's bcq_matmul and ternary_matmul).  Gates:
    every decode step launches counted bodies and none runs the
    tensor-core tile (decode rows are at most 8); with bcq_matmul and with
    ternary_matmul every decode step runs the tensor-core decode tile
    (``gemv``) of each of the run's kernels and nothing else; and in every
    prefill chunk all of the GEMM launches but the head's (one row per
    request) run the tensor-core tile.  With ``linears`` (the model's
    quantized linears) each decode step's ``gemv`` launches and each
    chunk's ``mma`` launches must number exactly that (``chunk_linears``,
    where it differs: an untied head runs a chunk's one row on the decode
    tile): every linear ran on a kernel, none on a plain path."""
    chunk_linears = chunk_linears or linears
    gemms = (gemm,) if isinstance(gemm, str) else tuple(gemm)

    def add(rows):
        out = {}
        for r in rows:
            for k, n in r.items():
                out[k] = out.get(k, 0) + n
        return out
    decode, prefill = add(step_routes), add(chunk_routes)
    if sum(decode.values()) + sum(prefill.values()) != sum(total.values()):
        fail(f"serve[{tag}]: GEMM launches outside the decode steps and "
             "prefill chunks")
    if any(k.endswith("/mma") for k in decode):
        fail(f"serve[{tag}]: a decode step ran the tensor-core tile")
    if set(gemms) <= {"bcq_matmul", "ternary_matmul"}:
        # decode steps run the tensor-core decode tile, never the
        # CUDA-core GEMV or the half-LUT body (the shapes they keep are
        # not served)
        want = {f"{g}/gemv" for g in gemms}
        for i, r in enumerate(step_routes):
            bodies = {k for k in r if k.split("/")[0] in gemms}
            if bodies != want:
                fail(f"serve[{tag}]: decode step {i} GEMM bodies {r}: its "
                     "linears must run the tensor-core decode tile")
            if linears and sum(r[k] for k in bodies) != linears:
                fail(f"serve[{tag}]: decode step {i} ran {r}, not "
                     f"{linears} linears on the decode tile")
    if not all(step_routes) or not chunk_routes:
        fail(f"serve[{tag}]: a decode step or the run's prefill launched "
             "no counted GEMM body")
    mma = {f"{g}/mma" for g in gemms}
    for i, r in enumerate(chunk_routes):
        n_mma = sum(n for k, n in r.items() if k in mma)
        other = sum(n for k, n in r.items() if k not in mma)
        if n_mma <= 0 or other > 1 or (chunk_linears
                                        and n_mma != chunk_linears):
            fail(f"serve[{tag}]: prefill chunk {i} GEMM bodies {r}: its "
                 "linears must run the tensor-core tile")
    n_gemm = sum(n for k, n in prefill.items() if k.split("/")[0] in gemms)
    return dict(decode=decode, prefill=prefill,
                prefill_chunks=len(chunk_routes),
                prefill_mma_share=sum(prefill.get(k, 0) for k in mma)
                / max(1, n_gemm))


def expert_path_times(torch, model, gen):
    """The first MoE layer of ``model`` (BCQ-3 banks) timed on the card:
    routing, the dequantize of every routed expert to bf16 and its three
    f32-accumulated products, the combine, and the shared experts where
    the config has them (on the BCQ tiles), at a batch-8 decode (x [8, 1,
    d]) and a 512-row prefill (x [1, 512, d]), bf16.  No kernel of the
    port runs in the routed path (the reference has none); the routing's
    host read of the routed experts falls inside the time."""
    from repro_torch.models.moe import MoE, route
    moe = next(b.mlp for b in model.stack.layers if isinstance(b.mlp, MoE))
    from repro_torch.tune.measure import Timer
    timer = Timer(iters=5, warmup=1)
    out = {}
    for name, shape in (("decode_b8", (8, 1)), ("prefill_512", (1, 512))):
        x = torch.randn((*shape, model.cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        t = timer(lambda: moe(x))
        experts = route(moe.router, x, model.cfg.experts_per_token)[1]
        routed = int(torch.unique(experts).numel())
        out[name] = dict(ms=t, rows=shape[0] * shape[1],
                         experts_routed=routed)
        log(f"{model.cfg.name} expert path ({name}, one layer, BCQ-3 "
            f"banks dequantized to bf16, no kernel): {t:.3f} ms, {routed} "
            f"of {model.cfg.n_experts} experts routed")
    del timer
    torch.cuda.empty_cache()
    return out


def moe_drops(model, real):
    """(real-token assignments, pad assignments) dropped beyond capacity
    over ``model``'s MoE layers in its last call; ``real`` (a slice of
    the sequence axis) holds its real tokens, the other rows are pads."""
    from repro_torch.models.moe import MoE
    n_real = n_pad = 0
    for blk in model.stack.layers:
        if not isinstance(blk.mlp, MoE):
            continue
        dropped = ~blk.mlp.last_keep                      # [B, S, k]
        is_real = dropped.new_zeros(dropped.shape[1])
        is_real[real] = True
        n_real += int(dropped[:, is_real].sum())
        n_pad += int(dropped[:, ~is_real].sum())
    return n_real, n_pad


def long_prompt_gate(torch, kern, plain, prompt, steps=4):
    """The long prompt left-padded into its bucket (the top bucket
    rounded up: 4608 for 4200 tokens, 408 pads) and prefilled into a
    1-row contiguous cache of ``MIXTRAL_CACHE_LEN`` (a ring of 4096: only
    the trailing 4096 entries stay), then ``steps`` decode steps at
    positions 4200 on, each written past the ring's wrap, feeding the
    prompt's first tokens; in the f32 views of the kernel and the plain
    path.  Gate: the last step's logits within ``F32_LOGIT_TOL`` of the
    logit scale.  Reported beside it, not gated: the plain path against a
    plain full-sequence forward of the same tokens (window mask, no
    pads), from which the served path departs where the reference's
    does: the prefill's queries read only the ring's trailing entries,
    and the pads take expert capacity."""
    import numpy as np
    plen = len(prompt)
    bucket = next((b for b in BUCKETS if plen <= b),
                  -(-plen // BUCKETS[-1]) * BUCKETS[-1])
    toks = np.zeros((1, bucket), np.int64)
    toks[0, -plen:] = prompt
    feed = prompt[:steps]
    logits, drops = {}, None
    for name, m in (("kernel", kern), ("plain", plain)):
        v = f32_view(m)
        cache = v.init_cache(1, MIXTRAL_CACHE_LEN)
        pre = lambda: v.prefill(torch.as_tensor(toks, device="cuda"), cache,
                                plen - bucket)
        if name == "kernel":
            (_, cache), routes, pre_ms = f32_on_tiles(
                torch, "mixtral long prompt", pre)
        else:
            _, cache = pre()
        if drops is None:
            drops = moe_drops(v, slice(bucket - plen, None))
        for t in range(steps):
            out, cache = v.decode_step(
                torch.as_tensor([[int(feed[t])]], device="cuda"), cache,
                plen + t)
        torch.cuda.synchronize()
        logits[name] = out
        del cache, v
        torch.cuda.empty_cache()
    got, want = logits["kernel"], logits["plain"]
    if not torch.isfinite(got).all():
        fail("mixtral long prompt: decode logits not finite")
    rel = float((got - want).abs().max()) / float(want.abs().max())
    full = f32_view(plain).forward(torch.as_tensor(
        np.concatenate([prompt, feed])[None], device="cuda"))[:, -1]
    rel_full = float((want - full).abs().max()) / float(full.abs().max())
    del full
    torch.cuda.empty_cache()
    log(f"mixtral long prompt ({plen} tokens in a bucket of {bucket}, ring "
        f"{min(MIXTRAL_CACHE_LEN, kern.cfg.sliding_window)}): decode step "
        f"{steps} past the wrap, f32 view, kernel vs plain path: rel err "
        f"{rel:.3e} <= {F32_LOGIT_TOL:g}: {rel <= F32_LOGIT_TOL}; argmax "
        f"{int(got.argmax())} vs {int(want.argmax())}; its prefill dropped "
        f"{drops[0]} real-token and {drops[1]} pad assignments; the f32 "
        f"kernel prefill {pre_ms:.1f} ms, GEMM bodies {routes}; the plain "
        f"path against a plain full-sequence forward with the window "
        f"(not gated): {rel_full:.3e}")
    if not rel <= F32_LOGIT_TOL:
        fail("mixtral long prompt: kernel path disagrees with plain path "
             "after the wrap (f32 view)")
    return dict(prompt_len=plen, bucket=bucket, decode_steps=steps,
                f32_rel_err=rel, plain_vs_full_forward_rel=rel_full,
                f32_prefill_ms=pre_ms, f32_routes=routes,
                dropped_real=drops[0], dropped_pads=drops[1])


def serve_mixtral(torch, args, power_line, results, totals):
    """Mixtral-8x7B at full width (d 4096, 32 heads over 8 kv heads, 8
    experts top-2, moe_d_ff 14336, vocab 32000, window 4096, rope theta
    1e6), ``MIXTRAL_SERVE_LAYERS`` of 32 layers, BCQ-3 g 128 random
    weights from ``--seed``, through the slots engine (``ServeEngine``,
    8 slots of ``MIXTRAL_CACHE_LEN``, buckets 32/128/512): the 8-request
    mix plus one request of ``LONG_PROMPT`` tokens and ``LONG_NEW`` new
    ones, submitted first.  Gates: the f32 view's first prefill (the
    mix's first 128 tokens, contiguous cache) against the plain path
    within ``F32_LOGIT_TOL`` (the bf16 error printed), the long prompt
    after the wrap (``long_prompt_gate``), every decode step's 33 BCQ
    linears (8 x q/k/v/o + the head) on ``gemv`` and every prefill's 32
    on ``mma`` (the head's one row on ``gemv``), no paged kernel."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantSpec
    from repro_torch.serve import Request

    full = get_config("mixtral_8x7b")
    cfg = full.replace(n_layers=MIXTRAL_SERVE_LAYERS)
    spec = QuantSpec(format="bcq", bits=3, group_size=128)
    log(f"serve: {cfg.name} d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} experts={cfg.n_experts} top-"
        f"{cfg.experts_per_token} moe_d_ff={cfg.moe_d_ff} vocab="
        f"{cfg.vocab_size} window={cfg.sliding_window}; full width, depth "
        f"cut to {cfg.n_layers} of its {full.n_layers} layers; "
        f"{spec.describe()} weights")
    prompts = mix_prompts(args.seed, cfg.vocab_size)
    long_prompt = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (LONG_PROMPT,))
    model, manifest, _, gen = build_quantized(torch, cfg, spec, args.seed)
    kern = model.with_config(quant=spec)
    plain = model.with_config(quant=spec.replace(backend="dense"))
    expert = expert_path_times(torch, kern, gen)
    toks = torch.as_tensor(prompts[0][None, :128], device="cuda")
    rel = contiguous_prefill_gate(torch, "mixtral", kern, plain, toks,
                                  MIXTRAL_CACHE_LEN)
    wrap = long_prompt_gate(torch, kern, plain, long_prompt)

    reqs = [Request(uid=8, prompt=long_prompt, max_new_tokens=LONG_NEW)]
    reqs += [Request(uid=i, prompt=p, max_new_tokens=32)
             for i, p in enumerate(prompts)]
    out, extra = run_slots(torch, "mixtral", kern, reqs, MIXTRAL_CACHE_LEN,
                           totals)
    drops = extra["drops"]
    layer, head = layer_gemm_shapes(cfg, 0), gemm_shapes(cfg)[1]
    t8 = {(r["m"], r["n"]): r["ms"] for r in results["bcq_matmul"]
          if r.get("model") == "mixtral_8x7b" and r["rows"] == 8}
    kern_ms = cfg.n_layers * sum(t8[sh] for sh in layer) + t8[head]
    expert_ms = cfg.n_layers * expert["decode_b8"]["ms"]
    out.update(
        ring=min(MIXTRAL_CACHE_LEN, cfg.sliding_window),
        first_prefill_rel_err=rel["bf16"],
        first_prefill_f32_rel_err=rel["f32"],
        gate_f32_prefill_ms=rel["f32_prefill_ms"],
        gate_f32_routes=rel["f32_routes"], long_prompt=wrap,
        step_kernel_ms=kern_ms, expert_path=expert,
        expert_path_ms_per_step=expert_ms,
        weight_bytes=manifest.quant_bytes,
        dropped_first_prefill={"real": drops[0][0], "pads": drops[0][1]},
        dropped_all_prefills=[list(d) for d in drops])
    log(f"serve[mixtral]: {out['requests']} requests ({LONG_PROMPT}-token "
        f"prompt first), {out['tokens_out']} tokens in {out['wall_s']:.2f} "
        f"s = {out['tokens_per_s']:.1f} tok/s; TTFT p50 "
        f"{out['ttft_p50_ms']:.1f} ms; decode step p50 "
        f"{out['decode_step_ms_p50']:.2f} ms over {out['decode_steps']} "
        f"steps (its BCQ kernels: {kern_ms:.2f} ms by the phase-3 times; "
        f"its expert path, no kernel: {expert_ms:.2f} ms = {cfg.n_layers} "
        f"x {expert['decode_b8']['ms']:.3f} ms); weights "
        f"{manifest.quant_bytes / 1e9:.3f} GB; first prefill dropped "
        f"{drops[0][0]} real-token and {drops[0][1]} pad assignments; "
        f"launches {out['launches']}; GEMM bodies: decode steps "
        f"{out['routes']['decode']}, prefills {out['routes']['prefill']}; "
        f"card {power_line}")
    del kern, plain, model
    torch.cuda.empty_cache()
    return out


def serve_mamba(torch, args, power_line, results, totals):
    """Mamba2-2.7B at full width and depth (64 layers, d 2560, d_inner
    5120, 80 heads of 64, state 128, conv 4, chunk 128, tied vocab
    50280), BCQ-3 g 128 random weights from ``--seed``, through the slots
    engine (``ServeEngine``, 8 slots of 512, buckets 32/128/512): the
    8-request mix, 32 new tokens each, every prompt left-padded into its
    bucket (the pads enter the SSM state, as in the reference).  Gates:
    the f32 view's first prefill (the mix's first 128 tokens, contiguous
    cache) against the plain path within ``F32_LOGIT_TOL`` (the bf16
    error printed); every logit row finite; every decode step's 128 BCQ
    linears (64 x in_proj, out_proj) on ``gemv`` and every prefill's 128
    on ``mma`` (the tied head is a dense matmul); no paged kernel."""
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantSpec
    from repro_torch.serve import Request

    cfg = get_config("mamba2_2_7b")
    spec = QuantSpec(format="bcq", bits=3, group_size=128)
    cache_len = 512
    log(f"serve: {cfg.name} d={cfg.d_model} d_inner="
        f"{cfg.ssm_expand * cfg.d_model} state={cfg.ssm_state} "
        f"chunk={cfg.ssm_chunk} vocab={cfg.vocab_size}; full width and "
        f"depth ({cfg.n_layers} layers); {spec.describe()} weights")
    prompts = mix_prompts(args.seed, cfg.vocab_size)
    model, manifest, n_params, _ = build_quantized(torch, cfg, spec,
                                                   args.seed)
    kern = model.with_config(quant=spec)
    plain = model.with_config(quant=spec.replace(backend="dense"))
    toks = torch.as_tensor(prompts[0][None, :128], device="cuda")
    rel = contiguous_prefill_gate(torch, "mamba2", kern, plain, toks,
                                  cache_len)
    out, _ = run_slots(torch, "mamba2", kern, [
        Request(uid=i, prompt=p, max_new_tokens=32)
        for i, p in enumerate(prompts)], cache_len, totals)
    kern_ms = step_kernel_ms(results, "bcq_matmul", None, cfg)
    head = [r for r in results["dense_head"]
            if r["model"] == "mamba2_2_7b"][0]
    pads = [next(b for b in BUCKETS if len(p) <= b) - len(p)
            for p in prompts]
    out.update(
        left_pads=pads, first_prefill_rel_err=rel["bf16"],
        first_prefill_f32_rel_err=rel["f32"],
        gate_f32_prefill_ms=rel["f32_prefill_ms"],
        gate_f32_routes=rel["f32_routes"], step_kernel_ms=kern_ms,
        tied_head_ms=head["ms"], weight_bytes=manifest.quant_bytes,
        params=n_params)
    log(f"serve[mamba2]: {out['requests']} requests, {out['tokens_out']} "
        f"tokens in {out['wall_s']:.2f} s = {out['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {out['ttft_p50_ms']:.1f} ms; decode step p50 "
        f"{out['decode_step_ms_p50']:.2f} ms over {out['decode_steps']} "
        f"steps (its BCQ kernels: {kern_ms:.2f} ms by the phase-3 times, + "
        f"the tied head's dense matmul {head['ms']:.4f} ms; the SSD scan, "
        f"conv and state update are plain PyTorch); weights "
        f"{manifest.quant_bytes / 1e9:.3f} GB; left-pads per prompt "
        f"{pads}; launches {out['launches']}; GEMM bodies: decode steps "
        f"{out['routes']['decode']}, prefills {out['routes']['prefill']}; "
        f"card {power_line}")
    del kern, plain, model
    torch.cuda.empty_cache()
    return out


def serve_jamba(torch, args, power_line, results, totals):
    """Jamba-1.5-Large at full width (d 8192, 64 heads over 8 kv heads of
    128, Mamba layers of d_inner 16384 with 128 SSM heads of 128 and
    state 64, 16 experts top-2 of moe_d_ff 24576, dense d_ff 24576,
    untied vocab 65536), ``JAMBA_SERVE_LAYERS`` of its 72 layers (Mamba
    0-3, MoE at 1 and 3, attention at 4), BCQ-3 g 128 random weights from
    ``--seed``, through the slots engine (8 slots of 512, buckets
    32/128/512): the 8-request mix with ``JAMBA_NEW_TOKENS`` new tokens
    each, every prompt left-padded into its bucket (the pads enter the
    Mamba state and take expert capacity, as in the reference).  Gates:
    the f32 view's first prefill (the mix's first 128 tokens, contiguous
    cache; expert banks dequantized to f32) against the plain path within
    ``F32_LOGIT_TOL`` (the bf16 error printed); every logit row finite;
    every decode step's 22 BCQ linears (4 x in_proj, out_proj, 3 dense
    MLPs, the attention layer's q/k/v/o, the head) on ``gemv`` and every
    prefill's 21 on ``mma``; no paged kernel.  The expert path is timed
    per layer and the drops beyond expert capacity printed per prefill."""
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantSpec
    from repro_torch.serve import Request

    full = get_config("jamba_1_5_large_398b")
    cfg = full.replace(n_layers=JAMBA_SERVE_LAYERS)
    spec = QuantSpec(format="bcq", bits=3, group_size=128)
    cache_len = 512
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    moe_at = [i for i in range(cfg.n_layers) if cfg.mlp_kind(i) == "moe"]
    log(f"serve: {cfg.name} d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_inner={cfg.ssm_expand * cfg.d_model} state="
        f"{cfg.ssm_state} experts={cfg.n_experts} top-"
        f"{cfg.experts_per_token} moe_d_ff={cfg.moe_d_ff} vocab="
        f"{cfg.vocab_size}; full width, depth cut to {cfg.n_layers} of its "
        f"{full.n_layers} layers ({kinds}, MoE at {moe_at}); "
        f"{JAMBA_NEW_TOKENS} new tokens a request; {spec.describe()} weights")
    prompts = mix_prompts(args.seed, cfg.vocab_size)
    model, manifest, n_params, gen = build_quantized(torch, cfg, spec,
                                                     args.seed)
    kern = model.with_config(quant=spec)
    plain = model.with_config(quant=spec.replace(backend="dense"))
    expert = expert_path_times(torch, kern, gen)
    toks = torch.as_tensor(prompts[0][None, :128], device="cuda")
    rel = contiguous_prefill_gate(torch, "jamba", kern, plain, toks,
                                  cache_len)
    out, extra = run_slots(torch, "jamba", kern, [
        Request(uid=i, prompt=p, max_new_tokens=JAMBA_NEW_TOKENS)
        for i, p in enumerate(prompts)], cache_len, totals)
    drops = extra["drops"]
    kern_ms = step_kernel_ms(results, "bcq_matmul", None, cfg)
    n_moe = len(moe_at)
    expert_ms = n_moe * expert["decode_b8"]["ms"]
    out.update(
        first_prefill_rel_err=rel["bf16"],
        first_prefill_f32_rel_err=rel["f32"],
        gate_f32_prefill_ms=rel["f32_prefill_ms"],
        gate_f32_routes=rel["f32_routes"], step_kernel_ms=kern_ms,
        expert_path=expert, expert_path_ms_per_step=expert_ms,
        weight_bytes=manifest.quant_bytes, params=n_params,
        dropped_all_prefills=[list(d) for d in drops])
    log(f"serve[jamba]: {out['requests']} requests, {out['tokens_out']} "
        f"tokens in {out['wall_s']:.2f} s = {out['tokens_per_s']:.1f} "
        f"tok/s; TTFT p50 {out['ttft_p50_ms']:.1f} ms; decode step p50 "
        f"{out['decode_step_ms_p50']:.2f} ms over {out['decode_steps']} "
        f"steps (its BCQ kernels: {kern_ms:.2f} ms by the phase-3 times; "
        f"its expert path, no kernel: {expert_ms:.2f} ms = {n_moe} x "
        f"{expert['decode_b8']['ms']:.3f} ms; the SSD scan and attention "
        f"are plain PyTorch); weights {manifest.quant_bytes / 1e9:.3f} GB "
        f"({n_params / 1e9:.2f} G parameters before quantization); "
        f"assignments dropped beyond expert capacity per prefill (real, "
        f"pads): {drops}; launches {out['launches']}; GEMM bodies: decode "
        f"steps {out['routes']['decode']}, prefills "
        f"{out['routes']['prefill']}; card {power_line}")
    del kern, plain, model
    torch.cuda.empty_cache()
    return out


def model_api_run(torch, tag, m, toks, cache_len, steps, totals, linears,
                  prefill_linears, start, **inputs):
    """``toks`` [B, S] (with ``inputs``: ``patch_embeds`` or ``frames``)
    through ``Model.prefill`` into a contiguous cache of ``cache_len`` on
    a view of ``m``, then ``steps`` greedy decode steps fed their own
    argmax at positions ``start`` on (the positions the prefill filled),
    the launch counters set to 0 just before and read just after
    (and added to ``totals``).  Gates: every token inside the
    vocabulary, every logit row finite, no paged kernel (the cache is
    contiguous: its attention is plain PyTorch), ``linears`` on ``gemv``
    in every decode step and ``prefill_linears`` on ``mma`` in the
    prefill, the head's B rows on ``gemv`` (``route_totals``).  Returns
    (prefill ms, sorted decode-step ms, the tokens as [steps][B] lists,
    launch counts, routes)."""
    from repro_torch.kernels import _lib
    view = m.with_config()
    step_ms, _, step_routes, chunk_routes, extra = instrument(
        torch, view, "prefill")
    cache = view.init_cache(toks.shape[0], cache_len)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = view.prefill(toks, cache, 0, **inputs)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tokens = []
    for t in range(steps):
        tok = logits.argmax(-1)
        tokens.append(tok.tolist())
        logits, cache = view.decode_step(tok[:, None], cache, start + t)
    torch.cuda.synchronize()
    counts = dict(_lib.launch_counts)
    for k in totals:
        totals[k] += counts[k]
    del cache, view
    if any(not 0 <= t < m.cfg.vocab_size for row in tokens for t in row):
        fail(f"serve[{tag}]: token outside the vocabulary")
    finite_gate(tag, extra)
    paged = {k: n for k, n in counts.items() if k.startswith("paged_")
             and n}
    if paged:
        fail(f"serve[{tag}]: paged kernels on a contiguous cache {paged}")
    routes = route_totals(tag, "bcq_matmul", step_routes, chunk_routes,
                          dict(_lib.route_counts), linears=linears,
                          chunk_linears=prefill_linears)
    return prefill_ms, sorted(step_ms), tokens, counts, routes


def pixtral_vlm(torch, args, model, spec, manifest, totals, power_line):
    """Pixtral-12B's stub frontend on the served weights: 8 rows of
    ``num_patches`` random patch embeddings (N(0, 0.02), bf16, from
    ``--seed``) and ``PIXTRAL_TEXT`` text tokens each, no pads, through
    ``Model.prefill`` into a contiguous cache of ``PIXTRAL_CACHE_LEN``,
    then ``PIXTRAL_VLM_STEPS`` greedy decode steps, the launch counters
    set to 0 just before and read just after.  Gates: the f32 view's
    prefill logits (the first two rows) against the plain path within
    ``F32_LOGIT_TOL``; every logit row finite; the prefill's 280 linears
    on ``mma`` (8 x 1100 rows a call) and the head's 8 rows on ``gemv``,
    every decode step's 281 on ``gemv`` (``model_api_run``)."""
    cfg = model.cfg
    b, p = 8, cfg.num_patches
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    patches = (torch.randn((b, p, cfg.d_model), generator=gen,
                           device="cuda") * 0.02).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (b, PIXTRAL_TEXT),
                         generator=gen, device="cuda")
    kern = model.with_config(quant=spec)
    plain = model.with_config(quant=spec.replace(backend="dense"))
    log(f"pixtral vlm: {b} rows of {p} patches + {PIXTRAL_TEXT} tokens "
        f"({p + PIXTRAL_TEXT} positions a row), contiguous cache of "
        f"{PIXTRAL_CACHE_LEN}, {PIXTRAL_VLM_STEPS} decode steps")
    rel = contiguous_prefill_gate(torch, "pixtral_vlm", kern, plain,
                                  toks[:2], PIXTRAL_CACHE_LEN,
                                  inputs={"patch_embeds": patches[:2]})
    del plain
    step_lin, chunk_lin = step_linears(cfg)
    prefill_ms, steps, tokens, counts, routes = model_api_run(
        torch, "pixtral_vlm", kern, toks, PIXTRAL_CACHE_LEN,
        PIXTRAL_VLM_STEPS, totals, step_lin, chunk_lin, p + PIXTRAL_TEXT,
        patch_embeds=patches)
    p50 = steps[len(steps) // 2]
    log(f"serve[pixtral_vlm]: prefill of {b} x {p + PIXTRAL_TEXT} positions "
        f"{prefill_ms:.1f} ms ({chunk_lin} linears on mma at "
        f"{b * (p + PIXTRAL_TEXT)} rows a call, the head's {b} rows on "
        f"gemv); decode step p50 {p50:.2f} ms over {len(steps)} steps "
        f"({step_lin} linears on gemv); "
        f"{b * len(steps) / sum(steps) * 1e3:.1f} tok/s in decode; f32-view prefill gate {rel['f32']:.3e}, bf16 "
        f"{rel['bf16']:.3e}; launches {counts}; GEMM bodies: decode steps "
        f"{routes['decode']}, prefill {routes['prefill']}; card "
        f"{power_line}")
    del kern
    torch.cuda.empty_cache()
    return {"pixtral_vlm": dict(
        rows=b, patches=p, text=PIXTRAL_TEXT, cache_len=PIXTRAL_CACHE_LEN,
        prefill_ms=prefill_ms, decode_step_ms_p50=p50,
        decode_steps=len(steps), launches=counts, routes=routes,
        first_prefill_rel_err=rel["bf16"],
        first_prefill_f32_rel_err=rel["f32"],
        gate_f32_prefill_ms=rel["f32_prefill_ms"],
        gate_f32_routes=rel["f32_routes"],
        weight_bytes=manifest.quant_bytes, tokens=tokens)}


def serve_whisper(torch, args, power_line, results, totals):
    """Whisper-medium at full width and depth (24 encoder + 24 decoder
    layers, d 1024, 16 heads of 64, GELU d_ff 4096, LayerNorm, learned
    positions, untied vocab 51865), BCQ-3 g 128 random weights from
    ``--seed``, through the model API (neither engine serves an
    encoder-decoder, as in the reference): 8 rows of 1500 random frames
    (N(0, 1), bf16) and a ``WHISPER_PROMPT``-token decoder prompt through
    ``Model.prefill`` into a contiguous cache, then ``WHISPER_STEPS``
    greedy decode steps, the launch counters set to 0 just before and
    read just after.  Gates: the f32 view within ``F32_LOGIT_TOL`` of the
    logit scale against the plain path at the prefill and at the last
    step (the served tokens fed to both); every logit row finite; the
    prefill's 384 linears (the encoder's 144 and the cross k/v at 12,000
    rows, the decoder's at 32) on ``mma`` and the head's 8 rows on
    ``gemv``; every decode step's 193 (24 x (4 self + 2 cross + 2 MLP) +
    the head) on ``gemv``, the cross K/V read from the cache
    (``model_api_run``)."""
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantSpec

    cfg = get_config("whisper_medium")
    spec = QuantSpec(format="bcq", bits=3, group_size=128)
    b, cache_len = 8, 64
    log(f"serve: {cfg.name} d={cfg.d_model} heads={cfg.n_heads} d_ff="
        f"{cfg.d_ff} vocab={cfg.vocab_size}; full width and depth "
        f"({cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, "
        f"{cfg.encoder_seq} frames; a learned position table of "
        f"{cfg.max_seq_len} as the reference's config has it); "
        f"{spec.describe()} weights")
    model, manifest, n_params, gen = build_quantized(torch, cfg, spec,
                                                     args.seed)
    kern = model.with_config(quant=spec)
    plain = model.with_config(quant=spec.replace(backend="dense"))
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (b, WHISPER_PROMPT),
                         generator=gen, device="cuda")
    rel = contiguous_prefill_gate(torch, "whisper", kern, plain, toks,
                                  cache_len, inputs={"frames": frames})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kern.encode(frames)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    mlp = 3 if cfg.mlp_act == "swiglu" else 2
    chunk_lin = cfg.n_encoder_layers * (4 + mlp) + cfg.n_layers * (8 + mlp)
    step_lin, _ = step_linears(cfg)
    prefill_ms, steps, tokens, counts, routes = model_api_run(
        torch, "whisper", kern, toks, cache_len, WHISPER_STEPS, totals,
        step_lin, chunk_lin, WHISPER_PROMPT, frames=frames)
    tokens = torch.as_tensor(tokens, device="cuda")

    def f32_run(m):
        v = f32_view(m)
        pre = lambda: v.prefill(toks, v.init_cache(b, cache_len), 0,
                                frames=frames.float())
        if m is kern:
            (first, c), f32_out["routes"], f32_out["ms"] = f32_on_tiles(
                torch, "whisper f32 run", pre)
        else:
            first, c = pre()
        for t, tok in enumerate(tokens):
            last, c = v.decode_step(tok[:, None], c, WHISPER_PROMPT + t)
        torch.cuda.synchronize()
        return first, last
    f32_out = {}
    got, want = f32_run(kern), f32_run(plain)
    rel_first, rel_last = (float((g - w).abs().max()) / float(w.abs().max())
                           for g, w in zip(got, want))
    if not all(torch.isfinite(t).all() for t in (*got, *want)):
        fail("serve[whisper]: f32-view logits not finite")
    log(f"serve[whisper] f32 view, kernel vs plain path with the served "
        f"tokens: prefill {rel_first:.3e}, step {WHISPER_STEPS} "
        f"{rel_last:.3e} (<= {F32_LOGIT_TOL:g}: "
        f"{max(rel_first, rel_last) <= F32_LOGIT_TOL}); the f32 kernel "
        f"prefill {f32_out['ms']:.1f} ms, GEMM bodies {f32_out['routes']}")
    if not max(rel_first, rel_last) <= F32_LOGIT_TOL:
        fail("serve[whisper]: kernel path disagrees with plain path (f32 "
             "view)")
    del got, want
    p50 = steps[len(steps) // 2]
    kern_ms = step_kernel_ms(results, "bcq_matmul", None, cfg)
    log(f"serve[whisper]: encoder {encode_ms:.1f} ms ({b} x "
        f"{cfg.encoder_seq} frames); prefill {prefill_ms:.1f} ms (encoder "
        f"+ {WHISPER_PROMPT}-token decoder prompt, cross K/V written); "
        f"decode step p50 {p50:.2f} ms over {len(steps)} steps (its BCQ "
        f"kernels: {kern_ms:.2f} ms by the phase-3 times; attention plain "
        f"PyTorch), {b * len(steps) / sum(steps) * 1e3:.1f} tok/s in "
        f"decode; weights {manifest.quant_bytes / 1e9:.3f} GB "
        f"({n_params / 1e9:.3f} G parameters before quantization, the "
        f"position table's {cfg.max_seq_len * cfg.d_model / 1e9:.3f} G "
        f"among them); launches {counts}; GEMM bodies: decode steps "
        f"{routes['decode']}, prefill {routes['prefill']}; card "
        f"{power_line}")
    del kern, plain, model
    torch.cuda.empty_cache()
    return dict(
        rows=b, prompt=WHISPER_PROMPT, encode_ms=encode_ms,
        prefill_ms=prefill_ms, decode_step_ms_p50=p50,
        decode_steps=len(steps), tokens_per_s=b * len(steps) / sum(steps)
        * 1e3, step_kernel_ms=kern_ms, launches=counts, routes=routes,
        first_prefill_rel_err=rel["bf16"],
        first_prefill_f32_rel_err=rel["f32"],
        gate_f32_prefill_ms=rel["f32_prefill_ms"],
        gate_f32_routes=rel["f32_routes"],
        f32_rel_err_prefill=rel_first, f32_rel_err_last_step=rel_last,
        f32_prefill_ms=f32_out["ms"], f32_routes=f32_out["routes"],
        weight_bytes=manifest.quant_bytes, params=n_params,
        tokens=tokens.tolist())


def engines_f32(torch, m, prompts, eng_kw):
    """The 8-request mix (32 new tokens each) through the paged engine
    (fused paged kernels) and the slots engine (8 slots of 512) on the f32
    view of ``m``: the share of greedy tokens equal, and where each
    request's streams part, printed and recorded, not gated.  Equal
    streams in f32 put the bf16 runs' disagreement on rounding.  Each
    engine's run must put its prefills' linears on the tensor-core tile
    and reach no CUDA-core body (``f32_on_tiles``)."""
    from repro_torch.serve import PagedServeEngine, Request, ServeEngine
    v = f32_view(m)
    toks = {}
    for name, eng in (
            ("paged", PagedServeEngine(v, paged_kernel="fused", **eng_kw)),
            ("slots", ServeEngine(v, slots=8, cache_len=512,
                                  prefill_buckets=(32, 128, 512)))):
        done, routes, _ = f32_on_tiles(
            torch, f"engines_f32[{name}]", lambda: eng.run(
                [Request(uid=i, prompt=p, max_new_tokens=32)
                 for i, p in enumerate(prompts)], max_ticks=4000))
        log(f"{m.cfg.name} f32 view, {name} engine: GEMM bodies {routes}")
        if len(done) != len(prompts) or any(r.error for r in done):
            fail(f"engines_f32[{name}]: requests incomplete")
        toks[name] = {r.uid: list(r.out_tokens) for r in done}
        del eng
    parts = {}
    for uid, a in toks["paged"].items():
        b = toks["slots"][uid]
        parts[uid] = next((i for i, (x, y) in enumerate(zip(a, b))
                           if x != y), None)
    same = sum(x == y for uid, a in toks["paged"].items()
               for x, y in zip(a, toks["slots"][uid]))
    share = same / sum(len(a) for a in toks["paged"].values())
    log(f"{m.cfg.name} f32 view, paged vs slots engine: greedy tokens equal "
        f"{share:.1%}; streams identical {sum(p is None for p in parts.values())}"
        f" of {len(parts)}; first differing token per request {parts}")
    del v
    torch.cuda.empty_cache()
    return dict(tokens_equal=share, parts_at=parts, tokens=toks)


def serve(torch, args, power_line, results):
    """Phase 4: the serve runs, each through the paged engine with fused
    paged attention.  Returns (per-run results, launch totals)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.quant import QuantSpec

    eng_kw = dict(num_blocks=256, block_size=16, max_batch=8,
                  max_seq_len=512, prefill_buckets=(32, 128, 512))
    serve_out = {}
    totals = {k: 0 for k in _lib.KERNELS}
    bcq3 = QuantSpec(format="bcq", bits=3, group_size=128)
    full_opt = get_config("opt_6_7b")
    opt = full_opt.replace(n_layers=args.layers)
    mla = get_config("minicpm3_4b")                    # full width and depth
    phi4 = get_config("phi4_mini_3_8b")                # full width and depth
    full_qwen = get_config("qwen1_5_32b")
    qwen = full_qwen.replace(n_layers=QWEN_SERVE_LAYERS)
    full_ds = get_config("deepseek_v2_236b")
    deepseek = full_ds.replace(n_layers=DEEPSEEK_SERVE_LAYERS)
    # Qwen at full depth is ~67 GB of bf16 weights before quantization
    # (the model is built dense, then quantized one linear at a time), so
    # depth is the one cut, and it is printed
    log(f"qwen1.5-32b: full width, depth cut to {qwen.n_layers} of its "
        f"{full_qwen.n_layers} layers; deepseek-v2-236b: full width, depth "
        f"cut to {deepseek.n_layers} of its {full_ds.n_layers} layers")
    runs = (
        # (config, weight spec, KV bits, [(run name, backend, gemm
        #  kernel, engine)], decode attention kernel, prefill attention
        #  kernel)
        (opt, bcq3, 16, [("auto", "auto", "bcq_matmul", "paged"),
                         ("lut_pallas", "lut_pallas", "lut_gemm", "paged")],
         "paged_decode", "paged_prefill"),
        (opt, QuantSpec(format="ternary", group_size=128), 8,
         [("ternary_int8kv", "auto", "ternary_matmul", "paged")],
         "paged_decode_int8", "paged_prefill_int8"),
        # MLA prefill stays on the gathered path, as in the reference
        (mla, bcq3, 16, [("minicpm3_auto", "auto", "bcq_matmul", "paged")],
         "paged_decode_mla", None),
        # mixed precision at full width and depth (GEMM kernels from the
        # plan): the paper's 2.4-bit point, and a 1.8-bit budget that
        # mixes ternary and BCQ leaves
        (full_opt, QuantSpec(format="bcq", bits=2.4, group_size=128), 16,
         [("opt_mixed_2p4", "auto", None, "paged")], "paged_decode",
         "paged_prefill"),
        (full_opt, QuantSpec(format="bcq", bits=1.8, group_size=128), 16,
         [("opt_mixed_1p8", "auto", None, "paged")], "paged_decode",
         "paged_prefill"),
        # the rotary GQA decoders: Phi-4-mini at full width and depth
        # through both engines on the same weights (GQA rep 3), then
        # Qwen1.5-32B at full width and QWEN_SERVE_LAYERS of its 64 layers
        (phi4, bcq3, 16, [("phi4_paged", "auto", "bcq_matmul", "paged"),
                          ("phi4_slots", "auto", "bcq_matmul", "slots")],
         "paged_decode", "paged_prefill"),
        (qwen, bcq3, 16, [("qwen_paged", "auto", "bcq_matmul", "paged")],
         "paged_decode", "paged_prefill"),
        # MLA + MoE (160 experts top-6, 2 shared) after one dense layer, at
        # full width and DEEPSEEK_SERVE_LAYERS of its 60 layers; its
        # prefill is gathered, as MiniCPM3's
        (deepseek, bcq3, 16, [("deepseek_paged", "auto", "bcq_matmul",
                               "paged")], "paged_decode_mla", None),
    )
    for cfg, spec, kv_bits, backends, attn, prefill in runs:
        # the mesh run (serve_sharded, two ranks on the one card) of the
        # weights of each run SHARDED_KINDS names
        kind = sharded_kind(cfg, spec, kv_bits)
        after = None if kind is None else (
            lambda model, manifest, kind=kind, spec=spec:
            {f"serve_sharded_{kind}": serve_sharded(
                torch, args, model, spec, eng_kw, totals, power_line,
                kind=kind)})
        if kind == "opt":
            # the OPT BCQ-3 weights: serving breadth (prefix cache, async
            # tick, sampling, cancel, deadlines, trace), then the tune
            # phase's winners, then the mesh run
            after = lambda model, manifest: {
                # the stored bytes phase 7's byte model is held against
                "opt_param_bytes": opt_param_bytes(model),
                "serve_breadth": serve_breadth(torch, args, model, bcq3,
                                               power_line, totals),
                "serve_tuned": serve_tuned(torch, args, model, bcq3, eng_kw,
                                           totals, power_line),
                "serve_sharded": serve_sharded(torch, args, model, bcq3,
                                               eng_kw, totals, power_line)}
        serve_model(torch, args, cfg, spec, kv_bits, backends, attn,
                    prefill, eng_kw, results, totals, power_line, serve_out,
                    after=after)
    # sliding-window attention and MoE layers through the slots engine
    serve_out["mixtral"] = serve_mixtral(torch, args, power_line, results,
                                         totals)
    # the SSD mixer through the slots engine, at full width and depth
    serve_out["mamba2"] = serve_mamba(torch, args, power_line, results,
                                      totals)
    # the hybrid: Mamba, MoE and attention layers through the slots engine
    serve_out["jamba"] = serve_jamba(torch, args, power_line, results,
                                     totals)
    # Pixtral-12B at full width and depth: text through the paged engine
    # (GQA rep 4), then its patch frontend through Model.prefill on the
    # same weights
    pixtral = get_config("pixtral_12b")
    serve_model(torch, args, pixtral, bcq3, 16,
                [("pixtral_paged", "auto", "bcq_matmul", "paged")],
                "paged_decode", "paged_prefill", eng_kw, results, totals,
                power_line, serve_out,
                after=lambda model, manifest: pixtral_vlm(
                    torch, args, model, bcq3, manifest, totals, power_line))
    # the encoder-decoder through the model API, at full width and depth
    serve_out["whisper"] = serve_whisper(torch, args, power_line, results,
                                         totals)
    serve_out["checkpoint_round_trip"] = checkpoint_round_trip(
        torch, args, eng_kw)
    # an OPTQ checkpoint through both GEMM kernels
    serve_out["optq"] = optq_phase(torch, args, power_line, results, totals,
                                   eng_kw)
    return serve_out, totals


BREADTH_COUNTERS = ("admitted", "preempted", "tokens_out", "prefill_chunks",
                    "prefix_lookups", "prefix_hit_requests",
                    "prefix_hit_blocks", "prefix_tokens_saved",
                    "prefix_cow_tokens")


def serve_breadth(torch, args, model, spec, power_line, totals):
    """Phase 4, serving breadth, on the OPT-6.7B BCQ-3 weights the OPT run
    quantized: 8 requests that share a 256-token prefix, tails of 16-144
    tokens, 32 new tokens each; the first submitted one tick before the
    rest (so its prompt blocks are registered when they are admitted).
    (a) prefix cache on against off: identical greedy tokens in bf16
    with the top prefill bucket at the prefix's 256 tokens (so off splits
    each prompt where on adopts, and every tail chunk runs at the same
    bucket in both) and on the f32 view at the engine's buckets; at those
    buckets in bf16 the share of equal tokens is printed; hit blocks > 0;
    in every prefix-on run the pool bytes of every adopted block are
    unchanged from the copy taken when its writer's prefill filled it;
    (b) ``run``-style sync ticks against async ticks: identical
    tokens and counters, decode-step p50 and device-busy fraction of
    each, every async decode-only tick under
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync fails the
    run; ticks with a prefill run under "warn" and their flagged syncs
    are counted); (c) seeded sampling (temperature 0.7, top-k 40) sync
    against async, top-k 1 against greedy, the sampler's device time at
    [8, vocab]; (d) one cancel and one expired deadline, then the pool
    back at capacity; (e) that run's trace, written as ``--trace-out``
    writes it, through ``validate_chrome``."""
    import json as _json
    import traceback
    import warnings

    import numpy as np
    from repro_torch import obs
    from repro_torch.kernels import _lib
    from repro_torch.models.model import sample_tokens
    from repro_torch.serve import PagedServeEngine, Request

    m = model.with_config(quant=spec.replace(backend="auto"),
                          paged_kernel="fused")
    cfg = m.cfg
    rng = np.random.default_rng(args.seed + 17)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_BLOCKS * 16)
    tails = [int(t) for t in rng.integers(16, 145, 8)]
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, t)])
               .astype(np.int32) for t in tails]
    eng_kw = dict(num_blocks=256, block_size=16, max_batch=8,
                  max_seq_len=512, prefill_buckets=(32, 128, 512))
    need = ("bcq_matmul", "paged_decode", "paged_prefill")
    log(f"serve_breadth: {cfg.name} depth {cfg.n_layers}, 8 requests "
        f"sharing a 256-token prefix, tails {tails}, 32 new tokens each; "
        f"card {power_line}")

    def pool_blocks(eng, blocks):
        """Every layer's pool entries of ``blocks``, copied on the card."""
        idx = torch.as_tensor(blocks, device="cuda")
        return [{k: v[idx].clone() for k, v in layer.items()
                 if k != "block_tables"} for layer in eng.cache["layers"]]

    def drive(tag, mode, prefix_cache, sample=None, tracer=None,
              lifecycle=False, view=None, buckets=None):
        kw = dict(eng_kw, prefill_buckets=buckets or eng_kw["prefill_buckets"])
        eng = PagedServeEngine((view or m).with_config(),
                               prefix_cache=prefix_cache,
                               rng_seed=args.seed, tracer=tracer, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]
        for r in reqs:
            if sample:
                r.temperature, r.top_k = sample
        step = eng.step_async if mode == "async" else eng.step
        tick_ms, flagged, strict, where = [], 0, 0, []

        def flag_sync(message, category, filename, lineno, file=None,
                      line=None):
            """Record a sync the debug mode flagged: its last frames in
            the port and in torch."""
            nonlocal flagged
            if "synchroniz" not in str(message):
                return
            flagged += 1
            frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                      for f in traceback.extract_stack()[:-1]
                      if "repro_torch" in f.filename
                      or "/torch/" in f.filename]
            where.append(" < ".join(reversed(frames[-4:])))

        def tick():
            nonlocal strict
            decode_only = not eng.sched.waiting and all(
                s.kv_len >= s.prefill_target for s in eng.sched.running)
            c0 = dict(eng.metrics.counters)
            t = time.perf_counter()
            if mode == "async" and decode_only:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    step()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                strict += 1
            elif mode == "async":
                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.showwarning = flag_sync
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        step()
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
            else:
                step()
            dt = (time.perf_counter() - t) * 1e3
            c1 = eng.metrics.counters
            if c1["decode_steps"] > c0["decode_steps"] \
                    and c1["prefill_chunks"] == c0["prefill_chunks"]:
                tick_ms.append(dt)

        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        eng.submit(reqs[0])
        tick()
        # the first request's prefix blocks, copied once its first chunk
        # has written them (queued behind that chunk on the stream) and
        # before any other request is submitted: the blocks the others
        # adopt, as their writer left them
        first = next(s for s in eng.sched.running if s.req is reqs[0])
        witnessed = first.table[:first.kv_len // 16][:PREFIX_BLOCKS]
        before = pool_blocks(eng, witnessed) if prefix_cache else None
        adopted = set()
        for r in reqs[1:]:
            eng.submit(r)
        n = 0
        while eng.sched.has_work() or eng.has_inflight:
            n += 1
            if lifecycle and n == 3:
                if not eng.cancel(reqs[2]):
                    fail(f"serve_breadth[{tag}]: cancel found nothing")
            if lifecycle and n == 5:
                reqs[5].deadline_s = eng.clock()      # expires next tick
            tick()
            for s_ in eng.sched.running:
                adopted.update(s_.table[:s_.prefix_hit])
            if n > 4000:
                fail(f"serve_breadth[{tag}]: did not drain")
        eng.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prefix_cache:
            if not adopted:
                fail(f"serve_breadth[{tag}]: no block was adopted")
            if not adopted <= set(witnessed):
                fail(f"serve_breadth[{tag}]: blocks adopted outside the "
                     f"shared prefix: {sorted(adopted - set(witnessed))}")
            after = pool_blocks(eng, witnessed)
            changed = [k for b_, a_ in zip(before, after) for k in b_
                       if not torch.equal(b_[k], a_[k])]
            if changed:
                fail(f"serve_breadth[{tag}]: adopted blocks' pool bytes "
                     f"changed ({sorted(set(changed))})")
            del before, after
        counts = dict(_lib.launch_counts)
        for k in totals:
            totals[k] += counts[k]
        missing = [k for k in need if counts[k] <= 0]
        if missing:
            fail(f"serve_breadth[{tag}]: {missing} never launched")
        bad = {r.uid: r.error for r in reqs
               if r.error or len(r.out_tokens) != 32}
        want_bad = {2: "cancelled", 5: "deadline"} if lifecycle else {}
        if {u: e for u, e in bad.items()} != want_bad:
            fail(f"serve_breadth[{tag}]: unexpected request outcomes {bad}")
        eng.pool.check()
        if eng.prefix is not None:
            eng.prefix.clear()
        if eng.pool.free_blocks != eng.pool.capacity:
            fail(f"serve_breadth[{tag}]: pool not back at capacity "
                 f"({eng.pool.free_blocks} of {eng.pool.capacity} free)")
        s = eng.metrics.summary()
        steps = sorted(tick_ms)
        out = dict(
            mode=mode, prefix_cache=prefix_cache, sample=sample,
            wall_s=wall, tokens_out=s["counters"]["tokens_out"],
            ttft_p50_ms=s["ttft_s"]["p50"] * 1e3,
            decode_step_ms_p50=steps[len(steps) // 2] if steps else None,
            decode_ticks=len(steps),
            device_busy_fraction=s["device_busy_fraction"],
            counters={k: s["counters"][k] for k in BREADTH_COUNTERS},
            launches=counts, strict_ticks=strict, flagged_syncs=flagged,
            adopted_blocks_unchanged=len(adopted) if prefix_cache else None,
            buckets=list(kw["prefill_buckets"]),
            flagged_at=sorted(set(where)),
            tokens={r.uid: list(r.out_tokens) for r in reqs})
        log(f"serve_breadth[{tag}]: {mode}, prefix cache "
            f"{'on' if prefix_cache else 'off'}"
            f"{f', sampled {sample}' if sample else ''}: {wall:.2f} s, "
            f"TTFT p50 {out['ttft_p50_ms']:.1f} ms, decode step p50 "
            f"{out['decode_step_ms_p50']:.2f} ms over {len(steps)} "
            f"decode-only ticks, device busy fraction "
            f"{out['device_busy_fraction']:.3f}; prefix hit blocks "
            f"{s['counters']['prefix_hit_blocks']}, tokens saved "
            f"{s['counters']['prefix_tokens_saved']}"
            + (f", {len(adopted)} adopted blocks' pool bytes unchanged"
               if prefix_cache else "")
            + f"; prefill buckets {kw['prefill_buckets']}; "
            + (f"{strict} decode-only ticks under sync debug 'error', "
               f"{flagged} syncs flagged in ticks with a prefill "
               f"{sorted(set(where))}; "
               if mode == "async" else "")
            + f"launches {counts}; card {power_line}")
        del eng
        return out

    def agreement(a, b):
        """Share of equal greedy tokens and each request's first
        differing token (None: identical streams)."""
        same = sum(x == y for u in a for x, y in zip(a[u], b[u]))
        parts = {u: next((i for i, (x, y) in enumerate(zip(a[u], b[u]))
                          if x != y), None) for u in a}
        return same / sum(len(t) for t in a.values()), parts

    res = {}
    # (a) prefix cache on against off (greedy, sync).  At the engine's
    # buckets an adopted prompt's tail is prefilled as its own chunk, at
    # another bucket than the whole prompt is without the cache, so its
    # bf16 roundings differ and the streams may part: the share is
    # printed.  With the top bucket at the prefix's 256 tokens, off
    # splits every prompt at the prefix too and each tail runs at the
    # same bucket in both: there, and on the f32 view (f32_view) at the
    # engine's buckets, the tokens must be identical.
    res["off"] = drive("off", "sync", False)
    res["on"] = drive("on", "sync", True)
    share, parts = agreement(res["off"]["tokens"], res["on"]["tokens"])
    res["on_off_bf16"] = dict(tokens_equal=share, parts_at=parts)
    log(f"serve_breadth: prefix on vs off in bf16: greedy tokens equal "
        f"{share:.1%}; first differing token per request {parts}")
    split = (32, 128, PREFIX_BLOCKS * 16)
    res["off_split"] = drive("off_split", "sync", False, buckets=split)
    res["on_split"] = drive("on_split", "sync", True, buckets=split)
    if res["on_split"]["tokens"] != res["off_split"]["tokens"]:
        fail("serve_breadth: prefix cache on and off give different bf16 "
             f"tokens at buckets {split}: "
             f"{agreement(res['off_split']['tokens'], res['on_split']['tokens'])}")
    log(f"serve_breadth: prefix on vs off in bf16 at buckets {split}: "
        "identical greedy tokens")
    v = f32_view(m)
    res["off_f32"] = drive("off_f32", "sync", False, view=v)
    res["on_f32"] = drive("on_f32", "sync", True, view=v)
    del v
    if res["on_f32"]["tokens"] != res["off_f32"]["tokens"]:
        fail("serve_breadth: prefix cache on and off give different "
             "tokens on the f32 view: "
             f"{agreement(res['off_f32']['tokens'], res['on_f32']['tokens'])}")
    log("serve_breadth: prefix on vs off on the f32 view: identical greedy "
        "tokens")
    if res["on"]["counters"]["prefix_hit_blocks"] <= 0:
        fail("serve_breadth: no prefix hit blocks")
    # (b) async against sync (greedy, prefix on)
    res["async"] = drive("async", "async", True)
    for key in ("tokens", "counters"):
        if res["async"][key] != res["on"][key]:
            fail(f"serve_breadth: async and sync {key} differ: "
                 f"{res['async'][key] if key == 'counters' else ''} vs "
                 f"{res['on'][key] if key == 'counters' else ''}")
    if not res["async"]["device_busy_fraction"] \
            > res["on"]["device_busy_fraction"]:
        fail("serve_breadth: async device busy fraction not above sync's")
    # (c) seeded sampling: sync against async; top-k 1 against greedy
    res["sampled_sync"] = drive("sampled_sync", "sync", True, (0.7, 40))
    res["sampled_async"] = drive("sampled_async", "async", True, (0.7, 40))
    if res["sampled_async"]["tokens"] != res["sampled_sync"]["tokens"]:
        fail("serve_breadth: sampled tokens differ between sync and async")
    if res["sampled_async"]["tokens"] == res["async"]["tokens"]:
        fail("serve_breadth: sampling at temperature 0.7 gave the greedy "
             "tokens")
    res["top1"] = drive("top1", "async", True, (0.7, 1))
    if res["top1"]["tokens"] != res["async"]["tokens"]:
        fail("serve_breadth: top-k 1 differs from greedy")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    logits = torch.randn((8, cfg.vocab_size), generator=gen, device="cuda")
    keys = torch.randint(0, 2**32, (8, 2), generator=gen, device="cuda",
                         dtype=torch.int64)
    temps = torch.full((8,), 0.7, device="cuda")
    topk = torch.full((8,), 40, dtype=torch.int32, device="cuda")
    from repro_torch.tune.measure import Timer
    timer = Timer()
    res["sampler_ms"] = timer(lambda: sample_tokens(logits, keys, temps,
                                                    topk))
    res["argmax_ms"] = timer(lambda: torch.argmax(logits, -1))
    log(f"serve_breadth: sample_tokens at [8, {cfg.vocab_size}] (top-k 40): "
        f"{res['sampler_ms']:.4f} ms of device time, argmax alone "
        f"{res['argmax_ms']:.4f} ms; card {power_line}")
    del timer
    # (d) cancel and deadline, (e) the trace
    tracer = obs.Tracer()
    res["lifecycle"] = drive("lifecycle", "async", True, tracer=tracer,
                             lifecycle=True)
    path = ROOT / "chiprun_out" / "serve_trace.json"
    path.parent.mkdir(exist_ok=True)
    obs.save_chrome(tracer, str(path))
    errs = obs.validate_chrome(_json.loads(path.read_text()))
    obs.set_active(None)
    if errs:
        fail(f"serve_breadth: trace invalid: {errs[:5]}")
    res["trace_events"] = len(tracer.events)
    log(f"serve_breadth: trace {path.name}: {len(tracer.events)} events, "
        f"{tracer.dropped} dropped, validate_chrome clean; card "
        f"{power_line}")
    for run in res.values():
        if isinstance(run, dict):
            run.pop("tokens", None)
    torch.cuda.empty_cache()
    return res


def mix_prompts(seed, vocab):
    """The 8-request mix: prompts of 48-400 tokens drawn from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(48, 401)) for _ in range(8)]
    return [rng.integers(0, vocab, (n,)) for n in lens]


def mixed_plan(results, cfg, spec, manifest, attn):
    """A mixed-precision run's plan (leaf -> width, 1.585 for ternary) from
    its manifest, printed with the manifest summary and the achieved
    average; fails unless a sub-2 budget mixes ternary and BCQ leaves and
    any other plan holds more than one width.  Returns the plan, its GEMM
    kernels, its linears per step and its decode step's kernel time (the
    phase-3 rows-8 time of each leaf's shape and width, times its layers,
    plus the decode attention at B 8)."""
    plan, n_w, lins, kern_ms = {}, {}, 0, 0.0
    attn_ms = attn_record(results, attn, cfg, b=8)["ms"]
    for leaf in manifest.layers:
        key = leaf["path"]
        b = (leaf["effective_bits"] if leaf["format"] == "ternary"
             else leaf["plane_bits"])
        plan[key] = b
        shape = leaf["shape"]
        n_w[key] = math.prod(shape)
        layers = shape[0] if len(shape) == 3 else 1
        lins += layers
        m, n = shape[-2], shape[-1]
        if b < 2:
            rows = [r for r in results["ternary_matmul"] if "ms" in r]
        elif b == 3:
            rows = [r for r in results["bcq_matmul"] if "model" not in r]
        else:
            rows = [r for r in results["bcq_matmul_widths"]
                    if r["bits"] == b]
        kern_ms += layers * [r["ms"] for r in rows if r["rows"] == 8
                             and (r["m"], r["n"]) == (m, n)][0]
    kern_ms += cfg.n_layers * attn_ms
    avg = sum(plan[k] * n_w[k] for k in plan) / sum(n_w.values())
    log("plan " + ", ".join(f"{k}: {b:g}" for k, b in plan.items()))
    log(f"{spec.describe()}: achieved average {avg:.4f} bits (budget "
        f"{spec.bits:g}); {manifest.summary()}")
    ternary = [k for k, b in plan.items() if b < 2]
    if spec.bits < 2 and (not ternary or len(ternary) == len(plan)):
        fail(f"{spec.describe()}: the plan does not mix ternary and BCQ "
             f"leaves: {plan}")
    if len(set(plan.values())) < 2:
        fail(f"{spec.describe()}: the plan holds one width: {plan}")
    gemms = tuple(g for g, used in (
        ("bcq_matmul", len(ternary) < len(plan)),
        ("ternary_matmul", bool(ternary))) if used)
    return dict(plan=plan, avg_bits=avg, gemms=gemms, linears=lins,
                kern_ms=kern_ms)


def checkpoint_round_trip(torch, args, eng_kw):
    """The 2.4-bit plan on OPT-6.7B at full width and 4 layers: saved with
    ``save_quantized`` into the git-ignored ``build/``, read back into a
    fresh model by ``load_quantized_model``, then deleted.  Every bundle
    and every other leaf must come back bit-identical, and greedy tokens
    for the mix's first prompt must equal the saved model's."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.core.plane import PlaneBundle
    from repro_torch.models import Model, to_params
    from repro_torch.quant import QuantSpec, quantize_model, save_quantized
    from repro_torch.quant.checkpoint import load_quantized_model
    from repro_torch.serve import PagedServeEngine, Request

    cfg = get_config("opt_6_7b").replace(n_layers=4)
    spec = QuantSpec(format="bcq", bits=2.4, group_size=128)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = Model(cfg, device="cuda").init_params(gen)
    manifest = quantize_model(model, spec)
    model = model.with_config(quant=spec)
    d = ROOT / "build" / "ckpt_round_trip"
    shutil.rmtree(d, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = Path(save_quantized(str(d), model, spec, manifest,
                                   arch=cfg.name,
                                   extra_meta={"d_model": cfg.d_model,
                                               "n_layers": cfg.n_layers,
                                               "vocab_size": cfg.vocab_size}))
        t_write = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in path.iterdir())
        t0 = time.perf_counter()
        loaded, spec2, man2, _ = load_quantized_model(str(d), cfg,
                                                      device="cuda")
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if spec2 != spec or man2.to_dict() != manifest.to_dict():
        fail("checkpoint round trip: spec or manifest changed")

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree
    a, b = dict(leaves(to_params(model))), dict(leaves(to_params(loaded)))
    n_bundles = sum(isinstance(lin.weight, PlaneBundle)
                    for blk in loaded.stack.layers
                    for mod in (blk.mixer, blk.mlp)
                    for lin in mod.children())
    same = a.keys() == b.keys() and all(
        (torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype)
        if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a)
    if not same or n_bundles != 6 * cfg.n_layers:
        fail("checkpoint round trip: a leaf differs after loading")
    prompt = mix_prompts(args.seed, cfg.vocab_size)[0]
    outs = []
    for m in (model, loaded):
        eng = PagedServeEngine(m, paged_kernel="fused", **eng_kw)
        done = eng.run([Request(uid=0, prompt=prompt, max_new_tokens=32)],
                       max_ticks=400)
        outs.append(list(done[0].out_tokens))
        del eng
    if outs[0] != outs[1] or len(outs[0]) != 32:
        fail(f"checkpoint round trip: greedy tokens differ: {outs}")
    log(f"checkpoint round trip ({spec.describe()}, {cfg.n_layers} layers "
        f"at full width): {len(a)} leaves, {n_bundles} bundles "
        f"bit-identical; {disk / 1e9:.3f} GB on disk, write {t_write:.2f} s,"
        f" read {t_read:.2f} s; greedy tokens of the first prompt identical "
        f"({len(outs[0])} tokens)")
    del model, loaded
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, leaves=len(a), bundles=n_bundles,
                disk_bytes=disk, write_s=t_write, read_s=t_read,
                tokens=outs[0], plan={l["path"]: l["plane_bits"]
                                      for l in manifest.layers})


# ---------------------------------------------------------------------------
# phase 4: launch-config tuning and OPTQ
# ---------------------------------------------------------------------------

# OPT-6.7B's three layer shapes ([out, in]: q/k/v/o, up, down) and the
# rows the tune phase tunes them at (decode, and the prefill buckets)
OPT_SHAPES = ((4096, 4096), (16384, 4096), (4096, 16384))
TUNE_ROWS = (8, 32, 128, 512)
# the tuning caches of this run (git-ignored, removed at the end): every
# phase but the tuned ones reads a cold cache, so launches the
# heuristic's configs, the wrappers' fixed rules
TUNE_DIR = ROOT / "build" / "chip_smoke_tune"
TUNED_CACHE = TUNE_DIR / "tuned.json"
# OPTQ on OPT-6.7B at full width: the column loop costs seconds a layer,
# so depth is cut to 4 of 32 layers
OPTQ_LAYERS, OPTQ_BITS, OPTQ_GROUP = 4, 3, 64


@contextlib.contextmanager
def tune_env(path, mode="on"):
    """Point ``repro_torch.tune`` at the cache file ``path`` in ``mode``
    for the block (the process-wide cache re-read on entry and exit)."""
    from repro_torch import tune as T
    keys = ("REPRO_TORCH_TUNE_CACHE", "REPRO_TORCH_TUNE")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(REPRO_TORCH_TUNE_CACHE=str(path), REPRO_TORCH_TUNE=mode)
    T.reset_default_cache()
    try:
        yield T.default_cache()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        T.reset_default_cache()


def kernel_events(tracer):
    """{kernel: {source: count}} of a trace's kernel-config records."""
    out = {}
    for e in tracer.events:
        if e["name"].startswith("kernel_config:"):
            src = out.setdefault(e["args"]["kernel"], {})
            src[e["args"]["source"]] = src.get(e["args"]["source"], 0) + 1
    return out


def tune_phase(torch, args, power_line):
    """Tune OPT-6.7B BCQ-3 g 128's three layer shapes at rows 8, 32, 128
    and 512 for bcq_matmul and lut_gemm (mu 4), and paged decode at the
    phase-3 case (B 8, H 32, D 128, bs 16, a 32-page table, ~150 live
    pages), into ``TUNED_CACHE``.  Each key's heuristic time, winner
    time and winner config are printed.  Then the cache is reloaded
    from disk and every winner resolves from it (trace source ``cache``,
    the winner's body launched) and is held against its plain version
    again: the GEMMs at 1e-3 of the output scale, paged decode at its
    bf16-pool gate (2e-2) and, on the same case's f32 pools at the
    winner's split count, at 1e-4."""
    from repro_torch import obs, tune as T
    from repro_torch.core import bcq
    from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
    from repro_torch.kernels.lut_gemm import lut_gemm
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_decode_ref)
    if TUNED_CACHE.exists():
        TUNED_CACHE.unlink()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 28)
    f32 = torch.float32
    cases, recs = [], []
    t0 = time.perf_counter()

    def record(res, kernel, **case):
        heur = res.timings[0]
        rec = dict(kernel=kernel, key=res.key, **case,
                   heuristic=heur.config.to_dict(),
                   heuristic_ms=heur.seconds * 1e3,
                   best=res.best.to_dict(), best_ms=res.best_time * 1e3,
                   speedup=res.speedup, candidates=len(res.timings),
                   invalid=sum(not t.ok for t in res.timings))
        recs.append(rec)
        log(f"tune {kernel:12s} {case}: heuristic {rec['heuristic']} "
            f"{rec['heuristic_ms']:.4f} ms -> winner {rec['best']} "
            f"{rec['best_ms']:.4f} ms (x{rec['speedup']:.3f}; "
            f"{rec['candidates']} candidates, {rec['invalid']} invalid)")

    with tune_env(TUNED_CACHE) as cache:
        for m, n in OPT_SHAPES:
            w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                             * 0.02, bits=3, group_size=128)
            for rows in TUNE_ROWS:
                x = torch.randn((rows, n), generator=gen,
                                device="cuda").to(torch.bfloat16)
                for kernel in ("bcq_matmul", "lut_gemm"):
                    res = T.tune(kernel, x, w, mu=4, cache=cache)
                    cases.append((kernel, x, w, res))
                    record(res, kernel, rows=rows, m=m, n=n)
        pool = pool_case(torch, gen, args.seed + 8, b=8, h=32, d=128, nb=257,
                         bs=16, pages=32, dtype=torch.bfloat16)
        res_pd = T.tune("paged_decode", *pool, cache=cache)
        record(res_pd, "paged_decode", b=8, h=32, hkv=32, d=128, pages=32)
        cache.save()
    tune_s = time.perf_counter() - t0

    # the winners, read back from disk, through the unpinned wrappers
    tracer = obs.Tracer()
    with tune_env(TUNED_CACHE) as cache, obs.activate(tracer):
        if len(cache) != len(recs):
            fail(f"tune: {len(cache)} cache entries after the reload, "
                 f"{len(recs)} tuned")
        for kernel, x, w, res in cases:
            if cache.lookup(res.key) != res.best:
                fail(f"tune: {res.key} reloads as {cache.lookup(res.key)}")
            fn = bcq_matmul if kernel == "bcq_matmul" else lut_gemm
            got, route = routed(torch, kernel,
                                lambda: fn(x, w, out_dtype=f32))
            want = bcq_matmul_ref(x, w, f32)
            rel = float((got - want).abs().max()) / float(want.abs().max())
            if route != res.best.route or not rel <= 1e-3:
                fail(f"tune: {res.key} after the reload ran {route} with "
                     f"rel err {rel:.3e} (winner {res.best})")
        q, k, v, pos, tables, positions = pool
        want = paged_decode_ref(*pool, out_dtype=f32)
        got = paged_attention(*pool, out_dtype=f32)
        rel_bf16 = float((got - want).abs().max()) / float(want.abs().max())
        pool32 = (q.float(), k.float(), v.float(), pos, tables, positions)
        want = paged_decode_ref(*pool32, out_dtype=f32)
        got = paged_attention(*pool32, out_dtype=f32,
                              splits=res_pd.best.splits)
        rel_f32 = float((got - want).abs().max()) / float(want.abs().max())
        if not (rel_bf16 <= 2e-2 and rel_f32 <= 1e-4):
            fail(f"tune: paged decode winner {res_pd.best}: rel err "
                 f"{rel_bf16:.3e} (bf16 pools), {rel_f32:.3e} (f32 pools)")
        torch.cuda.synchronize()
    sources = kernel_events(tracer)
    if any(set(src) != {"cache"} for src in sources.values()) or \
            set(sources) != {"bcq_matmul", "lut_gemm", "paged_decode"}:
        fail(f"tune: the reloaded winners resolved from {sources}")
    moved = sum(r["best"] != r["heuristic"] for r in recs)
    log(f"tune: {len(recs)} keys in {tune_s:.1f} s ({moved} winners other "
        f"than the heuristic); reloaded from {TUNED_CACHE.name}: every "
        f"winner resolved from the cache (trace {sources}) and held "
        f"against its plain version (GEMMs <= 1e-3; paged decode bf16 "
        f"{rel_bf16:.2e} <= 2e-2, f32 pools {rel_f32:.2e} <= 1e-4); card "
        f"{power_line}")
    return dict(records=recs, tune_s=tune_s, moved=moved,
                paged_rel_err_bf16=rel_bf16, paged_rel_err_f32=rel_f32)


def tuned_step_ms(cache, cfg, dtype, tag):
    """A decode step's kernel time at batch 8 from the tuning cache's
    measurements (``tag``: the card's device tag): (winners, heuristics)
    in ms, each GEMM of every layer (bcq_matmul) plus paged decode once
    a layer where its key was tuned, and whether it was; None where a
    GEMM key is missing."""
    from repro_torch.tune import cache as tcache
    best = heur = 0.0
    pd = cache.entries.get(tcache.cache_key(
        "paged_decode", b=8, m=cfg.n_kv_heads, n=512, dtype=dtype,
        mu=cfg.n_heads // cfg.n_kv_heads, group_size=16, device=tag))
    for i in range(cfg.n_layers):
        for m, n in layer_gemm_shapes(cfg, i):
            ent = cache.entries.get(tcache.cache_key(
                "bcq_matmul", b=8, m=m, n=n, dtype=dtype, mu=0,
                group_size=128, device=tag))
            if ent is None:
                return None
            best += ent["time_s"] * 1e3
            heur += ent["default_time_s"] * 1e3
        if pd is not None:
            best += pd["time_s"] * 1e3
            heur += pd["default_time_s"] * 1e3
    return best, heur, pd is not None


def serve_tuned(torch, args, model, spec, eng_kw, totals, power_line):
    """Full-depth OPT-6.7B BCQ-3 (the first OPT run's weights) through the
    paged engine with ``pretune=True`` on the tune phase's cache (every
    bf16 GEMM key is there, so nothing is re-measured) and again under
    ``REPRO_TORCH_TUNE=off``, then both on the f32 view (where pretune
    tunes the f32 keys first).  Gates: the tuned bf16 run's trace holds
    kernel-config records of source ``cache`` and none ``tuned``; the
    ``off`` runs' records are all ``heuristic``; greedy tokens are
    identical on the f32 view.  Printed: the share of bf16 tokens equal,
    each run's step-kernel ms (the cache's measured times x the step's
    launches) and its GEMM bodies."""
    from repro_torch import obs
    from repro_torch.kernels import _lib
    from repro_torch.serve import PagedServeEngine, Request
    from repro_torch.tune import dispatch

    m = model.with_config(quant=spec.replace(backend="auto"),
                          paged_kernel="fused")
    prompts = mix_prompts(args.seed, m.cfg.vocab_size)
    _, tag = dispatch.device_of(torch.empty(0, device="cuda"))

    def run(name, view, mode, pretune):
        with tune_env(TUNED_CACHE, mode) as cache:
            tracer = obs.Tracer()
            t0 = time.perf_counter()
            eng = PagedServeEngine(view.with_config(), tracer=tracer,
                                   pretune=pretune, **eng_kw)
            pre_s = time.perf_counter() - t0
            reqs = [Request(uid=i, prompt=p, max_new_tokens=32)
                    for i, p in enumerate(prompts)]
            torch.cuda.synchronize()
            _lib.reset_launch_counts()
            t0 = time.perf_counter()
            done = eng.run(reqs, max_ticks=4000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eng.attach_tracer(None)
            counts = dict(_lib.launch_counts)
            for k in totals:
                totals[k] += counts[k]
            if len(done) != 8 or any(r.error or len(r.out_tokens) != 32
                                     for r in done):
                fail(f"serve_tuned[{name}]: requests incomplete")
            step = tuned_step_ms(cache, m.cfg, torch.bfloat16 if view is m
                                 else torch.float32, tag)
            s = eng.metrics.summary()
            out = dict(tokens={r.uid: list(r.out_tokens) for r in done},
                       sources=kernel_events(tracer), pretune_s=pre_s,
                       cache_entries=len(cache), wall_s=wall,
                       tokens_per_s=s["counters"]["tokens_out"] / wall,
                       ttft_p50_ms=s["ttft_s"]["p50"] * 1e3,
                       per_token_ms_p50=s["per_token_s"]["p50"] * 1e3,
                       routes=dict(_lib.route_counts), launches=counts)
            if step is not None:
                out["step_kernel_ms"] = step[0] if mode == "on" else step[1]
                out["step_kernel_ms_has_attention"] = step[2]
            del eng
        torch.cuda.empty_cache()
        log(f"serve_tuned[{name}]: pretune {pre_s:.1f} s ({len(cache)} "
            f"cache entries); {out['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{out['ttft_p50_ms']:.1f} ms, per-token p50 "
            f"{out['per_token_ms_p50']:.2f} ms; step kernels "
            f"{out.get('step_kernel_ms', float('nan')):.3f} ms by the "
            f"cache's times (paged decode in it: "
            f"{out.get('step_kernel_ms_has_attention')}); config sources "
            f"{out['sources']}; GEMM bodies "
            f"{out['routes']}; card {power_line}")
        return out

    res = {"bf16_pretune": run("bf16, pretune", m, "on", True),
           "bf16_off": run("bf16, off", m, "off", False)}
    view = f32_view(m)
    res["f32_pretune"] = run("f32 view, pretune", view, "on", True)
    res["f32_off"] = run("f32 view, off", view, "off", False)
    for tag in ("bf16_pretune", "f32_pretune"):
        src = res[tag]["sources"]
        if not any("cache" in v for v in src.values()) or \
                any("tuned" in v for v in src.values()):
            fail(f"serve_tuned[{tag}]: config sources {src}: the tuned "
                 "cache was not read")
    for tag in ("bf16_off", "f32_off"):
        if any(set(v) != {"heuristic"} for v in res[tag]["sources"].values()):
            fail(f"serve_tuned[{tag}]: REPRO_TORCH_TUNE=off resolved "
                 f"{res[tag]['sources']}")
    if res["f32_pretune"]["tokens"] != res["f32_off"]["tokens"]:
        fail("serve_tuned: greedy tokens on the f32 view differ between the "
             "tuned configs and the heuristic's")
    a, b = res["bf16_pretune"]["tokens"], res["bf16_off"]["tokens"]
    same = sum(x == y for u in a for x, y in zip(a[u], b[u]))
    res["bf16_equal_share"] = same / sum(len(t) for t in a.values())
    log(f"serve_tuned: f32 view greedy tokens identical, tuned vs off; "
        f"bf16 tokens equal {res['bf16_equal_share']:.1%} (printed, not "
        f"gated); step kernels bf16 "
        f"{res['bf16_pretune'].get('step_kernel_ms', float('nan')):.3f} ms "
        f"tuned vs {res['bf16_off'].get('step_kernel_ms', float('nan')):.3f}"
        f" ms heuristic; card {power_line}")
    return res


def optq_phase(torch, args, power_line, results, totals, eng_kw):
    """OPT-6.7B at full width and ``OPTQ_LAYERS`` of its 32 layers: random
    weights from ``--seed``, calibration captured from 2 batches of
    [2 x 256] seeded random tokens (256 rows a linear), OPTQ at 3 bits,
    group 64 (the paper's Fig. 17 baseline) on the card, the seconds of
    each linear printed.  Gate, per linear: OPTQ's output error on its
    calibration rows at most RTN's at the same bits and group.  Then the
    checkpoint is served through the paged engine with ``auto``
    (bcq_matmul) and ``lut_pallas`` (lut_gemm) with ``serve_one``'s
    gates and route counts; the first prefill's logits within 5e-2 of
    the logit scale of the plain path and the f32 view's within 1e-3."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.bcq import from_uniform
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels.bcq_matmul import bcq_matmul
    from repro_torch.kernels.lut_gemm import lut_gemm
    from repro_torch.models import Model
    from repro_torch.quant import QuantSpec
    from repro_torch.quant.api import (QUANT_KEYS, build_manifest,
                                       linear_leaves, walk_linears)
    from repro_torch.quant.optq import (capture_calibration,
                                        optq_quantize_model)
    from repro_torch.tune.measure import Timer

    cfg = get_config("opt_6_7b").replace(n_layers=OPTQ_LAYERS)
    log(f"optq: {cfg.name} full width, depth cut to {cfg.n_layers} of 32 "
        f"layers (the column loop costs seconds a layer); {OPTQ_BITS} bits, "
        f"group {OPTQ_GROUP}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = Model(cfg, device="cuda").init_params(gen)
    rng = np.random.default_rng(args.seed + 29)
    batches = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                               device="cuda") for _ in range(2)]
    t0 = time.perf_counter()
    cal = capture_calibration(model, batches, max_samples=256)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    dense = {p: lin.weight.clone() for p, lin in walk_linears(model)
             if p.rsplit("/", 1)[-1] in QUANT_KEYS}
    leaves = linear_leaves(model)        # the manifest's leaves, dense
    stamps = []

    def calib(path, n):
        torch.cuda.synchronize()
        stamps.append((path, time.perf_counter()))
        return cal[path]

    done = optq_quantize_model(model, calib, bits=OPTQ_BITS,
                               group_size=OPTQ_GROUP)
    torch.cuda.synchronize()
    ends = [t for _, t in stamps[1:]] + [time.perf_counter()]
    secs = {p: e - t for (p, t), e in zip(stamps, ends)}
    if set(done) != set(dense) or any(c.shape[0] != 256
                                      for c in cal.values()):
        fail(f"optq: quantized {len(done)} of {len(dense)} linears, "
             f"calibration rows {sorted({c.shape[0] for c in cal.values()})}")
    errs = {}
    for path, wq in done.items():
        x, w = cal[path], dense[path].float()
        y = x @ w.T
        e_optq = float(((x @ dequantize(wq, torch.float32).T - y) ** 2)
                       .mean())
        rtn = from_uniform(w, bits=OPTQ_BITS, group_size=OPTQ_GROUP)
        e_rtn = float(((x @ dequantize(rtn, torch.float32).T - y) ** 2)
                      .mean())
        errs[path] = dict(optq=e_optq, rtn=e_rtn, seconds=secs[path],
                          shape=list(w.shape))
        log(f"optq {path:28s} [{w.shape[0]}x{w.shape[1]}]: "
            f"{secs[path]:.2f} s; calibration output MSE OPTQ "
            f"{e_optq:.4e} vs RTN {e_rtn:.4e} ({e_optq / e_rtn:.3f}x)")
        if not e_optq <= e_rtn:
            fail(f"optq: {path} output error {e_optq:.4e} above RTN's "
                 f"{e_rtn:.4e}")
    del dense
    spec = QuantSpec(format="rtn", bits=OPTQ_BITS, group_size=OPTQ_GROUP)
    manifest = build_manifest(leaves, spec)
    # the step's GEMM time at batch 8 on these group-64 weights (phase 3
    # timed group 128): one timed call of each distinct shape
    timer = Timer(iters=5, warmup=1)
    x8 = {n: torch.randn((8, n), generator=gen, device="cuda").to(
        torch.bfloat16) for n in (4096, 16384)}
    shape_w = {}
    for path, wq in done.items():
        shape_w.setdefault((wq.out_features, wq.in_features), wq)
    attn_ms = attn_record(results, "paged_decode", cfg, b=8)["ms"]
    prompts = mix_prompts(args.seed, cfg.vocab_size)
    toks = torch.as_tensor(prompts[0][None, :128], device="cuda")
    plain = model.with_config(quant=spec.replace(backend="dense"),
                              paged_kernel="gather")
    want = first_logits(torch, plain, toks)
    out = dict(layers=cfg.n_layers, calibration_s=cal_s, linears=errs,
               bits=OPTQ_BITS, group_size=OPTQ_GROUP)
    for tag, backend, gemm in (("optq_auto", "auto", "bcq_matmul"),
                               ("optq_lut_pallas", "lut_pallas",
                                "lut_gemm")):
        fn = bcq_matmul if gemm == "bcq_matmul" else lut_gemm
        t = {sh: timer(lambda w=w: fn(x8[sh[1]], w)) for sh, w
             in shape_w.items()}
        kern_ms = sum(sum(t[sh] for sh in layer_gemm_shapes(cfg, i))
                      + attn_ms for i in range(cfg.n_layers))
        kern = model.with_config(quant=spec.replace(backend=backend),
                                 paged_kernel="fused")
        by_depth = logit_error_by_depth(torch, kern, plain, toks,
                                        [cfg.n_layers])
        res = serve_one(torch, tag, kern, want, toks, prompts, eng_kw,
                        results, gemm, "paged_decode", "paged_prefill",
                        (gemm, "paged_decode", "paged_prefill"), totals,
                        power_line, manifest, by_depth=by_depth,
                        kern_ms=kern_ms)
        rel = res["first_prefill_rel_err"]
        log(f"optq[{tag}]: first-prefill logits bf16 {rel:.3e} <= 5e-2: "
            f"{rel <= 5e-2}; f32 view {by_depth[cfg.n_layers]['f32']:.3e} "
            f"<= {F32_LOGIT_TOL:g} (gated in serve_one); GEMM times at "
            f"rows 8: " + ", ".join(f"[{a}x{b}] {ms:.4f} ms"
                                    for (a, b), ms in t.items()))
        if not rel <= 5e-2:
            fail(f"optq[{tag}]: kernel path disagrees with the plain path")
        res["gemm_ms_rows8"] = {f"{a}x{b}": ms for (a, b), ms in t.items()}
        res["logit_error_by_depth"] = by_depth
        out[tag] = res
    del model, plain, kern, want
    torch.cuda.empty_cache()
    return out


def serve_model(torch, args, cfg, spec, kv_bits, backends, attn, prefill,
                eng_kw, results, totals, power_line, serve_out, after=None):
    """Build ``cfg`` with random weights from ``--seed``, quantize it on
    the card, take the plain path's first-prefill logits, then serve
    the 8-request mix once per backend; ``after(model, manifest)``, where
    given, runs last on the same weights and its result is merged into
    ``serve_out``."""
    log(f"serve: {cfg.name} d={cfg.d_model} heads={cfg.n_heads} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} depth={cfg.n_layers} "
        f"layers; {spec.describe()} weights, {kv_bits}-bit KV")
    # the same mix shape for every model: 8 prompts of 48-400 tokens
    prompts = mix_prompts(args.seed, cfg.vocab_size)
    toks = torch.as_tensor(prompts[0][None, :128], device="cuda")
    # the same random weights from --seed for every format
    model, manifest, _, gen = build_quantized(torch, cfg, spec, args.seed)
    mixed = (mixed_plan(results, cfg, spec, manifest, attn)
             if spec.is_mixed else None)
    plain = model.with_config(quant=spec.replace(backend="dense"),
                              paged_kernel="gather", kv_cache_bits=kv_bits)
    want = first_logits(torch, plain, toks)
    required = tuple(k for k in (attn, prefill) if k)
    paged_tokens = None
    for tag, backend, gemm, engine in backends:
        gemm = mixed["gemms"] if mixed else gemm
        gemms = (gemm,) if isinstance(gemm, str) else gemm
        m = model.with_config(quant=spec.replace(backend=backend),
                              paged_kernel="fused", kv_cache_bits=kv_bits)
        if engine == "slots":
            # the same weights through the slots engine, then both engines
            # on the f32 view (is their bf16 disagreement rounding?)
            serve_out[tag] = serve_slots(torch, tag, m, plain, toks, prompts,
                                         results, gemm, totals, power_line,
                                         manifest, paged_tokens)
            serve_out[tag]["engines_f32"] = engines_f32(torch, m, prompts,
                                                        eng_kw)
            continue
        by_depth = None
        if cfg.attention == "mla" or cfg.pos == "rope":
            # Over MiniCPM3's 62 bf16 layers the kernel and plain paths
            # part by more than the 5e-2 the OPT runs hold (5.35e-2 on the
            # H100), growing with depth from 1.6e-2 at 8 layers, while the
            # same weights with f32 activations agree within 1.6e-5: the
            # GEMMs differ only in f32 summation order, which flips single
            # bf16 roundings that the random-weight stack amplifies.  The
            # rotary GQA decoders grow the same way (Phi-4-mini: 4.4e-2 at
            # 32 layers, where the plain bf16 path alone is 5.1e-2 from
            # the plain f32 path).  So these runs gate the f32 view, which
            # holds every kernel on the path to 1e-3 without that noise,
            # and report the bf16 error by depth.
            ends = (8, 16, 31) if cfg.attention == "mla" else (2, 4, 8, 16)
            depths = sorted({min(d, cfg.n_layers)
                             for d in ends + (cfg.n_layers,)})
            by_depth = logit_error_by_depth(torch, m, plain, toks, depths)
        serve_out[tag] = serve_one(torch, tag, m, want, toks, prompts,
                                   eng_kw, results, gemm, attn, prefill,
                                   gemms + required, totals, power_line,
                                   manifest, by_depth, mixed)
        serve_out[tag]["logit_error_by_depth"] = by_depth
        if cfg.n_experts:
            serve_out[tag]["expert_path"] = expert_path_times(torch, m, gen)
        paged_tokens = serve_out[tag]["tokens"]
        if mixed:
            serve_out[tag].update(plan=mixed["plan"],
                                  avg_bits=mixed["avg_bits"],
                                  spec=spec.to_dict())
    del plain, want
    torch.cuda.empty_cache()
    if after is not None:
        serve_out.update(after(model, manifest))
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# mesh serving: two ranks on the one card
# ---------------------------------------------------------------------------

# OPT-6.7B's serve depth over the mesh (of 32; full width kept), and the
# depths of the ternary + int8-KV OPT run (of 32) and of MiniCPM3-4B (of
# 62), cut so that the script stays within its 1200 s on one H100, the
# build included (README): with those two at 32 and 62 layers the whole
# script took 973 s
SHARDED_SERVE_LAYERS = 32
TERNARY_SHARDED_LAYERS = 8
MINICPM3_SHARDED_LAYERS = 16
SHARDED_DIR = ROOT / "build" / "serve_sharded"
# the tp-2 shard of each OPT-6.7B linear, [out x in]: q / k / v, out_proj,
# fc1, fc2
OPT_TP2_SHAPES = ((2048, 4096), (4096, 2048), (8192, 4096), (4096, 8192))
# the sharded runs, each on the weights of a phase-4 run: the arch, its
# weight format (``QuantSpec`` fields) and KV bits, the layers served (the
# first ones of the phase-4 model; OPT's also at most ``--layers``), the
# views served (``sharded_view``), the requests of the mix and the new
# tokens of each, and the decode and prefill attention kernels (prefill
# None: MLA prefill is gathered, as in the reference).  The GEMM kernel
# is bcq_matmul (ternary_matmul for ternary weights), lut_gemm on the
# lut_pallas view.
BCQ3 = dict(format="bcq", bits=3, group_size=128)
# a MoE model's drops over a mesh in bf16 against the unsharded run's, a
# share of them (on DeepSeek-V2's 4 layers they were equal on every rank
# at (1, 2) and (2, 2): 16,573 of 16,573)
BF16_DROPS_TOL = 0.01
SHARDED_KINDS = {
    "opt": dict(arch="opt_6_7b", spec=BCQ3, kv_bits=16,
                layers=SHARDED_SERVE_LAYERS,
                views=("auto", "lut_pallas", "f32"), requests=8,
                max_new=32, attn="paged_decode", prefill="paged_prefill"),
    "opt_ternary_int8kv": dict(arch="opt_6_7b",
                               spec=dict(format="ternary", group_size=128),
                               kv_bits=8, layers=TERNARY_SHARDED_LAYERS,
                               views=("auto", "f32"), requests=4,
                               max_new=16, attn="paged_decode_int8",
                               prefill="paged_prefill_int8"),
    "minicpm3": dict(arch="minicpm3_4b", spec=BCQ3, kv_bits=16,
                     layers=MINICPM3_SHARDED_LAYERS,
                     views=("auto", "f32"), requests=4, max_new=16,
                     attn="paged_decode_mla", prefill=None),
    "deepseek": dict(arch="deepseek_v2_236b", spec=BCQ3, kv_bits=16,
                     layers=DEEPSEEK_SERVE_LAYERS,
                     views=("auto", "f32"), requests=4, max_new=16,
                     attn="paged_decode_mla", prefill=None),
}


def sharded_kind(cfg, spec, kv_bits):
    """The ``SHARDED_KINDS`` entry a phase-4 run's weights are served
    over the mesh as (its arch, weight spec and KV bits), or None."""
    from repro_torch.quant import QuantSpec
    arch = cfg.name.replace("-", "_").replace(".", "_")
    return next((k for k, r in SHARDED_KINDS.items()
                 if r["arch"] == arch and r["kv_bits"] == kv_bits
                 and QuantSpec(**r["spec"]) == spec), None)


def check_shard_shapes(torch, timer, gen, results):
    """bcq_matmul and lut_gemm, BCQ-3 g 128 on bf16 activations, at the
    tp-2 shard shapes of OPT-6.7B's linears (the serve_sharded phase's
    calls), rows 8 (a decode step) and 512 (the top prefill bucket):
    1e-3 of the output scale against the plain version, timed beside it,
    ``torch.matmul`` on the dequantized bf16 shard and the bound."""
    from repro_torch.core import bcq
    from repro_torch.core.plane import dequantize
    from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
    from repro_torch.kernels.lut_gemm import lut_gemm

    tol = 1e-3
    out = []
    for m, n in OPT_TP2_SHAPES:
        w_dense = torch.randn((m, n), generator=gen, device="cuda") * 0.02
        w = bcq.quantize(w_dense, bits=3, group_size=128)
        del w_dense
        dense_bf16 = dequantize(w, torch.bfloat16)
        for rows in (8, 512):
            x = torch.randn((rows, n), generator=gen,
                            device="cuda").to(torch.bfloat16)
            plain = bcq_matmul_ref(x, w, out_dtype=torch.float32)
            scale = float(plain.abs().max()) + 1e-12
            b_ms, b_by = bound(rows * n * 2 + w.nbytes() + rows * m * 4,
                               2.0 * rows * m * n)
            t_plain = timer(lambda: bcq_matmul_ref(x, w, torch.float32))
            t_lib = timer(lambda: torch.matmul(x, dense_bf16.T))
            for name, fn in (
                    ("bcq_matmul",
                     lambda: bcq_matmul(x, w, out_dtype=torch.float32)),
                    ("lut_gemm",
                     lambda: lut_gemm(x, w, out_dtype=torch.float32))):
                got, route = routed(torch, name, fn)
                if got.shape != plain.shape or not torch.isfinite(got).all():
                    fail(f"{name} shard [{rows}x{n}]x[{m}x{n}]^T: bad "
                         "output")
                err = float((got - plain).abs().max())
                t = timer(fn)
                out.append(dict(kernel=name, m=m, n=n, rows=rows,
                                route=route, max_abs_err=err,
                                rel_err=err / scale, tol=tol, ms=t,
                                plain_ms=t_plain, library_ms=t_lib,
                                bound_ms=b_ms, bound_by=b_by))
                log(f"{name:10s} tp-2 shard rows={rows:3d} M={m:5d} "
                    f"N={n:5d} [{route}]: rel err {err / scale:.2e} <= "
                    f"{tol:g}: {err / scale <= tol}  kernel {t:.4f} ms  "
                    f"plain {t_plain:.4f} ms  torch.matmul {t_lib:.4f} ms"
                    f"  bound {b_ms:.4f} ms ({b_by})")
                if err / scale > tol:
                    fail(f"{name} disagrees with its plain version at a "
                         "tp-2 shard shape")
        del w, dense_bf16
    results["shard_shapes"] = out


def sharded_view(torch, m, spec, view):
    """The serve view ``view`` of ``m``: its weights through the ``auto``
    backend's kernel (bcq_matmul, or ternary_matmul for ternary weights)
    or through lut_gemm (``lut_pallas``) in bf16, or through the ``auto``
    kernel on the f32 view (``f32``)."""
    backend = "auto" if view == "f32" else view
    v = m.with_config(quant=spec.replace(backend=backend),
                      paged_kernel="fused")
    return f32_view(v) if view == "f32" else v


def sharded_serve_run(torch, tag, m, prompts, eng_kw, mesh=None,
                      max_new=32):
    """One serve of ``prompts`` (``max_new`` new tokens each) through the
    paged engine (over ``mesh`` where given), instrumented as
    ``serve_one``: per-step times and launches, GEMM bodies per step and
    chunk, finite logits, the MoE drops; over a mesh also the
    collectives' seconds inside each decode step, the host syncs a step
    (``rank_report``) and whether the pool leaves a model group holds
    whole agree."""
    from repro_torch.kernels import _lib
    from repro_torch.serve import PagedServeEngine, Request
    eng = PagedServeEngine(m, paged_kernel="fused", mesh=mesh, **eng_kw)
    step_ms, step_launches, step_routes, chunk_routes, extra = instrument(
        torch, eng.model, "prefill_chunk")
    comm = []
    if mesh is not None:
        inner = eng.model.decode_step

        def counted(*a, **kw):
            c0 = mesh.comm_s
            r = inner(*a, **kw)
            comm.append(mesh.comm_s - c0)
            return r
        eng.model.decode_step = counted
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    if mesh is not None:
        mesh.reset_counters()
    t0 = time.perf_counter()
    done = eng.run(reqs, max_ticks=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = dict(_lib.launch_counts), dict(_lib.route_counts)
    bad = [r.uid for r in done if r.error or len(r.out_tokens) != max_new]
    if len(done) != len(reqs) or bad:
        fail(f"serve[{tag}]: requests incomplete: {bad}")
    finite_gate(tag, extra)
    s = eng.metrics.summary()
    steps = sorted(step_ms)
    layer = eng.cache["layers"][0]
    pool = layer["k"] if "k" in layer else layer["ckv"]
    out = dict(
        tokens={str(r.uid): [int(t) for t in r.out_tokens] for r in done},
        tokens_out=s["counters"]["tokens_out"], wall_s=wall,
        tokens_per_s=s["counters"]["tokens_out"] / wall,
        ttft_p50_ms=s["ttft_s"]["p50"] * 1e3,
        decode_step_ms_p50=steps[len(steps) // 2], decode_steps=len(steps),
        launches=counts, routes=routes, step_launches=step_launches,
        step_routes=step_routes, chunk_routes=chunk_routes,
        decode_path=eng.decode_path, prefill_path=eng.prefill_path,
        k_shape=list(pool.shape), k_dtype=str(pool.dtype),
        scale_shape=list(layer["k_scale"].shape) if "k_scale" in layer
        else None, **eng.rank_report())
    if mesh is not None:
        share = sorted(c / t * 1e3 for c, t in zip(comm, step_ms))
        out.update(comm_share_p50=share[len(share) // 2],
                   collectives=mesh.collectives,
                   same_host_state=mesh.same_on_all(eng.host_state()),
                   same_pool_leaves=mesh.same_within(eng.pool_state(),
                                                     "model"))
    del eng
    torch.cuda.empty_cache()
    return out


def sharded_model(torch, args, kind):
    """(model, weight spec) of ``kind``'s sharded run, built as its
    phase-4 run builds it (OPT ``--layers`` deep) and cut to the run's
    depth."""
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantSpec
    run = SHARDED_KINDS[kind]
    cfg = get_config(run["arch"])
    n = args.layers if run["arch"] == "opt_6_7b" else cfg.n_layers
    cfg = cfg.replace(n_layers=min(run["layers"], n))
    spec = QuantSpec(**run["spec"])
    model, _, _, _ = build_quantized(torch, cfg, spec, args.seed)
    return model.with_config(quant=spec), spec


def sharded_only(torch, args, power_line):
    """``--sharded-mesh DxM``: each of ``--sharded-kinds`` (default OPT-6.7B
    BCQ-3, MiniCPM3-4B and DeepSeek-V2, at full width) served unsharded
    and over the mesh (``serve_sharded``); results in
    ``chiprun_out/serve_sharded.json``."""
    from repro_torch.kernels import _lib
    shape = tuple(int(x) for x in args.sharded_mesh.lower().split("x"))
    eng_kw = dict(num_blocks=256, block_size=16, max_batch=8,
                  max_seq_len=512, prefill_buckets=BUCKETS)
    totals = {k: 0 for k in _lib.KERNELS}
    report = {}
    for kind in args.sharded_kinds.split(","):
        model, spec = sharded_model(torch, args, kind)
        report[kind] = serve_sharded(torch, args, model, spec, eng_kw, totals,
                                     power_line, mesh_shape=shape, kind=kind)
        del model
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "serve_sharded.json").write_text(json.dumps(report,
                                                           indent=1))
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def shard_gates(tag, model, cfg, tp, mesh):
    """This rank's cuts of ``model``, gated: every linear holds its shard
    (OPT at tp 2: q / k / v [2048 x 4096], out_proj [4096 x 2048], fc1
    [8192 x 4096], fc2 [4096 x 8192]; an MLA layer's q_b its heads' rows
    and o their columns, q_a and kv_a whole, kv_b its heads'; a MoE
    layer's banks E / tp whole experts, the router whole, the shared
    experts column- and row-parallel), the head its slice of the padded
    vocab, each layer H / tp query heads.  Returns the shapes."""
    from repro_torch.models.moe import MoE
    blk = model.stack.layers[0]
    mix = blk.mixer
    d, h = cfg.d_model, cfg.n_heads

    def dims(lin):
        w = lin.weight
        return [w.out_features, w.in_features] if hasattr(
            w, "out_features") else list(w.shape)
    if cfg.attention == "mla":
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        lins = (("q_a", mix.q_a), ("q_b", mix.q_b), ("kv_a", mix.kv_a),
                ("kv_b", mix.kv_b), ("o", mix.o))
        want = {"q_a": [cfg.q_lora_rank, d],
                "q_b": [h // tp * (dn + dr), cfg.q_lora_rank],
                "kv_a": [cfg.kv_lora_rank + dr, d],
                "kv_b": [h // tp * (dn + dv), cfg.kv_lora_rank],
                "o": [d, h // tp * dv]}
    else:
        lins = (("q", mix.q), ("k", mix.k), ("v", mix.v), ("o", mix.o))
        want = {"q": [d // tp, d], "k": [d // tp, d], "v": [d // tp, d],
                "o": [d, d // tp]}
    f = cfg.d_ff
    lins += tuple((n, getattr(blk.mlp, n)) for n in ("gate", "up", "down")
                  if getattr(blk.mlp, n, None) is not None)
    want.update({n: [f // tp, d] for n in ("gate", "up")
                 if getattr(blk.mlp, n, None) is not None})
    want["down"] = [d, f // tp]
    shapes = {n: dims(lin) for n, lin in lins}
    moe = next((b.mlp for b in model.stack.layers
                if isinstance(b.mlp, MoE)), None)
    if moe is not None:
        e, fs = cfg.n_experts, cfg.moe_d_ff * cfg.n_shared_experts
        m = mesh.index("model")
        shapes.update(
            experts=list(moe.tp.experts), router=list(moe.router.shape),
            bank=list(moe.gate.weight.packed.shape),
            shared_gate=dims(moe.shared_gate),
            shared_down=dims(moe.shared_down))
        want.update(
            experts=[m * e // tp, (m + 1) * e // tp], router=[e, d],
            bank=[e // tp] + list(moe.gate.weight.packed.shape[1:]),
            shared_gate=[fs // tp, d], shared_down=[d, fs // tp])
    if shapes != want:
        fail(f"{tag}: shard shapes {shapes}, want {want}")
    heads = mix.tp.heads
    if heads[1] - heads[0] != h // tp \
            or list(model.embed.tok.shape) != [cfg.padded_vocab // tp, d]:
        fail(f"{tag}: heads {heads}, tok {list(model.embed.tok.shape)}")
    if cfg.attention != "mla" and not mix.tp.local:
        fail(f"{tag}: the pool is not cut on kv heads ({mix.tp.pool})")
    return shapes, heads


def sharded_rank(job_path):
    """One rank of ``serve_sharded`` (run as ``chip_smoke.py --rank-job
    JOB``): join the job's mesh, load the checkpoint on the host, keep
    this rank's shard on the card (``shard_model``), gate its cuts
    (``shard_gates``), serve each view of the mix over the mesh, and
    write the runs and the f32 view's first-prefill logits to the job's
    folder."""
    job = json.loads(Path(job_path).read_text())
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("rank: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import shard_model
    from repro_torch.quant.checkpoint import load_quantized
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"),
                     device_type="cuda")
    rank = mesh.rank
    tag = f"sharded/{job['kind']}/rank{rank}"
    tp = mesh.size("model")
    t0 = time.perf_counter()
    params, spec, _, _ = load_quantized(job["ckpt"])
    cfg = get_config(job["arch"]).replace(
        n_layers=job["layers"], quant=spec, kv_cache_bits=job["kv_bits"])
    model = shard_model(params, cfg, mesh, device=mesh.device)
    del params
    load_s = time.perf_counter() - t0
    if model.device.type != "cuda" or mesh.backend != job["backend"]:
        fail(f"{tag}: on {model.device} over {mesh.backend}")
    shapes, heads = shard_gates(tag, model, cfg, tp, mesh)
    log(f"{tag}: mesh {mesh}, shard loaded in {load_s:.1f} s; shapes "
        f"{shapes}, heads {heads}, tok {list(model.embed.tok.shape)}")
    prompts = [np.asarray(p) for p in job["prompts"]]
    toks = torch.as_tensor(prompts[0][None, :128], device=mesh.device)
    res = dict(rank=rank, coords=list(mesh.coords), backend=mesh.backend,
               load_s=load_s, shapes=shapes, heads=list(heads), runs={})
    logits = first_logits(torch, sharded_view(torch, model, spec, "f32"),
                          toks)
    np.save(Path(job["out"]) / f"logits{rank}.npy", logits.cpu().numpy())
    for view in job["views"]:
        res["runs"][view] = sharded_serve_run(
            torch, f"{tag}/{view}", sharded_view(torch, model, spec, view),
            prompts, job["eng_kw"], mesh, max_new=job["max_new"])
    if mesh.backend == "nccl" and job["kind"] == "opt":
        res["async"] = sharded_async_run(
            torch, f"{tag}/async", sharded_view(torch, model, spec, "auto"),
            prompts, job["eng_kw"], mesh)
        if res["async"]["tokens"] != res["runs"]["auto"]["tokens"]:
            fail(f"{tag}: async tokens differ from sync")
    (Path(job["out"]) / f"rank{rank}.json").write_text(json.dumps(res))
    # every rank done, the process ends without tearing the groups down
    # (gloo's teardown has aborted a rank now and then after all its work)
    torch.distributed.barrier(group=mesh.host_group)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def sharded_async_run(torch, tag, m, prompts, eng_kw, mesh):
    """The mix through the async tick over an NCCL mesh, every
    decode-only tick under ``torch.cuda.set_sync_debug_mode("error")``:
    its collectives are stream-ordered on the card, so the tick keeps
    its one host wait (the event after the previous tick's ids)."""
    from repro_torch.serve import PagedServeEngine, Request
    eng = PagedServeEngine(m, paged_kernel="fused", mesh=mesh, **eng_kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
    strict, tick_ms = 0, []
    mesh.reset_counters()
    while eng.sched.has_work() or eng.has_inflight:
        decode_only = not eng.sched.waiting and all(
            s.kv_len >= s.prefill_target for s in eng.sched.running)
        t = time.perf_counter()
        if decode_only:
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.step_async()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            strict += 1
            tick_ms.append((time.perf_counter() - t) * 1e3)
        else:
            eng.step_async()
    eng.flush()
    done = eng.finished
    if len(done) != len(prompts) or any(r.error for r in done):
        fail(f"serve[{tag}]: requests incomplete")
    ticks = sorted(tick_ms)
    log(f"serve[{tag}]: {strict} decode-only async ticks with no host sync "
        f"but the tick's event; tick p50 {ticks[len(ticks) // 2]:.2f} ms; "
        f"{mesh.host_syncs} collectives staged through host memory")
    return dict(tokens={str(r.uid): [int(t) for t in r.out_tokens]
                        for r in done},
                strict_ticks=strict, tick_ms_p50=ticks[len(ticks) // 2],
                host_syncs=mesh.host_syncs)


def sharded_rank_gates(tag, view, rv, cfg, tp, layers, run, gemm, eng_kw,
                       step_lin, chunk_lin, single):
    """One rank's run of one view, gated: every decode step's linears on
    the decode tile and every chunk's on the tensor-core tile at the
    shard shapes (``route_totals``), the decode attention kernel once a
    layer a step and the prefill kernel (where the config has one) once
    a layer a chunk, the pool's cut (GQA: Hkv / tp heads, int8 with its
    scale pools; MLA: the latent pool whole), the paths, the host state
    and the pool leaves a model group holds whole agreeing, and a MoE
    model's drops equal to the unsharded run's: exactly on the f32 view
    (the routing is whole on every rank), within ``BF16_DROPS_TOL`` of
    them in bf16, where the row-parallel sums round the router's input
    otherwise than one GEMM does and may reroute a token."""
    attn, prefill = run["attn"], run["prefill"]
    route_totals(tag, gemm, rv["step_routes"], rv["chunk_routes"],
                 {k: n for k, n in rv["routes"].items()
                  if k.split("/")[0] in ROUTED},
                 linears=step_lin, chunk_linears=chunk_lin)
    if gemm == "lut_gemm":
        # lut_gemm's decode rows run its LUT body, every linear
        for i, r in enumerate(rv["step_routes"]):
            if r.get("lut_gemm/lut", 0) != step_lin:
                fail(f"{tag}: decode step {i} bodies {r}")
    for i, n in enumerate(rv["step_launches"]):
        if n[attn] != layers:
            fail(f"{tag}: decode step {i} launched {attn} {n[attn]} times, "
                 "not once a layer")
    if prefill and rv["launches"][prefill] != layers * len(
            rv["chunk_routes"]):
        fail(f"{tag}: {prefill} not once a layer a chunk")
    nb, bs = eng_kw["num_blocks"], eng_kw["block_size"]
    if cfg.attention == "mla":
        pool, scales = [nb, bs, cfg.kv_lora_rank], None
    else:
        hkv = cfg.n_kv_heads // tp
        pool = [nb, bs, hkv, cfg.head_dim_]
        scales = [nb, bs, hkv] if cfg.kv_cache_bits == 8 else None
    if rv["k_shape"] != pool or rv["scale_shape"] != scales or (
            scales and rv["k_dtype"] != "torch.int8"):
        fail(f"{tag}: pool {rv['k_shape']} {rv['k_dtype']}, scales "
             f"{rv['scale_shape']}; want {pool}, {scales}")
    want_prefill = "fused" if prefill else "gather"
    if rv["decode_path"] != "fused" or rv["prefill_path"] != want_prefill \
            or not rv["same_host_state"] or not rv["same_pool_leaves"]:
        fail(f"{tag}: paths {rv['decode_path']} / {rv['prefill_path']}, "
             f"host state agreed: {rv['same_host_state']}, pool leaves "
             f"agreed: {rv['same_pool_leaves']}")
    tol = 0 if view == "f32" else BF16_DROPS_TOL * single["moe_drops"]
    if abs(rv["moe_drops"] - single["moe_drops"]) > tol:
        fail(f"{tag}: MoE drops {rv['moe_drops']}, unsharded "
             f"{single['moe_drops']} (tolerance {tol:g})")


def serve_sharded(torch, args, model, spec, eng_kw, totals, power_line,
                  mesh_shape=(1, 2), kind="opt"):
    """Mesh serving on the card(s): ``model`` (a phase-4 run's weights:
    ``SHARDED_KINDS[kind]``, its first ``layers``) written
    once through ``quant/checkpoint.py`` to ``build/`` and served over a
    ``mesh_shape`` mesh by one process a rank (gloo where they share one
    card), each loading its shard (``sharded_rank``), on each of the
    kind's views; the same requests served unsharded here before them.
    Gates, per rank: its cuts (``shard_gates``), the run's
    (``sharded_rank_gates``), finite logits, the f32 view's
    first-prefill logits within 1e-3 of the unsharded f32 view's scale,
    and the same tokens on every rank.  Printed: the share of greedy
    tokens equal to the unsharded run's (f32, bf16) and per rank tok/s,
    TTFT p50, decode-step p50, the collectives' share of a step, host
    syncs a step and MoE drops beside the unsharded run."""
    import numpy as np
    from repro_torch.launch.mesh import spawn
    from repro_torch.quant import save_quantized

    t_phase = time.perf_counter()
    run = SHARDED_KINDS[kind]
    cfg = model.cfg
    layers = min(run["layers"], cfg.n_layers)
    m = depth_view(model, layers) if layers < cfg.n_layers else model
    kv_bits = run["kv_bits"]
    m = m.with_config(kv_cache_bits=kv_bits)
    n = mesh_shape[0] * mesh_shape[1]
    tp = mesh_shape[1]
    # one rank a card where there are enough (NCCL), else all on one
    backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    log(f"serve_sharded[{kind}]: {cfg.name} at full width, {layers} of "
        f"{cfg.n_layers} layers, {spec.describe()}, {kv_bits}-bit KV, "
        f"over a {tuple(mesh_shape)} mesh of {n} processes on "
        f"{torch.cuda.device_count()} card(s) ({backend}); "
        f"{run['requests']} requests x {run['max_new']} new tokens")
    prompts = mix_prompts(args.seed, cfg.vocab_size)[:run["requests"]]
    toks = torch.as_tensor(prompts[0][None, :128], device="cuda")
    out_dir = SHARDED_DIR / kind
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    save_quantized(str(out_dir / "ckpt"), m.with_config(quant=spec),
                   spec, arch=cfg.name)
    save_s = time.perf_counter() - t0
    want_logits = first_logits(torch, sharded_view(torch, m, spec, "f32"),
                               toks).cpu().numpy()
    single = {view: sharded_serve_run(
        torch, f"single/{kind}/{view}", sharded_view(torch, m, spec, view),
        prompts, eng_kw, max_new=run["max_new"]) for view in run["views"]}
    job = out_dir / "job.json"
    job.write_text(json.dumps(dict(
        kind=kind, arch=run["arch"], mesh=list(mesh_shape), backend=backend,
        ckpt=str(out_dir / "ckpt"), layers=layers, kv_bits=kv_bits,
        views=list(run["views"]), max_new=run["max_new"],
        prompts=[p.tolist() for p in prompts], eng_kw=eng_kw,
        out=str(out_dir))))
    t0 = time.perf_counter()
    outs = spawn([sys.executable, str(ROOT / "chip_smoke.py"), "--rank-job",
                  str(job)], n, timeout=900)
    ranks_s = time.perf_counter() - t0
    for r, (rc, out, err) in enumerate(outs):
        for line in out.splitlines():
            log(f"  [rank {r}] {line}")
        if rc != 0:
            fail(f"serve_sharded[{kind}]: rank {r} exited {rc}:\n"
                 f"{err[-3000:]}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(n)]
    step_lin, chunk_lin = step_linears(m.cfg)
    report = dict(kind=kind, arch=run["arch"], layers=layers,
                  mesh=list(mesh_shape), backend=backend, save_s=save_s,
                  ranks_s=ranks_s, card=power_line, single={}, ranks=[])
    for view in run["views"]:
        gemm = "lut_gemm" if view == "lut_pallas" else (
            "ternary_matmul" if spec.format == "ternary" else "bcq_matmul")
        sv = single[view]
        report["single"][view] = {k: sv[k] for k in (
            "tokens_per_s", "ttft_p50_ms", "decode_step_ms_p50",
            "decode_steps", "wall_s", "moe_drops")}
        for rk in ranks:
            rv = rk["runs"][view]
            tag = f"serve_sharded[{kind}/rank {rk['rank']}/{view}]"
            for k in {run["attn"], run["prefill"], gemm} - {None}:
                totals[k] += rv["launches"][k]
            sharded_rank_gates(tag, view, rv, m.cfg, tp, layers, run, gemm,
                               eng_kw, step_lin, chunk_lin, sv)
            if rv["tokens"] != ranks[0]["runs"][view]["tokens"]:
                fail(f"{tag}: the ranks emitted different tokens")
        r0 = ranks[0]["runs"][view]
        same = sum(a == b for u in sv["tokens"] for a, b in
                   zip(sv["tokens"][u], r0["tokens"][u]))
        total = sum(len(t) for t in sv["tokens"].values())
        report["single"][view]["equal_token_share"] = same / total
        log(f"serve_sharded[{kind}/{view}]: greedy tokens equal to the "
            f"unsharded run's: {same}/{total} = {same / total:.1%}; "
            f"unsharded {sv['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{sv['ttft_p50_ms']:.1f} ms, decode step p50 "
            f"{sv['decode_step_ms_p50']:.2f} ms, MoE drops "
            f"{sv['moe_drops']}; " + "; ".join(
                f"rank {rk['rank']}: {rk['runs'][view]['tokens_per_s']:.1f}"
                f" tok/s, TTFT p50 {rk['runs'][view]['ttft_p50_ms']:.1f} ms,"
                f" decode step p50 "
                f"{rk['runs'][view]['decode_step_ms_p50']:.2f} ms, "
                f"collectives {rk['runs'][view]['comm_share_p50']:.1%} of "
                f"a step ({rk['runs'][view]['host_syncs_per_step']:g} host "
                f"syncs a step), MoE drops {rk['runs'][view]['moe_drops']}"
                for rk in ranks) + f"; card {power_line}")
    for rk in ranks:
        if "async" in rk:
            a = rk["async"]
            log(f"serve_sharded[{kind}/rank {rk['rank']}/async]: tokens "
                f"equal to the sync run's; {a['strict_ticks']} decode-only "
                f"ticks under sync debug mode 'error', tick p50 "
                f"{a['tick_ms_p50']:.2f} ms, {a['host_syncs']} collectives "
                "staged through host memory")
        got = np.load(out_dir / f"logits{rk['rank']}.npy")
        if got.shape != want_logits.shape or not np.isfinite(got).all():
            fail(f"serve_sharded[{kind}]: rank {rk['rank']} first-prefill "
                 "logits bad")
        rel = float(np.abs(got - want_logits).max()) / float(
            np.abs(want_logits).max())
        log(f"serve_sharded[{kind}/rank {rk['rank']}]: f32 view's "
            f"first-prefill logits vs the unsharded f32 view: rel err "
            f"{rel:.3e} <= {F32_LOGIT_TOL:g}: {rel <= F32_LOGIT_TOL}")
        if not rel <= F32_LOGIT_TOL:
            fail(f"serve_sharded[{kind}]: the sharded f32 view disagrees")
        rk["f32_first_logits_rel_err"] = rel
        report["ranks"].append({k: v for k, v in rk.items()
                                if k != "runs"} | {
            "runs": {view: {k: v for k, v in r.items() if k not in (
                "step_launches", "step_routes", "chunk_routes", "tokens")}
                for view, r in rk["runs"].items()}})
    shutil.rmtree(out_dir, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"serve_sharded[{kind}]: checkpoint written in {save_s:.1f} s, "
        f"ranks ran {ranks_s:.1f} s, phase {report['phase_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

# OPT-6.7B at full width, 8 of its 32 layers: ~1.83 B parameters, ~22 GB
# at 12 B a parameter (bf16 weights and gradients, f32 AdamW moments);
# the full 32 layers (~6.65 B) would need ~80 GB before any activation
TRAIN_LAYERS = 8
# a constant lr of 1e-5 after one warmup step: with warmup 2 and cosine
# decay, lr 1e-3 and 1e-4 made step 2's loss spike to 40.7 and 26.5 at
# full width (Adam's first steps move every weight by ~lr, coherently,
# so each output by ~lr x its fan-in), then end at 11.6 and 11.4
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 12, 1e-5, 1
TRAIN_SCHEDULE = "constant"
TRAIN_SEQ, TRAIN_BATCH = 512, 8
# the card-vs-host check, the resume check and the data-parallel run:
# full width, 2 layers
TRAIN_CHECK_LAYERS = 2
TRAIN_DIR = ROOT / "build" / "train"
# the leaves whose gradient is accumulated by the embedding lookups'
# backward (``index_put_`` with accumulate): the one op on the path that
# may add in another order from run to run
EMBED_LEAVES = ("embed/tok", "embed/pos")
F32_PEAK_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores


def train_config(layers):
    """OPT-6.7B at full width and ``layers`` deep, remat on; the stack
    unrolled (the checkpoint writes it so, with no host-side stacking)."""
    from repro_torch.configs import get_config
    return get_config("opt_6_7b").replace(n_layers=layers, remat=True,
                                          scan_layers=False)


def train_model(torch, cfg, seed, device="cuda", dtype=None):
    """Random weights from ``seed`` (the trainer's init) on ``device``."""
    from repro_torch.models import Model
    model = Model(cfg, device=device, dtype=dtype or torch.bfloat16)
    model.init_params(torch.Generator(device=device).manual_seed(seed))
    return model


def trainer_for(model, steps, ckpt_dir, *, ckpt_every=0, mesh=None,
                microbatches=1, sharded=False):
    """The phase's trainer; ``sharded``: the launcher's rules, fsdp and
    act_shard on."""
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.trainer import TrainConfig, Trainer
    return Trainer(model, adamw.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps,
        schedule=TRAIN_SCHEDULE),
        TrainConfig(steps=steps, ckpt_every=ckpt_every or steps,
                    ckpt_dir=str(ckpt_dir), log_every=1000,
                    microbatches=microbatches, fsdp=sharded), mesh=mesh,
        rules=make_rules(fsdp=True, act_shard=True) if sharded else None)


class ShardsPipeline:
    """The global batch of a (D, 1) mesh: every data shard's batch at the
    step, concatenated in rank order."""

    def __init__(self, n, **kw):
        from repro_torch.data.pipeline import SyntheticLM
        self.parts = [SyntheticLM(data_shard=r, data_shards=n, **kw)
                      for r in range(n)]

    def batch_at(self, step):
        import numpy as np
        return {"tokens": np.concatenate(
            [p.batch_at(step)["tokens"] for p in self.parts])}


def leaf_paths(tree):
    """The "/"-joined paths of a tree's leaves, in ``tree_leaves`` order."""
    from repro_torch.tree import leaves_with_path
    return ["/".join(map(str, p)) for p, _ in leaves_with_path(tree)]


def train_gates(tag, tr, hist, steps):
    """Every step ran, every loss is finite, and no failure was
    recovered from (a swallowed RuntimeError, an OOM, must not pass)."""
    if len(hist) != steps or tr.recoveries:
        fail(f"{tag}: {len(hist)} of {steps} steps, recoveries "
             f"{tr.recoveries}")
    bad = [h for h in hist if not all(math.isfinite(h[k]) for k in h)]
    if bad:
        fail(f"{tag}: non-finite metrics {bad[0]}")


def train_step_flops(cfg, tokens):
    """A training step's matmul operations: each layer's linears and
    attention scores and values (the full S x S product) forward, again
    in the backward's recompute (remat) and twice in the backward; the
    head forward and twice in the backward."""
    d, f, s = cfg.d_model, cfg.d_ff, TRAIN_SEQ
    layer = 4 * d * d + 2 * d * f + 2 * s * d
    head = d * cfg.padded_vocab
    return 2 * tokens * (cfg.n_layers * layer * 4 + head * 3)


def time_adamw(torch, tr, state):
    """Median ms of three ``apply_updates`` on the trained state (random
    bf16 gradients), CUDA events; bytes each parameter moves: bf16
    weight read and written, bf16 gradient read, f32 m and v read and
    written."""
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map
    params = state["params"]
    grads = tree_map(lambda p: torch.randn(p.shape, device=p.device,
                                           dtype=p.dtype) * 1e-3, params)
    times, opt = [], state["opt"]
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        _, opt, _ = adamw.apply_updates(params, grads, opt, tr.opt_cfg)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    n = sum(p.numel() for p in tree_leaves(params))
    nbytes = sum(p.numel() * (3 * p.element_size() + 16)
                 for p in tree_leaves(params))
    del grads
    return sorted(times)[1], nbytes / HBM_BYTES_PER_S * 1e3, n


def train_main(torch, args, power_line):
    """OPT-6.7B at full width, TRAIN_LAYERS deep, bf16, remat: the
    trainer's run with one async checkpoint at the end."""
    from repro_torch.data.pipeline import SyntheticLM
    cfg = train_config(TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = train_model(torch, cfg, args.seed)
    n_params = model.n_params()
    tr = trainer_for(model, TRAIN_STEPS, TRAIN_DIR / "main")
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=args.seed)
    log(f"train: opt-6.7b at full width (d {cfg.d_model}, {cfg.n_heads} "
        f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded to "
        f"{cfg.padded_vocab}), {cfg.n_layers} of 32 layers, "
        f"{n_params / 1e9:.3f} B params, bf16, remat; {TRAIN_STEPS} steps "
        f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamW lr {TRAIN_LR:g}, "
        f"warmup {TRAIN_WARMUP}, {TRAIN_SCHEDULE} schedule")
    t0 = time.perf_counter()
    state, hist = tr.run(pipe, state=tr.fresh_state())
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    train_gates("train", tr, hist, TRAIN_STEPS)
    losses = [h["loss"] for h in hist]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    log(f"train: losses {[round(x, 4) for x in losses]}; mean of the first "
        f"three {first:.4f}, of the last three {last:.4f}")
    if not last < first:
        fail("train: the loss did not decrease")
    steps_ms = sorted(t * 1e3 for t in tr.step_times[1:])
    p50 = steps_ms[len(steps_ms) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_step_flops(cfg, tokens)
    ckpt_dir = TRAIN_DIR / "main" / f"step_{TRAIN_STEPS:08d}"
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.iterdir())
    adamw_ms, adamw_bound_ms, n_leaf = time_adamw(torch, tr, state)
    out = dict(layers=cfg.n_layers, params=n_params, steps=TRAIN_STEPS,
               lr=TRAIN_LR, warmup=TRAIN_WARMUP, schedule=TRAIN_SCHEDULE,
               batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, losses=losses, grad_norms=[
                   h["grad_norm"] for h in hist], step_ms=steps_ms,
               step_ms_p50=p50, first_step_ms=tr.step_times[0] * 1e3,
               tokens_per_s=tokens / (p50 / 1e3), wall_s=wall,
               peak_bytes=peak, step_flops=flops,
               f32_bound_ms=flops / F32_PEAK_FLOPS * 1e3,
               bf16_bound_ms=flops / BF16_FLOPS * 1e3,
               adamw_ms=adamw_ms, adamw_bound_ms=adamw_bound_ms,
               ckpt_snapshot_s=tr.ckpt.last_snapshot_s,
               ckpt_write_s=tr.ckpt.last_write_s, ckpt_bytes=ckpt_bytes,
               card=power_line)
    log(f"train: step p50 {p50:.1f} ms (first step {out['first_step_ms']:.1f}"
        f" ms), {out['tokens_per_s']:.0f} tokens/s; {flops / 1e12:.1f} "
        f"TFLOP a step of matmuls on f32 operands (the dense linear's), "
        f"bound {out['f32_bound_ms']:.1f} ms at the f32 peak, "
        f"{out['bf16_bound_ms']:.1f} ms at the bf16 tensor-core peak; card "
        f"{power_line}")
    log(f"train: AdamW update {adamw_ms:.2f} ms over {n_leaf / 1e9:.3f} B "
        f"params (bound {adamw_bound_ms:.2f} ms by bytes); card {power_line}")
    log(f"train: async checkpoint of step {TRAIN_STEPS} "
        f"({ckpt_bytes / 1e9:.2f} GB): snapshot to host "
        f"{out['ckpt_snapshot_s']:.2f} s, write {out['ckpt_write_s']:.2f} s "
        f"(in the background); card {power_line}")
    log(f"train: peak device memory {peak / 1e9:.2f} GB "
        f"(max_memory_allocated); card {power_line}")
    shutil.rmtree(TRAIN_DIR / "main", ignore_errors=True)
    return out


def train_host_check(torch, args):
    """The same weights (full width, TRAIN_CHECK_LAYERS deep, f32) on the
    card and on the host: the first step's loss and grad_norm, batch 1 x
    64 tokens, within 1e-4 relative."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import from_jax_params, to_params
    cfg = train_config(TRAIN_CHECK_LAYERS)
    host = train_model(torch, cfg, args.seed, device="cpu",
                       dtype=torch.float32)
    card = from_jax_params(to_params(host), cfg, device="cuda")
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64,
                        global_batch=1, seed=args.seed).batch_at(0)
    got = {}
    for where, model in (("cuda", card), ("cpu", host)):
        tr = trainer_for(model, 1, TRAIN_DIR / f"host_{where}")
        t0 = time.perf_counter()
        _, metrics = tr.build_step()(tr.fresh_state(), batch)
        got[where] = {k: float(v) for k, v in metrics.items()}
        got[where]["s"] = time.perf_counter() - t0
    del card, host
    out = {"cuda": got["cuda"], "cpu": got["cpu"]}
    for k in ("loss", "grad_norm"):
        rel = abs(got["cuda"][k] - got["cpu"][k]) / abs(got["cpu"][k])
        out[f"{k}_rel_err"] = rel
        log(f"train[host check]: first-step {k} card {got['cuda'][k]:.7f}, "
            f"host {got['cpu'][k]:.7f}: rel err {rel:.3e} <= 1e-4: "
            f"{rel <= 1e-4}")
        if not rel <= 1e-4:
            fail(f"train: the card's {k} disagrees with the host's")
    return out


def bf16_ulps(torch, a, b):
    """Max distance in bf16 ulps between two bf16 tensors of one sign
    pattern (inf where a sign differs)."""
    ai, bi = a.view(torch.int16).int(), b.view(torch.int16).int()
    if ((ai < 0) != (bi < 0)).any():
        return float("inf")
    return int((ai - bi).abs().max())


def train_resume_check(torch, args):
    """Full width, TRAIN_CHECK_LAYERS deep, bf16, 4 steps: uninterrupted
    against a run that fails at step 3 (``inject_failure_at``) and resumes
    from its async checkpoint of step 2.  The final parameters equal bit
    for bit; on the embedding leaves (``EMBED_LEAVES``: their gradient
    comes from the lookups' ``index_put_`` accumulation) at most one bf16
    ulp apart.  Exactly one recovery, the injected one."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.tree import tree_leaves
    cfg = train_config(TRAIN_CHECK_LAYERS)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=args.seed)
    finals, out = {}, {}
    for name, inject, every in (("uninterrupted", None, 4),
                                ("injected", 3, 2)):
        model = train_model(torch, cfg, args.seed)
        tr = trainer_for(model, 4, TRAIN_DIR / name, ckpt_every=every)
        t0 = time.perf_counter()
        state, hist = tr.run(pipe, state=tr.fresh_state(),
                             inject_failure_at=inject)
        wall = time.perf_counter() - t0
        want = [] if inject is None else [(3, "simulated node failure")]
        if tr.recoveries != want or int(state["step"]) != 4:
            fail(f"train[{name}]: recoveries {tr.recoveries}, want {want}; "
                 f"step {int(state['step'])}")
        bad = [h for h in hist if not math.isfinite(h["loss"])]
        if bad or len(hist) != (4 if inject is None else 5):
            fail(f"train[{name}]: history {hist}")
        paths = leaf_paths(state["params"])
        finals[name] = [t.detach().clone() for t in
                        tree_leaves(state["params"])]
        out[name] = dict(losses=[h["loss"] for h in hist], wall_s=wall,
                         recoveries=tr.recoveries,
                         ckpt_write_s=tr.ckpt.last_write_s)
        del model, tr, state
        shutil.rmtree(TRAIN_DIR / name, ignore_errors=True)
        torch.cuda.empty_cache()
    diff = {}
    for path, a, b in zip(paths, finals["uninterrupted"], finals["injected"]):
        if torch.equal(a, b):
            continue
        ulps = (bf16_ulps(torch, a, b) if a.dtype == torch.bfloat16
                else float("inf"))
        diff[path] = dict(ulps=ulps, elements=int((a != b).sum()))
        if path not in EMBED_LEAVES or ulps > 1:
            fail(f"train[resume]: {path} differs from the uninterrupted "
                 f"run: {diff[path]}")
    out["differing_leaves"] = diff
    log(f"train[resume]: failure injected at step 3, one recovery from the "
        f"async checkpoint of step 2; final params equal the uninterrupted "
        f"run's bit for bit on {len(paths) - len(diff)} of {len(paths)} "
        f"leaves" + (f"; within 1 bf16 ulp on {sorted(diff)} (the "
                     f"embedding backward's index_put_ accumulation): "
                     f"{diff}" if diff else ""))
    return out


def start_data_parallel(torch, args):
    """Two ranks sharing the card over gloo (``chip_smoke.py
    --train-rank-job``), a (2, 1) mesh, full width, TRAIN_CHECK_LAYERS
    deep, bf16, 2 steps, each rank on its shard of the global batch,
    held against one process training the same global batch as the
    same two microbatches (run here first).  The ranks run in a thread
    while the phase's other checks run on the same card and host, so
    their step and all-reduce times are confounded with those checks and
    are printed as such, not as a metric; ``finish_data_parallel`` joins
    and gates them.  Returns the pending job."""
    import threading
    from repro_torch.launch.mesh import spawn
    from repro_torch.tree import tree_leaves
    cfg = train_config(TRAIN_CHECK_LAYERS)
    steps = 2
    model = train_model(torch, cfg, args.seed)
    tr = trainer_for(model, steps, TRAIN_DIR / "solo", microbatches=2)
    t0 = time.perf_counter()
    state, hist = tr.run(ShardsPipeline(2, vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH,
                                        seed=args.seed),
                         state=tr.fresh_state())
    solo_s = time.perf_counter() - t0
    train_gates("train[solo]", tr, hist, steps)
    torch.save([t.detach().cpu() for t in tree_leaves(state["params"])],
               TRAIN_DIR / "solo.pt")
    del model, tr, state
    shutil.rmtree(TRAIN_DIR / "solo", ignore_errors=True)
    torch.cuda.empty_cache()
    job = TRAIN_DIR / "dp_job.json"
    job.write_text(json.dumps(dict(
        layers=TRAIN_CHECK_LAYERS, steps=steps, seed=args.seed,
        solo=str(TRAIN_DIR / "solo.pt"), ckpt=str(TRAIN_DIR / "dp"),
        out=str(TRAIN_DIR))))
    pending = dict(steps=steps, hist=hist, solo_s=solo_s,
                   t0=time.perf_counter())

    def run():
        pending["outs"] = spawn([sys.executable, str(ROOT / "chip_smoke.py"),
                                 "--train-rank-job", str(job)], 2,
                                timeout=900)
    pending["thread"] = threading.Thread(target=run, daemon=True)
    pending["thread"].start()
    return pending


def finish_data_parallel(pending, power_line):
    """Join the ranks of ``start_data_parallel`` and gate them: losses,
    grad norms and every parameter within 1e-5 of the single process's,
    no recovery, gloo."""
    pending["thread"].join()
    ranks_s = time.perf_counter() - pending["t0"]
    steps, hist = pending["steps"], pending["hist"]
    if "outs" not in pending:
        fail("train[data parallel]: the ranks were not started")
    for r, (rc, out, err) in enumerate(pending["outs"]):
        for line in out.splitlines():
            log(f"  [rank {r}] {line}")
        if rc != 0:
            fail(f"train[data parallel]: rank {r} exited {rc}:\n"
                 f"{err[-3000:]}")
    ranks = [json.loads((TRAIN_DIR / f"dp_rank{r}.json").read_text())
             for r in range(2)]
    for rk in ranks:
        tag = f"train[data parallel, rank {rk['rank']}]"
        if rk["backend"] != "gloo" or rk["recoveries"] or \
                len(rk["hist"]) != steps:
            fail(f"{tag}: backend {rk['backend']}, recoveries "
                 f"{rk['recoveries']}, {len(rk['hist'])} steps")
        for a, b in zip(hist, rk["hist"]):
            for k in ("loss", "grad_norm"):
                if not abs(a[k] - b[k]) <= 1e-5 * abs(a[k]):
                    fail(f"{tag}: {k} {b[k]} vs the single rank's {a[k]}")
        log(f"{tag}: losses {[h['loss'] for h in rk['hist']]} (single rank "
            f"{[h['loss'] for h in hist]}); params max rel err "
            f"{rk['max_rel']:.3e} <= 1e-5: {rk['max_rel'] <= 1e-5} (worst "
            f"leaf {rk['worst_leaf']}); confounded, run beside the "
            f"card-vs-host and resume checks: steps {rk['step_ms']} ms, "
            f"gradient all-reduce {rk['comm_s']:.2f} s over "
            f"{rk['collectives']} collectives staged through host memory; "
            f"card {power_line}")
        if not rk["max_rel"] <= 1e-5:
            fail(f"{tag}: params differ from the single rank's")
    return dict(steps=steps, solo_losses=[h["loss"] for h in hist],
                solo_s=pending["solo_s"], ranks_s=ranks_s, ranks=ranks)


def train_rank(job_path):
    """One rank of ``start_data_parallel``: join the (2, 1) mesh over
    gloo, train on this rank's shard, hold the final parameters against
    the single process's (max |a - b| over the leaf's max-abs)."""
    job = json.loads(Path(job_path).read_text())
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("rank: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_leaves
    mesh = make_mesh((2, 1), ("data", "model"), device_type="cuda")
    cfg = train_config(job["layers"])
    model = train_model(torch, cfg, job["seed"])
    tr = trainer_for(model, job["steps"], job["ckpt"], mesh=mesh)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=job["seed"],
                       data_shard=mesh.index("data"),
                       data_shards=mesh.size("data"))
    mesh.reset_counters()
    state, hist = tr.run(pipe, state=tr.fresh_state())
    solo = torch.load(job["solo"])
    paths = leaf_paths(state["params"])
    worst, worst_leaf = 0.0, None
    for path, a, b in zip(paths, tree_leaves(state["params"]), solo):
        a, b = a.detach().float().cpu(), b.float()
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel >= worst:
            worst, worst_leaf = rel, path
    res = dict(rank=mesh.rank, backend=mesh.backend, hist=hist,
               recoveries=tr.recoveries, max_rel=worst,
               worst_leaf=worst_leaf,
               step_ms=[round(t * 1e3, 1) for t in tr.step_times],
               comm_s=mesh.comm_s, collectives=mesh.collectives)
    (Path(job["out"]) / f"dp_rank{mesh.rank}.json").write_text(
        json.dumps(res))
    torch.distributed.destroy_process_group()


# the (2, 2) mesh run on the one card: four gloo ranks, full width,
# TRAIN_CHECK_LAYERS deep, f32, against one unsharded process
TP_MESH, TP_STEPS, TP_BATCH, TP_SEQ = (2, 2), 2, 4, 256
# An AdamW step moves an element by lr x |m^ / (sqrt(v^) + eps)|, which
# is at most ~1.0004 lr at steps 1 and 2 with betas (0.9, 0.95), plus
# weight decay (lr x 0.1 x |p|, the same in both runs).  Summed in
# another order (the shards), a gradient within rounding of eps can turn
# that update around: 2 lr a step.  So no element may move further apart
# than 2 lr per step (4e-5 at lr 1e-5 over 2 steps).
TP_PARAM_BOUND = 2 * TRAIN_LR * TP_STEPS * 1.001


class ShardRows:
    """This data shard's rows of a pipeline's global batch."""

    def __init__(self, pipe, shard, shards):
        self.pipe, self.shard, self.shards = pipe, shard, shards

    def batch_at(self, step):
        t = self.pipe.batch_at(step)["tokens"]
        n = t.shape[0] // self.shards
        return {"tokens": t[self.shard * n:(self.shard + 1) * n]}


def train_sharded(torch, args, power_line):
    """The (2, 2) mesh on the one card (``TP_MESH``): one unsharded f32
    process on the global batch here, saving its initial and final
    params, then four gloo ranks (``--train-tp-rank-job``), each holding
    its slices and gated against the unsharded run."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import spawn
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = train_config(TRAIN_CHECK_LAYERS)
    model = train_model(torch, cfg, args.seed, dtype=torch.float32)
    torch.save([t.detach().cpu() for t in tree_leaves(
        model.train_params())], TRAIN_DIR / "tp_init.pt")
    tr = trainer_for(model, TP_STEPS, TRAIN_DIR / "tp_solo")
    t0 = time.perf_counter()
    state, hist = tr.run(SyntheticLM(vocab_size=cfg.vocab_size,
                                     seq_len=TP_SEQ, global_batch=TP_BATCH,
                                     seed=args.seed),
                         state=tr.fresh_state())
    solo_s = time.perf_counter() - t0
    train_gates("train[sharded, solo]", tr, hist, TP_STEPS)
    leaves = tree_leaves(state["params"])
    whole_w = sum(t.numel() * t.element_size() for t in leaves)
    torch.save([t.detach().cpu() for t in leaves], TRAIN_DIR / "tp_final.pt")
    del model, tr, state, leaves
    shutil.rmtree(TRAIN_DIR / "tp_solo", ignore_errors=True)
    torch.cuda.empty_cache()
    job = TRAIN_DIR / "tp_job.json"
    job.write_text(json.dumps(dict(
        mesh=TP_MESH, layers=TRAIN_CHECK_LAYERS, steps=TP_STEPS,
        seed=args.seed, init=str(TRAIN_DIR / "tp_init.pt"),
        final=str(TRAIN_DIR / "tp_final.pt"), ckpt=str(TRAIN_DIR / "tp"),
        out=str(TRAIN_DIR))))
    n = TP_MESH[0] * TP_MESH[1]
    t0 = time.perf_counter()
    outs = spawn([sys.executable, str(ROOT / "chip_smoke.py"),
                  "--train-tp-rank-job", str(job)], n, timeout=600)
    ranks_s = time.perf_counter() - t0
    for r, (rc, out, err) in enumerate(outs):
        for line in out.splitlines():
            log(f"  [rank {r}] {line}")
        if rc != 0:
            fail(f"train[sharded]: rank {r} exited {rc}:\n{err[-3000:]}")
    ranks = [json.loads((TRAIN_DIR / f"tp_rank{r}.json").read_text())
             for r in range(n)]
    for rk in ranks:
        tag = f"train[sharded {TP_MESH}, rank {rk['rank']} at {rk['coords']}]"
        if rk["backend"] != "gloo" or rk["recoveries"] or \
                len(rk["hist"]) != TP_STEPS or not rk["init_equal"]:
            fail(f"{tag}: backend {rk['backend']}, recoveries "
                 f"{rk['recoveries']}, {len(rk['hist'])} steps, init equal "
                 f"{rk['init_equal']}")
        for a, b in zip(hist, rk["hist"]):
            for k in ("loss", "grad_norm"):
                if not abs(a[k] - b[k]) <= 1e-5 * abs(a[k]):
                    fail(f"{tag}: {k} {b[k]} vs the unsharded {a[k]}")
        log(f"{tag}: init slices equal the unsharded init's; losses "
            f"{[h['loss'] for h in rk['hist']]}, grad norms "
            f"{[h['grad_norm'] for h in rk['hist']]} (unsharded "
            f"{[h['loss'] for h in hist]}, "
            f"{[h['grad_norm'] for h in hist]}: within 1e-5); params max "
            f"|diff| {rk['max_abs']:.3e} <= {TP_PARAM_BOUND:.3e} (2 lr a "
            f"step): {rk['max_abs'] <= TP_PARAM_BOUND}, "
            f"{rk['beyond_1e-6']} of {rk['elements']} elements beyond 1e-6 "
            f"of their leaf's max-abs (worst leaf {rk['worst_leaf']})")
        log(f"{tag}: holds {rk['weight_bytes'] / 1e9:.3f} GB of f32 weights"
            f" and {rk['moment_bytes'] / 1e9:.3f} GB of AdamW moments, of "
            f"{rk['whole_weight_bytes'] / 1e9:.3f} and "
            f"{rk['whole_moment_bytes'] / 1e9:.3f} GB unsharded "
            f"({rk['weight_bytes'] / rk['whole_weight_bytes']:.3f}); "
            f"{rk['collectives']} collectives, {rk['coll_bytes']} bytes, "
            f"{rk['comm_s']:.2f} s of host time in them ({rk['host_syncs']} "
            f"staged through host memory) over steps of {rk['step_ms']} ms; "
            f"checkpoint written slice by slice in "
            f"{rk['ckpt_write_s']:.2f} s; card {power_line}")
        if not rk["max_abs"] <= TP_PARAM_BOUND:
            fail(f"{tag}: params differ from the unsharded run's beyond "
                 f"{TP_PARAM_BOUND:.3e}")
        if rk["whole_weight_bytes"] != whole_w:
            fail(f"{tag}: unsharded weight bytes {rk['whole_weight_bytes']} "
                 f"vs the unsharded process's {whole_w}")
    out = dict(mesh=TP_MESH, layers=TRAIN_CHECK_LAYERS, steps=TP_STEPS,
               batch=TP_BATCH, seq=TP_SEQ, solo_losses=[h["loss"]
                                                        for h in hist],
               solo_grad_norms=[h["grad_norm"] for h in hist],
               solo_s=solo_s, ranks_s=ranks_s, param_bound=TP_PARAM_BOUND,
               ranks=ranks, card=power_line)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"train[sharded]: {out['phase_s']:.1f} s (unsharded run "
        f"{solo_s:.1f} s, ranks {ranks_s:.1f} s from spawn to exit)")
    return out


def train_tp_rank(job_path):
    """One rank of ``train_sharded``: the (2, 2) mesh over gloo, this
    rank's slices of the seed's init (held against the unsharded init),
    ``TP_STEPS`` steps on its data shard's rows, its slices of the final
    params held against the unsharded run's."""
    job = json.loads(Path(job_path).read_text())
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("rank: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"),
                     device_type="cuda")
    cfg = train_config(job["layers"])
    tr = trainer_for(Model(cfg, device="meta", dtype=torch.float32),
                     job["steps"], job["ckpt"], mesh=mesh, sharded=True)
    plan = tr.plan
    state = tr.init_state(job["seed"])
    init = torch.load(job["init"])
    init_equal = all(torch.equal(t.detach(), plan.local(w, i)) for i, (t, w)
                     in enumerate(zip(tree_leaves(state["params"]), init)))
    del init
    pipe = ShardRows(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TP_SEQ,
                                 global_batch=TP_BATCH, seed=job["seed"]),
                     mesh.index("data"), mesh.size("data"))
    mesh.reset_counters()
    state, hist = tr.run(pipe, state=state)
    comm = dict(collectives=mesh.collectives, coll_bytes=dict(
        mesh.coll_bytes), comm_s=mesh.comm_s, host_syncs=mesh.host_syncs)
    final = torch.load(job["final"])
    worst, worst_leaf, beyond, elements = 0.0, None, 0, 0
    for i, (t, w) in enumerate(zip(tree_leaves(state["params"]), final)):
        want = plan.local(w, i).float()
        err = (t.detach().float() - want).abs()
        if float(err.max()) >= worst:
            worst, worst_leaf = float(err.max()), "/".join(
                map(str, plan.paths[i]))
        beyond += int((err > 1e-6 * float(w.abs().max())).sum())
        elements += err.numel()
    res = dict(rank=mesh.rank, coords=list(mesh.coords),
               backend=mesh.backend, hist=hist, recoveries=tr.recoveries,
               init_equal=init_equal, max_abs=worst, worst_leaf=worst_leaf,
               **{"beyond_1e-6": beyond}, elements=elements,
               weight_bytes=plan.nbytes(),
               moment_bytes=2 * plan.nbytes(dtype=torch.float32),
               whole_weight_bytes=plan.nbytes(whole=True),
               whole_moment_bytes=2 * plan.nbytes(whole=True,
                                                  dtype=torch.float32),
               step_ms=[round(t * 1e3, 1) for t in tr.step_times],
               ckpt_write_s=tr.ckpt.last_write_s, **comm)
    (Path(job["out"]) / f"tp_rank{mesh.rank}.json").write_text(
        json.dumps(res))
    torch.distributed.destroy_process_group()


# --train-mesh: OPT-6.7B at full depth on a mesh of cards, one rank a card
# over NCCL (the four-card run)
MESH_TRAIN_STEPS = 6
MESH_TRAIN_DIR = ROOT / "build" / "train_mesh"


def train_mesh_only(torch, args, power_line):
    """``--train-mesh DxM``: phase 1, then OPT-6.7B at full width and
    depth (32 layers), bf16, remat, ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens, ``MESH_TRAIN_STEPS`` steps on a (D, M) mesh of D x M cards
    (``--train-mesh-rank-job``), fsdp and act_shard on; then one
    checkpoint written slice by slice and restored on a (D x M, 1) mesh
    with fsdp, every leaf's sum equal.  ``chiprun_out/train_mesh.json``."""
    from repro_torch.launch.mesh import spawn
    shape = tuple(int(x) for x in args.train_mesh.lower().split("x"))
    n = shape[0] * shape[1]
    if torch.cuda.device_count() < n:
        fail(f"--train-mesh {args.train_mesh} needs {n} cards, "
             f"{torch.cuda.device_count()} visible")
    shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
    MESH_TRAIN_DIR.mkdir(parents=True)
    job = MESH_TRAIN_DIR / "job.json"
    job.write_text(json.dumps(dict(
        mesh=shape, layers=32, steps=MESH_TRAIN_STEPS, seed=args.seed,
        ckpt=str(MESH_TRAIN_DIR / "ckpt"), out=str(MESH_TRAIN_DIR))))
    t0 = time.perf_counter()
    try:
        outs = spawn([sys.executable, str(ROOT / "chip_smoke.py"),
                      "--train-mesh-rank-job", str(job)], n, timeout=2400)
        for r, (rc, out, err) in enumerate(outs):
            for line in out.splitlines():
                log(f"  [rank {r}] {line}")
            if rc != 0:
                fail(f"train[mesh]: rank {r} exited {rc}:\n{err[-3000:]}")
        ranks = [json.loads((MESH_TRAIN_DIR / f"rank{r}.json").read_text())
                 for r in range(n)]
    finally:
        shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for rk in ranks:
        tag = f"train[mesh {shape}, rank {rk['rank']} at {rk['coords']}]"
        p50 = rk["step_ms_p50"]
        log(f"{tag}: backend {rk['backend']}; losses {rk['losses']}; step "
            f"p50 {p50:.1f} ms ({tokens} tokens a step: "
            f"{tokens / (p50 / 1e3):.0f} tokens/s); collectives "
            f"{rk['comm_share_p50']:.3f} of the step's device time (p50; "
            f"{rk['collectives']} a step, {rk['coll_bytes']} bytes); peak "
            f"device memory {rk['peak_bytes'] / 1e9:.2f} GB (weights "
            f"{rk['weight_bytes'] / 1e9:.2f}, moments "
            f"{rk['moment_bytes'] / 1e9:.2f} GB of "
            f"{rk['whole_weight_bytes'] / 1e9:.2f} and "
            f"{rk['whole_moment_bytes'] / 1e9:.2f} unsharded); card "
            f"{power_line}")
        if rk["backend"] != "nccl" or not all(
                math.isfinite(x) for x in rk["losses"]):
            fail(f"{tag}: backend {rk['backend']}, losses {rk['losses']}")
        ck = rk["ckpt"]
        if ck.get("skipped"):
            log(f"{tag}: checkpoint skipped: {ck['skipped']}")
            continue
        log(f"{tag}: checkpoint of {ck['bytes'] / 1e9:.2f} GB: snapshot "
            f"{ck['snapshot_s']:.2f} s, write and commit {ck['write_s']:.2f}"
            f" s; restored on a {ck['restore_mesh']} mesh in "
            f"{ck['restore_s']:.2f} s (peak "
            f"{ck['restore_peak_bytes'] / 1e9:.2f} GB, "
            f"{ck['held_before_restore'] / 1e9:.2f} GB held before it), "
            f"every leaf's sum equal: {ck['sums_equal']}")
        if not ck["sums_equal"]:
            fail(f"{tag}: the restored state differs from the saved one")
    out = dict(mesh=shape, layers=32, steps=MESH_TRAIN_STEPS,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, wall_s=wall, ranks=ranks,
               card=power_line)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "train_mesh.json").write_text(json.dumps(out, indent=1))
    log(f"train[mesh]: {wall:.1f} s")
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def train_mesh_rank(job_path):
    """One rank of ``--train-mesh``: the steps through ``build_step``,
    each timed on the host to the read of its loss, its collectives
    timed by CUDA events (``Mesh.timing``); then the checkpoint and its
    restore on (n, 1)."""
    job = json.loads(Path(job_path).read_text())
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"),
                     device_type="cuda")
    cfg = train_config(job["layers"])
    tr = trainer_for(Model(cfg, device="meta"), job["steps"], job["ckpt"],
                     mesh=mesh, sharded=True)
    plan = tr.plan
    torch.cuda.reset_peak_memory_stats()
    state = tr.init_state(job["seed"])
    pipe = ShardRows(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, seed=job["seed"]),
                     mesh.index("data"), mesh.size("data"))
    step = tr.build_step()
    mesh.timing = True
    losses, step_ms, shares = [], [], []
    for i in range(job["steps"]):
        mesh.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        step_ms.append(dt * 1e3)
        shares.append(mesh.device_comm_s() / dt)
        coll = dict(collectives=mesh.collectives,
                    coll_bytes=dict(mesh.coll_bytes))
    mesh.timing = False
    peak = torch.cuda.max_memory_allocated()
    later = sorted(step_ms[1:])
    res = dict(rank=mesh.rank, coords=list(mesh.coords), backend=mesh.backend,
               losses=losses, step_ms=step_ms,
               step_ms_p50=later[len(later) // 2], comm_shares=shares,
               comm_share_p50=sorted(shares[1:])[len(later) // 2],
               peak_bytes=peak, weight_bytes=plan.nbytes(),
               moment_bytes=2 * plan.nbytes(dtype=torch.float32),
               whole_weight_bytes=plan.nbytes(whole=True),
               whole_moment_bytes=2 * plan.nbytes(whole=True,
                                                  dtype=torch.float32),
               **coll)
    # one checkpoint, written slice by slice, then restored on (n, 1)
    # with nothing else on the card
    need = plan.nbytes(whole=True) * 5       # weights + f32 m and v
    free = shutil.disk_usage(Path(job["ckpt"]).parent).free
    if free < 1.2 * need:
        res["ckpt"] = {"skipped": f"{free / 1e9:.0f} GB free for a "
                                  f"{need / 1e9:.0f}-GB checkpoint"}
    else:
        before = leaf_sums(torch, tr, state)
        t0 = time.perf_counter()
        tr.save_async(job["steps"], state)
        saved = dict(bytes=need, snapshot_s=tr.ckpt.last_snapshot_s)
        tr.ckpt.wait()
        saved["write_s"] = time.perf_counter() - t0
        cfg = tr.model.cfg
        del tr, state, step, plan
        res["ckpt"] = {**saved, **mesh_restore(torch, cfg, mesh, job,
                                               before)}
    (Path(job["out"]) / f"rank{mesh.rank}.json").write_text(json.dumps(res))
    torch.distributed.barrier(group=mesh.host_group)
    torch.distributed.destroy_process_group()


def leaf_sums(torch, tr, state):
    """Each whole leaf's (sum, sum of magnitudes) in f64 from this rank's
    slices: the params, then both moments."""
    from repro_torch.tree import tree_leaves
    out = []
    for tree in (state["params"], state["opt"].m, state["opt"].v):
        leaves = tree_leaves(tree)
        sums = tr._over_slices([t.detach().double().sum() for t in leaves],
                               "sum")
        mags = tr._over_slices([t.detach().double().abs().sum()
                                for t in leaves], "sum")
        out += [(float(a), float(m)) for a, m in zip(sums, mags)]
    return out


def mesh_restore(torch, cfg, mesh, job, before):
    """Restore the checkpoint of ``train_mesh_rank`` on an (n, 1) mesh with
    fsdp, its time and peak device memory taken with nothing else on the
    card; then the sums of every params and moments leaf against
    ``before``."""
    import gc
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n = mesh.size_total
    flat = make_mesh((n, 1), ("data", "model"), device_type="cuda")
    back = trainer_for(Model(cfg, device="meta"), job["steps"], job["ckpt"],
                       mesh=flat, sharded=True)
    t0 = time.perf_counter()
    restored, at = back._restore(job["steps"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    after = leaf_sums(torch, back, restored)
    return dict(restore_mesh=[n, 1], restore_s=restore_s, step=at,
                restore_peak_bytes=peak, held_before_restore=held,
                # each sum taken over other slices: equal up to f64
                # rounding of the partial sums
                sums_equal=len(before) == len(after) and all(
                    abs(a - b) <= 1e-12 * max(m, 1e-300) and
                    abs(m - mb) <= 1e-12 * max(m, 1e-300)
                    for (a, m), (b, mb) in zip(before, after)))


def train_phase(torch, args, power_line):
    """Phase 6: training (``repro_torch.train``): the main run, then the
    data-parallel ranks on the card in the background while the
    card-vs-host check and failure injection and resume run."""
    import gc
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    log(f"train: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        f"allocated on the card; {shutil.disk_usage(TRAIN_DIR).free / 1e9:.0f}"
        f" GB free for checkpoints under {TRAIN_DIR.relative_to(ROOT)}")
    out = {"card": power_line}
    pending = None
    try:
        out["main"] = train_main(torch, args, power_line)
        # the data-parallel ranks run beside the checks that record no
        # time
        pending = start_data_parallel(torch, args)
        out["host_check"] = train_host_check(torch, args)
        out["resume"] = train_resume_check(torch, args)
        out["data_parallel"] = finish_data_parallel(pending, power_line)
        out["sharded"] = train_sharded(torch, args, power_line)
    finally:
        if pending is not None:
            pending["thread"].join()
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"train: phase {out['phase_s']:.1f} s")
    return out


def train_only(torch, args, power_line):
    """``--train-only``: phase 1 and the training phase; results in
    ``chiprun_out/train.json``."""
    out = train_phase(torch, args, power_line)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "train.json").write_text(json.dumps(out, indent=1))
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# phase 7: analysis (FIGLUT-I numerics, the dry run, the byte model)
# ---------------------------------------------------------------------------

PREALIGN_ROWS = (8, 512)
# mantissa bits: fp16 inputs (1 implicit + 10 stored), bf16 inputs
PREALIGN_MBS = (11, 8)
# the reference's Table IV gate on FIGLUT-F and FIGLUT-I at fp16
# mantissas against the dense dequantized product
# (``benchmarks/bench_table4_numerics.py``)
TABLE4_TOL = 5e-3
# f32 unit roundoff: the card-vs-host bound of the alpha / z contraction
F32_U = 2.0 ** -24
ANALYSIS_BITS = 3            # the width phase 4 serves


def contraction_tol(torch, part, mant, scale, w):
    """Per output element of FIGLUT-I, how far two f32 evaluations of its
    alpha / z contraction of the same integer partials ``part`` can lie
    apart in any summation order: each is within gamma_K * T of the exact
    sum (T the sum of the K terms' magnitudes, gamma_K = K u / (1 - K u)),
    so 2 gamma_K T, de-aligned by ``scale``; doubled for the rounding of T
    itself and of the de-aligned product (at most u |y| a side, which
    2 gamma_K T scale already exceeds)."""
    q, _, _, n_groups = part.shape
    terms = torch.einsum("qbmG,qmG->bm", part.abs(), w.alpha.float().abs())
    k = q * n_groups
    if w.z is not None:
        msum = mant.reshape(mant.shape[0], n_groups, -1).sum(-1)
        terms = terms + torch.einsum("bG,mG->bm", msum.abs(),
                                     w.z.float().abs())
        k += n_groups + 1
    gamma = k * F32_U / (1 - k * F32_U)
    return 2 * (2 * gamma * terms) * scale


def prealign_cases(torch, gen, power_line):
    """Phase 7 (a): FIGLUT-I (``core/prealign.py``) at OPT-6.7B's three
    layer shapes, BCQ-3 g 128, rows 8 and 512, mantissa bits 11 and 8:
    the card against the host (mantissas, scales and partial sums bit for
    bit, the output within :func:`contraction_tol` of the host's, its
    share of the output's scale printed), and the Table IV rows: FIGLUT-I and
    FIGLUT-F (the ``bcq_matmul`` kernel) against the dense dequantized
    product in f32 ("GPU").  Returns (records, [(record, call)]): each
    case's call, for :func:`time_prealign`."""
    import functools
    from repro_torch.core import bcq
    from repro_torch.core.plane import dequantize
    from repro_torch.core.prealign import prealign, prealigned_bcq_matmul
    from repro_torch.kernels.bcq_matmul import bcq_matmul
    if torch.backends.cuda.matmul.allow_tf32:
        fail("prealign: TF32 is on; FIGLUT-I's integer sums are exact only "
             "in f32")
    out, calls = [], []
    for m, n in OPT_SHAPES:
        w_dense = torch.randn((m, n), generator=gen, device="cuda") * 0.02
        w = bcq.quantize(w_dense, bits=ANALYSIS_BITS, group_size=128)
        del w_dense
        w_host = w.to("cpu")
        dense = dequantize(w, torch.float32)
        for rows in PREALIGN_ROWS:
            x = torch.randn((rows, n), generator=gen, device="cuda")
            x_host = x.cpu()
            gpu = torch.matmul(x, dense.T)
            scale = float(gpu.abs().max())
            fig_f = bcq_matmul(x, w, out_dtype=torch.float32)
            err_f = float((fig_f - gpu).abs().max()) / scale
            for mb in PREALIGN_MBS:
                y, part = prealigned_bcq_matmul(
                    x, w, mb, torch.float32, with_partials=True)
                yh, part_h = prealigned_bcq_matmul(
                    x_host, w_host, mb, torch.float32, with_partials=True)
                same = torch.equal(part.cpu(), part_h)
                del part_h
                mant, sc = prealign(x, mb)
                mant_h, sc_h = prealign(x_host, mb)
                aligned = (torch.equal(mant.cpu(), mant_h)
                           and torch.equal(sc.cpu(), sc_h))
                del mant_h, sc_h
                # the bound from the card's operands (the same bits as the
                # host's where the gates above pass)
                tol = contraction_tol(torch, part, mant, sc, w)
                del part, mant, sc
                diff = (y - yh.to(y.device)).abs()
                # the share of the contraction bound the difference uses
                used = float((diff / tol.clamp(min=1e-30)).max())
                within = bool((diff <= tol).all())
                host_err = float(diff.max()) / (float(yh.abs().max())
                                                + 1e-30)
                del diff, tol
                err_i = float((y - gpu).abs().max()) / scale
                rec = dict(m=m, n=n, rows=rows, mantissa_bits=mb,
                           partials_bit_identical=same,
                           alignment_bit_identical=aligned,
                           card_vs_host_rel=host_err,
                           card_vs_host_of_bound=used,
                           figlut_i_rel_err=err_i, figlut_f_rel_err=err_f)
                out.append(rec)
                calls.append((rec, functools.partial(
                    prealigned_bcq_matmul, x, w, mb, torch.float32)))
                log(f"prealign [{m}x{n}] rows {rows} mb {mb}: mantissas "
                    f"and scales card == host {aligned}, partial sums "
                    f"{same}, output card vs host {host_err:.2e} of its "
                    f"scale, {used:.3f} of the f32 contraction bound; "
                    f"Table IV max rel err vs GPU: "
                    f"FIGLUT-I {err_i:.3e}, FIGLUT-F {err_f:.3e}")
                if not same:
                    fail(f"prealign [{m}x{n}] rows {rows} mb {mb}: the "
                         "card's integer partial sums differ from the "
                         "host's")
                if not aligned:
                    fail(f"prealign [{m}x{n}] rows {rows} mb {mb}: the "
                         "card's mantissas or scales differ from the "
                         "host's")
                if not within:
                    fail(f"prealign [{m}x{n}] rows {rows} mb {mb}: output "
                         f"{used:.2f}x the f32 contraction bound from the "
                         "host's")
                if mb == 11 and max(err_i, err_f) > TABLE4_TOL:
                    fail(f"prealign [{m}x{n}] rows {rows}: Table IV rows "
                         f"{err_i:.2e} / {err_f:.2e} above {TABLE4_TOL}")
                del y, yh
        del w_host, dense
        torch.cuda.empty_cache()
    return out, calls


def time_prealign(torch, calls, power_line):
    """The plain FIGLUT-I function's device time at each case (CUDA
    events, L2 flushed), with no other host work beside it; no speed
    claim: it has no kernel."""
    from repro_torch.tune.measure import Timer
    timer = Timer(iters=5, warmup=1)
    for rec, call in calls:
        rec["plain_ms"] = timer(call)
        log(f"prealign [{rec['m']}x{rec['n']}] rows {rec['rows']} mb "
            f"{rec['mantissa_bits']}: plain FIGLUT-I {rec['plain_ms']:.3f} "
            f"ms on {power_line}")


def dryrun_cells(torch):
    """Phase 7 (b): ``launch/dryrun.run_cell`` for every (arch x shape)
    the arch supports, at full size on the meta device, on the
    production mesh (16 x 16) and on one card (1 x 1), at the served
    width (BCQ-3 g 128): per-rank GB, whether it fits in this card's
    memory, FLOPs, bottleneck and roofline terms, one line per cell."""
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch import dryrun
    cap = torch.cuda.get_device_properties(0).total_memory
    meshes = (("16x16", dryrun.production_mesh()),
              ("1x1", dryrun.ShapeMesh((1, 1), ("data", "model"))))
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if shape == "long_500k" and \
                    not get_config(arch).supports_long_context():
                log(f"dryrun {arch}/{shape}: SKIP (full attention)")
                continue
            for label, mesh in meshes:
                r = dryrun.run_cell(arch, shape, quant=ANALYSIS_BITS,
                                    mesh=mesh, capacity_bytes=cap,
                                    verbose=False)
                roof = r["roofline"]
                if roof["flops_per_dev"] <= 0:
                    fail(f"dryrun {arch}/{shape}/{label}: 0 FLOPs")
                gb = (r["arg_bytes"] + r["out_bytes"] - r["alias_bytes"]) \
                    / 1e9
                row = dict(arch=arch, shape=shape, mesh=label, gb=gb,
                           fits=r["fits"], per_rank_bytes=r["per_rank_bytes"],
                           flops=roof["flops_per_dev"],
                           bottleneck=roof["bottleneck"],
                           t_compute_ms=roof["t_compute_s"] * 1e3,
                           t_memory_ms=roof["t_memory_s"] * 1e3,
                           useful=roof["useful_flops_ratio"])
                out.append(row)
                log(f"dryrun {arch:21s} {shape:11s} {label:5s}: "
                    f"{gb:9.2f} GB/rank (fits {cap / 1e9:.1f} GB: "
                    f"{r['fits']}), {row['flops']:.3e} FLOPs/rank, "
                    f"{row['bottleneck']}-bound, t_comp "
                    f"{row['t_compute_ms']:.3f} ms, t_mem "
                    f"{row['t_memory_ms']:.3f} ms, useful "
                    f"{row['useful']:.3f}")
    return out


def byte_model(torch, args, cells, card_bytes, decode_p50):
    """Phase 7 (c): the meta prediction of OPT-6.7B BCQ-3 g 128's
    parameter bytes against the model phase 4 built on the card (exactly
    equal, and equal to the dry run's one-card cell at full depth); the
    ``serve_analytic_bytes`` decode bound at batch 8 beside phase 4's
    measured OPT ``auto`` decode-step p50 (printed, not gated)."""
    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.launch.dryrun import active_params
    from repro_torch.models.model import to_params
    from repro_torch.models.module import abstract_model, param_bytes
    from repro_torch.quant.api import abstract_quantized_params
    from repro_torch.roofline import analysis as ra
    cfg = get_config("opt_6_7b").replace(n_layers=args.layers)
    meta = abstract_model(cfg)
    manifest = abstract_quantized_params(meta, bits=ANALYSIS_BITS,
                                         group_size=128)
    pred = param_bytes(to_params(meta, scan_layers=False))
    log(f"byte model: OPT-6.7B BCQ-3 g 128 ({cfg.n_layers} layers) "
        f"predicted on meta {pred:,} B; built on the card {card_bytes:,} B")
    if pred != card_bytes:
        fail(f"byte model: meta prediction {pred} != the card's "
             f"{card_bytes}")
    cell = [c for c in cells if c["arch"] == "opt_6_7b"
            and c["shape"] == "decode_32k" and c["mesh"] == "1x1"][0]
    if cfg.n_layers == get_config("opt_6_7b").n_layers and \
            cell["per_rank_bytes"]["params"] != pred:
        fail(f"byte model: the dry run's one-card cell holds "
             f"{cell['per_rank_bytes']['params']} B of parameters, the "
             f"meta model {pred}")
    # the mix's mean live context during decode: its prompts plus half
    # of the 32 new tokens
    lens = [len(p) for p in mix_prompts(args.seed, cfg.vocab_size)]
    ctx = int(round(sum(lens) / len(lens) + 16))
    n_act, _ = active_params(cfg, meta)
    rows = ra.serve_analytic_bytes(cfg, ShapeCfg("serve_b8", ctx, 8,
                                                 "decode"),
                                   n_act, ANALYSIS_BITS, n_model=1,
                                   n_data=1)
    kq = rows["kernel_q"]
    t_packed = kq["t_memory_s"] * 1e3
    # the same bound with the f32 alpha / z rows of every quantized
    # linear (the bytes the kernels stream besides the planes)
    t_scales = (manifest.quant_bytes + kq["cache_bytes"]) / ra.HBM_BW * 1e3
    out = dict(predicted_bytes=pred, card_bytes=card_bytes,
               mean_context=ctx, n_active_params=n_act,
               kernel_q_bound_ms=t_packed, cache_bytes=kq["cache_bytes"],
               with_scales_bound_ms=t_scales, decode_p50_ms=decode_p50)
    if decode_p50:
        out["bound_share_of_p50"] = t_packed / decode_p50
        share = (f"{t_packed / decode_p50:.2%} of phase 4's OPT `auto` "
                 f"decode-step p50 {decode_p50:.2f} ms")
    else:
        share = "phase 4's decode-step p50 not measured in this run"
    log(f"byte model: serve_analytic_bytes kernel_q bound at batch 8, "
        f"context {ctx}: {t_packed:.4f} ms (packed planes "
        f"{kq['weight_bytes'] / 1e9:.3f} GB + cache "
        f"{kq['cache_bytes'] / 1e9:.3f} GB at 3.35 TB/s); with the f32 "
        f"alpha / z rows {t_scales:.4f} ms; {share}")
    return out


def analysis_phase(torch, args, power_line, card_bytes, decode_p50):
    """Phase 7: (a) FIGLUT-I numerics, (b) the dry run of every cell,
    (c) the byte model against the card."""
    import threading
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    out = {"card": power_line}
    # the dry run is host work on meta tensors (Python dispatch, one
    # core): it runs beside (a), whose host side is multi-threaded
    # products that release the interpreter
    dry, errors, spans = {}, [], {}

    def run_dry():
        t = time.perf_counter()
        try:
            dry["cells"] = dryrun_cells(torch)
        except BaseException as e:          # re-raised below
            errors.append(e)
        spans["dryrun"] = time.perf_counter() - t
    thread = threading.Thread(target=run_dry)
    thread.start()
    try:
        out["prealign"], calls = prealign_cases(torch, gen, power_line)
        spans["prealign"] = time.perf_counter() - t0
    finally:
        thread.join()
    if errors:
        raise errors[0]
    # timed alone: the dry run's thread would delay the launches
    time_prealign(torch, calls, power_line)
    del calls
    torch.cuda.empty_cache()
    out["dryrun"] = dry["cells"]
    out["byte_model"] = byte_model(torch, args, out["dryrun"], card_bytes,
                                   decode_p50)
    out["phase_s"] = time.perf_counter() - t0
    out["spans_s"] = spans
    log(f"analysis: phase {out['phase_s']:.1f} s (prealign checks "
        f"{spans['prealign']:.1f} s beside the dry run "
        f"{spans['dryrun']:.1f} s, then the timings)")
    return out


def opt_param_bytes(model) -> int:
    """The stored bytes of a model's parameters (``param_bytes`` of its
    reference-layout tree)."""
    from repro_torch.models.model import to_params
    from repro_torch.models.module import param_bytes
    return param_bytes(to_params(model, scan_layers=False))


def analysis_only(torch, args, power_line):
    """``--analysis-only``: phase 1, the build and phase 7, phase 7 (c)
    on OPT-6.7B BCQ-3 built alone; results in
    ``chiprun_out/analysis.json``."""
    from repro_torch.configs import get_config
    from repro_torch.quant import QuantSpec
    cfg = get_config("opt_6_7b").replace(n_layers=args.layers)
    model, _, _, _ = build_quantized(
        torch, cfg, QuantSpec(format="bcq", bits=ANALYSIS_BITS,
                              group_size=128), args.seed)
    card_bytes = opt_param_bytes(model)
    del model
    torch.cuda.empty_cache()
    out = analysis_phase(torch, args, power_line, card_bytes, None)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "analysis.json").write_text(json.dumps(out, indent=1))
    print(power_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32,
                    help="OPT-6.7B serve depth (full width is always kept)")
    ap.add_argument("--rank-job", default="",
                    help=argparse.SUPPRESS)  # one rank of serve_sharded
    ap.add_argument("--train-rank-job", default="",
                    help=argparse.SUPPRESS)  # one rank of the train phase
    ap.add_argument("--train-tp-rank-job", default="",
                    help=argparse.SUPPRESS)  # one rank of train_sharded
    ap.add_argument("--train-mesh-rank-job", default="",
                    help=argparse.SUPPRESS)  # one rank of --train-mesh
    ap.add_argument("--train-mesh", default="",
                    help="run only phase 1 and OPT-6.7B's full-depth "
                         "training on a DxM mesh, one rank a card (NCCL), "
                         "e.g. 2x2 on four cards")
    ap.add_argument("--train-only", action="store_true",
                    help="run only phase 1 and the training phase")
    ap.add_argument("--analysis-only", action="store_true",
                    help="run only phase 1, the build and the analysis "
                         "phase")
    ap.add_argument("--sharded-mesh", default="",
                    help="run only the build and serve_sharded on a DxM "
                         "mesh, one rank a card where there are D*M cards "
                         "(NCCL), e.g. 2x2 on four cards")
    ap.add_argument("--sharded-kinds", default="opt,minicpm3,deepseek",
                    help="the serve_sharded runs of --sharded-mesh, of "
                         + ", ".join(SHARDED_KINDS))

    args = ap.parse_args()
    if args.rank_job:
        return sharded_rank(args.rank_job)
    if args.train_rank_job:
        return train_rank(args.train_rank_job)
    if args.train_tp_rank_job:
        return train_tp_rank(args.train_tp_rank_job)
    if args.train_mesh_rank_job:
        return train_mesh_rank(args.train_mesh_rank_job)
    t_start = time.perf_counter()

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("src/repro_torch/csrc not found next to chip_smoke.py: run "
             "from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    # phase 1: environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    power_line = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    cap = torch.cuda.get_device_capability(0)
    log(f"card: {power_line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; capability {cap}; python "
        f"{sys.version.split()[0]}")
    if cap != (9, 0):
        fail(f"need compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every phase but the tuned ones reads a cold tuning cache inside the
    # checkout, so launches the wrappers' fixed rules
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    os.environ.update(REPRO_TORCH_TUNE_CACHE=str(TUNE_DIR / "cold.json"),
                      REPRO_TORCH_TUNE="on")

    if args.train_only:
        return train_only(torch, args, power_line)
    if args.train_mesh:
        return train_mesh_only(torch, args, power_line)

    # phase 2: build
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    so = _lib.build(verbose=True)
    _lib.lib()
    log(f"built {so.name} in {time.perf_counter() - t0:.1f} s")

    if args.sharded_mesh:
        return sharded_only(torch, args, power_line)
    if args.analysis_only:
        return analysis_only(torch, args, power_line)

    # phase 3: kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    from repro_torch.tune.measure import Timer
    timer = Timer()
    results = {}
    check_gemms(torch, timer, gen, results)
    check_paged(torch, timer, gen, results, args.seed)
    check_ternary(torch, timer, gen, results)
    odd_shape_cases(torch, timer, gen, results)
    f32_mma_cases(torch, timer, gen, results)
    check_paged_int8(torch, timer, gen, results, args.seed)
    check_paged_mla(torch, timer, gen, results, args.seed)
    check_bcq_minicpm3(torch, timer, gen, results)
    check_bcq_widths(torch, timer, gen, results)
    check_bcq_dense_archs(torch, timer, gen, results)
    check_bcq_mixtral(torch, timer, gen, results)
    check_shard_shapes(torch, timer, gen, results)
    del timer
    torch.cuda.empty_cache()

    # phase 4: tune, then serve (the tuned runs, on the tune phase's
    # cache, beside the first OPT run)
    tune_out = tune_phase(torch, args, power_line)
    serve_out, totals = serve(torch, args, power_line, results)
    serve_out["tune"] = tune_out
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    missing = [k for k, n in totals.items() if n <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    # phase 6: training (no kernel of the port: the dense path under
    # autograd)
    serve_out["train"] = train_phase(torch, args, power_line)
    # phase 7: analysis (FIGLUT-I numerics, the dry run, the byte model
    # against phase 4's first OPT model)
    serve_out["analysis"] = analysis_phase(
        torch, args, power_line, serve_out["opt_param_bytes"],
        serve_out["auto"]["decode_step_ms_p50"])

    paged_cu = "src/repro_torch/csrc/paged_attention.cu"
    decode_cu = "src/repro_torch/csrc/paged_decode.cu"
    src = {"bcq_matmul": "src/repro_torch/csrc/bcq_matmul.cu",
           "lut_gemm": "src/repro_torch/csrc/lut_gemm.cu",
           "paged_decode": decode_cu, "paged_prefill": paged_cu,
           "ternary_matmul": "src/repro_torch/csrc/ternary_matmul.cu",
           "paged_decode_int8": decode_cu, "paged_prefill_int8": paged_cu,
           "paged_decode_mla": "src/repro_torch/csrc/paged_attention_mla.cu"}
    replaces = {
        "bcq_matmul": "src/repro/kernels/bcq_matmul/bcq_matmul.py:81",
        "lut_gemm": "src/repro/kernels/lut_gemm/lut_gemm.py:104",
        "paged_decode":
            "src/repro/kernels/paged_attention/paged_attention.py:173",
        "paged_prefill":
            "src/repro/kernels/paged_attention/paged_attention.py:530",
        "ternary_matmul":
            "src/repro/kernels/ternary_matmul/ternary_matmul.py:97",
        "paged_decode_int8":
            "src/repro/kernels/paged_attention/paged_attention.py:289",
        "paged_prefill_int8":
            "src/repro/kernels/paged_attention/paged_attention.py:530",
        "paged_decode_mla":
            "src/repro/kernels/paged_attention/paged_attention.py:400"}
    # the representative main-path case of each kernel: a decode-batch
    # GEMM on the widest weight, B = 8 decode, the C = 512 prefill chunk
    rep = {"bcq_matmul": dict(rows=8, m=16384, n=4096),
           "lut_gemm": dict(rows=8, m=16384, n=4096),
           "paged_decode": dict(b=8, hkv=32, long=False),
           "paged_prefill": dict(c=512, hkv=32),
           "ternary_matmul": dict(rows=8, m=16384, n=4096),
           "paged_decode_int8": dict(b=8, hkv=32, long=False),
           "paged_prefill_int8": dict(c=512, hkv=32),
           "paged_decode_mla": dict(b=8)}
    kernels = []
    for name in _lib.KERNELS:
        sel = [r for r in results[name] if "ms" in r
               and all(r.get(k) == v for k, v in rep[name].items())][0]
        kernels.append(dict(
            name=name, route="cuda", source=src[name],
            replaces=replaces[name], launches=totals[name],
            max_abs_err=sel["max_abs_err"], ms=sel["ms"],
            plain_ms=sel["plain_ms"], bound_ms=sel["bound_ms"],
            bound_by=sel["bound_by"], library_ms=sel["library_ms"],
            case={k: sel[k] for k in rep[name]}))
        keys = ("rows", "m", "n", "route", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        if name in ROUTED:
            # the prefill case beside the decode case: the serve's 512-row
            # chunk on the widest weight, on the tensor-core tile
            pre = [r for r in results[name] if r.get("rows") == 512
                   and r.get("m") == 16384 and "model" not in r
                   and "ms" in r][0]
            kernels[-1]["case"]["route"] = sel["route"]
            kernels[-1]["prefill"] = {k: pre[k] for k in keys}
            # f32 activations above 8 rows on the tensor-core tile: rows
            # 512 on [16384 x 4096] and Whisper's 12,000 on [4096 x 1024]
            kernels[-1]["f32_mma"] = [
                {k: r[k] for k in keys + ("variant",)}
                for r in results["f32_mma"] if r["name"] == name]
        if name == "bcq_matmul":
            # the decode tile's split count, f32 rows of the same weight on
            # the decode tile, and the dequantizing tile at calls it takes
            # (f32 and bf16 rows 8 at group size 16, its decode stage; f32
            # and bf16 rows 512 at group size 8)
            kernels[-1]["case"]["splits"] = sel["splits"]
            f32 = [r for r in results["bcq_matmul_f32"]
                   if r["m"] == sel["m"] and r["n"] == sel["n"]][0]
            kernels[-1]["f32_decode"] = {k: f32[k] for k in keys + (
                "splits", "library_bf16_ms")}
            for key in ("mma_dq_decode", "mma_dq_decode_bf16", "mma_dq",
                        "mma_dq_bf16"):
                r = results[f"bcq_matmul_{key}"][0]
                kernels[-1][key] = {k: r[k] for k in keys + (
                    "group_size", "dtype")}
            # the GEMMs of Mixtral-8x7B's (attention, head), DeepSeek-V2's
            # (MLA, dense MLP, shared experts, head), Mamba2's (in_proj,
            # out_proj), Jamba's, Pixtral's and Whisper's serve paths
            for key, arch in (("mixtral", "mixtral_8x7b"),
                              ("deepseek", "deepseek_v2_236b"),
                              ("mamba2", "mamba2_2_7b"),
                              ("jamba", "jamba_1_5_large_398b"),
                              ("pixtral", "pixtral_12b"),
                              ("whisper", "whisper_medium")):
                kernels[-1][key] = [
                    {k: r[k] for k in keys + ("splits",) if k in r}
                    for r in results["bcq_matmul"]
                    if r.get("model") == arch and r["rows"] != 1]
            # the mixed plans' other widths on the widest weight
            kernels[-1]["widths"] = [
                {k: r[k] for k in keys + ("bits",)}
                for r in results["bcq_matmul_widths"]
                if r["rows"] in (8, 512) and r["m"] == 16384]
        if name == "lut_gemm":
            # the LUT body at the ablation variants (f32 rows 8), each
            # beside the decode tile on the same call
            for key in ("mu2_full", "mu2_half", "mu4_full"):
                r = results[f"lut_gemm_lut_{key}"][0]
                kernels[-1][f"lut_{key}"] = {k: r[k] for k in keys + (
                    "dtype", "gemv_ms")}
            # the dequantizing tile at a call it takes: f32 rows 512, g 8
            r = results["lut_gemm_mma_dq"][0]
            kernels[-1]["mma_dq"] = {k: r[k] for k in keys + (
                "group_size", "dtype", "splits")}
        if name == "paged_decode_mla":
            kernels[-1]["case"]["splits"] = sel["splits"]
            # DeepSeek-V2's widths: 128 heads (4 head tiles), lora 512
            r = [r for r in results[name] if "ms" in r and r["h"] == 128][0]
            kernels[-1]["deepseek"] = {k: r[k] for k in (
                "b", "h", "lora", "dr", "splits", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
            # the tp-2 shards serve_sharded runs: 20 and 64 heads
            kernels[-1]["tp2_shards"] = [{k: r[k] for k in (
                "b", "h", "lora", "dr", "splits", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for r in results[name] if "ms" in r and r["h"] in (20, 64)]
        if name in ("paged_decode_int8", "paged_prefill_int8"):
            # OPT-6.7B's 16-head slice at tp 2 (serve_sharded)
            r = [r for r in results[name] if "ms" in r and r["h"] == 16][0]
            kernels[-1]["tp2_shard"] = {k: r.get(k) for k in (
                "b", "c", "h", "hkv", "splits", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name == "ternary_matmul":
            kernels[-1]["case"]["splits"] = sel["splits"]
            kernels[-1]["exact_inputs_max_abs_err"] = max(
                r["max_abs_err"] for r in results[name]
                if r.get("exact_inputs"))
            # the dequantizing tile at calls it takes, all at group size
            # 8: bf16 rows 8, f32 and bf16 rows 512
            for key in ("mma_dq", "mma_dq_f32", "mma_dq_bf16"):
                r = results[f"ternary_matmul_{key}"][0]
                kernels[-1][key] = {k: r[k] for k in keys + (
                    "group_size", "dtype", "splits")}
        if name in ("paged_decode", "paged_prefill"):
            # Phi-4-mini's serve shape: 24 query heads over 8 kv heads;
            # Pixtral-12B's: 32 over 8 (rep 4)
            for key, h, hkv in (("gqa_rep3", 24, 8), ("gqa_rep4", 32, 8)):
                r = [r for r in results[name] if "ms" in r and r["h"] == h
                     and r["hkv"] == hkv and not r["long"]][0]
                kernels[-1][key] = {k: r.get(k) for k in (
                    "b", "c", "h", "hkv", "splits", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name == "paged_prefill":
            # a chunk after a prefix-cache hit: two rows sharing their
            # first PREFIX_BLOCKS blocks, the chunk starting past them
            r = [r for r in results[name] if "ms" in r
                 and r.get("shared_blocks")][0]
            kernels[-1]["shared_prefix"] = {k: r[k] for k in (
                "b", "c", "h", "hkv", "shared_blocks", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name in ("paged_decode", "paged_decode_int8"):
            # the split-table kernel: its split count at the main case,
            # and its GQA (rep 4) and long-table cases
            kernels[-1]["case"]["splits"] = sel["splits"]
            for key, want in (("gqa", dict(hkv=8)), ("long",
                                                     dict(long=True))):
                r = [r for r in results[name] if "ms" in r and all(
                    r.get(k) == v for k, v in want.items())][0]
                kernels[-1][key] = {k: r[k] for k in (
                    "hkv", "long", "splits", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms")}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=power_line, torch=torch.__version__,
             cuda=torch.version.cuda, kernels=results, serve=serve_out,
             build_s=_lib.build_seconds,
             total_s=time.perf_counter() - t_start), indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(power_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
