"""Roofline terms of one step, per device, with the H100's constants.

Counterpart of ``repro.roofline.analysis``.  Three terms per (arch x
shape x mesh), each per device:

    compute    = FLOPs / peak FLOP/s           (989e12: H100 SXM bf16 dense)
    memory     = bytes / HBM bytes/s           (3.35e12: H100 SXM HBM3)
    collective = collective bytes / link B/s   (450e9: NVLink 4, one way)

These are data-sheet figures of the H100 SXM, not measurements.  The
link figure is one direction of NVLink 4 (18 links at 25 GB/s each way:
450 GB/s; the 900 GB/s of the data sheet adds both directions).  A mesh
larger than one 8-card NVLink domain crosses slower inter-node links, so
there the collective term is a lower bound.

The reference reads its terms from XLA's compiled artifacts
(``cost_analysis``, ``memory_analysis`` and the HLO's collectives).  The
port compiles nothing, so :func:`measure` runs one call of a step and
counts its FLOPs and collective bytes; the bytes accessed are the dry
run's:

  * FLOPs with ``torch.utils.flop_counter.FlopCounterMode``: the matmul
    family (mm, bmm, addmm, einsum's products, convolutions, SDPA) at
    2 flops a multiply-add, forward and backward; elementwise work is not
    counted (XLA counts it).  Run the step on the meta device or the
    CPU: a CUDA kernel of the port is not an op the counter sees, so on
    the card a quantized linear would count 0;
  * collective bytes from the mesh's counters (``launch/mesh.py``): the
    result bytes of every ``all-reduce`` / ``all-gather`` this device
    issued, the reference's convention for the HLO's result shapes;
  * bytes accessed: no HLO exists, so "bytes accessed" is every argument
    read once plus every output written once (an output that is an
    argument updated in place, a cache or a parameter, counts once, as
    the reference's donated buffers), per rank from the sharding specs
    (``launch/dryrun.py``'s ``cell_roofline``); ``temp_bytes`` cannot be
    known without a compiler's buffer assignment and stays ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# hardware constants: the H100 SXM data sheet
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12             # B/s per card
LINK_BW = 450e9              # B/s, NVLink 4, one direction


def collective_bytes(mesh) -> dict:
    """{'all-reduce': bytes, 'all-gather': bytes} this rank's collectives
    moved since the mesh's counters were last reset."""
    if mesh is None:
        return {}
    return {k: v for k, v in getattr(mesh, "coll_bytes", {}).items() if v}


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    coll_bytes: float            # per device
    coll_breakdown: dict
    arg_bytes: float = 0.0
    temp_bytes: Optional[float] = None   # not measurable without a compiler
    out_bytes: float = 0.0
    alias_bytes: float = 0.0     # outputs that update an argument in place

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def fraction_of_roofline(self) -> float:
        """compute term / binding term: 1.0 means compute-bound."""
        return self.t_compute / max(self.t_bound, 1e-30)

    def device_memory_gb(self) -> float:
        """Arguments + outputs - in-place outputs, GiB; temporaries are
        not in it (``temp_bytes`` None)."""
        return (self.arg_bytes + (self.temp_bytes or 0.0) + self.out_bytes
                - self.alias_bytes) / 2**30

    def row(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "coll_bytes_per_dev": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.fraction_of_roofline(),
            "device_mem_gb": self.device_memory_gb(),
            "temp_bytes": self.temp_bytes,
            "coll_breakdown": self.coll_breakdown,
        }


def measure(fn, *args, mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and return (its output, its FLOPs,
    :func:`collective_bytes` of ``mesh``, whose counters are reset
    first).  Bytes accessed are the caller's to count: the dry run's
    per-rank accounting (``launch/dryrun.py``)."""
    from torch.utils.flop_counter import FlopCounterMode
    if mesh is not None:
        mesh.reset_counters()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, float(counter.get_total_flops()), collective_bytes(mesh)


def extrapolate(r1: Roofline, r2: Roofline, n1: float, n2: float,
                n_total: float, mem: Optional[Roofline] = None) -> Roofline:
    """Linear layer-count extrapolation (exact for homogeneous periods).

    r1/r2: rooflines of unrolled models with n1/n2 layer-periods;
    n_total: periods in the full model; mem: optional full-model roofline
    supplying the memory-fit numbers."""
    def ext(a, b):
        slope = (b - a) / max(n2 - n1, 1e-9)
        return a + slope * (n_total - n1)

    coll = {k: ext(r1.coll_breakdown.get(k, 0), r2.coll_breakdown.get(k, 0))
            for k in set(r1.coll_breakdown) | set(r2.coll_breakdown)}
    base = mem if mem is not None else r2
    return Roofline(
        flops=ext(r1.flops, r2.flops),
        bytes_accessed=ext(r1.bytes_accessed, r2.bytes_accessed),
        coll_bytes=ext(r1.coll_bytes, r2.coll_bytes),
        coll_breakdown=coll,
        arg_bytes=base.arg_bytes, temp_bytes=base.temp_bytes,
        out_bytes=base.out_bytes, alias_bytes=base.alias_bytes,
    )


def serve_analytic_bytes(cfg, shape, n_active_params: float, bits: int,
                         n_model: int = 16, n_data: int = 16) -> dict:
    """Analytic per-device HBM bytes for one serve step, three variants
    (the reference's closed form; times at the H100's HBM rate):

      dense_bf16  — bf16 weights (2 B/w)
      xla_bf16    — packed read + a bf16 dense copy (2 + q/8 B/w)
      kernel_q    — the GEMM kernels: packed planes only (q/8 B/w; the
                    f32 alpha / z rows are not counted)

    plus the (shared) KV / state-cache read traffic per step."""
    w_global = n_active_params
    w_dense = 2.0 * w_global / n_model
    w_packed = (bits / 8.0) * w_global / n_model
    b_loc = shape.global_batch // n_data

    cache = 0.0
    if cfg.is_ssm_only or cfg.is_hybrid:
        d_inner = cfg.ssm_expand * cfg.d_model
        h = d_inner // cfg.ssm_head_dim
        n_mamba = sum(1 for i in range(cfg.n_layers)
                      if cfg.layer_kind(i) == "mamba")
        state = b_loc * max(h // n_model, 1) * cfg.ssm_head_dim * \
            cfg.ssm_state * 4
        cache += n_mamba * state * 2                    # read + write
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    if n_attn and cfg.attention != "none":
        length = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        if cfg.attention == "mla":
            per = b_loc * (length // n_model) * \
                (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
        else:
            hd = cfg.head_dim_
            hkv = cfg.n_kv_heads
            shard = n_model if hkv % n_model == 0 else \
                (n_model if hd % n_model == 0 else 1)
            per = b_loc * length * hkv * hd * 2 * 2 // shard   # k + v
        cache += n_attn * per

    out = {}
    for name, wb in [("dense_bf16", w_dense), ("xla_bf16", w_dense + w_packed),
                     ("kernel_q", w_packed)]:
        total = wb + cache
        out[name] = {"bytes_per_dev": total, "t_memory_s": total / HBM_BW,
                     "weight_bytes": wb, "cache_bytes": cache}
    return out


def model_flops(cfg, shape, n_active_params: float,
                n_total_params: float) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), global, forward +
    backward for train; 2*N*D forward-only for serving shapes.

    Encoder-decoder: the encoder's params see encoder_seq frames, not the
    decoder token count, so the two stacks are counted apart."""
    mult = 6.0 if shape.kind == "train" else 2.0
    dec_tokens = (shape.global_batch * shape.seq_len
                  if shape.kind != "decode" else shape.global_batch)
    if cfg is not None and getattr(cfg, "is_encdec", False):
        # params split by stack depth share (same-width layers)
        enc_frac = cfg.n_encoder_layers / (cfg.n_encoder_layers + cfg.n_layers)
        n_enc = n_active_params * enc_frac
        n_dec = n_active_params - n_enc
        enc_tokens = shape.global_batch * cfg.encoder_seq \
            if shape.kind != "decode" else 0      # encoder cached at decode
        return mult * (n_dec * dec_tokens + n_enc * enc_tokens)
    return mult * n_active_params * dec_tokens


__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "Roofline", "collective_bytes",
           "extrapolate", "measure", "model_flops", "serve_analytic_bytes"]
