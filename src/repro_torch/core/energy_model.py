"""Analytical energy / area / throughput model of FP-INT GEMM engines.

Counterpart of ``repro.core.energy_model``, the same model line for line
(numpy only; its one import, ``generator_adder_count``, from the port's
``core/lut.py``).  Its constants describe the paper's 28-nm engines at
100 MHz with a DDR4-class channel: an analytic model of ASIC designs, not
a measurement of the H100 or of any other chip.  No number of the card
enters it, and none of its outputs is a time or an energy of the card.

The paper's headline results (Figs 6, 8, 9, 13, 15, 16, 17; Tables III, V)
are circuit measurements from a 28 nm P&R flow — unavailable in software.
We reproduce them with a component-level analytical model:

  * per-op energies (pJ) for FP/INT adders & multipliers, flip-flops,
    muxes, register files, SRAM and DRAM accesses — 28 nm-class constants
    (Horowitz ISSCC'14 scaled, CACTI-class memory numbers), with a small
    set of calibration factors chosen once so that the *paper's own
    anchors* (Table V watts, Fig 6 RFLUT>FP-adder ordering, Fig 8/9 optima
    at mu=4/k=32) are met; every benchmark then reports model numbers next
    to the paper's and the deltas.
  * engine descriptions mirroring §IV-B's configurations: FPE & FIGNA
    64x64 PEs, iFPU 64x64x4 bit-serial, FIGLUT 2x16x4 PEs with one
    (h)FFLUT + k RACs per PE — all sized for identical Q4 throughput.

Workloads are (M, N, B) GEMMs; LLM evaluation walks the OPT family's layer
shapes.  Cycle counts follow each engine's dataflow; bit-serial engines
(iFPU, FIGLUT) scale cycles with q, fixed-width engines pad sub-4-bit to
Q4 (§IV-C).  Time = max(compute, DRAM) — the memory-bound regime of LLM
decode is what rewards sub-4-bit storage.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from repro_torch.core.lut import generator_adder_count

Engine = Literal["FPE", "iFPU", "FIGNA", "FIGLUT-F", "FIGLUT-I"]

# ---------------------------------------------------------------------------
# component constants (28nm-class; pJ, um^2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tech:
    # arithmetic energy, pJ
    fp16_add: float = 0.40
    fp16_mul: float = 1.10
    fp32_add: float = 0.90
    fp32_mul: float = 3.70
    int_add_per_bit: float = 0.006      # ripple-class adder, pJ/bit
    int_mul_per_bit2: float = 0.0095     # array multiplier, pJ/(bit*bit)
    i2f_dequant: float = 0.55            # INT->FP convert + scale (FPE)
    # storage / wires
    ff_clk_per_bit: float = 0.0035       # FF clock+data toggle, pJ/bit/cycle
    mux_per_bit_per_way: float = 0.0015  # read-mux select tree, pJ/(bit*way)
    fanout_per_reader: float = 0.004     # relative extra mux/wire energy per
                                         # additional RAC sharing one LUT
    rf_read_per_bit: float = 0.055       # register-file (RFLUT) read, pJ/bit
    sram_per_byte: float = 2.5
    dram_per_byte: float = 20.0
    # area, um^2
    a_fp16_add: float = 600.0
    a_fp16_mul: float = 1700.0
    a_fp32_add: float = 1300.0
    a_fp32_mul: float = 4500.0
    a_int_add_per_bit: float = 18.0
    a_int_mul_per_bit2: float = 8.0
    a_ff_per_bit: float = 4.5
    a_mux_per_bit_per_way: float = 0.55
    a_i2f: float = 900.0
    # system
    freq_hz: float = 100e6               # paper synthesizes @100 MHz
    dram_bw: float = 25.6e9              # single-channel DDR4-class
    # single global derate calibrated to Table V's 0.14 TOPS anchor
    utilization: float = 0.17
    # on-chip power overhead (clock tree, control, buffer static power —
    # not modelled per-component); calibrated once against Table V watts
    overhead_factor: float = 7.5


TECH = Tech()

ACT_BITS = {"fp16": 16, "bf16": 16, "fp32": 32}
ACT_MANT = {"fp16": 11, "bf16": 8, "fp32": 24}  # incl. implicit bit


# ---------------------------------------------------------------------------
# engine configurations  (paper §IV-B "Configuration Setup")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineCfg:
    name: str
    macs_per_cycle: int          # Q4-equivalent MACs per cycle
    bit_serial: bool
    mu: int = 4
    k: int = 32

    @property
    def binary_ops_per_cycle(self) -> int:
        return self.macs_per_cycle * 4  # Q4 reference


def engine_cfg(engine: Engine, mu: int = 4, k: int = 32) -> EngineCfg:
    if engine == "FPE":
        return EngineCfg("FPE", 64 * 64, False)
    if engine == "FIGNA":
        return EngineCfg("FIGNA", 64 * 64, False)
    if engine == "iFPU":
        return EngineCfg("iFPU", 64 * 64, True)          # 64x64x4 binary units
    if engine in ("FIGLUT-F", "FIGLUT-I"):
        # 2x16x4 PEs x k RACs; with mu=4,k=32 -> 4096 RACs = iFPU unit count
        return EngineCfg(engine, 64 * 64, True, mu=mu, k=k)
    raise ValueError(engine)


# ---------------------------------------------------------------------------
# LUT power primitives (Fig 6 / Fig 8 / Fig 9 / Table III)
# ---------------------------------------------------------------------------


def fflut_read_energy(mu: int, act_bits: int, k: int, tech: Tech = TECH,
                      half: bool = True) -> float:
    """Energy of one RAC read from a (h)FFLUT shared by k readers, pJ.

    mux tree over the table entries x value width, plus fan-out wiring
    penalty growing with k (paper Fig 9's rising tail).
    """
    entries = (1 << (mu - 1)) if half else (1 << mu)
    base = tech.mux_per_bit_per_way * entries * act_bits
    if half:
        base += 0.10 * base  # hFFLUT decoder (sign flip + MSB mux, Table III)
    return base * (1.0 + tech.fanout_per_reader * max(k - 1, 0))


def fflut_static_energy_per_cycle(mu: int, act_bits: int, tech: Tech = TECH,
                                  half: bool = True) -> float:
    """FF clock/toggle energy of one LUT per cycle, pJ."""
    entries = (1 << (mu - 1)) if half else (1 << mu)
    return tech.ff_clk_per_bit * entries * act_bits


def rflut_read_energy(mu: int, act_bits: int, tech: Tech = TECH) -> float:
    """Register-file LUT read (the rejected baseline of Fig 6), pJ."""
    return tech.rf_read_per_bit * act_bits * (1.0 + 0.08 * mu)


def lut_generation_energy(mu: int, act_bits: int, is_int: bool,
                          tech: Tech = TECH, half: bool = True) -> float:
    """Energy to (re)generate one LUT's entries (§III-E tree), pJ."""
    adds = generator_adder_count(mu, half=half)
    if is_int:
        e_add = tech.int_add_per_bit * (ACT_MANT["fp16"] + int(np.log2(mu)))
    else:
        e_add = tech.fp16_add if act_bits == 16 else tech.fp32_add
    write = tech.ff_clk_per_bit * ((1 << (mu - 1)) if half else (1 << mu)) * act_bits
    return adds * e_add + write


# ---------------------------------------------------------------------------
# per-engine MAC-level energy (compute only)
# ---------------------------------------------------------------------------


def _acc_bits(act: str) -> int:
    return 24 if act != "fp32" else 32     # prealigned integer accumulators


def pe_energy_per_mac(engine: Engine, q: int, act: str = "fp16",
                      mu: int = 4, k: int = 32, tech: Tech = TECH) -> float:
    """Average compute energy per (FP-act x INTq-weight) MAC, pJ.

    Bit-serial engines process ceil stays with q planes; fixed-width engines
    execute sub-4-bit as padded Q4 (energy of the Q4 datapath).
    """
    ab = ACT_BITS[act]
    mant = ACT_MANT[act]
    if engine == "FPE":
        # dequant INT->FP + FP mul + FP32 acc
        mul = tech.fp16_mul if ab == 16 else tech.fp32_mul
        return tech.i2f_dequant + mul + tech.fp32_add
    if engine == "FIGNA":
        # INT(mant) x INT(max(q,4)) mul + INT acc  (+ prealign amortized)
        qq = max(q, 4)
        mul = tech.int_mul_per_bit2 * mant * qq
        acc = tech.int_add_per_bit * _acc_bits(act)
        return mul + acc + 0.02  # prealign/postscale amortized over N
    if engine == "iFPU":
        # q binary-plane INT add/subs per MAC + pipeline FF overhead
        add = tech.int_add_per_bit * _acc_bits(act)
        ff = tech.ff_clk_per_bit * 2 * _acc_bits(act)   # deep bit-serial pipe
        return q * (add + ff) + 0.02
    if engine in ("FIGLUT-F", "FIGLUT-I"):
        # q/mu LUT reads per MAC + accumulate; generation amortized over k
        # readers x (M/k reuse via row forwarding) -> per-read share below.
        if engine == "FIGLUT-I":
            acc = tech.int_add_per_bit * _acc_bits(act)
            is_int = True
        else:
            acc = tech.fp32_add
            is_int = False
        read = fflut_read_energy(mu, ab, k, tech)
        static_share = fflut_static_energy_per_cycle(mu, ab, tech) / k
        gen_share = lut_generation_energy(mu, ab, is_int, tech) / (64 * mu)
        # one LUT serves k RACs each cycle; a generated LUT is reused by all
        # 64 output rows of a tile column (row forwarding, §III-B).
        per_read = read + acc + static_share + gen_share
        return (q / mu) * per_read
    raise ValueError(engine)


# ---------------------------------------------------------------------------
# GEMM-level model (cycles, DRAM, power, TOPS/W)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GemmReport:
    engine: str
    q: float
    act: str
    macs: float
    cycles: float
    time_s: float
    compute_J: float
    sram_J: float
    dram_J: float
    total_J: float
    power_W: float
    tops: float
    tops_per_w: float

    def row(self) -> str:
        return (f"{self.engine:10s} q={self.q:<4} {self.act:5s} "
                f"P={self.power_W:6.3f}W  TOPS={self.tops:6.3f}  "
                f"TOPS/W={self.tops_per_w:6.3f}")


def gemm_report(engine: Engine, M: int, N: int, B: int, q: float,
                act: str = "fp16", mu: int = 4, k: int = 32,
                tech: Tech = TECH, weight_resident: bool = False) -> GemmReport:
    """Model one FP-INT GEMM  y[B,M] = x[B,N] @ W[M,N]^T  on an engine.

    ``q`` may be fractional (mixed precision — average plane count for
    bit-serial engines; fixed engines pad up to ceil->4/8).
    """
    cfg = engine_cfg(engine, mu, k)
    macs = float(M) * N * B
    ab = ACT_BITS[act]

    if cfg.bit_serial:
        cycles = macs * q / cfg.binary_ops_per_cycle
    else:
        q_hw = 4 if q <= 4 else 8
        cycles = macs / cfg.macs_per_cycle
        if q_hw == 8:   # widened datapath runs at same rate, higher energy
            pass
    t_compute = cycles / tech.freq_hz

    # DRAM: packed weights (q/8 B each) + FP acts in + FP outs
    w_bytes = M * N * q / 8 + M * (N / 128) * (q + 1) * 2   # planes + alpha/z fp16
    if engine in ("FPE", "FIGNA") and q < 4:
        w_bytes = M * N * 4 / 8 + M * (N / 128) * 5 * 2     # stored padded Q4
    io_bytes = (B * N + B * M) * (ab // 8)
    dram_bytes = (0 if weight_resident else w_bytes) + io_bytes
    t_dram = dram_bytes / tech.dram_bw
    time_s = max(t_compute, t_dram) / tech.utilization

    e_mac = pe_energy_per_mac(engine, min(int(np.ceil(q)), 8), act, mu, k, tech)
    if cfg.bit_serial:
        # energy scales with actual plane count (possibly fractional avg)
        e_mac = e_mac * (q / min(int(np.ceil(q)), 8))
    compute_J = macs * e_mac * 1e-12
    # SRAM: every operand staged through on-chip buffers once per tile-use
    sram_J = (w_bytes + 2 * io_bytes) * tech.sram_per_byte * 1e-12
    dram_J = dram_bytes * tech.dram_per_byte * 1e-12
    # clock/control/static overhead applies on-chip only (not DRAM)
    compute_J *= tech.overhead_factor
    sram_J *= tech.overhead_factor
    total_J = compute_J + sram_J + dram_J

    power = total_J / time_s
    ops = 2 * macs
    tops = ops / time_s / 1e12
    return GemmReport(engine, q, act, macs, cycles, time_s, compute_J,
                      sram_J, dram_J, total_J, power, tops,
                      tops / max(power, 1e-12))


# ---------------------------------------------------------------------------
# area model (Fig 13 / Fig 14)
# ---------------------------------------------------------------------------


def engine_area_mm2(engine: Engine, q: int = 4, act: str = "fp16",
                    mu: int = 4, k: int = 32, tech: Tech = TECH) -> dict:
    """MPU area split into arithmetic vs flip-flop (Fig 14's categories)."""
    ab = ACT_BITS[act]
    mant = ACT_MANT[act]
    n_pe = 64 * 64
    if engine == "FPE":
        a_mul = tech.a_fp16_mul if ab == 16 else tech.a_fp32_mul
        a_add = tech.a_fp32_add
        arith = n_pe * (a_mul + a_add + tech.a_i2f)
        ff = n_pe * tech.a_ff_per_bit * (2 * ab + 32) * 2.0   # 63-stage systolic pipe
    elif engine == "FIGNA":
        qq = max(q, 4)
        arith = n_pe * (tech.a_int_mul_per_bit2 * mant * qq
                        + tech.a_int_add_per_bit * 24)
        ff = n_pe * tech.a_ff_per_bit * (mant + qq + 24) * 2.0
    elif engine == "iFPU":
        n_units = 64 * 64 * 4
        arith = n_units * tech.a_int_add_per_bit * 24
        ff = n_units * tech.a_ff_per_bit * 24 * 2.5          # deep serial pipes
    elif engine in ("FIGLUT-F", "FIGLUT-I"):
        n_rac = 2 * 16 * 4 * k
        n_lut = 2 * 16 * 4
        entries = 1 << (mu - 1)
        a_acc = tech.a_fp32_add if engine == "FIGLUT-F" else tech.a_int_add_per_bit * 24
        arith = (n_rac * (a_acc + tech.a_mux_per_bit_per_way * entries * ab)
                 + n_lut * 2 * 16 * (tech.a_fp16_add if engine == "FIGLUT-F"
                                     else tech.a_int_add_per_bit * (mant + 2)) )
        # generators: 14 adders per LUT row block
        ff = n_lut * tech.a_ff_per_bit * entries * ab \
            + n_rac * tech.a_ff_per_bit * (mu + 32)          # key reg + acc reg
        # 15-stage (vs 63) input staging credit already reflected in counts
    else:
        raise ValueError(engine)
    return {"arith_mm2": arith * 1e-6, "ff_mm2": ff * 1e-6,
            "total_mm2": (arith + ff) * 1e-6}


# ---------------------------------------------------------------------------
# OPT-family workload shapes (paper evaluates OPT-125M .. 30B)
# ---------------------------------------------------------------------------

OPT_DIMS = {            # d_model, n_layers, ffn_mult 4
    "opt-125m": (768, 12),
    "opt-350m": (1024, 24),
    "opt-1.3b": (2048, 24),
    "opt-2.7b": (2560, 32),
    "opt-6.7b": (4096, 32),
    "opt-13b": (5120, 40),
    "opt-30b": (7168, 48),
}


def opt_layer_gemms(model: str) -> list[tuple[int, int]]:
    """(M, N) for every GEMM in one decoder layer (QKVO + 2 FFN)."""
    d, _ = OPT_DIMS[model]
    return [(d, d)] * 4 + [(4 * d, d), (d, 4 * d)]


def model_report(engine: Engine, model: str, B: int, q: float,
                 act: str = "fp16", mu: int = 4, k: int = 32,
                 tech: Tech = TECH) -> GemmReport:
    """Aggregate a whole OPT model's GEMMs into one report."""
    d, L = OPT_DIMS[model]
    reports = [gemm_report(engine, M, N, B, q, act, mu, k, tech)
               for (M, N) in opt_layer_gemms(model)]
    agg = GemmReport(engine, q, act, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    for r in reports:
        agg.macs += r.macs * L
        agg.cycles += r.cycles * L
        agg.time_s += r.time_s * L
        agg.compute_J += r.compute_J * L
        agg.sram_J += r.sram_J * L
        agg.dram_J += r.dram_J * L
        agg.total_J += r.total_J * L
    agg.power_W = agg.total_J / agg.time_s
    agg.tops = 2 * agg.macs / agg.time_s / 1e12
    agg.tops_per_w = agg.tops / agg.power_W
    return agg
