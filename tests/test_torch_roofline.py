"""Port parity: the analysis path — shape cells, meta-device abstract
models, abstract quantized leaves, the roofline module (H100 constants),
the FLOP counter and the dry run (``repro_torch.configs``,
``models/module.py``, ``quant/api.py``, ``roofline/analysis.py``,
``launch/dryrun.py``, ``launch/run_all.py``).

Held against the reference where the reference computes the same thing
without a compile: ``SHAPES``, ``supports_long_context`` and
``input_specs`` for all 11 archs x 4 shapes; parameter counts of the
full-size models (``Model.n_params()``); the total bytes of
``abstract_quantized_params`` at full size; ``model_flops``,
``serve_analytic_bytes`` and ``active_params``.  The reference's own
roofline tests (``tests/test_roofline.py``: the terms, the
extrapolation, Table I and the energy model's +59% band) are ported with
the H100's constants.  The reference's compile-based dry run is not run
here (it takes minutes a cell).
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.quant.ptq import abstract_quantized_params as j_abstract_q
from repro.roofline import analysis as jra
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_reduced
from repro_torch.core import energy_model as em
from repro_torch.launch import dryrun, run_all
from repro_torch.models.model import to_params
from repro_torch.models.module import (abstract_model, abstract_params,
                                       param_bytes, param_count)
from repro_torch.quant import QuantSpec, quantize_model
from repro_torch.quant.api import abstract_quantized_params
from repro_torch.roofline import analysis as ra


# ---------------------------------------------------------------------------
# the reference's roofline tests, with the H100's constants
# ---------------------------------------------------------------------------


class TestRooflineTerms:
    def test_constants_are_the_h100s(self):
        assert ra.PEAK_FLOPS == 989e12 and ra.HBM_BW == 3.35e12
        assert ra.LINK_BW == 450e9

    def test_bottleneck_selection(self):
        r = ra.Roofline(flops=989e12, bytes_accessed=1, coll_bytes=1,
                        coll_breakdown={})
        assert r.bottleneck == "compute" and r.t_compute == pytest.approx(1.0)
        r = ra.Roofline(flops=1, bytes_accessed=3.35e12 * 2, coll_bytes=1,
                        coll_breakdown={})
        assert r.bottleneck == "memory" and r.t_memory == pytest.approx(2.0)
        r = ra.Roofline(flops=1, bytes_accessed=1, coll_bytes=450e9 * 3,
                        coll_breakdown={})
        assert r.bottleneck == "collective"
        assert r.t_collective == pytest.approx(3.0)

    def test_extrapolation_exact_for_linear(self):
        r1 = ra.Roofline(flops=10, bytes_accessed=100, coll_bytes=4,
                         coll_breakdown={"all-reduce": 4})
        r2 = ra.Roofline(flops=16, bytes_accessed=150, coll_bytes=6,
                         coll_breakdown={"all-reduce": 6})
        r = ra.extrapolate(r1, r2, 1, 2, 10)
        assert r.flops == pytest.approx(10 + 6 * 9)
        assert r.bytes_accessed == pytest.approx(100 + 50 * 9)
        assert r.coll_breakdown["all-reduce"] == pytest.approx(4 + 2 * 9)

    def test_serve_analytic_kernel_beats_dense(self):
        cfg = get_config("phi4_mini_3_8b")
        rows = ra.serve_analytic_bytes(cfg, SHAPES["decode_32k"], 3.6e9, 4)
        assert rows["kernel_q"]["weight_bytes"] < \
            rows["dense_bf16"]["weight_bytes"] / 3
        assert rows["kernel_q"]["t_memory_s"] < \
            rows["dense_bf16"]["t_memory_s"]
        assert rows["kernel_q"]["cache_bytes"] == \
            rows["dense_bf16"]["cache_bytes"]

    def test_temp_bytes_absent(self):
        r = ra.Roofline(flops=1, bytes_accessed=2, coll_bytes=0,
                        coll_breakdown={}, arg_bytes=2**30, out_bytes=2**30,
                        alias_bytes=2**29)
        assert r.temp_bytes is None and r.row()["temp_bytes"] is None
        assert r.device_memory_gb() == pytest.approx(1.5)


class TestComplexityTableI:
    """Paper Table I: computational complexity per engine."""

    def test_figlut_reduces_bitserial_by_mu(self):
        m, n, k, q, mu = 512, 512, 8, 3, 4
        ifpu_ops = m * n * k * q
        figlut_reads = m * n * k * q // mu
        assert figlut_reads * mu == ifpu_ops

    def test_energy_model_orderings_stable(self):
        """The calibrated model keeps the paper's orderings."""
        r = {e: em.model_report(e, "opt-6.7b", B=32, q=4).tops_per_w
             for e in ("FPE", "iFPU", "FIGNA", "FIGLUT-I")}
        assert r["FIGLUT-I"] > r["FIGNA"] > r["iFPU"] > r["FPE"]
        r3 = {e: em.model_report(e, "opt-6.7b", B=32, q=3).tops_per_w
              for e in ("FIGNA", "FIGLUT-I")}
        ratio = r3["FIGLUT-I"] / r3["FIGNA"]
        assert 1.59 * 0.7 < ratio < 1.59 * 1.4   # the +59% headline claim


# ---------------------------------------------------------------------------
# shape cells and configs
# ---------------------------------------------------------------------------


def test_shapes_equal():
    assert list(SHAPES) == list(JSHAPES)
    for k, s in SHAPES.items():
        j = JSHAPES[k]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long_context_and_input_specs(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.supports_long_context() == jcfg.supports_long_context()
    for name, shape in SHAPES.items():
        for per_device, shards in ((False, 1), (True, 16)):
            mine = cfg.input_specs(shape, per_device=per_device,
                                   data_shards=shards)
            ref = jcfg.input_specs(JSHAPES[name], per_device=per_device,
                                   data_shards=shards)
            assert list(mine) == list(ref)
            for k, t in mine.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(ref[k].shape)
                assert str(t.dtype).replace("torch.", "") == \
                    str(ref[k].dtype)


def test_registry():
    from repro_torch.configs import registry
    reg = registry()
    assert list(reg) == ARCH_IDS
    assert all(reg[a] is get_config(a) for a in ARCH_IDS)


# ---------------------------------------------------------------------------
# abstract models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_counts():
    """The reference's full-size parameter counts and BCQ-3 abstract
    bytes, per arch (no compile: descriptor trees)."""
    out = {}
    for arch in ARCH_IDS:
        jm = JModel(jget_config(arch))
        tree = j_abstract_q(jm.abstract(), jm.axes(), bits=3)
        nbytes = sum(int(np.prod(l.shape)) * np.dtype(l.dtype).itemsize
                     for l in jax.tree_util.tree_leaves(tree))
        out[arch] = (jm.n_params(), nbytes, jm)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_model_counts_match(arch, ref_counts):
    n_ref, bytes_ref, jm = ref_counts[arch]
    m = abstract_model(get_config(arch))
    assert all(t.device.type == "meta" for t in _tensors(m))
    assert m.n_params() == n_ref
    assert param_count(abstract_params(get_config(arch))) == n_ref
    # active parameters (MODEL_FLOPS' N) as the reference's dry run
    jcfg = jget_config(arch)
    from repro.launch import dryrun as jdry
    assert dryrun.active_params(get_config(arch), m) == \
        jdry.active_params(jcfg, jm)
    manifest = abstract_quantized_params(m, bits=3)
    assert param_bytes(to_params(m, scan_layers=False)) == bytes_ref
    assert manifest.quant_bytes > 0
    assert all(t.device.type == "meta" for t in _tensors(m))


def _tensors(model):
    """Every tensor the model holds: parameters, buffers, plain tensor
    attributes and the fields of its bundles."""
    from repro_torch.core.plane import PlaneBundle
    out = []
    for mod in model.modules():
        out += list(mod.parameters(recurse=False))
        out += list(mod.buffers(recurse=False))
        for v in vars(mod).values():
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, PlaneBundle):
                out += [t for t in (v.packed, v.alpha, v.z) if t is not None]
    return out


def _fields(tree):
    from repro_torch.tree import leaves_with_path
    out = {}
    for path, x in leaves_with_path(tree):
        if isinstance(x, torch.Tensor):
            out["/".join(map(str, path))] = (tuple(x.shape), x.dtype)
    return out


@pytest.mark.parametrize("arch", ["opt_6_7b", "minicpm3_4b",
                                  "mixtral_8x7b", "mamba2_2_7b",
                                  "whisper_medium", "qwen1_5_32b"])
@pytest.mark.parametrize("scan", [False, True])
def test_abstract_leaves_match_quantize_model(arch, scan):
    """Meta bundles laid out as the real ``quantize_model`` lays them out
    (shapes and dtypes, every field, expert banks per expert)."""
    cfg = get_reduced(arch).replace(scan_layers=scan)
    spec = QuantSpec(format="bcq", bits=3, group_size=32, iters=0)
    real = abstract_model(cfg).__class__(cfg, device="cpu")
    real.init_params(torch.Generator().manual_seed(0))
    quantize_model(real, spec)
    meta = abstract_model(cfg)
    abstract_quantized_params(meta, bits=3, group_size=32)
    assert _fields(to_params(meta)) == _fields(to_params(real))


# ---------------------------------------------------------------------------
# closed forms against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_analytic_bytes_match(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        a = ra.model_flops(cfg, shape, 3.3e9, 4.1e9)
        b = jra.model_flops(jcfg, JSHAPES[name], 3.3e9, 4.1e9)
        assert a == b
        mine = ra.serve_analytic_bytes(cfg, shape, 3.3e9, 3)
        ref = jra.serve_analytic_bytes(jcfg, JSHAPES[name], 3.3e9, 3)
        for k in ref:
            for f in ("bytes_per_dev", "weight_bytes", "cache_bytes"):
                assert mine[k][f] == ref[k][f]
            assert mine[k]["t_memory_s"] == pytest.approx(
                ref[k]["bytes_per_dev"] / 3.35e12)


# ---------------------------------------------------------------------------
# FLOP counter and measure()
# ---------------------------------------------------------------------------


def test_flop_count_closed_form_opt_decode():
    """One unrolled reduced OPT decode step: the counted FLOPs equal the
    sum of its products, on the CPU and on the meta device."""
    cfg = get_reduced("opt_6_7b").replace(scan_layers=False)
    b, length = 3, 40
    d, f, h, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim_
    want = cfg.n_layers * (2 * b * (4 * d * d + 2 * d * f)
                           + 2 * 2 * b * h * length * hd)
    want += 2 * b * d * cfg.padded_vocab                  # the tied head
    for dev in ("cpu", "meta"):
        m = abstract_model(cfg).__class__(cfg, device=dev)
        if dev == "cpu":
            m.init_params(torch.Generator().manual_seed(0))
        cache = m.init_cache(b, length)
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        pos = torch.full((b,), 5, dtype=torch.int32, device=dev)
        _, flops, coll = ra.measure(m.decode_step, tok, cache, pos)
        assert flops == want, dev
        assert coll == {}


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "mamba2_2_7b"])
def test_meta_routes_count_the_cpu_flops(arch):
    """The shape-only MoE and SSD routes count the FLOPs the plain path
    runs on the CPU (a prefill long enough that every expert gets
    tokens)."""
    cfg = get_reduced(arch).replace(scan_layers=False)
    out = []
    for dev in ("cpu", "meta"):
        m = abstract_model(cfg).__class__(cfg, device=dev)
        if dev == "cpu":
            m.init_params(torch.Generator().manual_seed(0))
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32)).to(dev)
        cache = m.init_cache(2, 64)
        with FlopCounterMode(display=False) as fc:
            m.prefill(toks, cache, 0)
        out.append(fc.get_total_flops())
    assert out[0] == out[1] > 0


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_dryrun_decode_cell_bytes_and_flops():
    """OPT-6.7B decode_32k: on one card the per-rank parameter bytes are
    the quantized model's, on the production mesh about a 16th (the model
    axis cuts the linears; norms, positions and some scales stay whole);
    the global FLOPs are the same on both meshes."""
    one = dryrun.run_cell("opt_6_7b", "decode_32k", quant=3,
                          mesh=dryrun.ShapeMesh((1, 1), ("data", "model")),
                          capacity_bytes=80e9, verbose=False)
    prod = dryrun.run_cell("opt_6_7b", "decode_32k", quant=3, verbose=False)
    m = abstract_model(get_config("opt_6_7b"))
    abstract_quantized_params(m, bits=3)
    assert one["per_rank_bytes"]["params"] == param_bytes(
        to_params(m, scan_layers=False))
    assert prod["per_rank_bytes"]["params"] < \
        one["per_rank_bytes"]["params"] / 14
    assert one["temp_bytes"] is None and "fits" in one
    f1 = one["roofline"]["flops_per_dev"]
    f256 = prod["roofline"]["flops_per_dev"] * 256
    assert f1 > 0 and f256 == pytest.approx(f1)
    assert one["roofline"]["bottleneck"] == "memory"


def test_dryrun_train_cell_fsdp_bytes():
    """train_4k under FSDP: weights and f32 moments over all 256 ranks."""
    r = dryrun.run_cell("stablelm_1_6b", "train_4k", verbose=False,
                        roofline=False)
    n = get_config("stablelm_1_6b")
    total = abstract_model(n).n_params()
    held = r["per_rank_bytes"]
    assert held["params"] < total * 2 / 100
    assert held["moments"] == pytest.approx(4 * held["params"], rel=0.02)
    assert "replicates" in r["note"]


def test_dryrun_long_context_skip():
    with pytest.raises(SystemExit, match="SKIP: opt_6_7b has no "
                                          "sub-quadratic path"):
        dryrun.run_cell("opt_6_7b", "long_500k", verbose=False)


def test_dryrun_cli_and_run_all(tmp_path, capsys):
    out = tmp_path / "cell.json"
    dryrun.main(["--arch", "mamba2_2_7b", "--shape", "long_500k",
                 "--quant", "3", "--json-out", str(out)])
    res = json.loads(out.read_text())
    assert res["roofline"]["flops_per_dev"] > 0
    assert res["mesh"] == [16, 16]
    d = tmp_path / "all"
    assert run_all.main(["--out", str(d), "--only", "stablelm"]) == 0
    names = sorted(p.name for p in d.iterdir())
    assert len(names) == 8
    skip = json.loads((d / "stablelm_1_6b__long_500k__multi.json")
                      .read_text())
    assert skip["skipped"]
    multi = json.loads((d / "stablelm_1_6b__decode_32k__multi.json")
                       .read_text())
    assert multi["mesh"] == [2, 16, 16] and "roofline" not in multi
    single = json.loads((d / "stablelm_1_6b__prefill_32k__single.json")
                        .read_text())
    assert single["roofline"]["flops_per_dev"] > 0
