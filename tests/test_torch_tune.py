"""``repro_torch.tune`` on the CPU: the cache, the resolution order, the
config space and its heuristic, pinning, pretuning's collection and the
trace records.

The contract the serving path leans on: with ``REPRO_TORCH_TUNE=off`` or
a cold cache every wrapper launches exactly the route and split count
of the wrappers' own rules (``route_for``, ``mma_splits``,
``gemv_splits``, ``dq_splits``, lut_gemm's and paged decode's
``decode_splits``, ``mla_splits``), held here over a grid of shapes;
every candidate the tuner may time is one the launchers take.  Whether
each candidate also computes the plain version's answer is a card test
(``tests/test_torch_cuda.py``, ``-k tune``): no kernel runs here.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import obs, tune as T
from repro_torch.core import bcq
from repro_torch.kernels import _lib
from repro_torch.kernels.bcq_matmul import ops as bops
from repro_torch.kernels.bcq_matmul.ref import GEMV_STEP, dq_step
from repro_torch.kernels.lut_gemm import ops as lops
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.ternary_matmul import ops as tops
from repro_torch.tune import cache as tcache, dispatch, space

DEV = "Test_Card+sm132+srcabc"
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test sees its own empty cache file and the default mode."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.delenv("REPRO_TORCH_TUNE", raising=False)
    T.reset_default_cache()
    yield
    T.reset_default_cache()


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def test_key_buckets_rows():
    kw = dict(m=64, n=128, dtype=BF16, mu=4, group_size=64, device=DEV)
    keys = [T.cache_key("lut_gemm", b=b, **kw) for b in (1, 5, 8, 9, 16, 17)]
    assert keys[0] == keys[1] == keys[2]         # every decode row count
    assert keys[2] != keys[3] and keys[3] == keys[4] != keys[5]
    assert [T.bucket_batch(b) for b in (1, 8, 9, 32, 33, 512, 513)] == \
        [8, 8, 16, 32, 64, 512, 1024]
    assert T.cache_key("lut_gemm", b=8, **kw) == \
        f"lut_gemm|b8|m64|n128|bfloat16|mu4|g64|{DEV}"


def test_device_tag_keeps_card_and_source_digest_apart(monkeypatch):
    tag = T.device_tag("NVIDIA H100 80GB HBM3", 132, "aaaa")
    assert tag == "NVIDIA_H100_80GB_HBM3+sm132+srcaaaa" and "|" not in tag
    assert tag != T.device_tag("NVIDIA H100 80GB HBM3", 132, "bbbb")
    assert tag != T.device_tag("NVIDIA H100 80GB HBM3", 114, "aaaa")
    assert tag != T.device_tag("NVIDIA H200", 132, "aaaa")
    # the default digest is the kernel library's own
    monkeypatch.setattr(_lib, "_digest", lambda: "d1")
    one = T.device_tag("card", 132)
    monkeypatch.setattr(_lib, "_digest", lambda: "d2")
    assert one.endswith("srcd1") and T.device_tag("card", 132) != one
    kw = dict(b=8, m=64, n=128, dtype=BF16, mu=0, group_size=64)
    assert T.cache_key("bcq_matmul", device=one, **kw) != \
        T.cache_key("bcq_matmul", device=T.device_tag("card", 132), **kw)


def test_cache_round_trip_is_byte_identical(tmp_path):
    path = str(tmp_path / "rt.json")
    c1 = T.TuneCache(path)
    c1.store("k1", T.KernelConfig("lut", 4, False), time_s=1.0)
    c1.store("k0", T.KernelConfig("mma", 2), time_s=2.0)
    c1.save()
    first = open(path, "rb").read()
    c2 = T.TuneCache(path)
    assert c2.lookup("k1") == T.KernelConfig("lut", 4, False)
    assert c2.lookup("k0") == T.KernelConfig("mma", 2)
    assert c2.lookup("missing") is None and "k1" in c2 and "x" not in c2
    c2.save()
    assert open(path, "rb").read() == first
    blob = json.loads(first)
    assert blob["version"] == tcache.SCHEMA_VERSION
    assert list(blob["entries"]) == ["k0", "k1"]


@pytest.mark.parametrize("text", ["{not json", '{"version": 99, "entries": '
                                  '{"k": {"config": {}}}}', '[1, 2]',
                                  '{"version": 1, "entries": [1]}'])
def test_corrupt_cache_is_cold(tmp_path, text):
    path = tmp_path / "bad.json"
    path.write_text(text)
    c = T.TuneCache(str(path))
    assert len(c) == 0 and c.lookup("k") is None


# ---------------------------------------------------------------------------
# the heuristic is today's rules
# ---------------------------------------------------------------------------


def _today(kernel, b, m, n, dtype, g, sms, mu=4):
    """The (route, splits) the wrappers launched before the tuner: their
    code, with the split rules called as they called them."""
    n_groups = -(-n // g)
    nb = n_groups * g // 8
    if kernel == "lut_gemm":
        route = lops.route_for(b, dtype, g, n, mu, True)
        if route == "lut":
            return route, lops.decode_splits(m, nb, sms)
    else:
        mod = bops if kernel == "bcq_matmul" else tops
        route = mod.route_for(b, dtype, g, n)
        if route == "gemv":
            return route, bops.gemv_splits(m, nb * 8, sms)
    if route == "mma":
        return route, bops.mma_splits(b, m, n_groups, sms)
    return route, bops.dq_splits(b, m, nb * 8, sms)


GEMM_GRID = [(b, m, n, dtype, g)
             for b in (1, 3, 8, 9, 32, 100, 512)
             for m, n in ((4096, 4096), (16384, 4096), (4096, 16384),
                          (96, 200), (50, 136))
             for dtype in (BF16, F32)
             for g in (8, 16, 24, 64, 128, 256, 512)]
DECODE_GRID = [(b, h, hkv, pages, bs) for b in (1, 3, 8)
               for h, hkv in ((32, 32), (24, 8), (40, 40), (128, 128))
               for pages in (1, 6, 32, 150) for bs in (4, 16)]


@pytest.mark.parametrize("mode", ["cold", "off"])
def test_cold_cache_and_off_launch_todays_rules(monkeypatch, mode):
    if mode == "off":
        # a warm entry for every key must not be read
        monkeypatch.setenv("REPRO_TORCH_TUNE", "off")
    for sms in (132, 16):
        dev = T.device_tag("card", sms, "x")
        for b, m, n, dtype, g in GEMM_GRID:
            for kernel in space.GEMM_KERNELS:
                mu = 4 if kernel == "lut_gemm" else 0
                got = dispatch.launch_config(
                    kernel, b=b, m=m, n=n, dtype=dtype, mu=mu,
                    group_size=g, sms=sms, device=dev)
                want = _today(kernel, b, m, n, dtype, g, sms)
                assert (got.route, got.splits, got.half_lut) == \
                    want + (True,), (kernel, b, m, n, dtype, g, sms)
        for b, h, hkv, pages, bs in DECODE_GRID:
            for kernel in ("paged_decode", "paged_decode_int8"):
                got = dispatch.launch_config(
                    kernel, sms=sms, device=dev, **space.decode_problem(
                        kernel, b=b, h=h, hkv=hkv, pages=pages, bs=bs,
                        dtype=BF16))
                assert got == T.KernelConfig("", pops.decode_splits(
                    b, hkv, h // hkv, pages, bs, sms))
            got = dispatch.launch_config(
                "paged_decode_mla", sms=sms, device=dev,
                **space.decode_problem("paged_decode_mla", b=b, h=h, hkv=h,
                                       pages=pages, bs=bs, dtype=F32))
            assert got == T.KernelConfig("", pops.mla_splits(b, h, pages,
                                                             sms))
            got = dispatch.launch_config(
                "paged_prefill", b=b, m=hkv, n=pages * bs, dtype=BF16,
                mu=h // hkv, group_size=bs, sms=sms, device=dev)
            assert got == T.KernelConfig("", 1)


def test_off_ignores_a_warm_cache(monkeypatch):
    kw = dict(b=8, m=16384, n=4096, dtype=BF16, mu=0, group_size=128,
              sms=132, device=DEV)
    heur = T.heuristic_config("bcq_matmul", **{k: v for k, v in kw.items()
                                                if k != "device"})
    assert heur == T.KernelConfig("gemv", 1)
    tuned = T.KernelConfig("mma_dq", 4)
    key = T.cache_key("bcq_matmul", **{k: v for k, v in kw.items()
                                       if k != "sms"})
    T.default_cache().store(key, tuned)
    assert T.kernel_config("bcq_matmul", **kw) == tuned
    monkeypatch.setenv("REPRO_TORCH_TUNE", "off")
    assert T.kernel_config("bcq_matmul", **kw) == heur
    monkeypatch.setenv("REPRO_TORCH_TUNE", "on")
    assert T.kernel_config("bcq_matmul", **kw) == tuned
    # a reload from disk: the saved entry is what resolves
    T.default_cache().save()
    T.reset_default_cache()
    assert T.kernel_config("bcq_matmul", **kw) == tuned


def test_cached_entries_are_clamped_to_the_call():
    kw = dict(b=512, m=4096, n=4096, dtype=BF16, mu=0, group_size=128,
              sms=132)
    # a route that does not take the call: the heuristic's route and splits
    assert T.clamp_config(T.KernelConfig("gemv", 7), "bcq_matmul", **kw) == \
        T.heuristic_config("bcq_matmul", **kw)
    # a split count past the units snaps down to a legal one
    got = T.clamp_config(T.KernelConfig("mma", 1000), "bcq_matmul", **kw)
    assert got == T.KernelConfig("mma", 32)            # 32 alpha groups
    got = T.clamp_config(T.KernelConfig("mma_dq", 5), "bcq_matmul", **kw)
    assert got.route == "mma_dq" and space.is_legal(got, "bcq_matmul",
                                                    **_shape(kw))
    # half_lut only on lut_gemm's LUT body
    assert T.clamp_config(T.KernelConfig("mma", 2, False), "lut_gemm",
                          **kw).half_lut is True
    dec = dict(kw, b=8)
    assert T.clamp_config(T.KernelConfig("lut", 5, False), "lut_gemm",
                          **dec) == T.KernelConfig("lut", 4, False)
    # the clamp is what dispatch returns for a stale entry
    key = T.cache_key("bcq_matmul", device=DEV, **{
        k: v for k, v in kw.items() if k != "sms"})
    T.default_cache().store(key, T.KernelConfig("gemv", 7))
    assert T.kernel_config("bcq_matmul", device=DEV, **kw) == \
        T.heuristic_config("bcq_matmul", **kw)


def _shape(kw):
    return {k: kw[k] for k in ("b", "m", "n", "dtype", "group_size")}


def _units(kernel, route, b, n, g):
    """The launchers' own unit counts (csrc: G, nst, nsteps, nchunks,
    ntab, pages), written out independently of ``space``."""
    nb = -(-n // g) * g // 8
    return {"mma": -(-n // g), "mma_dq": -(-nb // (dq_step(b) // 8)),
            "gemv": -(-nb // (GEMV_STEP // 8)),
            "lut": -(-nb * 8 // lops.DECODE_CHUNK)}[route]


@pytest.mark.parametrize("kernel", space.GEMM_KERNELS)
def test_candidates_are_legal_unique_heuristic_first(kernel):
    for b, m, n, dtype, g in GEMM_GRID[::7]:
        kw = dict(b=b, m=m, n=n, dtype=dtype, group_size=g, sms=132,
                  mu=4 if kernel == "lut_gemm" else 0)
        cands = T.candidate_configs(kernel, **kw)
        assert cands[0] == T.heuristic_config(kernel, **kw)
        assert len(cands) == len(set(cands))
        routes = {c.route for c in cands}
        for c in cands:
            units = _units(kernel, c.route, b, n, g)
            per = -(-units // c.splits)
            assert 1 <= c.splits <= units and -(-units // per) == c.splits
            takes = {"gemv": bops.gemv_takes(b, dtype, g, n),
                     "mma": bops.mma_takes(b, dtype, g, n),
                     "lut": kernel == "lut_gemm" and b <= 8,
                     "mma_dq": True}[c.route]
            assert takes and (c.route != "gemv" or kernel != "lut_gemm")
            assert c.half_lut or (kernel, c.route) == ("lut_gemm", "lut")
        # every body that takes the call is a candidate
        assert "mma_dq" in routes
        assert ("mma" in routes) == bops.mma_takes(b, dtype, g, n)
        if kernel == "lut_gemm" and b <= 8:
            assert {c.half_lut for c in cands if c.route == "lut"} == \
                {True, False}
    decode = T.candidate_configs("paged_decode", b=8, m=32, n=512,
                                 dtype=BF16, mu=1, group_size=16, sms=132)
    assert decode[0].splits == pops.decode_splits(8, 32, 1, 32, 16, 132)
    assert {c.route for c in decode} == {""}
    assert T.candidate_configs("paged_prefill", b=1, m=32, n=512,
                               dtype=BF16, mu=1, group_size=16,
                               sms=132) == [T.KernelConfig("", 1)]
    assert len(T.candidate_configs("bcq_matmul", b=512, m=4096, n=4096,
                                   dtype=BF16, group_size=128, sms=132,
                                   max_candidates=3)) == 3


# ---------------------------------------------------------------------------
# pinning, the wrappers, collection, CPU refusals
# ---------------------------------------------------------------------------


def test_pinned_arguments_bypass_dispatch(monkeypatch):
    calls = []
    real = dispatch.kernel_config

    def spy(kernel, **kw):
        calls.append(kernel)
        return real(kernel, **kw)

    monkeypatch.setattr(dispatch, "kernel_config", spy)
    kw = dict(b=8, m=4096, n=4096, dtype=BF16, group_size=128, sms=132,
              device=DEV)
    dispatch.launch_config("bcq_matmul", **kw)
    assert calls == ["bcq_matmul"]

    def boom(*a, **k):
        raise AssertionError("dispatch must not be consulted")

    monkeypatch.setattr(dispatch, "kernel_config", boom)
    assert dispatch.launch_config("bcq_matmul", route="mma_dq", splits=2,
                                  **kw) == T.KernelConfig("mma_dq", 2)
    # one pin: the other field takes the heuristic's rule for that route
    assert dispatch.launch_config("bcq_matmul", route="mma_dq", **kw) == \
        T.KernelConfig("mma_dq", bops.dq_splits(8, 4096, 4096, 132))
    assert dispatch.launch_config("bcq_matmul", splits=4, **kw) == \
        T.KernelConfig("gemv", 4)
    # a pin the launchers would refuse raises: nothing falls back
    for bad in (dict(route="mma"), dict(route="lut"),
                dict(route="gemv", splits=5), dict(route="gemv", splits=99)):
        with pytest.raises(ValueError, match="pinned"):
            dispatch.launch_config("bcq_matmul", **bad, **kw)
    # on CPU tensors the wrappers run their plain versions, pins or not
    rng = np.random.default_rng(0)
    w = bcq.from_uniform(torch.from_numpy(rng.normal(size=(40, 128)).astype(
        np.float32)), bits=3, group_size=64)
    x = torch.from_numpy(rng.normal(size=(3, 128)).astype(np.float32))
    from repro_torch.kernels.bcq_matmul import bcq_matmul
    from repro_torch.kernels.lut_gemm import lut_gemm
    want = bcq_matmul(x, w)
    assert torch.equal(bcq_matmul(x, w, route="mma_dq", splits=1), want)
    torch.testing.assert_close(lut_gemm(x, w, route="lut", splits=1), want,
                               rtol=1e-5, atol=1e-5)


def test_collect_bcq_specs_dedups():
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.quant import QuantSpec, quantize_model
    cfg = get_reduced("opt_6_7b")
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert T.collect_bcq_specs(model) == []          # dense: nothing
    quantize_model(model, QuantSpec(format="bcq", bits=3, group_size=64))
    specs = T.collect_bcq_specs(model)
    # q/k/v/o share [64 x 64]; up [128 x 64]; down [64 x 128], two layers
    assert specs == [(64, 64, 3, 64, "bcq"), (128, 64, 3, 64, "bcq"),
                     (64, 128, 3, 64, "bcq")]


def test_tune_and_pretune_refuse_the_cpu():
    rng = np.random.default_rng(1)
    w = bcq.from_uniform(torch.from_numpy(rng.normal(size=(32, 128)).astype(
        np.float32)), bits=2, group_size=64)
    x = torch.zeros((4, 128))
    for kernel in ("bcq_matmul", "lut_gemm"):
        with pytest.raises(ValueError, match="CUDA"):
            T.tune(kernel, x, w)
    with pytest.raises(ValueError, match="launch choice"):
        T.tune("paged_prefill", torch.zeros(1, device="meta"))
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.quant import QuantSpec, quantize_model
    from repro_torch.serve import PagedServeEngine
    from repro_torch.serve.engine import _pretune
    spec = QuantSpec(format="bcq", bits=3, group_size=64,
                     backend="mxu_pallas")
    model = Model(get_reduced("opt_6_7b"), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    quantize_model(model, spec)
    model = model.with_config(quant=spec)
    with pytest.raises(ValueError, match="card"):
        _pretune(model, [1, 8])
    with pytest.raises(ValueError, match="card"):
        PagedServeEngine(model, num_blocks=8, block_size=8, max_batch=2,
                         max_seq_len=64, pretune=True)
    # a dense model has nothing to tune
    assert _pretune(model.with_config(quant=None), [1]) == []
    from repro_torch.launch import serve as launch
    with pytest.raises(SystemExit, match="card"):
        launch.main(["--device", "cpu", "--pretune", "--requests", "1"])


# ---------------------------------------------------------------------------
# trace records
# ---------------------------------------------------------------------------


def test_kernel_config_records_on_the_active_tracer():
    kw = dict(b=8, m=16384, n=4096, dtype=BF16, mu=0, group_size=128,
              sms=132, device=DEV)
    T.kernel_config("bcq_matmul", **kw)                  # no tracer: no-op
    tr = obs.Tracer()
    with obs.activate(tr):
        for _ in range(3):                                # recorded once
            T.kernel_config("bcq_matmul", **kw)
        key = T.cache_key("bcq_matmul", **{k: v for k, v in kw.items()
                                           if k != "sms"})
        T.default_cache().store(key, T.KernelConfig("mma_dq", 2))
        T.kernel_config("bcq_matmul", **kw)
        T.kernel_config("bcq_matmul", **dict(kw, b=3))    # same bucket
        assert T.kernel_unsupported_reason(
            "ternary_matmul", m=8, n=64, group_size=64, kind="bcq") == "kind"
        T.kernel_unsupported_reason("ternary_matmul", m=8, n=64,
                                    group_size=64, kind="bcq")
    ev = [(e["name"], e["args"].get("source"), e["args"].get("config"))
          for e in tr.events]
    assert ev == [
        ("kernel_config:bcq_matmul", "heuristic",
         {"route": "gemv", "splits": 1, "half_lut": True}),
        ("kernel_config:bcq_matmul", "cache",
         {"route": "mma_dq", "splits": 2, "half_lut": True}),
        ("kernel_config:bcq_matmul", "cache",
         {"route": "mma_dq", "splits": 2, "half_lut": True}),
        ("kernel_unsupported:ternary_matmul", None, None)]
    assert {e["track"] for e in tr.events} == {"engine/kernel"}
    assert tr.events[-1]["args"]["reason"] == "kind"
    # a new tracer records the same resolutions again
    tr2 = obs.Tracer()
    with obs.activate(tr2):
        T.kernel_config("bcq_matmul", **kw)
    assert [e["args"]["source"] for e in tr2.events] == ["cache"]


def test_capability_probe_reasons():
    r = T.kernel_unsupported_reason
    assert r("nope", m=1, n=1, group_size=8) == "unknown_kernel"
    assert r("bcq_matmul", m=8, n=64, group_size=12) == "group_size"
    assert r("lut_gemm", m=8, n=64, group_size=64, bits=9) == "bits"
    assert r("bcq_matmul", m=8, n=64, group_size=64, lead=1) == "shape"
    assert r("bcq_matmul", m=8, n=64, group_size=64, kind="ternary") == "kind"
    assert r("ternary_matmul", m=8, n=64, group_size=64, kind="ternary") \
        is None
    assert r("paged_decode", m=24, n=512, group_size=16, n_kv_heads=8,
             head_dim=128) is None
    assert r("paged_decode", m=24, n=512, group_size=16, n_kv_heads=7) == \
        "heads"
    assert r("paged_decode", m=8, n=512, group_size=16, head_dim=72) == \
        "head_dim"
    assert r("paged_prefill", m=8, n=512, group_size=16, head_dim=320) == \
        "head_dim"
    assert r("paged_prefill", m=8, n=512, group_size=16, head_dim=320,
             bf16=False) is None
    assert r("paged_decode_mla", m=40, n=512, group_size=16, lora=1024) == \
        "head_dim"
    assert r("paged_prefill", m=8, n=512, group_size=16, latent=True) == \
        "latent"
    assert r("paged_decode", m=8, n=512, group_size=16, window=64) == "window"
    assert r("paged_decode", m=8, n=512, group_size=16,
             kv_dtype=torch.int32) == "kv_dtype"
    assert T.kernel_supports("paged_decode_int8", m=8, n=512, group_size=16,
                             kv_dtype=torch.int8)
