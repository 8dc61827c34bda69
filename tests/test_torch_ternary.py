"""Port parity: the ternary weight path (format, kernel module, dispatch,
manifest) and a reduced OPT served with ternary weights and an int8 KV
cache.

Tolerances, each with its reason:

  * ``quantize_ternary``: reconstruction within 1e-6 (the clipping fixed
    point sums |w| in another order, so alpha may differ in the last f32
    bit); on a weight that is already ternary the bundles are equal
    (every sum is of exact multiples of 0.5);
  * the plain ``ternary_matmul`` against the reference kernel (Pallas
    interpret mode) and ``ternary_ref``: exact on exact inputs (integer
    activations, power-of-two alphas: every partial sum is an exact f32),
    1e-4 of the output scale otherwise (summation order);
  * ``ternary_planes_ref`` (the arithmetic of the tensor-core route:
    x against the sum of the two derived +-1 planes per alpha group,
    then alpha / 2) against the reference kernel: exact on exact inputs,
    1e-3 of the output scale (the reference's GEMM gate) on random ones;
  * ``ternary_masked_ref`` (the arithmetic of the decode tile: x against
    mask * (+-1 sign) per alpha group, then alpha) against the
    reference's ``ternary_ref``: exact on exact inputs, 1e-3 of the
    output scale on random ones;
  * dequantize and manifest bytes: exactly equal;
  * the greedy token stream of the port's ``PagedServeEngine``: identical
    to the reference engine's (tolerance 0 on token ids).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_reduced as j_reduced
from repro.core import plane as jplane
from repro.kernels.ternary_matmul import ternary_matmul as j_ternary
from repro.kernels.ternary_matmul import ternary_ref as j_ternary_ref
from repro.models import Model as JModel
from repro.quant import formats as jformats
from repro.serve import Request as JRequest
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.core import bcq as tbcq
from repro_torch.core import lut_gemm as tlg
from repro_torch.core import plane as tplane
from repro_torch.kernels import _lib
from repro_torch.kernels.lut_common import ternary_plane_bytes
from repro_torch.kernels.ternary_matmul import (dense_ref, route_for,
                                                ternary_masked_ref,
                                                ternary_matmul,
                                                ternary_planes_ref,
                                                ternary_ref)
from repro_torch.kernels.bcq_matmul.ops import dq_splits
from repro_torch.kernels.bcq_matmul.ref import dq_step
from repro_torch.models import from_jax_params
from repro_torch.quant import QuantSpec, backends as tbackends, quantize_model
from repro_torch.quant.formats import quantize_ternary
from repro_torch.serve import PagedServeEngine, Request

from torch_port_cases import (f32_params, ref_paged_engine, to_numpy_tree,
                              torch_bundle)

RECON_TOL = 1e-6
FLOAT_TOL = 1e-4
SHAPES = [(64, 128, 1), (96, 200, 5), (33, 130, 2)]


def _ternary_w(m, n, seed):
    """0.5 * {-1, 0, +1}: a weight that is already ternary."""
    rng = np.random.default_rng(seed)
    return (0.5 * rng.integers(-1, 2, (m, n))).astype(np.float32)


def _pair(w, g):
    wj = jformats.quantize_ternary(jnp.asarray(w), group_size=g)
    return wj, torch_bundle(wj)


# ---------------------------------------------------------------------------
# format and layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,g", [(33, 130, 64), (64, 256, 128),
                                   (17, 72, 32)])
def test_quantize_ternary_matches(m, n, g):
    w = np.random.default_rng(m + n).normal(size=(m, n)).astype(np.float32)
    wj = jformats.quantize_ternary(jnp.asarray(w), group_size=g)
    wt = quantize_ternary(torch.from_numpy(w), group_size=g)
    assert wt.kind == "ternary" and wt.z is None and wt.bits == 2
    assert wt.packed.shape == tuple(wj.packed.shape)
    assert wt.alpha.shape == tuple(wj.alpha.shape)
    np.testing.assert_allclose(wt.dequantize().numpy(),
                               np.asarray(wj.dequantize()), rtol=RECON_TOL,
                               atol=RECON_TOL)


def test_quantize_ternary_exact_on_ternary_weight():
    w = _ternary_w(40, 192, 4)
    wj = jformats.quantize_ternary(jnp.asarray(w), group_size=64)
    wt = quantize_ternary(torch.from_numpy(w), group_size=64)
    np.testing.assert_array_equal(wt.packed.numpy(), np.asarray(wj.packed))
    np.testing.assert_array_equal(wt.alpha.numpy(), np.asarray(wj.alpha))
    np.testing.assert_array_equal(wt.dequantize().numpy(), w)


@pytest.mark.parametrize("m,n,g", [(33, 130, 64), (16, 256, 128)])
def test_ternary_dequantize_and_bytes_equal(m, n, g):
    w = np.random.default_rng(n).normal(size=(m, n)).astype(np.float32)
    wj, wt = _pair(w, g)
    np.testing.assert_array_equal(tplane.dequantize(wt).numpy(),
                                  np.asarray(jplane.dequantize(wj)))
    assert wt.nbytes() == wj.nbytes()
    assert wt.effective_bits == wj.effective_bits == tplane.TERNARY_BITS
    assert wt.bits == wj.bits == 2


def test_ternary_plane_bytes_match_reference():
    from repro.kernels.lut_common import ternary_plane_bytes as j_tpb
    rng = np.random.default_rng(0)
    s, m = rng.integers(0, 256, (2, 7, 9), dtype=np.uint8)
    b1, b2 = ternary_plane_bytes(torch.from_numpy(s), torch.from_numpy(m))
    j1, j2 = j_tpb(jnp.asarray(s), jnp.asarray(m))
    np.testing.assert_array_equal(b1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(j2))


def test_spec_and_kinds():
    for bits in (None, 2, 1.58, 1.585):
        s = QuantSpec(format="ternary", bits=bits)
        assert s.bits == tplane.TERNARY_BITS and s.int_bits == 2
    with pytest.raises(ValueError, match="ternary"):
        QuantSpec(format="ternary", bits=3)
    assert jquant.QuantSpec(format="ternary").bits == QuantSpec(
        format="ternary").bits


# ---------------------------------------------------------------------------
# kernel module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,b", SHAPES)
def test_ternary_matmul_exact_on_exact_inputs(m, n, b):
    rng = np.random.default_rng(m + n)
    wj, wt = _pair(_ternary_w(m, n, m + n), 64)
    x = rng.integers(-8, 9, (b, n)).astype(np.float32)
    want = np.asarray(j_ternary(jnp.asarray(x), wj, interpret=True))
    _lib.reset_launch_counts()
    got = ternary_matmul(torch.from_numpy(x), wt).numpy()
    assert _lib.launch_counts["ternary_matmul"] == 0     # plain on the CPU
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(j_ternary_ref(jnp.asarray(x), wj)))
    np.testing.assert_array_equal(
        dense_ref(torch.from_numpy(x), wt).numpy(), got)


@pytest.mark.parametrize("m,n,b", SHAPES)
def test_ternary_matmul_float_matches(m, n, b):
    rng = np.random.default_rng(m * n)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    wj, wt = _pair(w, 64)
    want = np.asarray(j_ternary(jnp.asarray(x), wj, interpret=True))
    got = ternary_matmul(torch.from_numpy(x), wt).numpy()
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=FLOAT_TOL)
    ref = ternary_ref(torch.from_numpy(x), wt).numpy()
    np.testing.assert_allclose(ref / scale, want / scale, atol=FLOAT_TOL)


def _tw(m, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(m, n)).astype(np.float32))


def test_ternary_matmul_rejects_bcq_and_bcq_kernels_reject_ternary():
    wt = quantize_ternary(_tw(16, 64, 0), group_size=32)
    wb = tbcq.from_uniform(_tw(16, 64, 0), bits=2, group_size=32)
    with pytest.raises(ValueError, match="ternary"):
        ternary_matmul(torch.ones(2, 64), wb)
    with pytest.raises(ValueError, match="planes"):
        tlg.bcq_apply(torch.ones(2, 64), wt, backend="bcq_xla_planes")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 64)).astype(np.float32))
    y = tlg.bcq_apply(x, wt, backend="ternary_pallas", out_dtype=torch.float32)
    for backend in ("dense", "bcq_xla"):
        z = tlg.bcq_apply(x, wt, backend=backend, out_dtype=torch.float32)
        assert float((z - y).abs().max()) <= 2e-2 * float(y.abs().max())


# the tensor-core route's shapes: ragged M, N (376 at gs 128: padded
# planes) and B, each group size the route takes
MMA_SHAPES = [(33, 376, 9, 128), (64, 256, 32, 16), (40, 192, 17, 64)]
GEMM_TOL = 1e-3


@pytest.mark.parametrize("m,n,b,g", MMA_SHAPES)
def test_ternary_planes_ref_exact_against_reference(m, n, b, g):
    """The mma route's re-associated arithmetic equals the reference
    kernel bit for bit on exact inputs."""
    rng = np.random.default_rng(m + b)
    wj, wt = _pair(_ternary_w(m, n, m + n), g)
    x = rng.integers(-8, 9, (b, n)).astype(np.float32)
    want = np.asarray(j_ternary(jnp.asarray(x), wj, interpret=True))
    got = ternary_planes_ref(torch.from_numpy(x), wt).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n,b,g", MMA_SHAPES)
def test_ternary_planes_ref_matches_reference(m, n, b, g):
    """On random weights and bf16-valued activations (what the route
    reads) within 1e-3 of the output scale of the reference kernel."""
    rng = np.random.default_rng(m * b)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    wj, wt = _pair(w, g)
    want = np.asarray(j_ternary(jnp.asarray(x), wj, interpret=True))
    got = ternary_planes_ref(torch.from_numpy(x), wt).numpy()
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=GEMM_TOL)


# the decode tile's shapes: ragged M, N (376 at gs 128, 600 at gs 32,
# 520 at gs 64: padded planes) and B (1-8), each group size it takes
GEMV_SHAPES = [(33, 376, 1, 128), (70, 600, 8, 32), (17, 520, 5, 64),
               (48, 1024, 3, 256)]


@pytest.mark.parametrize("m,n,b,g", GEMV_SHAPES)
def test_ternary_masked_ref_exact_against_reference(m, n, b, g):
    """The decode tile's one-operand arithmetic, alpha x . (mask (+-1
    sign)), equals the reference's ternary_ref (the derived planes'
    alpha / 2 (V1 + V2)) bit for bit on exact inputs."""
    rng = np.random.default_rng(m + b + g)
    wj, wt = _pair(_ternary_w(m, n, m + n), g)
    x = rng.integers(-8, 9, (b, n)).astype(np.float32)
    want = np.asarray(j_ternary_ref(jnp.asarray(x), wj))
    got = ternary_masked_ref(torch.from_numpy(x), wt).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n,b,g", GEMV_SHAPES)
def test_ternary_masked_ref_matches_reference(m, n, b, g):
    """On random weights and f32 activations within 1e-3 of the output
    scale of the reference's ternary_ref."""
    rng = np.random.default_rng(m * b + g)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    wj, wt = _pair(w, g)
    want = np.asarray(j_ternary_ref(jnp.asarray(x), wj))
    got = ternary_masked_ref(torch.from_numpy(x), wt).numpy()
    assert got.shape == want.shape == (b, m)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=GEMM_TOL)


@pytest.mark.parametrize("rows,dtype,gs,n,want", [
    (1, torch.bfloat16, 128, 4096, "gemv"), (8, torch.bfloat16, 128, 4096,
                                             "gemv"),
    (9, torch.bfloat16, 128, 4096, "mma"), (512, torch.bfloat16, 16, 136,
                                            "mma"),
    (512, torch.bfloat16, 256, 4096, "mma"),
    (512, torch.float32, 128, 4096, "mma"),
    (512, torch.bfloat16, 8, 4096, "mma_dq"),
    (512, torch.bfloat16, 24, 4096, "mma_dq"),
    (512, torch.bfloat16, 512, 4096, "mma_dq"),
    (512, torch.bfloat16, 128, 4092, "mma_dq"),
    # the decode tile: bf16 and f32 rows <= 8, gs 32-256, 8 | in_features
    (8, torch.float32, 128, 4096, "gemv"), (1, torch.float32, 32, 2560,
                                            "gemv"),
    (8, torch.bfloat16, 256, 768, "gemv"),
    (8, torch.bfloat16, 8, 4096, "mma_dq"),
    (8, torch.bfloat16, 24, 4096, "mma_dq"),
    (8, torch.bfloat16, 16, 4096, "mma_dq"),
    (8, torch.float32, 512, 4096, "mma_dq"),
    (8, torch.bfloat16, 128, 4092, "mma_dq"),
    # f32 above 8 rows: the mma route under the same rule, the
    # dequantizing tile for the group sizes and widths it does not take
    (9, torch.float32, 16, 4096, "mma"),
    (512, torch.float32, 8, 4096, "mma_dq"),
    (512, torch.float32, 512, 4096, "mma_dq"),
    (512, torch.float32, 128, 4100, "mma_dq")])
def test_ternary_route_edges(rows, dtype, gs, n, want):
    """The decode tile takes at most 8 bf16 or f32 rows with gs 32, 64,
    128 or 256 and 8 | in_features (bcq_matmul's gemv rule); the mma
    route more than 8 bf16 or f32 rows with 16 | gs <= 256 and 8 |
    in_features (bcq_matmul's mma rule); every other call, at any row
    count, the dequantizing tile."""
    assert route_for(rows, dtype, gs, n) == want


def test_split_count_covers_every_chunk():
    """The dequantizing tile's split of its stages (the route the
    half-LUT body's calls now take; 64 columns, 512 at 8 rows or fewer):
    every split holds whole stages, none is empty, and every stage is
    covered."""
    for b, m, nb, sms in ((8, 16384, 512, 132), (8, 4096, 512, 132),
                          (8, 4096, 2048, 132), (512, 4096, 512, 132),
                          (1, 33, 17, 132), (3, 96, 25, 4)):
        s = dq_splits(b, m, nb * 8, sms)
        stages = -(-nb * 8 // dq_step(b))
        per = -(-stages // s)
        assert 1 <= s <= stages and (s - 1) * per < stages <= s * per


# ---------------------------------------------------------------------------
# dispatch and manifest
# ---------------------------------------------------------------------------


def test_resolution_and_kind_rule(monkeypatch):
    wt = quantize_ternary(_tw(8, 64, 2), group_size=32)
    wb = tbcq.from_uniform(_tw(8, 64, 2), bits=2, group_size=32)
    r = tbackends.matmul_unsupported_reason
    assert r("ternary_matmul", wt) is None and r("ternary_matmul", wb) == \
        "kind"
    assert r("bcq_matmul", wt) == "kind" and r("lut_gemm", wt) == "kind"
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tbackends.on_h100.cache_clear()
        # off the card: as the reference off the TPU
        assert tbackends.resolve_backend("auto", wt) == "bcq_xla"
        assert tbackends.resolve_backend("ternary_pallas", wt) == \
            "ternary_pallas"
        assert tbackends.resolve_backend("ternary_pallas", wb) == "bcq_xla"
        # on the card (the kernels are native there)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda *a: (9, 0))
        tbackends.on_h100.cache_clear()
        assert tbackends.resolve_backend("auto", wt) == "ternary_pallas"
        assert tbackends.resolve_backend("auto", wb) == "mxu_pallas"
        assert tbackends.resolve_backend("mxu_pallas", wt) == "bcq_xla"
        assert tbackends.resolve_backend("lut_pallas", wt) == "bcq_xla"
    finally:
        monkeypatch.undo()
        tbackends.on_h100.cache_clear()


def _reduced_pair():
    cfg = j_reduced("opt_6_7b").replace(remat=False, dtype="float32")
    jm = JModel(cfg)
    params = f32_params(jm.init(jax.random.PRNGKey(0)))
    return jm, params


def test_manifest_bytes_and_ratio_match_reference():
    jm, params = _reduced_pair()
    tcfg = t_reduced("opt_6_7b").replace(dtype="float32")
    mans = {}
    for fmt, bits in (("ternary", None), ("bcq", 2)):
        _, jman = jquant.quantize_model(
            params, jquant.QuantSpec(format=fmt, bits=bits, group_size=32,
                                     iters=2), jm.axes())
        tm = from_jax_params(to_numpy_tree(params), tcfg, device="cpu")
        tman = quantize_model(tm, QuantSpec(format=fmt, bits=bits,
                                            group_size=32, iters=2))
        assert tman.quant_bytes == jman.quant_bytes
        assert [l["quant_bytes"] for l in tman.layers] == \
            [l["quant_bytes"] for l in jman.layers]
        for lt, lj in zip(tman.layers, jman.layers):
            assert (lt["format"], lt["plane_bits"], lt["effective_bits"]) \
                == (lj["format"], lj["plane_bits"], lj["effective_bits"])
        mans[fmt] = (tman, jman)
    t_ratio = mans["ternary"][0].quant_bytes / mans["bcq"][0].quant_bytes
    j_ratio = mans["ternary"][1].quant_bytes / mans["bcq"][1].quant_bytes
    assert t_ratio == j_ratio < 1.0
    assert mans["ternary"][0].layers[0]["effective_bits"] == 1.585


def test_ternary_ratio_at_reference_shape():
    """The reference's measured ternary / BCQ-2 bytes ratio: 0.818 at
    M = 256, N = 512, g = 128."""
    w = _tw(256, 512, 3)
    t = quantize_ternary(w, group_size=128).nbytes()
    b = tbcq.from_uniform(w, bits=2, group_size=128).nbytes()
    assert round(t / b, 3) == 0.818


def test_from_jax_params_carries_ternary_bundles():
    jm, params = _reduced_pair()
    qparams, _ = jquant.quantize_model(
        params, jquant.QuantSpec(format="ternary", group_size=32), jm.axes())
    tcfg = t_reduced("opt_6_7b").replace(dtype="float32")
    tm = from_jax_params(to_numpy_tree(qparams), tcfg, device="cpu")
    w = tm.stack.layers[0].mixer.q.weight
    assert isinstance(w, tplane.PlaneBundle)
    assert w.kind == "ternary" and w.z is None and w.alpha.shape[0] == 1


# ---------------------------------------------------------------------------
# serving: ternary weights + int8 KV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged_kernel", ["gather", "fused"])
def test_greedy_stream_ternary_int8_kv_matches_reference(paged_kernel):
    over = dict(dtype="float32", paged_kernel=paged_kernel, kv_cache_bits=8)
    jcfg = j_reduced("opt_6_7b").replace(remat=False, **over)
    jm = JModel(jcfg)
    params = f32_params(jm.init(jax.random.PRNGKey(0)))
    jspec = jquant.QuantSpec(format="ternary", group_size=32,
                             backend="bcq_xla")
    params, _ = jquant.quantize_model(params, jspec, jm.axes())
    jm = JModel(jcfg.replace(quant=jspec))
    tcfg = t_reduced("opt_6_7b").replace(
        **over, quant=QuantSpec(format="ternary", group_size=32,
                                backend="bcq_xla"))
    tm = from_jax_params(to_numpy_tree(params), tcfg, device="cpu")
    big = paged_kernel == "gather"
    kw = dict(num_blocks=24 if big else 12, block_size=8 if big else 4,
              max_batch=3 if big else 2, max_seq_len=64 if big else 32,
              prefill_buckets=(8, 16) if big else (8,))
    lens, max_new = ([3, 9, 17, 30, 5], 5) if big else ([6, 11], 3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]
    je = ref_paged_engine(jm, params, **kw)
    jdone = je.run([JRequest(uid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)], max_ticks=400)
    te = PagedServeEngine(tm, **kw)
    tdone = te.run([Request(uid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)], max_ticks=400)
    assert te.decode_path == te.prefill_path == paged_kernel
    assert te.cache["layers"][0]["k"].dtype == torch.int8
    assert {r.uid: list(r.out_tokens) for r in tdone} == \
        {r.uid: list(r.out_tokens) for r in jdone}
    tpk = te.metrics.summary()["paged_kernel"]
    jpk = je.metrics.summary()["paged_kernel"]
    for key in ("kv_bytes_per_token_fused", "kv_bytes_per_token_gathered"):
        assert tpk[key] == jpk[key]
