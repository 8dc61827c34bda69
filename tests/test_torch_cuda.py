"""On the card: each CUDA kernel of the port against its plain version.

Marked ``cuda``; every test skips on a host without a (9, 0) device.
The file imports neither JAX nor the reference package, so it also runs
on the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: 1e-3 of the output scale for the GEMMs, 1e-4 for float paged
decode and prefill on f32 pools (the reference's gates); ternary_matmul
exactly (0) on exact inputs (integer activations, power-of-two alphas);
int8 paged decode and prefill 1e-4 of the output scale when they compute
in f32 with power-of-two scales (no bf16 rounding, exact scale
products), and the reference's int8 gate, 5e-2, in bf16 (the kernel
rounds p * v_scale before normalizing, the plain version after).  The
tensor-core chunked prefill on bf16 pools: 2e-2 of the output scale
(chip_smoke's bf16 gate: the kernel rounds the unnormalized
probabilities to bf16 tile by tile, the plain version the normalized
ones).  MLA
decode within 1e-4 of the output scale (the reference's
``paged_attention_mla_maxerr`` gate): both sides compute in f32 from
the same pools, only the summation order differs.  The split-table
decode kernel (float and int8 pools): 1e-4 of the output scale in f32,
and the bf16 and int8 gates above in bf16 (it rounds p against each
warp's running max of its split, the plain version the normalized p).
The split-table MLA kernel keeps 1e-4 at every split count, and both
split merges (MLA, the decode tile) give bit-identical outputs on a
repeated call.  The decode tile on f32 activations (x split into three
bf16 parts) is also held to 1e-5 at the served shapes: the split is
exact for normal values, so only the f32 summation order differs.  The
tensor-core tile on f32 activations above 8 rows (the same split) is
held to 1e-3 of the output scale and bit for bit on exact inputs, at
every group size it takes, q 1-8 at group size 256 (its shared-memory
budget: 64, 32 or 16 batch rows a block), split and unsplit.  The
dequantizing tile (route ``mma_dq``: the group sizes and input widths the
other tiles refuse) is held to 1e-3 of the output scale against the
plain version and its own walk (``dq_split_ref``), bit for bit on exact
inputs, at group sizes 8 and 512, q 1-8, ragged M / N / B, split and
unsplit, bf16 and f32.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bcq
from repro_torch.kernels import _lib
from repro_torch.kernels.bcq_matmul import bcq_matmul, bcq_matmul_ref
from repro_torch.kernels.lut_gemm import lut_gemm, lut_ref
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_int8,
                                                 paged_attention_mla,
                                                 paged_decode_int8_ref,
                                                 paged_decode_mla_ref,
                                                 paged_decode_ref,
                                                 paged_prefill,
                                                 paged_prefill_ref)
from repro_torch.kernels.ternary_matmul import (dense_ref, ternary_masked_ref,
                                                ternary_matmul,
                                                ternary_planes_ref,
                                                ternary_ref)
from repro_torch.quant.formats import quantize_ternary

from torch_port_cases import (int8_pools, live_slots, mla_pool_case,
                              pool_case, require_cuda)

GEMM_TOL = 1e-3
PAGED_TOL = 1e-4
INT8_TOL = 5e-2
BF16_POOL_TOL = 2e-2


def _close(got, want, tol):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,b", [(64, 128, 1), (96, 200, 5), (33, 136, 2),
                                   (4096, 4096, 8), (512, 1024, 40)])
def test_cuda_gemms_match_plain(m, n, b):
    require_cuda()
    rng = np.random.default_rng(m + b)
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    wt = bcq.from_uniform(w.to("cuda"), bits=3,
                          group_size=64 if n % 64 == 0 else 8)
    x = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xt = x.to("cuda", dtype)
        want = bcq_matmul_ref(xt, wt, torch.float32)
        _lib.reset_launch_counts()
        _close(bcq_matmul(xt, wt, out_dtype=torch.float32), want, GEMM_TOL)
        for mu in (2, 4):
            for half in (True, False):
                got = lut_gemm(xt, wt, mu=mu, half_lut=half,
                               out_dtype=torch.float32)
                _close(got, want, GEMM_TOL)
        _close(lut_gemm(xt, wt, out_dtype=torch.float32),
               lut_ref(xt, wt, out_dtype=torch.float32), GEMM_TOL)
        assert _lib.launch_counts["bcq_matmul"] == 1
        assert _lib.launch_counts["lut_gemm"] == 5


def _routes_run(fn):
    """The routes ``fn`` launched, as {"<kernel>/<route>": count}."""
    _lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_lib.route_counts)


# lut_gemm's table variants: the serve path's (mu 4, half) and the
# paper's LUT-size and hFFLUT ablations, all on the lut body at decode
# rows
LUT_VARIANTS = ((4, True), (4, False), (2, True), (2, False))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 2, 3, 4])
@pytest.mark.parametrize("gs", [16, 64, 128])
@pytest.mark.parametrize("rows", [1, 8, 9, 32, 128, 512])
def test_cuda_gemm_routes_match_plain(rows, gs, q):
    """Every body of bcq_matmul and lut_gemm against the plain version,
    1e-3 of the output scale: decode rows (gemv / lut), prefill rows in
    bf16 and f32 (the tensor-core tile, f32 split into three bf16
    parts); ragged M
    (33, 288), ragged batch rows (9), an input width that is not a whole
    number of groups (376 at gs 128: padded planes).  The route counters
    show which body ran."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul import route_for as bcq_route
    from repro_torch.kernels.lut_gemm import route_for as lut_route
    rng = np.random.default_rng(rows * 100 + gs + q)
    m = 288 if q % 2 else 33
    n = 376 if gs == 128 and q > 2 else 384
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    wt = bcq.from_uniform(w.to("cuda"), bits=q, group_size=gs)
    x = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xt = x.to("cuda", dtype)
        want = bcq_matmul_ref(xt, wt, torch.float32)
        got, routes = _routes_run(
            lambda: bcq_matmul(xt, wt, out_dtype=torch.float32))
        _close(got, want, GEMM_TOL)
        route = bcq_route(rows, dtype, gs, n)
        assert routes == {f"bcq_matmul/{route}": 1}
        assert route == (("gemv" if gs != 16 else "mma_dq")
                         if rows <= 8 else "mma")
        for mu, half in LUT_VARIANTS:
            got, routes = _routes_run(lambda: lut_gemm(
                xt, wt, mu=mu, half_lut=half, out_dtype=torch.float32))
            _close(got, want, GEMM_TOL)
            route = lut_route(rows, dtype, gs, n, mu, half)
            assert routes == {f"lut_gemm/{route}": 1}
            assert route == ("mma" if rows > 8 else "lut")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 32, 512])
def test_cuda_gemm_routes_exact(rows):
    """Integer activations, power-of-two alphas and offsets: every partial
    sum is exact in f32, so every body equals the plain version bit for
    bit."""
    require_cuda()
    rng = np.random.default_rng(rows)
    m, n, gs, q = 160, 512, 128, 3
    wt = _exact_bundle(rng, q, m, n, gs, True)
    x = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
        np.float32)).to("cuda")
    want = bcq_matmul_ref(x, wt, torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        xt = x.to(dtype)
        assert torch.equal(bcq_matmul(xt, wt, out_dtype=torch.float32), want)
        for mu, half in LUT_VARIANTS:
            assert torch.equal(lut_gemm(xt, wt, mu=mu, half_lut=half,
                                        out_dtype=torch.float32), want)


@pytest.mark.cuda
@pytest.mark.parametrize("mu,half", LUT_VARIANTS)
def test_cuda_lut_variants_exact(mu, half):
    """The LUT body at every mu and table, decode rows 1, 2, 5 and 8 (its
    1-, 2-, 4- and 8-row tables), group size 8 and 96 (a group change
    inside a lane's bytes), a ragged width (1000) and a split reduction
    axis (256 rows of 64): integer x and power-of-two alphas and offsets
    give every table entry and sum exactly, so it equals the plain
    versions (``lut_ref``, the same algorithm, and ``bcq_matmul_ref``) bit
    for bit, bf16 and f32; random inputs within 1e-3 of the output
    scale."""
    require_cuda()
    from repro_torch.kernels.lut_gemm.ops import decode_splits
    rng = np.random.default_rng(mu * 10 + half)
    m, n = 256, 1000
    for gs in (8, 96):
        we = _exact_bundle(rng, 3, m, n, gs, True)
        wr = bcq.from_uniform(torch.from_numpy(rng.normal(size=(m, n)).astype(
            np.float32)).to("cuda"), bits=3, group_size=gs)
        assert decode_splits(m, we.packed.shape[-1], _lib.sm_count(0)) > 1
        for rows in (1, 2, 5, 8):
            xe = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
                np.float32)).to("cuda")
            xr = torch.from_numpy(rng.normal(size=(rows, n)).astype(
                np.float32)).to("cuda")
            for dtype in (torch.bfloat16, torch.float32):
                xt = xe.to(dtype)
                got, routes = _routes_run(lambda: lut_gemm(
                    xt, we, mu=mu, half_lut=half, out_dtype=torch.float32))
                assert routes == {"lut_gemm/lut": 1}
                assert torch.equal(got, lut_ref(xt, we, mu=mu, half_lut=half,
                                                out_dtype=torch.float32))
                assert torch.equal(got, bcq_matmul_ref(xt, we, torch.float32))
                xt = xr.to(dtype)
                _close(lut_gemm(xt, wr, mu=mu, half_lut=half,
                                out_dtype=torch.float32),
                       lut_ref(xt, wr, mu=mu, half_lut=half,
                               out_dtype=torch.float32), GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 32, 128])
def test_cuda_gemm_split_path(rows):
    """A narrow, long weight (64 x 16384): the row tiles alone fill few
    SMs, so the reduction axis is split over blocks (the lut body's 512-
    column chunks and the decode tile's 256-column steps at decode rows,
    the mma tile's alpha groups at prefill rows) and the partials are
    added in a fixed order: a second call repeats the first exactly."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul.ops import gemv_splits, mma_splits
    from repro_torch.kernels.lut_gemm.ops import decode_splits
    rng = np.random.default_rng(rows + 7)
    m, n = 64, 16384
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    wt = bcq.from_uniform(w.to("cuda"), bits=3, group_size=128)
    sms = _lib.sm_count(0)
    splits = (decode_splits(m, n // 8, sms) if rows <= 8
              else mma_splits(rows, m, n // 128, sms))
    assert splits > 1
    xt = torch.from_numpy(rng.normal(size=(rows, n)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    want = bcq_matmul_ref(xt, wt, torch.float32)
    got, routes = _routes_run(lambda: lut_gemm(xt, wt,
                                               out_dtype=torch.float32))
    _close(got, want, GEMM_TOL)
    assert routes == {"lut_gemm/" + ("lut" if rows <= 8 else "mma"): 1}
    got, routes = _routes_run(lambda: bcq_matmul(
        xt, wt, out_dtype=torch.float32))
    _close(got, want, GEMM_TOL)
    assert routes == {"bcq_matmul/" + ("gemv" if rows <= 8 else "mma"): 1}
    if rows <= 8:
        assert gemv_splits(m, n, sms) > 1
    assert torch.equal(got, bcq_matmul(xt, wt, out_dtype=torch.float32))
    again = lut_gemm(xt, wt, out_dtype=torch.float32)
    assert torch.equal(again, lut_gemm(xt, wt, out_dtype=torch.float32))


# the tensor-core tile on f32 activations: (group size, planes) at every
# group size it takes, all widths at group size 256 (64 batch rows a
# block up to q 3 there, 32 to q 6, 16 at q 7 and 8)
F32_MMA_GROUPS = [(16, 1), (16, 3), (32, 2), (32, 4), (64, 3), (128, 3),
                  (128, 8)] + [(256, q) for q in range(1, 9)]


def _exact_bundle(rng, q, m, n, gs, z):
    """Random planes, power-of-two alphas and quarter-integer offsets (or
    none) on the card: with integer x every partial sum is exact."""
    from repro_torch.core.plane import PlaneBundle
    dev = lambda a: torch.from_numpy(a).to("cuda")
    g = -(-n // gs)
    return PlaneBundle(
        packed=dev(rng.integers(0, 256, (q, m, g * gs // 8)).astype(
            np.uint8)),
        alpha=dev((2.0 ** rng.integers(-3, 2, (q, m, g))).astype(
            np.float32)),
        z=dev((0.25 * rng.integers(-4, 5, (m, g))).astype(np.float32))
        if z else None,
        group_size=gs, in_features=n, out_features=m)


@pytest.mark.cuda
@pytest.mark.parametrize("gs,q", F32_MMA_GROUPS)
def test_cuda_mma_f32_groups(gs, q):
    """f32 activations above 8 rows on the tensor-core tile, both
    wrappers (lut_gemm at mu 2 full and mu 4 half runs the same tile:
    bit-identical to bcq_matmul): ragged M (200), ragged B (77: 64-row
    tiles, and 20: one 32-row tile) and a padded N (3 groups less 8
    columns), with and without z: 1e-3 of the output scale on random
    inputs, bit for bit on exact ones (integer x, power-of-two
    alphas)."""
    require_cuda()
    rng = np.random.default_rng(gs * 10 + q)
    m, n = 200, 3 * gs - 8
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    wt = bcq.from_uniform(w.to("cuda"), bits=q, group_size=gs)
    for rows in (77, 20):
        x = torch.from_numpy(rng.normal(size=(rows, n)).astype(
            np.float32)).to("cuda")
        got, routes = _routes_run(lambda: bcq_matmul(
            x, wt, out_dtype=torch.float32))
        assert routes == {"bcq_matmul/mma": 1}
        _close(got, bcq_matmul_ref(x, wt, torch.float32), GEMM_TOL)
        for mu, half in ((2, False), (4, True)):
            again, routes = _routes_run(lambda: lut_gemm(
                x, wt, mu=mu, half_lut=half, out_dtype=torch.float32))
            assert routes == {"lut_gemm/mma": 1}
            assert torch.equal(again, got)
        for z in (True, False):
            we = _exact_bundle(rng, q, m, n, gs, z)
            xe = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
                np.float32)).to("cuda")
            assert torch.equal(bcq_matmul(xe, we, out_dtype=torch.float32),
                               bcq_matmul_ref(xe, we, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 128])
def test_cuda_mma_f32_split_path(rows):
    """f32 activations on a narrow, long weight (64 x 16384): the tile
    splits its alpha groups over blocks as for bf16 and adds the partials
    in a fixed order: 1e-3 of the output scale against the plain version
    and against the walk's own plain version (``mma_split_ref``), a
    second call repeats the first exactly, exact inputs bit for bit."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul import mma_split_ref
    from repro_torch.kernels.bcq_matmul.ops import mma_splits
    rng = np.random.default_rng(rows + 24)
    m, n = 64, 16384
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    wt = bcq.from_uniform(w.to("cuda"), bits=3, group_size=128)
    splits = mma_splits(rows, m, n // 128, _lib.sm_count(0))
    assert splits > 1
    x = torch.from_numpy(rng.normal(size=(rows, n)).astype(
        np.float32)).to("cuda")
    got, routes = _routes_run(lambda: bcq_matmul(x, wt,
                                                 out_dtype=torch.float32))
    assert routes == {"bcq_matmul/mma": 1}
    _close(got, bcq_matmul_ref(x, wt, torch.float32), GEMM_TOL)
    _close(got, mma_split_ref(x.cpu(), wt.to("cpu"), splits,
                              torch.float32), GEMM_TOL)
    assert torch.equal(got, bcq_matmul(x, wt, out_dtype=torch.float32))
    we = _exact_bundle(rng, 3, m, n, 128, True)
    xe = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
        np.float32)).to("cuda")
    assert torch.equal(bcq_matmul(xe, we, out_dtype=torch.float32),
                       bcq_matmul_ref(xe, we, torch.float32))


# Jamba-1.5-Large's GEMMs at full width (in_proj, out_proj, q/o, k/v,
# the dense MLP, the untied head), Pixtral-12B's (q, k/v, o, the MLP, the
# untied head) and Whisper-medium's (q/k/v/o, the MLP, the untied head:
# vocab 51865 padded to 51968)
LAST_CONFIG_SHAPES = [
    (33024, 8192), (8192, 16384), (8192, 8192), (1024, 8192),
    (24576, 8192), (8192, 24576), (65536, 8192),
    (4096, 5120), (1024, 5120), (5120, 4096), (14336, 5120),
    (5120, 14336), (131072, 5120),
    (1024, 1024), (4096, 1024), (1024, 4096), (51968, 1024)]
# every OPT-6.7B, MiniCPM3-4B, Phi-4-mini-3.8B and Qwen1.5-32B decode GEMM
# [out x in] (Qwen's with its untied head), Mixtral's attention and head,
# DeepSeek-V2's kv_a and head and Mamba2's in_proj (a ragged out-tile:
# 10576 = 165 x 64 + 16), and the last three configs'
DECODE_SHAPES = [(4096, 4096), (16384, 4096), (4096, 16384), (768, 2560),
                 (3840, 768), (288, 2560), (2560, 2560), (6400, 2560),
                 (2560, 6400), (73472, 2560), (3072, 3072), (1024, 3072),
                 (8192, 3072), (3072, 8192), (5120, 5120), (27392, 5120),
                 (5120, 27392), (152064, 5120), (1024, 4096), (32000, 4096),
                 (576, 5120), (102400, 5120), (10576, 2560)] + [
                     sh for sh in LAST_CONFIG_SHAPES
                     if sh != (1024, 4096)]      # Mixtral's k/v above


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("m,n", DECODE_SHAPES)
def test_cuda_gemv_tile_decode_shapes(m, n, rows):
    """The tensor-core decode tile at every served decode shape (BCQ-3,
    g 128, bf16 activations, as the serve runs quantize them): 1e-3 of
    the output scale against the plain version, split or not by the
    rule, and a second call repeats the first exactly (fixed-order
    merge)."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul.ops import gemv_splits
    gen = torch.Generator(device="cuda").manual_seed(m + n + rows)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=3, group_size=128)
    x = torch.randn((rows, n), generator=gen,
                    device="cuda").to(torch.bfloat16)
    want = bcq_matmul_ref(x, w, torch.float32)
    got, routes = _routes_run(lambda: bcq_matmul(x, w,
                                                 out_dtype=torch.float32))
    assert routes == {"bcq_matmul/gemv": 1}
    _close(got, want, GEMM_TOL)
    assert torch.equal(got, bcq_matmul(x, w, out_dtype=torch.float32))
    splits = gemv_splits(m, n, _lib.sm_count(0))
    assert (splits == 1) == (m >= 64 * _lib.sm_count(0))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 2, 3, 4])
@pytest.mark.parametrize("gs", [32, 256])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_cuda_gemv_tile_groups(rows, gs, q):
    """The decode tile at the group sizes the served models do not use
    (32: eight groups a step, 256: one), ragged M (70) and N (520 at g 32
    and 600 at g 256: padded planes, a half-empty last step), ragged
    rows, 1-4 planes, with and without z, bf16 and f32 activations: 1e-3
    of the output scale on random inputs, bit for bit on exact ones
    (integer x, power-of-two alphas), split and unsplit."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul.ops import gemv_splits
    rng = np.random.default_rng(rows * 100 + gs + q)
    m, n = 70, (520 if gs == 32 else 600)
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    wt = bcq.from_uniform(w.to("cuda"), bits=q, group_size=gs)
    x = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))
    for dtype in (torch.bfloat16, torch.float32):
        xt = x.to("cuda", dtype)
        got, routes = _routes_run(lambda: bcq_matmul(
            xt, wt, out_dtype=torch.float32))
        assert routes == {"bcq_matmul/gemv": 1}
        _close(got, bcq_matmul_ref(xt, wt, torch.float32), GEMM_TOL)
    assert gemv_splits(m, wt.n_groups * gs, _lib.sm_count(0)) > 1
    for z in (True, False):
        we = _exact_bundle(rng, q, m, n, gs, z)
        xe = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
            np.float32)).to("cuda")
        for dtype in (torch.bfloat16, torch.float32):
            assert torch.equal(
                bcq_matmul(xe.to(dtype), we, out_dtype=torch.float32),
                bcq_matmul_ref(xe, we, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(288, 2560), (2560, 6400), (4096, 4096)])
@pytest.mark.parametrize("rows", [1, 8])
def test_cuda_gemv_f32_rows_take_the_dequantizing_tile(m, n, rows):
    """f32 activations at decode rows where the decode tile does not
    take the group size (16) run the dequantizing tile's decode stage:
    1e-3 of the output scale against the plain version and the tile's
    walk (``dq_split_ref``)."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul import dq_split_ref
    from repro_torch.kernels.bcq_matmul.ops import dq_splits
    gen = torch.Generator(device="cuda").manual_seed(m + rows)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=3, group_size=16)
    x = torch.randn((rows, n), generator=gen, device="cuda")
    got, routes = _routes_run(lambda: bcq_matmul(x, w,
                                                 out_dtype=torch.float32))
    assert routes == {"bcq_matmul/mma_dq": 1}
    _close(got, bcq_matmul_ref(x, w, torch.float32), GEMM_TOL)
    splits = dq_splits(rows, m, w.packed.shape[-1] * 8, _lib.sm_count(0))
    _close(got, dq_split_ref(x, w, splits, torch.float32), GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("m,n", DECODE_SHAPES)
def test_cuda_gemv_f32_rows_on_the_decode_tile(m, n, rows):
    """f32 activations at every served decode shape (MiniCPM3's f32 view)
    take the decode tile (x split into three bf16 parts in the kernel):
    1e-3 of the output scale (the f32 split leaves only summation order:
    1e-5 is held too), and a second call repeats the first exactly."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(m + n + rows)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=3, group_size=128)
    x = torch.randn((rows, n), generator=gen, device="cuda")
    got, routes = _routes_run(lambda: bcq_matmul(x, w,
                                                 out_dtype=torch.float32))
    assert routes == {"bcq_matmul/gemv": 1}
    _close(got, bcq_matmul_ref(x, w, torch.float32), GEMM_TOL)
    _close(got, bcq_matmul_ref(x, w, torch.float32), 1e-5)
    assert torch.equal(got, bcq_matmul(x, w, out_dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", [(8, 4), (4, 4)])
def test_cuda_paged_match_plain(h, hkv):
    require_cuda()
    dev = lambda a: torch.from_numpy(a).to("cuda")
    q, k, v, pos, tables, positions = map(dev, pool_case(0, h=h, hkv=hkv))
    got = paged_attention(q, k, v, pos, tables, positions)
    want = paged_decode_ref(q, k, v, pos, tables, positions)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=PAGED_TOL)
    q, k, v, pos, tables, positions = map(
        dev, pool_case(3, h=h, hkv=hkv, chunk=5))
    got = paged_prefill(q, k, v, pos, tables, positions)
    want = paged_prefill_ref(q, k, v, pos, tables, positions)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=PAGED_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,b", [(64, 128, 1), (96, 200, 5), (33, 136, 2),
                                   (4096, 4096, 8), (1000, 1032, 19),
                                   (512, 4096, 40)])
def test_cuda_ternary_matches_plain(m, n, b):
    """Exact inputs agree bit for bit; random ones within 1e-3.  The
    shapes cover ragged M, N (a part-full last stage) and B, every body
    (group size 8 takes the dequantizing tile at every row count), and
    both the direct and the split-sum launches."""
    require_cuda()
    rng = np.random.default_rng(m + n + b)
    g = 64 if n % 64 == 0 else 8
    w_exact = (0.5 * rng.integers(-1, 2, (m, n))).astype(np.float32)
    wt = quantize_ternary(torch.from_numpy(w_exact).to("cuda"), group_size=g)
    x = torch.from_numpy(rng.integers(-8, 9, (b, n)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xt = x.to("cuda", dtype)
        _lib.reset_launch_counts()
        got = ternary_matmul(xt, wt, out_dtype=torch.float32)
        assert _lib.launch_counts["ternary_matmul"] == 1
        want = ternary_ref(xt, wt, out_dtype=torch.float32)
        assert torch.equal(got, want)
        assert torch.equal(got, dense_ref(xt, wt, torch.float32))
    w = rng.normal(size=(m, n)).astype(np.float32)
    wt = quantize_ternary(torch.from_numpy(w).to("cuda"), group_size=g)
    xr = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xt = xr.to("cuda", dtype)
        _close(ternary_matmul(xt, wt, out_dtype=torch.float32),
               dense_ref(xt, wt, torch.float32), GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", [(8, 4), (4, 4)])
def test_cuda_paged_int8_match_plain(h, hkv):
    require_cuda()
    dev = lambda a: torch.from_numpy(a).to("cuda")
    for chunk in (0, 5):
        q, k, v, pos, tables, positions = pool_case(3 + chunk, h=h, hkv=hkv,
                                                    chunk=chunk)
        for pow2, cdt, tol in ((True, torch.float32, PAGED_TOL),
                               (False, torch.bfloat16, INT8_TOL)):
            kq, vq, ks, vs = map(dev, int8_pools(k, v, seed=chunk,
                                                 pow2=pow2))
            qd, posd, td, pd = map(dev, (q, pos, tables, positions))
            _lib.reset_launch_counts()
            if chunk:
                got = paged_prefill(qd, kq, vq, posd, td, pd, k_scale=ks,
                                    v_scale=vs, compute_dtype=cdt)
                want = paged_prefill_ref(qd, kq, vq, posd, td, pd,
                                         k_scale=ks, v_scale=vs,
                                         compute_dtype=cdt)
                assert _lib.launch_counts["paged_prefill_int8"] == 1
            else:
                got = paged_attention_int8(qd, kq, vq, ks, vs, posd, td, pd,
                                           compute_dtype=cdt)
                want = paged_decode_int8_ref(qd, kq, vq, ks, vs, posd, td,
                                             pd, compute_dtype=cdt)
                assert _lib.launch_counts["paged_decode_int8"] == 1
            _close(got, want, tol)
            if chunk:
                assert float(got[-1, -2:].abs().max()) == 0.0
            else:
                assert float(got[0].abs().max()) == 0.0


def _prefill_flavours(q, k, v, pos, tables, positions):
    """(name, kernel call, plain call, tol) for the two bf16-compute
    prefill flavours on one pool case: bf16 pools with bf16 q and output
    (the main path's types), int8 pools with f32 q and output."""
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    qb = q.to(torch.bfloat16)
    kq, vq, ks, vs = (torch.from_numpy(a).to("cuda") for a in int8_pools(
        k.cpu().numpy(), v.cpu().numpy()))
    rest = (pos, tables, positions)
    return [
        ("paged_prefill", lambda: paged_prefill(qb, kb, vb, *rest),
         lambda: paged_prefill_ref(qb, kb, vb, *rest), BF16_POOL_TOL),
        ("paged_prefill_int8",
         lambda: paged_prefill(q, kq, vq, *rest, k_scale=ks, v_scale=vs),
         lambda: paged_prefill_ref(q, kq, vq, *rest, k_scale=ks,
                                   v_scale=vs), INT8_TOL)]


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("d", [16, 64, 128, 40])
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("chunk", [1, 5, 63, 64, 65, 130])
def test_cuda_prefill_mma_matches_plain(chunk, rep, d, bs):
    """The tensor-core prefill (bf16 pools 2e-2, int8 pools in bf16 5e-2
    of the output scale) across the 64-vector query tile and the 64-slot
    K/V tile, GQA up to rep 8 (rep 3 and 6, Phi-4-mini's group and twice
    it, end a 64-row query tile inside a token), an unaligned width (40:
    plain-load staging for int8 rows), and blocks of 4 and 16 slots; pad
    rows give exactly 0; one launch per call."""
    require_cuda()
    hkv = 2
    pages = -(-(chunk + 40) // bs)
    dev = lambda a: torch.from_numpy(a).to("cuda")
    q, k, v, pos, tables, positions = map(dev, pool_case(
        chunk + rep + d + bs, b=3, h=hkv * rep, hkv=hkv, d=d,
        nb=3 * pages + 6, bs=bs, pages=pages, chunk=chunk))
    for name, kern, plain, tol in _prefill_flavours(q, k, v, pos, tables,
                                                     positions):
        _lib.reset_launch_counts()
        got = kern()
        assert _lib.launch_counts[name] == 1
        want = plain()
        assert got.dtype == want.dtype and got.shape == want.shape
        _close(got.float(), want.float(), tol)
        assert float(got[-1, -2:].abs().max()) == 0.0   # pad rows


@pytest.mark.cuda
@pytest.mark.parametrize("hkv,b,chunk", [(32, 1, 512), (8, 1, 512),
                                         (8, 3, 200)])
def test_cuda_prefill_mma_main_width(hkv, b, chunk):
    """OPT-6.7B's prefill chunk: B 1, C 512, H 32, D 128, block 16, and
    the same at 8 kv heads (GQA, rep 4: Pixtral-12B's serve shape), and
    at rep 4 a ragged B 3, C 200 whose last row ends in pads."""
    require_cuda()
    h, d, bs, pages = 32, 128, 16, 40
    dev = lambda a: torch.from_numpy(a).to("cuda")
    q, k, v, pos, tables, positions = map(dev, pool_case(
        hkv + b, b=b, h=h, hkv=hkv, d=d, nb=b * pages + 8, bs=bs,
        pages=pages, chunk=chunk))
    for name, kern, plain, tol in _prefill_flavours(q, k, v, pos, tables,
                                                     positions):
        _lib.reset_launch_counts()
        got = kern()
        assert _lib.launch_counts[name] == 1
        _close(got.float(), plain().float(), tol)


@pytest.mark.cuda
def test_cuda_prefill_mma_refuses_wide_heads():
    """bf16 compute takes head widths up to 256; wider ones raise."""
    require_cuda()
    dev = lambda a: torch.from_numpy(a).to("cuda")
    q, k, v, pos, tables, positions = map(dev, pool_case(0, d=272,
                                                          chunk=5))
    with pytest.raises(ValueError):
        paged_prefill(q, k.to(torch.bfloat16), v.to(torch.bfloat16), pos,
                      tables, positions)


@pytest.mark.cuda
@pytest.mark.parametrize("h,lora,dr,bs,dtype", [
    (8, 12, 8, 4, torch.float32), (6, 12, 8, 4, torch.float32),
    (40, 256, 32, 16, torch.bfloat16), (40, 256, 32, 16, torch.float32),
    (13, 20, 6, 5, torch.bfloat16), (128, 512, 64, 16, torch.bfloat16),
    (128, 512, 64, 16, torch.float32)])
def test_cuda_paged_mla_matches_plain(h, lora, dr, bs, dtype):
    """Ragged head counts (6, 13, 40: no power of two), unaligned widths
    (the element-copy staging), the MiniCPM3 widths, DeepSeek-V2's (128
    heads: head tiles of 40, 40, 40 and 8; lora 512: 16 context values a
    lane and head); row 0 is idle and must give zeros; a stale recycled
    block must not change the result."""
    require_cuda()
    dev = lambda a: torch.from_numpy(a).to("cuda")
    qe, qr, ckv, kr, pos, tables, positions = map(dev, mla_pool_case(
        h, b=3, h=h, lora=lora, dr=dr, bs=bs, nb=24, pages=6))
    ckv, kr = ckv.to(dtype), kr.to(dtype)
    sc = 96 ** -0.5
    _lib.reset_launch_counts()
    got = paged_attention_mla(qe, qr, ckv, kr, pos, tables, positions,
                              scale=sc)
    assert _lib.launch_counts["paged_decode_mla"] == 1
    want = paged_decode_mla_ref(qe, qr, ckv, kr, pos, tables, positions,
                                scale=sc)
    _close(got, want, PAGED_TOL)
    assert float(got[0].abs().max()) == 0.0
    # poison every slot that is not live (unused and trash blocks, the
    # recycled block's stale slots, slots past a row's position)
    dead = ~torch.from_numpy(live_slots(*(t.cpu().numpy() for t in
                                          (pos, tables, positions)))).cuda()
    c2, r2 = ckv.clone(), kr.clone()
    c2[dead], r2[dead] = 7.7, -7.7
    again = paged_attention_mla(qe, qr, c2, r2, pos, tables, positions,
                                scale=sc)
    _close(again, got, 1e-6)


def _mla_serve_case(h, dtype, b=8, pages=32, seed=0, lora=256, dr=32):
    """MiniCPM3's latent widths (lora 256, rope 32, block 16; or the
    given ones) on a 32-page table per row (max_seq_len 512), with the
    ``mla_pool_case`` layout: an idle row 0, -1 pads, a stale recycled
    block."""
    case = mla_pool_case(seed, b=b, h=h, lora=lora, dr=dr, bs=16,
                         nb=b * pages + 2, pages=pages)
    qe, qr, ckv, kr, pos, tables, positions = (torch.from_numpy(a).to("cuda")
                                               for a in case)
    return qe, qr, ckv.to(dtype), kr.to(dtype), pos, tables, positions


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 5, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h", [40, 16, 72])
def test_cuda_mla_split_counts(h, dtype, splits, monkeypatch):
    """The split-table MLA kernel at B 8 on 32-page tables with the split
    count forced from 1 (no merge) to a split per page (more splits than
    most rows have live pages): 40 heads (MiniCPM3, one block of 20
    warps), 16, and 72 (two head tiles); bf16 and f32 pools; 1e-4 of the
    output scale against the plain version, the idle row exactly 0, and
    a second call repeats the first exactly."""
    require_cuda()
    from repro_torch.kernels.paged_attention import ops as pops
    monkeypatch.setattr(pops, "mla_splits", lambda *a: splits)
    qe, qr, ckv, kr, pos, tables, positions = _mla_serve_case(h, dtype)
    sc = 96 ** -0.5
    _lib.reset_launch_counts()
    got = paged_attention_mla(qe, qr, ckv, kr, pos, tables, positions,
                              scale=sc)
    assert _lib.launch_counts["paged_decode_mla"] == 1
    want = paged_decode_mla_ref(qe, qr, ckv, kr, pos, tables, positions,
                                scale=sc)
    _close(got, want, PAGED_TOL)
    assert float(got[0].abs().max()) == 0.0
    assert torch.equal(got, paged_attention_mla(qe, qr, ckv, kr, pos, tables,
                                                positions, scale=sc))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_mla_deepseek_widths(dtype, splits, monkeypatch):
    """The MLA decode kernel at DeepSeek-V2's serve shape: B 8, 128 heads
    (four head tiles, the last of 8 heads), lora 512, rope 64, block 16,
    32-page tables, at the rule's split count and at 1 and 5 forced: 1e-4
    of the output scale against the plain version, the idle row exactly
    0, a second call repeating the first exactly."""
    require_cuda()
    from repro_torch.kernels.paged_attention import ops as pops
    assert pops.mla_heads_per_block(128) == 40
    if splits is not None:
        monkeypatch.setattr(pops, "mla_splits", lambda *a: splits)
    qe, qr, ckv, kr, pos, tables, positions = _mla_serve_case(
        128, dtype, lora=512, dr=64)
    sc = 192 ** -0.5
    _lib.reset_launch_counts()
    got = paged_attention_mla(qe, qr, ckv, kr, pos, tables, positions,
                              scale=sc)
    assert _lib.launch_counts["paged_decode_mla"] == 1
    want = paged_decode_mla_ref(qe, qr, ckv, kr, pos, tables, positions,
                                scale=sc)
    _close(got, want, PAGED_TOL)
    assert float(got[0].abs().max()) == 0.0
    assert torch.equal(got, paged_attention_mla(qe, qr, ckv, kr, pos, tables,
                                                positions, scale=sc))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_operands():
    require_cuda()
    w = bcq.from_uniform(torch.randn(16, 64, device="cuda"), bits=2,
                         group_size=32)
    with pytest.raises(TypeError):
        bcq_matmul(torch.ones(2, 64, device="cuda", dtype=torch.float16), w)
    with pytest.raises(ValueError):
        lut_gemm(torch.ones(2, 64, device="cuda"), w, mu=3)
    t = quantize_ternary(torch.randn(16, 64, device="cuda"), group_size=32)
    with pytest.raises(ValueError):
        ternary_matmul(torch.ones(2, 64, device="cuda"), t, mu=2)
    with pytest.raises(ValueError):
        bcq_matmul(torch.ones(2, 64, device="cuda"), t)
    qe, qr, ckv, kr, pos, tables, positions = (
        torch.from_numpy(a).to("cuda") for a in mla_pool_case(0))
    with pytest.raises(TypeError):          # q_eff is never rounded
        paged_attention_mla(qe.to(torch.bfloat16), qr, ckv, kr, pos, tables,
                            positions, scale=0.1)
    with pytest.raises(ValueError):
        paged_attention_mla(qe, qr, ckv[..., :-1], kr, pos, tables,
                            positions, scale=0.1)


# ---------------------------------------------------------------------------
# ternary_matmul's tensor-core route
# ---------------------------------------------------------------------------


def _ternary_pair(rng, m, n, gs):
    """(exact weight bundle, random weight bundle) on the card: 0.5 *
    {-1, 0, +1} (alpha 0.5, every product exact) and a normal weight."""
    w_exact = (0.5 * rng.integers(-1, 2, (m, n))).astype(np.float32)
    w_rand = rng.normal(size=(m, n)).astype(np.float32)
    return tuple(quantize_ternary(torch.from_numpy(w).to("cuda"),
                                  group_size=gs) for w in (w_exact, w_rand))


@pytest.mark.cuda
@pytest.mark.parametrize("gs", [16, 64, 128])
@pytest.mark.parametrize("rows", [9, 32, 128, 512])
def test_cuda_ternary_mma_matches_plain(rows, gs):
    """bf16 activations above 8 rows take the tensor-core route: bit for
    bit on exact inputs (integer x, alpha 0.5) against both plain
    versions and the route's own arithmetic, 1e-3 of the output scale on
    random inputs; ragged M (33, 288), ragged N (376 at gs 128: padded
    planes) and ragged B (9).  f32 activations at the same rows take the
    same route (x split into three bf16 parts): bit for bit on exact
    inputs, 1e-3 on random ones.  The route counters show which body
    ran."""
    require_cuda()
    from repro_torch.kernels.ternary_matmul import route_for
    rng = np.random.default_rng(rows * 10 + gs)
    m = 33 if gs == 64 else 288
    n = 376 if gs == 128 else 384
    we, wr = _ternary_pair(rng, m, n, gs)
    xe = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
        np.float32)).to("cuda")
    xr = torch.from_numpy(rng.normal(size=(rows, n)).astype(
        np.float32)).to("cuda")
    assert route_for(rows, torch.bfloat16, gs, n) == "mma"
    xb = xe.to(torch.bfloat16)
    got, routes = _routes_run(
        lambda: ternary_matmul(xb, we, out_dtype=torch.float32))
    assert routes == {"ternary_matmul/mma": 1}
    assert torch.equal(got, ternary_ref(xb, we, out_dtype=torch.float32))
    assert torch.equal(got, dense_ref(xb, we, torch.float32))
    assert torch.equal(got, ternary_planes_ref(xb, we, torch.float32))
    xb = xr.to(torch.bfloat16)
    got, routes = _routes_run(
        lambda: ternary_matmul(xb, wr, out_dtype=torch.float32))
    assert routes == {"ternary_matmul/mma": 1}
    _close(got, dense_ref(xb, wr, torch.float32), GEMM_TOL)
    assert route_for(rows, torch.float32, gs, n) == "mma"
    got, routes = _routes_run(
        lambda: ternary_matmul(xe, we, out_dtype=torch.float32))
    assert routes == {"ternary_matmul/mma": 1}
    assert torch.equal(got, dense_ref(xe, we, torch.float32))
    assert torch.equal(got, ternary_planes_ref(xe, we, torch.float32))
    got, routes = _routes_run(
        lambda: ternary_matmul(xr, wr, out_dtype=torch.float32))
    assert routes == {"ternary_matmul/mma": 1}
    _close(got, dense_ref(xr, wr, torch.float32), GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,rows", [(64, 16384, 32), (64, 16384, 128),
                                      (2112, 1024, 512)])
def test_cuda_ternary_mma_split_path(m, n, rows):
    """A narrow, long weight (64 x 16384) splits its alpha groups over
    blocks and adds the partials in a fixed order; 2112 rows at 512
    batch rows fill every SM without a split.  Exact inputs agree bit
    for bit either way, and a second call repeats the first exactly."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul.ops import mma_splits
    rng = np.random.default_rng(m + rows)
    we, wr = _ternary_pair(rng, m, n, 128)
    splits = mma_splits(rows, m, n // 128, _lib.sm_count(0))
    assert (splits > 1) == (m == 64)
    xe = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    got, routes = _routes_run(
        lambda: ternary_matmul(xe, we, out_dtype=torch.float32))
    assert routes == {"ternary_matmul/mma": 1}
    assert torch.equal(got, dense_ref(xe, we, torch.float32))
    xr = torch.from_numpy(rng.normal(size=(rows, n)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    got = ternary_matmul(xr, wr, out_dtype=torch.float32)
    _close(got, dense_ref(xr, wr, torch.float32), GEMM_TOL)
    assert torch.equal(got, ternary_matmul(xr, wr, out_dtype=torch.float32))
    # f32 activations on the same route and splits
    xf = xr.float() + 1e-3 * torch.randn(xr.shape, device="cuda")
    got, routes = _routes_run(
        lambda: ternary_matmul(xf, wr, out_dtype=torch.float32))
    assert routes == {"ternary_matmul/mma": 1}
    _close(got, dense_ref(xf, wr, torch.float32), GEMM_TOL)
    assert torch.equal(got, ternary_matmul(xf, wr, out_dtype=torch.float32))
    xe = xe.float()
    assert torch.equal(ternary_matmul(xe, we, out_dtype=torch.float32),
                       dense_ref(xe, we, torch.float32))


# ---------------------------------------------------------------------------
# the split-table decode kernel (float and int8 pools)
# ---------------------------------------------------------------------------


def _decode_case(seed, *, b, hkv, rep, d, bs, pages):
    """``pool_case`` with a hole: row 1's second table entry set to -1
    (its slots are dead, the rest of the row still counts), besides the
    -1 pads, the recycled block with stale positions and the idle row 0."""
    q, k, v, pos, tables, positions = pool_case(
        seed, b=b, h=hkv * rep, hkv=hkv, d=d, nb=b * pages + 6, bs=bs,
        pages=pages)
    if b > 1 and (tables[1] >= 0).sum() >= 3:
        tables[1, 1] = -1
    return q, k, v, pos, tables, positions


def _decode_flavours(q, k, v, pos, tables, positions):
    """(name, kernel call, plain call, tol, poisonable) for each pool
    flavour and compute type of the decode kernel on one case."""
    dev = lambda a: torch.from_numpy(a).to("cuda")
    qd, kd, vd = dev(q), dev(k), dev(v)
    rest = tuple(map(dev, (pos, tables, positions)))
    kb, vb, qb = kd.to(torch.bfloat16), vd.to(torch.bfloat16), \
        qd.to(torch.bfloat16)
    out = [("paged_decode", lambda kk, vv: paged_attention(qd, kk, vv, *rest),
            lambda kk, vv: paged_decode_ref(qd, kk, vv, *rest), PAGED_TOL,
            (kd, vd)),
           ("paged_decode", lambda kk, vv: paged_attention(qb, kk, vv, *rest),
            lambda kk, vv: paged_decode_ref(qb, kk, vv, *rest),
            BF16_POOL_TOL, (kb, vb))]
    for pow2, cdt, tol in ((True, torch.float32, PAGED_TOL),
                           (False, torch.bfloat16, INT8_TOL)):
        kq, vq, ks, vs = map(dev, int8_pools(k, v, seed=3, pow2=pow2))
        out.append((
            "paged_decode_int8",
            lambda kk, vv, ks=ks, vs=vs, cdt=cdt: paged_attention_int8(
                qd, kk, vv, ks, vs, *rest, compute_dtype=cdt),
            lambda kk, vv, ks=ks, vs=vs, cdt=cdt: paged_decode_int8_ref(
                qd, kk, vv, ks, vs, *rest, compute_dtype=cdt), tol,
            (kq, vq)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 6, 8])
def test_cuda_decode_matches_plain(rep, d, bs):
    """The split-table decode on float pools (f32 1e-4, bf16 2e-2) and
    int8 pools (f32 compute with power-of-two scales 1e-4, bf16 compute
    5e-2), GQA up to rep 8 (rep 3 and 6 fill part of a head block of 4
    or 8: the spare head slots read no q and write nothing), blocks of 4
    and 16 slots, 200-slot tables (13 tiles, split over several blocks),
    a -1 hole, -1 pads, a stale recycled block; the idle row gives
    exactly 0, one launch per call, and a second call repeats the first
    exactly.  Every dead slot's K and V (stale, past a row's position, in
    no table) poisoned with NaN (or int8 extremes) leaves the output
    unchanged."""
    require_cuda()
    from repro_torch.kernels.paged_attention.ops import decode_splits
    b, hkv, pages = 3, 2, -(-200 // bs)
    case = _decode_case(rep * 100 + d + bs, b=b, hkv=hkv, rep=rep, d=d,
                        bs=bs, pages=pages)
    assert decode_splits(b, hkv, rep, pages, bs, _lib.sm_count(0)) > 1
    dead = ~torch.from_numpy(live_slots(case[3], case[4],
                                        case[5])).to("cuda")
    for name, kern, plain, tol, (kk, vv) in _decode_flavours(*case):
        _lib.reset_launch_counts()
        got = kern(kk, vv)
        assert _lib.launch_counts[name] == 1
        _close(got.float(), plain(kk, vv).float(), tol)
        assert float(got[0].abs().max()) == 0.0
        assert torch.equal(got, kern(kk, vv))
        k2, v2 = kk.clone(), vv.clone()
        poison = float("nan") if kk.dtype != torch.int8 else 127
        k2[dead], v2[dead] = poison, -poison if poison == 127 else poison
        assert torch.equal(kern(k2, v2), got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hkv,pages,long", [(8, 32, 32, False),
                                              (8, 8, 32, False),
                                              (8, 32, 32, True),
                                              (8, 8, 32, True),
                                              (33, 32, 8, False)])
def test_cuda_decode_main_width(b, hkv, pages, long):
    """OPT-6.7B's decode: H 32, D 128, block 16, B 8, MHA and 8 kv heads
    (GQA, rep 4: Pixtral-12B's serve shape); every row near max_seq_len
    512 (long tables), MHA and rep 4; and B 33, whose 1,056 (row, head)
    blocks fill the card without a split (the direct-write path)."""
    require_cuda()
    from repro_torch.kernels.paged_attention.ops import decode_splits
    h, d, bs = 32, 128, 16
    nb = b * pages + 8
    q, k, v, pos, tables, positions = pool_case(
        b + hkv, b=b, h=h, hkv=hkv, d=d, nb=nb, bs=bs, pages=pages)
    if long:                    # every row holds all its pages, ends near 512
        rng = np.random.default_rng(b + hkv)
        tables = rng.permutation(np.arange(1, nb))[:b * pages].reshape(
            b, pages).astype(np.int32)
        pos = np.full((nb, bs), -1, np.int32)
        for j in range(pages):
            pos[tables[:, j]] = j * bs + np.arange(bs)
        positions = (pages * bs - 1 - np.arange(b) % 5).astype(np.int32)
    splits = decode_splits(b, hkv, h // hkv, pages, bs, _lib.sm_count(0))
    assert (splits == 1) == (b == 33)
    for name, kern, plain, tol, (kk, vv) in _decode_flavours(
            q, k, v, pos, tables, positions):
        _lib.reset_launch_counts()
        got = kern(kk, vv)
        assert _lib.launch_counts[name] == 1
        _close(got.float(), plain(kk, vv).float(), tol)


@pytest.mark.cuda
def test_cuda_decode_refuses_unsupported_heads():
    """The decode kernel takes head widths that are multiples of 16 up to
    256; others raise."""
    require_cuda()
    for d in (24, 264):
        q, k, v, pos, tables, positions = (
            torch.from_numpy(a).to("cuda") for a in pool_case(0, d=d))
        with pytest.raises(ValueError):
            paged_attention(q, k, v, pos, tables, positions)


# ---------------------------------------------------------------------------
# ternary_matmul's decode rows on the tensor-core decode tile
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("m,n", [(4096, 4096), (16384, 4096),
                                 (4096, 16384)])
def test_cuda_ternary_gemv_opt_shapes(m, n, rows):
    """OPT-6.7B's decode GEMMs with ternary weights (g 128), bf16 and f32
    activations, on the decode tile: 1e-3 of the output scale, a second
    call repeats the first exactly (split or not)."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(m + n + rows)
    w = quantize_ternary(torch.randn((m, n), generator=gen, device="cuda")
                         * 0.02, group_size=128)
    x = torch.randn((rows, n), generator=gen, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        xt = x.to(dtype)
        got, routes = _routes_run(lambda: ternary_matmul(
            xt, w, out_dtype=torch.float32))
        assert routes == {"ternary_matmul/gemv": 1}
        _close(got, dense_ref(xt, w, torch.float32), GEMM_TOL)
        assert torch.equal(got, ternary_matmul(xt, w,
                                               out_dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("m,n,gs", [(4096, 4096, 128), (70, 600, 32),
                                    (33, 520, 64), (130, 1024, 256)])
def test_cuda_ternary_gemv_exact(m, n, gs, rows):
    """Exact inputs (integer x, alpha 0.5) on the decode tile equal every
    plain version bit for bit, bf16 and f32 activations: [4096 x 4096]
    splits its steps (64 row tiles are fewer than the SMs), the others
    are ragged (M 70 / 33 / 130, N 600 / 520: padded planes, a part-full
    last step); random inputs within 1e-3 of the output scale."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul.ops import gemv_splits
    rng = np.random.default_rng(m + n + gs + rows)
    we, wr = _ternary_pair(rng, m, n, gs)
    if (m, n) == (4096, 4096):
        assert gemv_splits(m, n, _lib.sm_count(0)) > 1
    xe = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
        np.float32)).to("cuda")
    xr = torch.from_numpy(rng.normal(size=(rows, n)).astype(
        np.float32)).to("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        xt = xe.to(dtype)
        got, routes = _routes_run(
            lambda: ternary_matmul(xt, we, out_dtype=torch.float32))
        assert routes == {"ternary_matmul/gemv": 1}
        assert torch.equal(got, ternary_ref(xt, we, out_dtype=torch.float32))
        assert torch.equal(got, dense_ref(xt, we, torch.float32))
        assert torch.equal(got, ternary_masked_ref(xt, we, torch.float32))
        xt = xr.to(dtype)
        got = ternary_matmul(xt, wr, out_dtype=torch.float32)
        _close(got, dense_ref(xt, wr, torch.float32), GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,gs", [(4096, 4096, 8), (300, 1032, 24),
                                    (300, 1032, 16), (300, 4092, 128)])
def test_cuda_ternary_lut_keeps_other_decode_rows(m, n, gs):
    """Decode rows the decode tile does not take (group sizes 8, 16, 24;
    an input width that is not a multiple of 8), which the half-LUT body
    took before, run the dequantizing tile: bit for bit on exact inputs
    against the half-LUT plain version and the tile's own walk, bf16 and
    f32."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul import dq_split_ref
    from repro_torch.kernels.bcq_matmul.ops import dq_splits
    rng = np.random.default_rng(m + gs)
    we, _ = _ternary_pair(rng, m, n, gs)
    xe = torch.from_numpy(rng.integers(-8, 9, (8, n)).astype(
        np.float32)).to("cuda")
    splits = dq_splits(8, m, we.packed.shape[-1] * 8, _lib.sm_count(0))
    for dtype in (torch.bfloat16, torch.float32):
        xt = xe.to(dtype)
        got, routes = _routes_run(
            lambda: ternary_matmul(xt, we, out_dtype=torch.float32))
        assert routes == {"ternary_matmul/mma_dq": 1}
        assert torch.equal(got, ternary_ref(xt, we, out_dtype=torch.float32))
        assert torch.equal(got, dq_split_ref(xt, we, splits, torch.float32))


# ---------------------------------------------------------------------------
# the dequantizing tile (route mma_dq of bcq_matmul and ternary_matmul)
# ---------------------------------------------------------------------------


def _dq_width(gs, q):
    """An input width for a dequantizing-tile case: aligned (16-byte x
    rows, plane rows and scale runs) for odd q, ragged (in_features 1004:
    8-byte bf16 rows, byte-wide plane copies at gs 8, single-value scale
    copies) for even q."""
    if q % 2:
        return 1024 if gs == 8 else 3 * gs
    return 1004


@pytest.mark.cuda
@pytest.mark.parametrize("q", list(range(1, 9)))
@pytest.mark.parametrize("gs", [8, 512])
def test_cuda_mma_dq_bcq(gs, q):
    """bcq_matmul at group sizes neither tile takes (8, 512), q 1-8,
    ragged M (200) and B (77: 64-row tiles, 20: one 32-row tile, 9; 8
    and 3: the decode stage), aligned and ragged input widths, with z at
    odd q and without at even: 1e-3 of the output scale against the
    plain version and the tile's walk (``dq_split_ref``), bf16 and f32;
    bit for bit on exact inputs (integer x, power-of-two alphas,
    quarter-integer offsets).  lut_gemm above 8 rows takes the same tile
    at these shapes (mu 2, full table)."""
    require_cuda()
    from repro_torch.core.plane import PlaneBundle
    from repro_torch.kernels.bcq_matmul import dq_split_ref
    from repro_torch.kernels.bcq_matmul.ops import dq_splits
    rng = np.random.default_rng(gs * 10 + q)
    m, n = 200, _dq_width(gs, q)
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    wt = bcq.from_uniform(w.to("cuda"), bits=q, group_size=gs)
    if q % 2 == 0:
        wt = PlaneBundle(packed=wt.packed, alpha=wt.alpha, z=None,
                         group_size=gs, in_features=n, out_features=m)
    we = _exact_bundle(rng, q, m, n, gs, q % 2 == 1)
    for rows in (77, 20, 9, 8, 3):
        splits = dq_splits(rows, m, wt.packed.shape[-1] * 8,
                           _lib.sm_count(0))
        x = torch.from_numpy(rng.normal(size=(rows, n)).astype(
            np.float32)).to("cuda")
        xe = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
            np.float32)).to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            xt = x.to(dtype)
            got, routes = _routes_run(lambda: bcq_matmul(
                xt, wt, out_dtype=torch.float32))
            assert routes == {"bcq_matmul/mma_dq": 1}
            _close(got, bcq_matmul_ref(xt, wt, torch.float32), GEMM_TOL)
            _close(got, dq_split_ref(xt, wt, splits, torch.float32),
                   GEMM_TOL)
            if rows > 8:
                got, routes = _routes_run(lambda: lut_gemm(
                    xt, wt, mu=2, half_lut=False, out_dtype=torch.float32))
                assert routes == {"lut_gemm/mma_dq": 1}
                _close(got, dq_split_ref(xt, wt, splits, torch.float32),
                       GEMM_TOL)
            xt = xe.to(dtype)
            assert torch.equal(bcq_matmul(xt, we, out_dtype=torch.float32),
                               bcq_matmul_ref(xt, we, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 9, 77, 512])
@pytest.mark.parametrize("m,n,gs", [(200, 1004, 8), (130, 1100, 512),
                                    (300, 4092, 24), (4096, 4096, 8)])
def test_cuda_ternary_mma_dq(m, n, gs, rows):
    """ternary_matmul at group sizes and widths neither the decode tile
    nor the tensor-core tile takes, at decode and prefill rows: 0 error on
    exact inputs (integer x, alpha 0.5) against the half-LUT plain
    version, the dense product and the tile's walk; 1e-3 of the output
    scale on random ones; bf16 and f32; ragged M, N and B, and [4096 x
    4096] at 8 rows splits its stages."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul import dq_split_ref
    from repro_torch.kernels.bcq_matmul.ops import dq_splits
    rng = np.random.default_rng(m + n + gs + rows)
    we, wr = _ternary_pair(rng, m, n, gs)
    splits = dq_splits(rows, m, we.packed.shape[-1] * 8, _lib.sm_count(0))
    if (m, rows) == (4096, 8):
        assert splits > 1
    xe = torch.from_numpy(rng.integers(-8, 9, (rows, n)).astype(
        np.float32)).to("cuda")
    xr = torch.from_numpy(rng.normal(size=(rows, n)).astype(
        np.float32)).to("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        xt = xe.to(dtype)
        got, routes = _routes_run(
            lambda: ternary_matmul(xt, we, out_dtype=torch.float32))
        assert routes == {"ternary_matmul/mma_dq": 1}
        assert torch.equal(got, ternary_ref(xt, we, out_dtype=torch.float32))
        assert torch.equal(got, dense_ref(xt, we, torch.float32))
        assert torch.equal(got, dq_split_ref(xt, we, splits, torch.float32))
        xt = xr.to(dtype)
        got = ternary_matmul(xt, wr, out_dtype=torch.float32)
        _close(got, dense_ref(xt, wr, torch.float32), GEMM_TOL)
        _close(got, dq_split_ref(xt, wr, splits, torch.float32), GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 32])
def test_cuda_mma_dq_split_path(rows):
    """A narrow, long weight (64 x 16384, g 8): the output tiles alone
    fill few SMs, so the dequantizing tile splits its stages (64 columns,
    512 at 8 rows) over blocks and adds the partials in a fixed order:
    1e-3 of the output scale against the plain version and the walk at
    that split, a second call repeats the first exactly (ternary and
    bcq_matmul at rows 8 and 32)."""
    require_cuda()
    from repro_torch.kernels.bcq_matmul import dq_split_ref
    from repro_torch.kernels.bcq_matmul.ops import dq_splits
    rng = np.random.default_rng(rows + 31)
    m, n = 64, 16384
    splits = dq_splits(rows, m, n, _lib.sm_count(0))
    assert splits > 1
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    cases = [("ternary_matmul", quantize_ternary(w.to("cuda"), group_size=8),
              ternary_matmul),
             ("bcq_matmul", bcq.from_uniform(w.to("cuda"), bits=3,
                                             group_size=8), bcq_matmul)]
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.normal(size=(rows, n)).astype(
            np.float32)).to("cuda", dtype)
        for name, wt, fn in cases:
            got, routes = _routes_run(lambda: fn(x, wt,
                                                 out_dtype=torch.float32))
            assert routes == {f"{name}/mma_dq": 1}
            _close(got, bcq_matmul_ref(x, wt, torch.float32)
                   if name == "bcq_matmul" else dense_ref(x, wt,
                                                          torch.float32),
                   GEMM_TOL)
            _close(got, dq_split_ref(x, wt, splits, torch.float32),
                   GEMM_TOL)
            assert torch.equal(got, fn(x, wt, out_dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 512])
@pytest.mark.parametrize("m,n", [(4096, 4096), (16384, 4096), (4096, 16384)])
@pytest.mark.parametrize("q", [2, 4])
def test_cuda_gemm_widths_opt_shapes(q, m, n, rows):
    """bcq_matmul and lut_gemm at q 2 and q 4 (the widths a mixed-precision
    plan puts beside q 3) at OPT's shapes, BCQ g 128 on bf16 activations
    as the serve quantizes them: the decode tile (``gemv``) / LUT body at
    rows 1 and 8, the tensor-core tile (``mma``) at rows 512, each 1e-3
    of the output scale."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(q * 7 + m + rows)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=q, group_size=128)
    assert w.bits == q
    x = torch.randn((rows, n), generator=gen,
                    device="cuda").to(torch.bfloat16)
    want = bcq_matmul_ref(x, w, torch.float32)
    for name, fn, route in (
            ("bcq_matmul", bcq_matmul, "gemv" if rows <= 8 else "mma"),
            ("lut_gemm", lut_gemm, "lut" if rows <= 8 else "mma")):
        got, routes = _routes_run(lambda: fn(x, w, out_dtype=torch.float32))
        assert routes == {f"{name}/{route}": 1}
        _close(got, want, GEMM_TOL)


def _mixed_reduced_model(dtype, bits):
    """A reduced OPT (scan-stacked leaves, g 32) on the card, quantized at
    a mixed plan holding q 2, 3 and 4 and ternary leaves (overrides pin
    q 4 and ternary where the probe would not put them)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.quant import QuantSpec, quantize_model
    cfg = get_reduced("opt_6_7b").replace(scan_layers=True, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    model = Model(cfg, device="cuda", dtype=dt).init_params(gen)
    spec = QuantSpec(bits=bits, group_size=32, iters=2,
                     overrides={"stack/scan/0/mixer/k": 1.585,
                                "stack/scan/0/mixer/q": 4})
    man = quantize_model(model, spec)
    widths = {(l["format"], l["plane_bits"]) for l in man.layers}
    assert ("ternary", 2) in widths and ("bcq", 4) in widths
    assert len(widths) >= 3, widths
    kern = model.with_config(quant=spec, paged_kernel="fused")
    plain = model.with_config(quant=spec.replace(backend="dense"),
                              paged_kernel="gather")
    return kern, plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", GEMM_TOL),
                                       ("bfloat16", BF16_POOL_TOL)])
@pytest.mark.parametrize("bits", [2.4, 1.8])
def test_cuda_mixed_model_kernel_path_matches_plain(bits, dtype, tol):
    """A reduced mixed-precision model on the card: kernel-path logits of a
    prefill chunk (rows > 8) and of two decode steps (rows 3) against the
    plain path (dequantize and matmul, gathered attention) within 1e-3 of
    the logit scale in f32 and 2e-2 in bf16 (the residual stream is
    rounded to bf16 after every linear).  The decode steps run bcq_matmul
    and ternary_matmul on the decode tile; bf16 prefill runs both on the
    tensor-core tile."""
    require_cuda()
    from repro_torch.models import set_block_tables
    kern, plain = _mixed_reduced_model(dtype, bits)
    rng = np.random.default_rng(int(bits * 10))
    toks = torch.from_numpy(rng.integers(0, 256, (3, 12)).astype(
        np.int32)).to("cuda")
    table = np.array([[3, 7, 1, 9], [2, 11, 5, 8], [4, 6, 10, 12]],
                     np.int32)
    outs, routes = [], []
    for m in (kern, plain):
        c = set_block_tables(m.init_paged_cache(3, 16, 8, 4), table)
        _lib.reset_launch_counts()
        lp, c = m.prefill_chunk(toks, c, 0, 11)
        pre = dict(_lib.route_counts)
        _lib.reset_launch_counts()
        ld1, c = m.decode_step(toks[:, :1], c, 12)
        ld2, c = m.decode_step(toks[:, 1:2], c, 13)
        torch.cuda.synchronize()
        outs.append((lp, ld1, ld2))
        routes.append((pre, dict(_lib.route_counts)))
    for got, want in zip(outs[0], outs[1]):
        assert torch.isfinite(got).all()
        _close(got, want, tol)
    pre, dec = routes[0]
    assert routes[1] == ({}, {})                    # the plain path
    assert set(dec) == {"bcq_matmul/gemv", "ternary_matmul/gemv"}
    assert sum(dec.values()) == 2 * 12              # 2 steps x 12 linears
    assert sum(pre.values()) == 12
    if dtype == "bfloat16":
        assert set(pre) == {"bcq_matmul/mma", "ternary_matmul/mma"}


@pytest.mark.cuda
def test_cuda_phi4_engines_agree():
    """Phi-4-mini at full width and 2 of its 32 layers, BCQ-3 (g 128) in
    f32 on the card: the paged engine (fused paged decode and chunked
    prefill at GQA rep 3, the GEMM kernels) and the slots engine (plain
    attention over the contiguous cache, the same GEMM kernels) give
    identical greedy tokens; both run their decode linears on the decode
    tile."""
    require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant import QuantSpec, quantize_model
    from repro_torch.serve import PagedServeEngine, Request, ServeEngine
    cfg = get_config("phi4_mini_3_8b").replace(n_layers=2, dtype="float32",
                                               max_seq_len=256)
    gen = torch.Generator(device="cuda").manual_seed(3)
    model = Model(cfg, device="cuda", dtype=torch.float32).init_params(gen)
    spec = QuantSpec(format="bcq", bits=3, group_size=128)
    quantize_model(model, spec)
    model = model.with_config(quant=spec, paged_kernel="fused")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (9, 40, 23)]
    outs, counts = [], []
    for eng in (PagedServeEngine(model, num_blocks=32, block_size=16,
                                 max_batch=3, max_seq_len=256,
                                 prefill_buckets=(16, 32, 64)),
                ServeEngine(model, slots=3, cache_len=256,
                            prefill_buckets=(16, 32, 64))):
        _lib.reset_launch_counts()
        done = eng.run([Request(uid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(prompts)], max_ticks=200)
        torch.cuda.synchronize()
        outs.append({r.uid: list(r.out_tokens) for r in done})
        counts.append(dict(_lib.launch_counts))
        assert _lib.route_counts.get("bcq_matmul/gemv", 0) > 0
    paged, slots = counts
    assert paged["paged_decode"] > 0 and paged["paged_prefill"] > 0
    assert slots["paged_decode"] == slots["paged_prefill"] == 0
    assert slots["bcq_matmul"] > 0
    assert outs[0] == outs[1]
    assert all(len(v) == 8 for v in outs[0].values())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(4096, 4096), (1024, 4096)])
def test_cuda_mma_mixtral_prefill_shapes(m, n):
    """Mixtral-8x7B's attention GEMMs at the 512-row prefill bucket (BCQ-3,
    g 128, bf16 activations) on the tensor-core tile: 1e-3 of the output
    scale against the plain version."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(m + n)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=3, group_size=128)
    x = torch.randn((512, n), generator=gen,
                    device="cuda").to(torch.bfloat16)
    got, routes = _routes_run(lambda: bcq_matmul(x, w,
                                                 out_dtype=torch.float32))
    assert routes == {"bcq_matmul/mma": 1}
    _close(got, bcq_matmul_ref(x, w, torch.float32), GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(10576, 2560), (576, 5120),
                                 (102400, 5120)])
def test_cuda_mma_deepseek_mamba_prefill_shapes(m, n):
    """Mamba2's in_proj (a ragged out-tile), DeepSeek-V2's kv_a and its
    head at the 512-row prefill bucket (BCQ-3, g 128, bf16 activations)
    on the tensor-core tile: 1e-3 of the output scale against the plain
    version."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(m + n)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=3, group_size=128)
    x = torch.randn((512, n), generator=gen,
                    device="cuda").to(torch.bfloat16)
    got, routes = _routes_run(lambda: bcq_matmul(x, w,
                                                 out_dtype=torch.float32))
    assert routes == {"bcq_matmul/mma": 1}
    _close(got, bcq_matmul_ref(x, w, torch.float32), GEMM_TOL)


@pytest.mark.cuda
def test_cuda_mixtral_slots_serve_matches_plain():
    """Reduced-width Mixtral (2 layers, window 32, 4 experts top-2), BCQ-3
    g 32 in f32 (expert banks dequantized to f32) on the card through the
    slots engine (ring of 32 under cache_len 80): a prompt past the
    window and decode past the wrap.
    The kernel path's prefill and decode logits within 1e-3 of the logit
    scale of the plain path (dequantize and matmul), its decode steps'
    linears (2 x q/k/v/o + the head) on the decode tile, and the two
    paths' greedy streams identical."""
    require_cuda()
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.quant import QuantSpec, quantize_model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_reduced("mixtral_8x7b").replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(21)
    model = Model(cfg, device="cuda", dtype=torch.float32).init_params(gen)
    spec = QuantSpec(format="bcq", bits=3, group_size=32)
    quantize_model(model, spec)
    for blk in model.stack.layers:
        # f32 expert banks: with bf16 ones (the served rounding) an f32
        # summation-order difference can reroute tokens
        blk.mlp.bank_dtype = torch.float32
    kern = model.with_config(quant=spec)
    plain = model.with_config(quant=spec.replace(backend="dense"))
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, 256, 40)
    toks = np.zeros((1, 48), np.int64)
    toks[0, -40:] = prompt
    outs, routes = [], []
    for m in (kern, plain):
        logits = []
        _lib.reset_launch_counts()
        lg, c = m.prefill(torch.as_tensor(toks, device="cuda"),
                          m.init_cache(1, 80), -8)
        logits.append(lg)
        step = {}
        for t in range(40, 44):
            _lib.reset_launch_counts()
            lg, c = m.decode_step(torch.as_tensor([[int(prompt[t - 40])]],
                                                  device="cuda"), c, t)
            torch.cuda.synchronize()
            logits.append(lg)
            step = dict(_lib.route_counts)
        outs.append(logits)
        routes.append(step)
    for got, want in zip(*outs):
        assert torch.isfinite(got).all()
        _close(got, want, GEMM_TOL)
    assert routes[0] == {"bcq_matmul/gemv": 2 * 4 + 1}
    assert routes[1] == {}
    streams = []
    for m in (kern, plain):
        done = ServeEngine(m, slots=2, cache_len=80,
                           prefill_buckets=(16, 32)).run(
            [Request(uid=i, prompt=p, max_new_tokens=24)
             for i, p in enumerate([prompt, prompt[:9]])], max_ticks=200)
        streams.append({r.uid: list(r.out_tokens) for r in done})
    assert streams[0] == streams[1]
    assert all(len(v) == 24 for v in streams[0].values())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", LAST_CONFIG_SHAPES)
def test_cuda_mma_last_configs_prefill_shapes(m, n):
    """Jamba-1.5-Large's, Pixtral-12B's and Whisper-medium's GEMMs (heads
    included) at the 512-row prefill bucket (BCQ-3, g 128, bf16
    activations) on the tensor-core tile: 1e-3 of the output scale
    against the plain version."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(m + n)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=3, group_size=128)
    x = torch.randn((512, n), generator=gen,
                    device="cuda").to(torch.bfloat16)
    got, routes = _routes_run(lambda: bcq_matmul(x, w,
                                                 out_dtype=torch.float32))
    assert routes == {"bcq_matmul/mma": 1}
    _close(got, bcq_matmul_ref(x, w, torch.float32), GEMM_TOL)


# the row counts the full-width runs give the tensor-core tile: Whisper's
# encoder and cross k/v (8 x 1500 frames) and its 4-token decoder prompt
# (8 x 4), Pixtral's VLM prefill (8 x (1024 patches + 76 tokens))
SERVED_PREFILL_CASES = (
    [(sh, rows) for sh in ((1024, 1024), (4096, 1024), (1024, 4096))
     for rows in (32, 12000)]
    + [(sh, 8800) for sh in ((4096, 5120), (1024, 5120), (5120, 4096),
                             (14336, 5120), (5120, 14336))])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", SERVED_PREFILL_CASES)
def test_cuda_mma_served_prefill_rows(shape, rows):
    """Whisper-medium's and Pixtral-12B's layer GEMMs at the row counts
    their full-width prefills run (BCQ-3, g 128, bf16 activations) on the
    tensor-core tile, split or not by the rule: 1e-3 of the output scale
    against the plain version."""
    require_cuda()
    m, n = shape
    gen = torch.Generator(device="cuda").manual_seed(m + n + rows)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=3, group_size=128)
    x = torch.randn((rows, n), generator=gen,
                    device="cuda").to(torch.bfloat16)
    got, routes = _routes_run(lambda: bcq_matmul(x, w,
                                                 out_dtype=torch.float32))
    assert routes == {"bcq_matmul/mma": 1}
    _close(got, bcq_matmul_ref(x, w, torch.float32), GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", [((4096, 1024), 12000),
                                        ((4096, 5120), 8800)])
def test_cuda_mma_f32_served_prefill_rows(shape, rows):
    """The f32 views' prefills at full width: Whisper's [4096 x 1024] at
    its encoder's 12,000 rows and Pixtral's q [4096 x 5120] at the VLM
    prefill's 8,800 (BCQ-3, g 128, f32 activations) on the tensor-core
    tile: 1e-3 of the output scale against the plain version."""
    require_cuda()
    m, n = shape
    gen = torch.Generator(device="cuda").manual_seed(m + n + rows)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=3, group_size=128)
    x = torch.randn((rows, n), generator=gen, device="cuda")
    got, routes = _routes_run(lambda: bcq_matmul(x, w,
                                                 out_dtype=torch.float32))
    assert routes == {"bcq_matmul/mma": 1}
    _close(got, bcq_matmul_ref(x, w, torch.float32), GEMM_TOL)


@pytest.mark.cuda
def test_cuda_whisper_prefill_decode_matches_plain():
    """Reduced Whisper (2 encoder + 2 decoder layers), BCQ-3 g 32 in f32
    on the card: frames [2, 16, 64] and a 5-token prompt through
    ``Model.prefill`` into a contiguous cache, then 8 greedy decode
    steps.  The kernel path's logits within 1e-3 of the logit scale of
    the plain path's (dequantize and matmul) at the prefill and at every
    step, the greedy tokens identical; every decode step runs its 17
    linears (2 x (4 self + 2 cross + 2 MLP) + the head) on the decode
    tile and the cross K/V are not recomputed (no GEMM on the encoder's
    16-row output)."""
    require_cuda()
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.quant import QuantSpec, quantize_model
    cfg = get_reduced("whisper_medium").replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(23)
    model = Model(cfg, device="cuda", dtype=torch.float32).init_params(gen)
    spec = QuantSpec(format="bcq", bits=3, group_size=32)
    quantize_model(model, spec)
    kern = model.with_config(quant=spec)
    plain = model.with_config(quant=spec.replace(backend="dense"))
    rng = np.random.default_rng(23)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 5)),
                           device="cuda")
    frames = torch.as_tensor(rng.normal(size=(2, cfg.encoder_seq,
                                              cfg.d_model)),
                             dtype=torch.float32, device="cuda")
    outs, tokens, routes = [], [], []
    for m in (kern, plain):
        lg, c = m.prefill(toks, m.init_cache(2, 32), frames=frames)
        logits, seq, step_routes = [lg], [], []
        for t in range(8):
            tok = lg.argmax(-1)
            seq.append(tok.tolist())
            _lib.reset_launch_counts()
            lg, c = m.decode_step(tok[:, None], c, 5 + t)
            torch.cuda.synchronize()
            step_routes.append(dict(_lib.route_counts))
            logits.append(lg)
        outs.append(logits)
        tokens.append(seq)
        routes.append(step_routes)
    for got, want in zip(*outs):
        assert torch.isfinite(got).all()
        _close(got, want, GEMM_TOL)
    assert tokens[0] == tokens[1]
    assert all(r == {"bcq_matmul/gemv": 2 * 8 + 1} for r in routes[0])
    assert all(r == {} for r in routes[1])


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [None, (0.7, 40)])
def test_cuda_async_tick_has_one_host_wait(sample):
    """OPT-6.7B at full width and 2 layers, BCQ-3 (g 128), bf16, with the
    prefix cache: the async tick gives the sync tick's tokens and
    counters (greedy and seeded sampling), and every decode-only async
    tick runs under ``torch.cuda.set_sync_debug_mode("error")``: its one
    host wait is the event after the previous tick's token copy, which
    that mode does not flag."""
    require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant import QuantSpec, quantize_model
    from repro_torch.serve import PagedServeEngine, Request
    cfg = get_config("opt_6_7b").replace(n_layers=2, max_seq_len=512)
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = Model(cfg, device="cuda").init_params(gen)
    spec = QuantSpec(format="bcq", bits=3, group_size=128)
    quantize_model(model, spec)
    model = model.with_config(quant=spec, paged_kernel="fused")
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab_size, (64,))
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                    (n,))])
               for n in (5, 30, 17, 44)]
    outs, strict = {}, 0
    for mode in ("sync", "async"):
        eng = PagedServeEngine(model, num_blocks=64, block_size=16,
                               max_batch=4, max_seq_len=256,
                               prefill_buckets=(32, 128), prefix_cache=True)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            if sample:
                r.temperature, r.top_k = sample
        eng.submit(reqs[0])
        eng.step_async() if mode == "async" else eng.step()
        for r in reqs[1:]:
            eng.submit(r)
        while eng.sched.has_work() or eng.has_inflight:
            if mode == "sync":
                eng.step()
                continue
            decode_only = not eng.sched.waiting and all(
                s.kv_len >= s.prefill_target for s in eng.sched.running)
            if decode_only:
                torch.cuda.set_sync_debug_mode("error")
                strict += 1
            try:
                eng.step_async()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        eng.flush()
        assert all(r.error is None and len(r.out_tokens) == 12
                   for r in reqs)
        outs[mode] = ({r.uid: r.out_tokens for r in reqs},
                      {k: eng.metrics.counters[k] for k in (
                          "admitted", "tokens_out", "prefill_chunks",
                          "prefix_hit_blocks")})
        eng.prefix.clear()
        eng.pool.check()
        assert eng.pool.free_blocks == eng.pool.capacity
    assert outs["async"] == outs["sync"]
    assert outs["sync"][1]["prefix_hit_blocks"] > 0
    assert strict >= 8


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bcq_matmul", "lut_gemm",
                                    "ternary_matmul", "paged_decode"])
def test_cuda_tune_candidates_match_plain(kernel, tmp_path, monkeypatch):
    """Every config the tuner may time, pinned through the wrapper, at
    decode rows and prefill rows of one small shape (a 16-step reduction
    axis, so the split grid is wide), against the plain version; then
    ``tune`` stores a winner that a cache reloaded from disk resolves
    (source ``cache``) and that still matches."""
    require_cuda()
    from repro_torch import obs, tune as T
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.delenv("REPRO_TORCH_TUNE", raising=False)
    T.reset_default_cache()
    sms, device = T.dispatch.device_of(torch.empty(0, device="cuda"))
    rng = np.random.default_rng(11)
    if kernel == "paged_decode":
        dev = lambda a: torch.from_numpy(a).to("cuda")
        ops = tuple(map(dev, pool_case(5, b=4, h=8, hkv=4, d=64, nb=80,
                                       bs=4, pages=16)))
        want = paged_decode_ref(*ops, out_dtype=torch.float32)
        run = lambda cfg: paged_attention(*ops, out_dtype=torch.float32,
                                          splits=cfg.splits)
        problems = [T.space.decode_problem(kernel, b=4, h=8, hkv=4,
                                           pages=16, bs=4,
                                           dtype=torch.float32)]
        tol, tune_ops = PAGED_TOL, ops
    else:
        m, n, g = 96, 4096, 128
        w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)
                             ).to("cuda")
        wq = (quantize_ternary(w, group_size=g) if kernel == "ternary_matmul"
              else bcq.from_uniform(w, bits=3, group_size=g))
        op = {"bcq_matmul": bcq_matmul, "lut_gemm": lut_gemm,
              "ternary_matmul": ternary_matmul}[kernel]
        problems, tol = [], GEMM_TOL
        for rows in (8, 64):
            x = torch.from_numpy(rng.normal(size=(rows, n)).astype(
                np.float32)).to("cuda", torch.bfloat16)
            want = bcq_matmul_ref(x, wq, torch.float32) \
                if kernel != "ternary_matmul" else ternary_ref(
                    x, wq, out_dtype=torch.float32)
            for cfg in T.candidate_configs(
                    kernel, b=rows, m=m, n=n, dtype=x.dtype,
                    mu=4 if kernel == "lut_gemm" else 0, group_size=g,
                    sms=sms):
                kw = ({"half_lut": cfg.half_lut} if kernel == "lut_gemm"
                      else {})
                got = op(x, wq, route=cfg.route, splits=cfg.splits,
                         out_dtype=torch.float32, **kw)
                _close(got, want, tol)
        run = lambda cfg: op(x, wq, out_dtype=torch.float32)
        tune_ops = (x, wq)
        problems = [dict(b=64, m=m, n=n, dtype=x.dtype,
                         mu=4 if kernel == "lut_gemm" else 0,
                         group_size=g)]
    if kernel == "paged_decode":
        for cfg in T.candidate_configs(kernel, sms=sms, **problems[0]):
            _close(run(cfg), want, tol)
    res = T.tune(kernel, *tune_ops, cache=T.default_cache(), reps=2,
                 warmup=1)
    assert res.timings[0].ok and res.best_time <= res.default_time
    T.default_cache().save()
    T.reset_default_cache()
    tr = obs.Tracer()
    with obs.activate(tr):
        assert T.kernel_config(kernel, sms=sms, device=device,
                               **problems[0]) == res.best
        _close(run(res.best) if kernel == "paged_decode" else
               run(None), want, tol)
    assert [e["args"]["source"] for e in tr.events
            if e["name"] == f"kernel_config:{kernel}"] == ["cache"]
    T.reset_default_cache()


# ---------------------------------------------------------------------------
# mesh serving: OPT-6.7B's tensor-parallel shard shapes, two ranks on the
# one card
# ---------------------------------------------------------------------------

# [out x in] of OPT-6.7B's linears cut over tp 2 and tp 4: q / k / v
# (column-parallel), out_proj (row-parallel), fc1, fc2
OPT_SHARD_SHAPES = [(2048, 4096), (4096, 2048), (8192, 4096), (4096, 8192),
                    (1024, 4096), (4096, 1024), (4096, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 512])
@pytest.mark.parametrize("m,n", OPT_SHARD_SHAPES)
def test_cuda_gemms_at_opt_shard_shapes(m, n, rows):
    """Each GEMM kernel at OPT-6.7B's tp-2 and tp-4 shard shapes (BCQ-3
    and ternary, g 128, bf16 activations) at a decode step's 8 rows and
    the top prefill bucket's 512: 1e-3 of the output scale against its
    plain version, on the body its rule picks."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(m + 3 * n + rows)
    w = bcq.quantize(torch.randn((m, n), generator=gen, device="cuda")
                     * 0.02, bits=3, group_size=128)
    wt = quantize_ternary(torch.randn((m, n), generator=gen, device="cuda")
                          * 0.02, group_size=128)
    x = torch.randn((rows, n), generator=gen,
                    device="cuda").to(torch.bfloat16)
    body = "gemv" if rows <= 8 else "mma"
    got, routes = _routes_run(lambda: bcq_matmul(x, w,
                                                 out_dtype=torch.float32))
    assert routes == {f"bcq_matmul/{body}": 1}
    _close(got, bcq_matmul_ref(x, w, torch.float32), GEMM_TOL)
    got, routes = _routes_run(lambda: lut_gemm(x, w,
                                               out_dtype=torch.float32))
    assert routes == {f"lut_gemm/{'lut' if rows <= 8 else 'mma'}": 1}
    _close(got, lut_ref(x, w, out_dtype=torch.float32)
           if rows <= 8 else bcq_matmul_ref(x, w, torch.float32), GEMM_TOL)
    got, routes = _routes_run(lambda: ternary_matmul(
        x, wt, out_dtype=torch.float32))
    assert routes == {f"ternary_matmul/{body}": 1}
    _close(got, dense_ref(x, wt, torch.float32), GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [0, 128, 512])
def test_cuda_paged_kernels_on_a_16_head_slice(chunk):
    """The paged kernels on OPT-6.7B's tp-2 slice (16 of 32 heads, D 128,
    block 16): decode at B 8 and prefill chunks of 128 and 512, float
    pools 1e-4 and bf16 pools at their gates, one launch a call."""
    require_cuda()
    h, d, bs, pages, b = 16, 128, 16, 40, (8 if not chunk else 1)
    if not chunk:
        for name, kern, plain, tol, (kk, vv) in _decode_flavours(
                *_decode_case(16, b=b, hkv=h, rep=1, d=d, bs=bs,
                              pages=pages)):
            _lib.reset_launch_counts()
            got = kern(kk, vv)
            assert _lib.launch_counts[name] == 1
            _close(got.float(), plain(kk, vv).float(), tol)
        return
    dev = lambda a: torch.from_numpy(a).to("cuda")
    q, k, v, pos, tables, positions = map(dev, pool_case(
        h + chunk, b=b, h=h, hkv=h, d=d, nb=b * pages + 8, bs=bs,
        pages=pages, chunk=chunk))
    _close(paged_prefill(q, k, v, pos, tables, positions),
           paged_prefill_ref(q, k, v, pos, tables, positions), PAGED_TOL)
    for name, kern, plain, tol in _prefill_flavours(q, k, v, pos, tables,
                                                     positions):
        _lib.reset_launch_counts()
        got = kern()
        assert _lib.launch_counts[name] == 1
        _close(got.float(), plain().float(), tol)


@pytest.mark.cuda
def test_cuda_sharded_serve_two_ranks_on_one_card(tmp_path):
    """OPT-6.7B at full width and 2 of its 32 layers, BCQ-3 (g 128) in
    f32, served over a (1, 2) mesh by two processes sharing the card
    (gloo): each rank's decode and prefill GEMMs and paged kernels
    launch on its shard, and the greedy tokens equal the unsharded
    engine's on the same weights."""
    require_cuda()
    import json
    import os
    import pickle
    import sys
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import Model, to_params
    from repro_torch.quant import QuantSpec, quantize_model
    from repro_torch.serve import PagedServeEngine, Request
    cfg = get_config("opt_6_7b").replace(n_layers=2, dtype="float32",
                                         max_seq_len=256)
    gen = torch.Generator(device="cuda").manual_seed(7)
    model = Model(cfg, device="cuda", dtype=torch.float32).init_params(gen)
    spec = QuantSpec(format="bcq", bits=3, group_size=128)
    quantize_model(model, spec)
    model = model.with_config(quant=spec, paged_kernel="fused")
    kw = dict(num_blocks=48, block_size=16, max_batch=4, max_seq_len=256,
              prefill_buckets=(16, 32, 64))
    rng = np.random.default_rng(0)
    lens = (9, 40, 23, 61)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    eng = PagedServeEngine(model, **kw)
    done = eng.run([Request(uid=i, prompt=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)])
    want = {str(r.uid): [int(t) for t in r.out_tokens] for r in done}

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        if isinstance(t, list):
            return [host(v) for v in t]
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else t
    job = tmp_path / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"mesh": (1, 2), "device": "cuda", "arch": "opt_6_7b",
                     "scenarios": [dict(
                         name="opt", full=True, lens=lens,
                         over=dict(n_layers=2, dtype="float32",
                                   max_seq_len=256),
                         quant=dict(format="bcq", bits=3, group_size=128),
                         params=host(to_params(model)), kw=kw,
                         runs=[dict(name="fused", mode="fused",
                                    kind="sync")])]}, f)
    del eng, model
    torch.cuda.empty_cache()
    here = os.path.dirname(__file__)
    outs = spawn([sys.executable, os.path.join(here,
                                               "torch_sharded_worker.py"),
                  str(job), str(tmp_path)], 2,
                 env={"PYTHONPATH": os.path.join(here, "..", "src")},
                 timeout=600)
    for r, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {r}:\n{err[-3000:]}"
    for r in range(2):
        got = json.load(open(tmp_path / f"rank{r}.json"))["opt"]["fused"]
        assert got["tokens"] == want
        assert got["decode_path"] == "fused" and got["same_host_state"]
        assert got["k_shape"] == [48, 16, 16, 128]
        assert got["linears"]["q"][0] == [2048 * r, 2048 * (r + 1)]
        launches = got["launches"]
        assert launches["bcq_matmul"] > 0
        assert launches["paged_decode"] > 0 and launches["paged_prefill"] > 0
        assert got["routes"].get("bcq_matmul/gemv", 0) > 0
        assert got["routes"].get("bcq_matmul/mma", 0) > 0
