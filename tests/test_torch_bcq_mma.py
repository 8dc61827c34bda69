"""Port parity: the arithmetic of the tensor-core BCQ tile.

``csrc/bcq_mma.cu`` (the ``mma`` route of ``bcq_matmul`` and
``lut_gemm``) re-associates the reference's one-hot LUT read:
``(x_g . S^T) . onehot(key)^T = x_g . (S^T . onehot(key)^T)``, and
``S^T . onehot(key)`` is the key's +-1 bit column, so the table read
becomes one product per bit plane and alpha group.  Its plain version,
``bcq_planes_ref`` (sums per plane and group in f32, scaled by alpha,
then z times the group's sum of x), is held here

  (a) against the reference kernels ``lut_gemm`` (mu 2 and 4, half and
      full table) and ``bcq_matmul``, run in Pallas interpret mode, within
      1e-3 of the output scale (the reference's GEMM gate), on x rounded
      to bf16 values first (the tile's operand type);
  (b) exactly, on integer activations and power-of-two scales: the
      reference's ``lut_common.build_lut`` + ``read_lut(mode="onehot")``
      equals the plane products bit for bit, and so does the whole
      reference kernel;
  (c) the wrappers' route rules at their edges (rows 8 / 9, f32 / bf16,
      group size 8 / 16 / 128; the decode tile's group sizes 32-256) and
      their split rules;
  (d) the decode tile's split walk (``gemv_split_ref``: 256-column steps,
      whole steps per split, partials added in split order) against the
      plain version and the reference kernel within 1e-5, and exactly on
      exact inputs;
  (e) the decode tile's f32 path: ``split_bf16x3`` rebuilds normal f32
      values within 2^-23 of |x| (in fact exactly), and the split walk on
      f32 activations (each group's terms summed over the three bf16
      parts) matches the reference's ``bcq_matmul_ref`` in f32 within
      1e-6 of the output scale (only the f32 summation order differs),
      q 1-4, with and without z;
  (f) the tensor-core tile's f32 path: its walk (``mma_split_ref``: each
      plane's group sums over the three bf16 parts of x, then alpha, then
      z times the parts' x-sums; the alpha groups split as ``mma_splits``
      cuts them, the partials added in split order), at rows 9 / 32 /
      128, q 1-4, splits 1 and 3, against the reference kernels
      ``bcq_matmul``, ``lut_gemm`` (mu 2 and 4, half and full table) and
      ``ternary_matmul`` in Pallas interpret mode on f32 activations that
      are not bf16 values (the reference's plain ``bcq_matmul_ref`` where
      a bundle has no z: its kernels take none), within 1e-6 of the
      output scale, and bit for bit on exact inputs.

The CUDA tile itself is held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcq as jbcq
from repro.core.plane import PlaneBundle as JPlaneBundle
from repro.kernels import lut_common as jlc
from repro.kernels.bcq_matmul import ops as j_mxu
from repro.kernels.bcq_matmul.ref import bcq_matmul_ref as j_bcq_ref
from repro.kernels.lut_gemm import ops as j_lut
from repro.kernels.ternary_matmul import ternary_matmul as j_ternary
from repro_torch.kernels.bcq_matmul import (bcq_matmul_ref, bcq_planes_ref,
                                            gemv_split_ref, mma_split_ref,
                                            plane_group_sums, split_bf16x3)
from repro_torch.kernels.bcq_matmul import route_for as bcq_route
from repro_torch.kernels.bcq_matmul.ops import gemv_splits, mma_splits
from repro_torch.kernels.lut_gemm import route_for as lut_route
from repro_torch.kernels.lut_gemm.ops import decode_splits

from torch_port_cases import torch_bundle

GEMM_TOL = 1e-3

# (out, in, rows, group size): ragged M and rows, a padded input width
# (200 at g 64), group sizes 16 / 64 / 128
SHAPES = [(33, 256, 9, 64), (96, 384, 1, 128), (64, 200, 40, 64),
          (20, 192, 3, 16)]


def _bf16_values(a):
    """f32 array holding the bf16-rounded values of ``a``."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _case(m, n, b, g, bits=3, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = _bf16_values(rng.normal(size=(b, n)).astype(np.float32))
    wj = jbcq.from_uniform(jnp.asarray(w), bits=bits, group_size=g)
    return x, wj, torch_bundle(wj)


def _close(got, want, tol):
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("m,n,b,g", SHAPES)
@pytest.mark.parametrize("mu,half", [(4, True), (4, False), (2, True),
                                     (2, False)])
def test_planes_ref_matches_reference_lut_gemm(m, n, b, g, mu, half):
    x, wj, wt = _case(m, n, b, g, seed=m + n + mu)
    want = np.asarray(j_lut.lut_gemm(jnp.asarray(x), wj, mu=mu,
                                     half_lut=half, interpret=True))
    got = bcq_planes_ref(torch.from_numpy(x), wt, torch.float32).numpy()
    assert got.shape == want.shape == (b, m)
    _close(got, want, GEMM_TOL)


@pytest.mark.parametrize("m,n,b,g", SHAPES)
@pytest.mark.parametrize("bits", [1, 3])
def test_planes_ref_matches_reference_bcq_matmul(m, n, b, g, bits):
    x, wj, wt = _case(m, n, b, g, bits=bits, seed=2 * m + n)
    want = np.asarray(j_mxu.bcq_matmul(jnp.asarray(x), wj, interpret=True))
    got = bcq_planes_ref(torch.from_numpy(x), wt, torch.float32).numpy()
    assert got.shape == want.shape == (b, m)
    _close(got, want, GEMM_TOL)


def _exact_case(m, n, b, g, q, seed):
    """Random planes, power-of-two alphas, quarter-integer offsets and
    integer activations: every partial sum is an exact f32."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (q, m, n // 8)).astype(np.uint8)
    alpha = (2.0 ** rng.integers(-3, 2, (q, m, n // g))).astype(np.float32)
    z = (0.25 * rng.integers(-4, 5, (m, n // g))).astype(np.float32)
    x = rng.integers(-8, 9, (b, n)).astype(np.float32)
    wj = JPlaneBundle(packed=jnp.asarray(packed), alpha=jnp.asarray(alpha),
                      z=jnp.asarray(z), group_size=g, in_features=n,
                      out_features=m)
    return x, wj, torch_bundle(wj)


@pytest.mark.parametrize("mu,half", [(4, True), (4, False), (2, True),
                                     (2, False)])
@pytest.mark.parametrize("q", [1, 3])
def test_onehot_read_is_the_plane_product(mu, half, q):
    """The re-association, pinned: per plane and alpha group, the
    reference's one-hot table read summed over the group equals
    sum_k x[b,k] (2 bit[m,k] - 1) exactly."""
    m, n, b, g = 24, 128, 5, 32
    x, wj, wt = _exact_case(m, n, b, g, q, seed=10 * mu + q)
    sums = plane_group_sums(torch.from_numpy(x), wt).numpy()   # [b,q,m,G]
    table = jlc.build_lut(jnp.asarray(x), mu, half)
    for i in range(q):
        keys = jlc.extract_keys(jnp.asarray(wj.packed[i]), mu)
        vals = np.asarray(jlc.read_lut(table, keys, mu, half, "onehot"))
        per_group = vals.reshape(b, m, n // g, g // mu).sum(-1)
        np.testing.assert_array_equal(per_group, sums[:, i])


@pytest.mark.parametrize("mu,half", [(4, True), (2, False)])
def test_planes_ref_equals_reference_kernel_on_exact_inputs(mu, half):
    x, wj, wt = _exact_case(40, 256, 9, 64, 3, seed=mu)
    want = np.asarray(j_lut.lut_gemm(jnp.asarray(x), wj, mu=mu,
                                     half_lut=half, interpret=True))
    got = bcq_planes_ref(torch.from_numpy(x), wt, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(j_mxu.bcq_matmul(jnp.asarray(x), wj, interpret=True))
    np.testing.assert_array_equal(got, want)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("rows,dtype,gs,n,want", [
    (8, BF16, 128, 4096, "gemv"), (9, BF16, 128, 4096, "mma"),
    (1, F32, 128, 4096, "gemv"), (9, F32, 128, 4096, "mma"),
    (512, BF16, 16, 4096, "mma"), (512, BF16, 8, 136, "mma_dq"),
    (512, BF16, 128, 4100, "mma_dq"), (512, BF16, 512, 4096, "mma_dq"),
    # the decode tile's edges: group sizes 32..256 that divide its
    # 256-column step, 16-byte activation rows, bf16 only
    (1, BF16, 32, 4096, "gemv"), (8, BF16, 256, 2560, "gemv"),
    (8, BF16, 64, 768, "gemv"), (8, BF16, 16, 4096, "mma_dq"),
    (8, BF16, 96, 4224, "mma_dq"), (8, BF16, 512, 4096, "mma_dq"),
    (8, BF16, 128, 4100, "mma_dq"), (8, F32, 128, 4096, "gemv"),
    # f32 decode rows take the decode tile under the same rule, and the
    # dequantizing tile where it refuses them
    (8, F32, 16, 4096, "mma_dq"), (1, F32, 96, 4224, "mma_dq"),
    (8, F32, 128, 4100, "mma_dq"), (8, F32, 256, 2560, "gemv"),
    # f32 prefill rows take the tensor-core tile under the bf16 rule; the
    # dequantizing tile takes group sizes 8 mod 16 or above 256 and input
    # widths that are not a multiple of 8
    (512, F32, 16, 4096, "mma"), (12000, F32, 256, 1024, "mma"),
    (512, F32, 8, 136, "mma_dq"), (512, F32, 512, 4096, "mma_dq"),
    (512, F32, 128, 4100, "mma_dq"),
])
def test_bcq_matmul_route_edges(rows, dtype, gs, n, want):
    assert bcq_route(rows, dtype, gs, n) == want


@pytest.mark.parametrize("rows,dtype,gs,mu,half,want", [
    (8, BF16, 128, 4, True, "lut"), (9, BF16, 128, 4, True, "mma"),
    (8, F32, 8, 4, True, "lut"), (9, F32, 128, 4, True, "mma"),
    (1, BF16, 128, 2, True, "lut"), (8, BF16, 128, 4, False, "lut"),
    (9, BF16, 16, 2, False, "mma"), (32, BF16, 8, 4, True, "mma_dq"),
    # f32 above 8 rows at any mu and table on the tensor-core tile; the
    # LUT body takes decode rows at every mu and table, the dequantizing
    # tile the group sizes the tensor-core tile does not take
    (512, F32, 128, 2, False, "mma"), (32, F32, 256, 4, False, "mma"),
    (8, F32, 128, 2, True, "lut"), (512, F32, 8, 4, True, "mma_dq"),
    (512, F32, 512, 2, False, "mma_dq"),
])
def test_lut_gemm_route_edges(rows, dtype, gs, mu, half, want):
    assert lut_route(rows, dtype, gs, 4096, mu, half) == want


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("mu,half", [(4, True), (2, False)])
def test_lut_gemm_takes_the_dequantizing_tile_at_odd_widths(dtype, mu,
                                                           half):
    """Input widths that are not a multiple of 8 take the dequantizing
    tile above 8 rows, f32 and bf16 alike; 8 | width takes the tensor-core
    tile; decode rows take the LUT body at either width."""
    assert lut_route(512, dtype, 128, 4100, mu, half) == "mma_dq"
    assert lut_route(512, dtype, 128, 4096, mu, half) == "mma"
    assert lut_route(8, dtype, 128, 4100, mu, half) == "lut"


def test_split_counts():
    """The reduction-axis splits: none while the row tiles fill the card
    (132 SMs), a whole number of groups, chunks or steps per split
    otherwise."""
    assert mma_splits(512, 16384, 32, 132) == 1
    assert mma_splits(512, 4096, 32, 132) == 1
    s = mma_splits(32, 4096, 32, 132)
    assert 1 < s <= 32 and -(-32 // -(-32 // s)) == s
    assert mma_splits(9, 64, 1, 132) == 1
    assert decode_splits(65536, 512, 132) == 1
    s = decode_splits(4096, 2048, 132)
    assert 1 < s <= 32 and -(-32 // -(-32 // s)) == s
    # the decode tile: 64-row tiles, 256-column steps
    assert gemv_splits(73472, 2560, 132) == 1
    s = gemv_splits(288, 2560, 132)
    assert 1 < s <= 10 and -(-10 // -(-10 // s)) == s


# every OPT-6.7B and MiniCPM3-4B decode GEMM [out x in] (g 128)
DECODE_SHAPES = [(4096, 4096), (16384, 4096), (4096, 16384), (768, 2560),
                 (3840, 768), (288, 2560), (2560, 2560), (6400, 2560),
                 (2560, 6400), (73472, 2560)]


@pytest.mark.parametrize("m,n", DECODE_SHAPES)
def test_gemv_split_counts(m, n):
    """The decode tile's split rule at the served shapes: whole 256-column
    steps per split, every step in one split, none past the axis; no
    split where the row tiles give every SM a block, and where they do
    not, a split per step or at least 1.5 blocks per SM (the rule asks
    for about three; whole steps per split round it down)."""
    sms = 132
    s = gemv_splits(m, n, sms)
    steps = -(-n // 256)
    tiles = -(-m // 64)
    per = -(-steps // s)
    assert 1 <= s <= steps and (s - 1) * per < steps <= s * per
    if tiles >= sms:
        assert s == 1
    else:
        assert s == steps or tiles * s >= 1.5 * sms


def _gemv_case(m, n, b, g, q, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = _bf16_values(rng.normal(size=(b, n)).astype(np.float32))
    wj = jbcq.from_uniform(jnp.asarray(w), bits=q, group_size=g)
    return x, wj, torch_bundle(wj)


# (out, in, rows, group size, planes): ragged M and N (600 at g 64 pads to
# 640, three steps, the last half full; 520 at g 128 pads to 640), rows
# 1-8, q 1-4, group sizes 32 / 64 / 128 / 256
GEMV_CASES = [(33, 600, 1, 64, 1), (70, 768, 8, 128, 3), (96, 1000, 5, 32, 2),
              (20, 520, 3, 128, 4), (48, 1024, 8, 256, 3),
              (17, 200, 2, 32, 4)]


@pytest.mark.parametrize("m,n,b,g,q", GEMV_CASES)
def test_gemv_split_ref_matches_reference(m, n, b, g, q):
    """The decode tile's split walk at every split count its steps allow
    equals bcq_matmul_ref and the reference kernel (interpret mode)
    within 1e-5 of the output scale."""
    x, wj, wt = _gemv_case(m, n, b, g, q, seed=m + n + q)
    want = np.asarray(j_mxu.bcq_matmul(jnp.asarray(x), wj, interpret=True))
    xt = torch.from_numpy(x)
    plain = bcq_matmul_ref(xt, wt, torch.float32).numpy()
    steps = -(-wt.n_groups * g // 256)
    counts = [s for s in range(1, steps + 1)
              if -(-steps // -(-steps // s)) == s]
    assert len(counts) >= (2 if steps > 1 else 1)
    for s in counts:
        got = gemv_split_ref(xt, wt, s, torch.float32).numpy()
        assert got.shape == want.shape == (b, m)
        _close(got, want, 1e-5)
        _close(got, plain, 1e-5)


def test_gemv_split_ref_exact_and_refuses_empty_splits():
    """On exact inputs every split walk equals the plain version bit for
    bit; a split count that would leave a split empty is refused."""
    x, wj, wt = _exact_case(40, 1024, 8, 64, 3, seed=4)
    want = bcq_matmul_ref(torch.from_numpy(x), wt, torch.float32)
    for s in (1, 2, 4):
        got = gemv_split_ref(torch.from_numpy(x), wt, s, torch.float32)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        gemv_split_ref(torch.from_numpy(x), wt, 3, torch.float32)


def test_split_bf16x3_rebuilds_normal_values():
    """Each part is a bf16 value, and h + m + l is x within 2^-23 of |x|
    for normal f32 values over 60 decades (8 significant bits a part)."""
    rng = np.random.default_rng(23)
    x = (rng.normal(size=8192) * 10.0 ** rng.integers(-30, 31, 8192)
         ).astype(np.float32)
    parts = split_bf16x3(torch.from_numpy(x))
    for p in parts:
        assert p.dtype == torch.float32
        assert torch.equal(p, p.to(torch.bfloat16).float())
    h, m, lo = (p.numpy().astype(np.float64) for p in parts)
    resid = np.abs(x.astype(np.float64) - (h + m + lo))
    assert np.all(resid <= 2.0 ** -23 * np.abs(x))
    assert np.all(np.abs(m) <= 2.0 ** -8 * np.abs(x))


# (out, in, rows, group size, planes): ragged M, N (600 at g 64 and 520
# at g 256: padded planes) and rows, q 1-4, group sizes 32-256
F32_GEMV_CASES = [(33, 600, 1, 64, 1), (70, 768, 8, 128, 2),
                  (96, 1000, 5, 32, 3), (20, 520, 3, 256, 4)]


@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("m,n,b,g,q", F32_GEMV_CASES)
def test_gemv_split_ref_f32_matches_reference(m, n, b, g, q, with_z):
    """The decode tile's f32 arithmetic (x split into three bf16 parts,
    every product run once per part) at every split count its steps
    allow: within 1e-6 of the output scale of the reference's
    bcq_matmul_ref in f32, on f32 activations that are not bf16
    values."""
    rng = np.random.default_rng(m + n + q)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    wj = jbcq.from_uniform(jnp.asarray(w), bits=q, group_size=g)
    if not with_z:
        wj = JPlaneBundle(packed=wj.packed, alpha=wj.alpha, z=None,
                          group_size=g, in_features=n, out_features=m)
    wt = torch_bundle(wj)
    assert (wt.z is not None) == with_z
    xt = torch.from_numpy(x)
    assert not torch.equal(xt, split_bf16x3(xt)[0])
    want = np.asarray(j_bcq_ref(jnp.asarray(x), wj, jnp.float32))
    steps = -(-wt.n_groups * g // 256)
    for s in [s for s in range(1, steps + 1)
              if -(-steps // -(-steps // s)) == s]:
        got = gemv_split_ref(xt, wt, s, torch.float32).numpy()
        assert got.shape == want.shape == (b, m)
        _close(got, want, 1e-6)


def _random_bundles(rng, m, n, g, q, with_z):
    """(BCQ bundle, ternary bundle) of random planes and scales, built
    directly (no quantizer run): alphas in [0.5, 1.5) that are not powers
    of two, offsets N(0, 0.1) or none; the ternary bundle's sign and mask
    planes and one alpha row."""
    nb, ng = -(-n // g) * g // 8, -(-n // g)
    bcq = JPlaneBundle(
        packed=jnp.asarray(rng.integers(0, 256, (q, m, nb), dtype=np.uint8)),
        alpha=jnp.asarray(rng.uniform(0.5, 1.5, (q, m, ng)), jnp.float32),
        z=jnp.asarray(0.1 * rng.normal(size=(m, ng)), jnp.float32)
        if with_z else None, group_size=g, in_features=n, out_features=m)
    tern = JPlaneBundle(
        packed=jnp.asarray(rng.integers(0, 256, (2, m, nb), dtype=np.uint8)),
        alpha=jnp.asarray(rng.uniform(0.5, 1.5, (1, m, ng)), jnp.float32),
        z=None, group_size=g, in_features=n, out_features=m, kind="ternary")
    return bcq, tern


# (out, in, rows, group size, planes, z, lut_gemm variants): rows 9 / 32 /
# 128 (ragged M; 376 at g 128 pads to 384), q 1-4, group sizes 16-128,
# each with 3 alpha groups or more, so 3 splits are whole
F32_MMA_CASES = [(33, 384, 9, 64, 1, True, ((4, True), (2, False))),
                 (40, 192, 32, 16, 3, False, ()),
                 (24, 376, 128, 128, 4, True, ((4, False), (2, True))),
                 (17, 320, 128, 64, 2, False, ())]


@pytest.mark.parametrize("m,n,b,g,q,with_z,luts", F32_MMA_CASES)
def test_mma_split_ref_f32_matches_reference_kernels(m, n, b, g, q, with_z,
                                                     luts):
    """The tensor-core tile's f32 walk at splits 1 and 3 against the
    reference kernels in interpret mode on f32 activations that are not
    bf16 values: bcq_matmul and the given lut_gemm variants (the
    reference's plain bcq_matmul_ref where the bundle has no z: its
    kernels take none) and ternary_matmul; within 1e-6 of the output
    scale (only the f32 summation order differs)."""
    rng = np.random.default_rng(m + n + b)
    wj, tj = _random_bundles(rng, m, n, g, q, with_z)
    x = rng.normal(size=(b, n)).astype(np.float32)
    xt = torch.from_numpy(x)
    assert not torch.equal(xt, split_bf16x3(xt)[0])
    if with_z:
        wants = [j_mxu.bcq_matmul(jnp.asarray(x), wj, interpret=True)]
        wants += [j_lut.lut_gemm(jnp.asarray(x), wj, mu=mu, half_lut=half,
                                 interpret=True) for mu, half in luts]
    else:
        wants = [j_bcq_ref(jnp.asarray(x), wj, jnp.float32)]
    want_t = np.asarray(j_ternary(jnp.asarray(x), tj, interpret=True))
    wt, tt = torch_bundle(wj), torch_bundle(tj)
    for s in (1, 3):
        got = mma_split_ref(xt, wt, s, torch.float32).numpy()
        for want in wants:
            assert got.shape == want.shape == (b, m)
            _close(got, np.asarray(want), 1e-6)
        _close(mma_split_ref(xt, tt, s, torch.float32).numpy(), want_t,
               1e-6)


def test_mma_split_ref_f32_exact_and_refuses_empty_splits():
    """On exact inputs (integer f32 x: its m and l parts are 0;
    power-of-two alphas) the f32 walk at splits 1 and 3 equals the
    reference kernels bit for bit (bcq_matmul, lut_gemm at mu 4 half and
    mu 2 full, ternary_matmul); a split count that would leave a split
    empty is refused."""
    x, wj, wt = _exact_case(40, 384, 32, 64, 3, seed=24)
    xt = torch.from_numpy(x)
    wants = [j_mxu.bcq_matmul(jnp.asarray(x), wj, interpret=True),
             j_lut.lut_gemm(jnp.asarray(x), wj, mu=4, half_lut=True,
                            interpret=True),
             j_lut.lut_gemm(jnp.asarray(x), wj, mu=2, half_lut=False,
                            interpret=True)]
    _, tj = _random_bundles(np.random.default_rng(24), 40, 384, 64, 3, False)
    tj = JPlaneBundle(packed=tj.packed, alpha=2.0 ** jnp.round(tj.alpha),
                      z=None, group_size=64, in_features=384,
                      out_features=40, kind="ternary")
    want_t = np.asarray(j_ternary(jnp.asarray(x), tj, interpret=True))
    for s in (1, 3):
        got = mma_split_ref(xt, wt, s, torch.float32).numpy()
        for want in wants:
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(
            mma_split_ref(xt, torch_bundle(tj), s, torch.float32).numpy(),
            want_t)
    with pytest.raises(ValueError):
        mma_split_ref(xt, wt, 4, torch.float32)
