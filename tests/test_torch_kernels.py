"""Port parity: the GEMM and paged-attention kernel modules.

On the CPU each port ``ops.py`` wrapper runs its plain version; it is
held against the reference ``ops.py`` run in Pallas interpret mode on
the same numpy inputs.  Tolerances are the reference's own gates
(``benchmarks/baselines/BENCH_kernels.json``): 1e-3 (relative to the
output scale) for the GEMMs, 1e-4 for float paged decode and prefill.
int8 pools: the plain versions follow the reference oracles' ordering
(normalize, then v_scale, then round to bf16) and agree with them within
1e-4; the reference kernels fold v_scale into the unnormalized
probabilities before the bf16 rounding, a different rounding point, so
against them the bound is the reference's int8 gate, 5e-2.  Chunked
prefill on bf16 pools: 2e-2 of the output scale (see its test).  The
decode kernel's split-and-merge walk (``paged_decode_split_ref``): 1e-4
against the reference kernel on f32 pools; on int8 pools 1e-4 against
the unsplit plain version in f32 compute with power-of-two scales (the
reference kernel computes in bf16 only), and the reference's int8 gate,
5e-2, against the reference kernel in bf16.  (The ternary
module has its own file, ``test_torch_ternary.py``.)
The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcq as jbcq
from repro.kernels.bcq_matmul import ops as j_mxu
from repro.kernels.lut_gemm import ops as j_lut
from repro.kernels.paged_attention import paged_attention as j_decode
from repro.kernels.paged_attention import paged_prefill as j_prefill
from repro.kernels.paged_attention import paged_attention_int8 as j_int8
from repro.kernels.paged_attention import ref as j_paged_ref
from repro_torch.kernels import _lib
from repro_torch.kernels.bcq_matmul import bcq_matmul
from repro_torch.kernels.lut_gemm import dense_ref, lut_gemm
from repro_torch.kernels.paged_attention import (paged_decode_split_ref,
                                                 paged_attention,
                                                 paged_attention_int8,
                                                 paged_prefill)

from torch_port_cases import int8_pools, pool_case, torch_bundle

GEMM_TOL = 1e-3
PAGED_TOL = 1e-4
INT8_TOL = 5e-2
BF16_POOL_TOL = 2e-2
INT8_FLIP_TOL = 1e-3

SHAPES = [(64, 128, 1), (96, 200, 5), (33, 130, 2)]


def _gemm_case(m, n, b, bits, seed, g=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    wj = jbcq.from_uniform(jnp.asarray(w), bits=bits, group_size=g)
    return x, wj, torch_bundle(wj)


def _close(got, want, tol):
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("m,n,b", SHAPES)
@pytest.mark.parametrize("bits", [2, 3])
def test_bcq_matmul_matches_reference(m, n, b, bits):
    x, wj, wt = _gemm_case(m, n, b, bits, seed=m + n + bits)
    want = np.asarray(j_mxu.bcq_matmul(jnp.asarray(x), wj, interpret=True))
    got = bcq_matmul(torch.from_numpy(x), wt).numpy()
    assert got.shape == want.shape
    _close(got, want, GEMM_TOL)


@pytest.mark.parametrize("m,n,b", SHAPES)
@pytest.mark.parametrize("mu,half", [(4, True), (4, False), (2, True),
                                     (2, False)])
def test_lut_gemm_matches_reference(m, n, b, mu, half):
    x, wj, wt = _gemm_case(m, n, b, 3, seed=2 * m + n)
    want = np.asarray(j_lut.lut_gemm(jnp.asarray(x), wj, mu=mu,
                                     half_lut=half, interpret=True))
    got = lut_gemm(torch.from_numpy(x), wt, mu=mu, half_lut=half).numpy()
    assert got.shape == want.shape
    _close(got, want, GEMM_TOL)


@pytest.mark.parametrize("mu,half", [(4, True), (4, False), (2, True),
                                     (2, False)])
def test_lut_gemm_decode_rows_at_group_size_8(mu, half):
    """Decode rows (8) at group size 8, where every plane byte of a lane
    starts a new alpha group, at every mu and table: the LUT body's plain
    version against the reference kernel."""
    x, wj, wt = _gemm_case(40, 136, 8, 3, seed=17 + mu + half, g=8)
    want = np.asarray(j_lut.lut_gemm(jnp.asarray(x), wj, mu=mu,
                                     half_lut=half, interpret=True))
    got = lut_gemm(torch.from_numpy(x), wt, mu=mu, half_lut=half).numpy()
    assert got.shape == want.shape
    _close(got, want, GEMM_TOL)


def test_lut_read_modes_are_one_function():
    x, wj, wt = _gemm_case(32, 128, 3, 2, seed=9)
    xt = torch.from_numpy(x)
    outs = [lut_gemm(xt, wt, read_mode=r).numpy()
            for r in ("select", "onehot", "gather")]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    _close(outs[0], dense_ref(xt, wt).numpy(), GEMM_TOL)
    with pytest.raises(ValueError):
        lut_gemm(xt, wt, read_mode="mxu")


def test_gemm_3d_batch_and_bf16():
    x, wj, wt = _gemm_case(48, 128, 6, 3, seed=5)
    x3 = torch.from_numpy(x).reshape(2, 3, 128)
    for fn in (bcq_matmul, lut_gemm):
        y = fn(x3, wt)
        assert y.shape == (2, 3, 48) and y.dtype == torch.float32
        yb = fn(x3.to(torch.bfloat16), wt)
        assert yb.dtype == torch.bfloat16


@pytest.mark.parametrize("h,hkv", [(8, 4), (4, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_decode_matches_reference(h, hkv, seed):
    q, k, v, pos, tables, positions = pool_case(seed, h=h, hkv=hkv)
    want = np.asarray(j_decode(*map(jnp.asarray, (q, k, v, pos, tables,
                                                  positions)),
                               interpret=True))
    got = paged_attention(*map(torch.from_numpy, (q, k, v, pos, tables,
                                                  positions))).numpy()
    np.testing.assert_allclose(got, want, atol=PAGED_TOL)
    assert np.abs(got[0]).max() == 0.0          # the idle row outputs 0


# chunked prefill: chunks on either side of the CUDA kernel's 64-row query
# tile (5, 65: with rep 2 the 65-token chunk is 130 query vectors), block
# sizes 4 and 16, MHA and GQA up to rep 8
PREFILL_CASES = [(chunk, bs, h, hkv) for chunk in (5, 65) for bs in (4, 16)
                 for h, hkv in ((8, 4), (4, 4), (8, 1))]


def _prefill_case(seed, chunk, bs, h, hkv):
    """``pool_case`` with room for the chunk plus some prior context (at
    chunk 5, block 4 exactly the default 6 pages of 24 blocks)."""
    pages = max(6, -(-(chunk + 12) // bs))
    return pool_case(seed, h=h, hkv=hkv, chunk=chunk, bs=bs, pages=pages,
                     nb=3 * pages + 6)


@pytest.mark.parametrize("chunk,bs,h,hkv", PREFILL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_matches_reference(chunk, bs, h, hkv, dtype):
    """f32 pools within the reference's 1e-4.  bf16 pools (the main
    path's) within 2e-2 of the output scale, chip_smoke's bf16 gate: both
    round q and K/V to bf16 alike, but the plain version rounds the
    normalized probabilities to bf16 and the reference kernel the
    unnormalized ones page by page, a relative 2^-9 per term apart."""
    q, k, v, pos, tables, positions = _prefill_case(3, chunk, bs, h, hkv)
    jk, jv = (jnp.asarray(x).astype(dtype) for x in (k, v))
    want = np.asarray(j_prefill(jnp.asarray(q), jk, jv,
                                *map(jnp.asarray, (pos, tables, positions)),
                                interpret=True))
    tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (k, v))
    got = paged_prefill(torch.from_numpy(q), tk, tv,
                        *map(torch.from_numpy, (pos, tables,
                                                positions))).numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=PAGED_TOL)
    else:
        _close(got, want, BF16_POOL_TOL)
    assert np.abs(got[-1, -2:]).max() == 0.0    # pad query rows output 0


def _int8_case(seed, chunk=0, h=8, hkv=4):
    q, k, v, pos, tables, positions = pool_case(seed, h=h, hkv=hkv,
                                                chunk=chunk)
    kq, vq, ks, vs = int8_pools(k, v)
    return q, kq, vq, ks, vs, pos, tables, positions


@pytest.mark.parametrize("h,hkv", [(8, 4), (4, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_decode_int8_matches_reference(h, hkv, seed):
    q, kq, vq, ks, vs, pos, tables, positions = _int8_case(seed, h=h,
                                                           hkv=hkv)
    args = (q, kq, vq, ks, vs, pos, tables, positions)
    got = paged_attention_int8(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(j_paged_ref.paged_decode_int8_ref(
        *map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, atol=PAGED_TOL)
    kern = np.asarray(j_int8(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, kern, atol=INT8_TOL)
    assert np.abs(got[0]).max() == 0.0          # the idle row outputs 0


@pytest.mark.parametrize("chunk,bs,h,hkv", PREFILL_CASES)
def test_paged_prefill_int8_matches_reference(chunk, bs, h, hkv):
    """Against the reference oracle: 1e-4 absolute on the chunk-5, block-4
    cases; 1e-3 of the output scale on the larger ones, where a few of
    the bf16 roundings of p * v_scale fall on the other side of a tie
    (torch and XLA take exp and the f32 sums in other orders, and one
    flipped rounding moves an output by up to 2^-8 of p * |v|).  Against
    the reference kernel: its int8 gate, 5e-2."""
    q, k, v, pos, tables, positions = _prefill_case(3, chunk, bs, h, hkv)
    kq, vq, ks, vs = int8_pools(k, v)
    pool = (q, kq, vq, pos, tables, positions)
    got = paged_prefill(*map(torch.from_numpy, pool),
                        k_scale=torch.from_numpy(ks),
                        v_scale=torch.from_numpy(vs)).numpy()
    jpool = tuple(map(jnp.asarray, pool))
    want = np.asarray(j_paged_ref.paged_prefill_ref(
        *jpool, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    if (chunk, bs) == (5, 4):
        np.testing.assert_allclose(got, want, atol=PAGED_TOL)
    else:
        _close(got, want, INT8_FLIP_TOL)
    kern = np.asarray(j_prefill(*jpool, k_scale=jnp.asarray(ks),
                                v_scale=jnp.asarray(vs), interpret=True))
    np.testing.assert_allclose(got, kern, atol=INT8_TOL)
    assert np.abs(got[-1, -2:]).max() == 0.0    # pad query rows output 0


def test_int8_wrappers_round_q_to_bf16_not_int8():
    """int8 pools compute in bf16 by default; asking for f32 changes the
    result only by bf16 rounding, and a float compute type on a float
    pool other than its own is refused."""
    q, kq, vq, ks, vs, pos, tables, positions = _int8_case(5)
    t = list(map(torch.from_numpy, (q, kq, vq, ks, vs, pos, tables,
                                    positions)))
    bf = paged_attention_int8(*t)
    f32 = paged_attention_int8(*t, compute_dtype=torch.float32)
    assert 0 < float((bf - f32).abs().max()) < INT8_TOL
    with pytest.raises(TypeError):
        paged_attention_int8(*t, compute_dtype=torch.int8)
    qf, k, v, posf, tf, pf = map(torch.from_numpy, pool_case(5))
    with pytest.raises(TypeError):
        paged_prefill(qf[:, None], k, v, posf, tf, pf[:, None],
                      compute_dtype=torch.bfloat16)


def test_wrappers_count_no_launch_on_cpu():
    _lib.reset_launch_counts()
    x, wj, wt = _gemm_case(32, 64, 2, 2, seed=1)
    bcq_matmul(torch.from_numpy(x), wt)
    lut_gemm(torch.from_numpy(x), wt)
    assert all(n == 0 for n in _lib.launch_counts.values())


# the decode kernel's split walk: 16-slot tiles, so a 48-page table of
# 4-slot blocks has 12 tiles and takes 1-4 splits of whole tiles
SPLIT_PAGES, SPLIT_BS = 48, 4


def _split_case(seed, h, hkv):
    """A 192-slot table in which a live row ends before the last quarter
    (so the 4-way split has an empty split on a live row), besides the
    idle row 0, -1 pads and a stale recycled block."""
    case = pool_case(seed, h=h, hkv=hkv, bs=SPLIT_BS, pages=SPLIT_PAGES,
                     nb=3 * SPLIT_PAGES + 6)
    assert (case[5][1:] < 144).any() and case[5][1:].max() >= 16
    return case


_JAX_DECODE = {}


def _jax_decode(seed, h, hkv, int8):
    """The reference kernel (interpret mode) on ``_split_case``, once per
    case: (inputs, its output)."""
    key = (seed, h, hkv, int8)
    if key not in _JAX_DECODE:
        q, k, v, pos, tables, positions = _split_case(seed, h, hkv)
        rest = tuple(map(jnp.asarray, (pos, tables, positions)))
        if int8:
            kq, vq, ks, vs = int8_pools(k, v, seed=seed, pow2=True)
            args = (q, kq, vq, ks, vs, pos, tables, positions)
            out = j_int8(*map(jnp.asarray, args[:5]), *rest,
                         interpret=True)
        else:
            args = (q, k, v, pos, tables, positions)
            out = j_decode(*map(jnp.asarray, args[:3]), *rest,
                           interpret=True)
        _JAX_DECODE[key] = (args, np.asarray(out))
    return _JAX_DECODE[key]


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("h,hkv", [(8, 4), (4, 4)])
def test_paged_decode_split_matches_reference(h, hkv, splits):
    """Partials per range of 16-slot tiles merged in split order equal the
    reference kernel within 1e-4 (f32 pools), empty splits included; the
    idle row gives 0."""
    (q, k, v, pos, tables, positions), want = _jax_decode(1, h, hkv, False)
    got = paged_decode_split_ref(*map(torch.from_numpy, (q, k, v, pos,
                                                          tables,
                                                          positions)),
                                 splits).numpy()
    np.testing.assert_allclose(got, want, atol=PAGED_TOL)
    assert np.abs(got[0]).max() == 0.0


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("h,hkv", [(8, 4), (4, 4)])
def test_paged_decode_int8_split_matches_reference(h, hkv, splits):
    """int8 pools with power-of-two scales: in f32 compute the split walk
    equals the unsplit plain version within 1e-4 (the scale products are
    exact, only the f32 sums move); in bf16 compute it is within the
    reference's int8 gate of the reference kernel."""
    args, want = _jax_decode(2, h, hkv, True)
    q, kq, vq, ks, vs, pos, tables, positions = map(torch.from_numpy, args)
    kw = dict(k_scale=ks, v_scale=vs)
    f32 = paged_decode_split_ref(q, kq, vq, pos, tables, positions, splits,
                                 compute_dtype=torch.float32, **kw)
    plain = paged_attention_int8(q, kq, vq, ks, vs, pos, tables, positions,
                                 compute_dtype=torch.float32)
    _close(f32.numpy(), plain.numpy(), PAGED_TOL)
    bf = paged_decode_split_ref(q, kq, vq, pos, tables, positions, splits,
                                **kw).numpy()
    _close(bf, want, INT8_TOL)
    assert np.abs(bf[0]).max() == 0.0


def test_decode_split_count_covers_the_table():
    """Every split is a whole number of 16-slot tiles, every tile of the
    table is in one, no split lies past the table, and a batch that fills
    the card takes no split."""
    from repro_torch.kernels.paged_attention.ops import decode_splits
    for b, hkv, rep, pages, bs, sms in (
            (8, 32, 1, 32, 16, 132), (8, 8, 4, 32, 16, 132),
            (1, 32, 1, 32, 16, 132), (3, 2, 8, 50, 4, 132),
            (3, 4, 2, 6, 4, 132), (2, 1, 1, 3, 5, 8), (1, 1, 1, 1, 16, 132),
            (64, 32, 1, 32, 16, 132)):
        s = decode_splits(b, hkv, rep, pages, bs, sms)
        tiles = -(-pages * bs // 16)
        per = -(-tiles // s)
        assert 1 <= s <= tiles and (s - 1) * per < tiles <= s * per
    assert decode_splits(64, 32, 1, 32, 16, 132) == 1
    assert decode_splits(8, 32, 1, 32, 16, 132) > 1
