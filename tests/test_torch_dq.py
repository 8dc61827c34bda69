"""Port parity: the arithmetic of the dequantizing tensor-core tile.

``csrc/bcq_dq.cu`` (the ``mma_dq`` route of ``bcq_matmul``,
``lut_gemm`` and ``ternary_matmul`` at any rows, for the group sizes and
input widths the other tiles refuse) dequantizes W in registers, in f32 and
in the reference's order (BCQ: the planes, then z; ternary: alpha *
mask * sign), splits it into hi = bf16(W) and lo = bf16(W - hi) and runs
the products hi . x, lo . x (bf16 x) or hi . h, lo . h, hi . m (f32 x's
two leading bf16 parts).  Its plain version, ``dq_split_ref``, is held
here

  (a) against the port's plain ``bcq_matmul_ref`` / ``dense_ref`` within
      1e-5 of the output scale (the split leaves W - hi - lo below 2^-16
      of |W| and drops products below 2^-16 of hi . h), and against the
      reference kernels ``bcq_matmul`` (its plain ``bcq_matmul_ref``
      where a bundle has no z: its kernel takes none) and
      ``ternary_matmul`` in Pallas interpret mode within 1e-3 (the
      reference's GEMM gate): group sizes 8, 24, 40 and 512, input widths
      4096, 4100 and 4092 (padded planes, rows not 16-byte multiples),
      q 1-8, with and without z, bf16 and f32 activations, split and
      unsplit; and at decode rows (8 and 1, 512-column stages) at group
      sizes 16 and 96 and in_features 4100;
  (b) exactly, on exact inputs (integer x, alpha 0.5 ternary weights;
      power-of-two alphas and quarter-integer offsets for BCQ): equal to
      ``ternary_ref`` (the half-LUT algorithm) and ``bcq_matmul_ref`` bit
      for bit, at every split;
  (c) the split rule ``dq_splits`` at its edges.

The CUDA tile itself is held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plane import PlaneBundle as JPlaneBundle
from repro.kernels.bcq_matmul import ops as j_mxu
from repro.kernels.bcq_matmul.ref import bcq_matmul_ref as j_bcq_ref
from repro.kernels.ternary_matmul import ternary_matmul as j_ternary
from repro_torch.kernels.bcq_matmul import (bcq_matmul_ref, dq_split_ref,
                                            split_bf16x3)
from repro_torch.kernels.bcq_matmul.ops import dq_splits
from repro_torch.kernels.bcq_matmul.ref import dq_step
from repro_torch.kernels.ternary_matmul import dense_ref, ternary_ref

from torch_port_cases import torch_bundle

PLAIN_TOL = 1e-5
GEMM_TOL = 1e-3


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


def _splits(w, rows):
    """Split counts that leave no range empty (1 and up to 3 more)."""
    stages = -(-w.packed.shape[-1] * 8 // dq_step(rows))
    ok = [s for s in range(1, stages + 1)
          if -(-stages // -(-stages // s)) == s]
    return ok[:1] + ok[1:][-3:]


def _bundle(rng, m, n, g, q, with_z, exact=False):
    """A reference BCQ bundle of random planes: alphas in [0.5, 1.5) (or
    powers of two), offsets N(0, 0.1) (or quarter integers) or none."""
    nb, ng = -(-n // g) * g // 8, -(-n // g)
    alpha = (2.0 ** rng.integers(-3, 2, (q, m, ng)) if exact
             else rng.uniform(0.5, 1.5, (q, m, ng)))
    z = (0.25 * rng.integers(-4, 5, (m, ng)) if exact
         else 0.1 * rng.normal(size=(m, ng)))
    return JPlaneBundle(
        packed=jnp.asarray(rng.integers(0, 256, (q, m, nb), dtype=np.uint8)),
        alpha=jnp.asarray(alpha, jnp.float32),
        z=jnp.asarray(z, jnp.float32) if with_z else None,
        group_size=g, in_features=n, out_features=m)


def _ternary(rng, m, n, g, exact=False):
    """A reference ternary bundle: random sign and mask planes, one alpha
    row (0.5 on exact inputs)."""
    nb, ng = -(-n // g) * g // 8, -(-n // g)
    alpha = (np.full((1, m, ng), 0.5) if exact
             else rng.uniform(0.5, 1.5, (1, m, ng)))
    return JPlaneBundle(
        packed=jnp.asarray(rng.integers(0, 256, (2, m, nb), dtype=np.uint8)),
        alpha=jnp.asarray(alpha, jnp.float32), z=None, group_size=g,
        in_features=n, out_features=m, kind="ternary")


def _xs(rng, b, n):
    """(bf16 x, f32 x that is not a bf16 value) as torch tensors, and the
    same values as numpy f32 arrays for the reference."""
    x = rng.normal(size=(b, n)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xf = torch.from_numpy(x)
    assert not torch.equal(xf, split_bf16x3(xf)[0])
    return ((xb, xb.float().numpy()), (xf, x))


# (group size, in_features, planes, z): every group size at every width,
# q 1-8
BCQ_CASES = [(8, 4096, 1, True), (8, 4100, 3, False), (8, 4092, 8, True),
             (24, 4100, 2, True), (24, 4092, 5, False), (24, 4096, 7, True),
             (40, 4092, 4, True), (40, 4096, 6, False), (40, 4100, 8, False),
             (512, 4096, 3, True), (512, 4100, 1, False),
             (512, 4092, 8, True)]


@pytest.mark.parametrize("g,n,q,with_z", BCQ_CASES)
def test_dq_split_ref_matches_plain_and_reference(g, n, q, with_z):
    """The dequantizing walk against the port's plain version (1e-5) and
    the reference's bcq_matmul kernel (1e-3), bf16 and f32 x, at every
    split count it takes."""
    rng = np.random.default_rng(g + n + q)
    m, b = 24, 5
    wj = _bundle(rng, m, n, g, q, with_z)
    wt = torch_bundle(wj)
    for xt, xn in _xs(rng, b, n):
        if with_z:
            want = j_mxu.bcq_matmul(jnp.asarray(xn), wj, interpret=True)
        else:
            want = j_bcq_ref(jnp.asarray(xn), wj, jnp.float32)
        plain = bcq_matmul_ref(xt, wt, torch.float32).numpy()
        for s in _splits(wt, b):
            got = dq_split_ref(xt, wt, s, torch.float32).numpy()
            assert got.shape == (b, m)
            _close(got, plain, PLAIN_TOL)
            _close(got, np.asarray(want), GEMM_TOL)


@pytest.mark.parametrize("g,n,q,with_z", [(16, 4096, 3, True),
                                          (96, 4224, 2, True),
                                          (16, 4100, 4, False)])
def test_dq_split_ref_decode_rows(g, n, q, with_z):
    """Decode rows (8; 1 against the plain version only) at the group
    sizes and width the decode tile refuses (16, 96; in_features 4100),
    which the dequantizing tile now takes in 512-column stages: the walk
    against the port's plain version (1e-5) and the reference's
    bcq_matmul kernel in interpret mode (1e-3), bf16 and f32 x, at every
    split count it takes."""
    rng = np.random.default_rng(g * 3 + n + q)
    wj = _bundle(rng, 24, n, g, q, with_z)
    wt = torch_bundle(wj)
    for b in (8, 1):
        for xt, xn in _xs(rng, b, n):
            want = None
            if b == 8 and with_z:
                want = j_mxu.bcq_matmul(jnp.asarray(xn), wj, interpret=True)
            elif b == 8:
                want = j_bcq_ref(jnp.asarray(xn), wj, jnp.float32)
            plain = bcq_matmul_ref(xt, wt, torch.float32).numpy()
            for s in _splits(wt, b):
                got = dq_split_ref(xt, wt, s, torch.float32).numpy()
                assert got.shape == (b, 24)
                _close(got, plain, PLAIN_TOL)
                if want is not None:
                    _close(got, np.asarray(want), GEMM_TOL)


@pytest.mark.parametrize("g,n", [(8, 4096), (24, 4100), (40, 4092),
                                 (512, 4096), (16, 4092), (8, 4100)])
def test_dq_split_ref_ternary_matches_plain_and_reference(g, n):
    """Ternary bundles: the walk against ``dense_ref`` (1e-5) and the
    reference's ternary_matmul kernel (1e-3), bf16 and f32 x."""
    rng = np.random.default_rng(g * 7 + n)
    m, b = 24, 3
    tj = _ternary(rng, m, n, g)
    tt = torch_bundle(tj)
    for xt, xn in _xs(rng, b, n):
        want = np.asarray(j_ternary(jnp.asarray(xn), tj, interpret=True))
        plain = dense_ref(xt, tt, torch.float32).numpy()
        for s in _splits(tt, b):
            got = dq_split_ref(xt, tt, s, torch.float32).numpy()
            _close(got, plain, PLAIN_TOL)
            _close(got, want, GEMM_TOL)


@pytest.mark.parametrize("g,n,b", [(8, 4096, 8), (24, 4100, 19),
                                   (512, 4092, 40), (16, 1032, 1)])
def test_dq_split_ref_ternary_exact(g, n, b):
    """Integer x and alpha 0.5: W is {-0.5, 0, 0.5} (lo = 0), x's lower
    parts are 0 and every sum is exact, so the walk equals the half-LUT
    algorithm, the dense product and the reference kernel bit for bit,
    bf16 and f32 x, at every split."""
    rng = np.random.default_rng(g + n + b)
    tj = _ternary(rng, 40, n, g, exact=True)
    tt = torch_bundle(tj)
    x = rng.integers(-8, 9, (b, n)).astype(np.float32)
    want_j = np.asarray(j_ternary(jnp.asarray(x), tj, interpret=True))
    for dtype in (torch.bfloat16, torch.float32):
        xt = torch.from_numpy(x).to(dtype)
        want = ternary_ref(xt, tt, out_dtype=torch.float32)
        assert torch.equal(want, dense_ref(xt, tt, torch.float32))
        np.testing.assert_array_equal(want.numpy(), want_j)
        for s in _splits(tt, b):
            assert torch.equal(dq_split_ref(xt, tt, s, torch.float32), want)


@pytest.mark.parametrize("g,n,q", [(8, 4100, 3), (40, 4092, 8),
                                   (512, 4096, 2)])
def test_dq_split_ref_bcq_exact(g, n, q):
    """Integer x, power-of-two alphas and quarter-integer offsets: every
    dequantized W is a bf16 value (lo = 0) and every sum is exact, so the
    walk equals ``bcq_matmul_ref`` and the reference kernel bit for
    bit."""
    rng = np.random.default_rng(g + q)
    wj = _bundle(rng, 40, n, g, q, True, exact=True)
    wt = torch_bundle(wj)
    b = 9
    x = rng.integers(-8, 9, (b, n)).astype(np.float32)
    want_j = np.asarray(j_mxu.bcq_matmul(jnp.asarray(x), wj, interpret=True))
    for dtype in (torch.bfloat16, torch.float32):
        xt = torch.from_numpy(x).to(dtype)
        want = bcq_matmul_ref(xt, wt, torch.float32)
        np.testing.assert_array_equal(want.numpy(), want_j)
        for s in _splits(wt, b):
            assert torch.equal(dq_split_ref(xt, wt, s, torch.float32), want)


@pytest.mark.parametrize("rows,stages", [(9, 10), (2, 5)])
def test_dq_split_ref_refuses_empty_splits(rows, stages):
    """640 columns are 10 stages of 64 above 8 rows, 2560 are 5 of 512 at
    8 rows or fewer.  10 split 4 ways are 3 + 3 + 3 + 1, 6 ways would be
    five ranges of 2 and an empty sixth; 5 split 3 ways are 2 + 2 + 1, 4
    ways would leave one empty; those and 0 are refused."""
    rng = np.random.default_rng(3)
    n = stages * dq_step(rows)
    wt = torch_bundle(_bundle(rng, 8, n, 8, 2, False))
    assert -(-n // dq_step(rows)) == stages
    x = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))
    good, bad = (4, 6) if stages == 10 else (3, 4)
    _close(dq_split_ref(x, wt, good).numpy(),
           bcq_matmul_ref(x, wt, torch.float32).numpy(), PLAIN_TOL)
    for s in (bad, 0):
        with pytest.raises(ValueError):
            dq_split_ref(x, wt, s)


def test_dq_split_counts():
    """The dequantizing tile's split rule (132 SMs): none while the
    (row, batch) tiles fill the card, else whole stages (64 columns, 512
    at 8 rows or fewer) per split, never more splits than stages."""
    assert (dq_step(8), dq_step(9)) == (512, 64)
    # rows 512 on [16384 x 4096]: 128 x 8 tiles; rows 8: 256 row tiles
    # of 64
    assert dq_splits(512, 16384, 4096, 132) == 1
    assert dq_splits(8, 16384, 4096, 132) == 1
    # rows 8 on [4096 x 4096]: 64 row tiles, 8 stages
    s = dq_splits(8, 4096, 4096, 132)
    assert 1 < s <= 8 and -(-8 // -(-8 // s)) == s
    # a narrow, long weight above 8 rows
    s = dq_splits(32, 64, 16384, 132)
    assert 1 < s <= 256 and -(-256 // -(-256 // s)) == s
    assert dq_splits(9, 64, 64, 132) == 1          # one stage
    assert dq_splits(512, 4096, 4096, 132) == 1
