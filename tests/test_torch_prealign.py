"""Port parity: FIGLUT-I pre-aligned numerics (``repro_torch.core.prealign``
against ``repro.core.prealign``).

The same seeded activations and BCQ weights go through both packages.
``prealign``'s mantissas and scales must be equal bit for bit (the
exponent and scale are computed as XLA computes ``log2`` and ``exp2``),
at mantissa widths 8 (bf16) and 11 (fp16), on rows whose max is exactly,
just under and just over a power of two, and on all-zero rows (the
1e-30 guard).  ``prealigned_bcq_matmul`` must lie within 1e-6 of the
reference's output scale (its alpha / z sums are f32 in another order),
at group sizes 32 and 128, with and without the offset row, with
leading dims; its integer partial sums are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcq as jbcq
from repro.core import prealign as jpre
from repro_torch.core import prealign as tpre
from repro_torch.core.plane import PlaneBundle

TOL = 1e-6
MBS = [8, 11]


def _edge_rows(rng, n=64):
    """Rows whose max is at, just under and just over powers of two, at
    several magnitudes, and all-zero rows."""
    rows = []
    for e in (-24, -10, -1, 0, 1, 7, 13, 20):
        p = np.float32(2.0) ** e
        for m in (p, np.nextafter(p, np.float32(0)),
                  np.nextafter(p, np.float32(np.inf))):
            r = (rng.uniform(-1, 1, n) * p * 0.5).astype(np.float32)
            r[rng.integers(n)] = m if rng.random() < 0.5 else -m
            rows.append(r)
    rows.append(np.zeros(n, np.float32))
    rows.append(np.zeros(n, np.float32))
    return np.stack(rows)


def _random_rows(rng, b=48, n=64):
    scale = np.float32(10.0) ** rng.integers(-6, 6, (b, 1))
    return (rng.normal(size=(b, n)) * scale).astype(np.float32)


@pytest.mark.parametrize("mb", MBS)
@pytest.mark.parametrize("rows", ["edges", "random"])
def test_prealign_bit_identical(mb, rows):
    rng = np.random.default_rng(mb)
    x = _edge_rows(rng) if rows == "edges" else _random_rows(rng)
    mj, sj = jpre.prealign(jnp.asarray(x), mb)
    mt, st = tpre.prealign(torch.from_numpy(x), mb)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert np.all(np.abs(mt.numpy()) <= 2.0 ** mb)
    assert np.all(mt.numpy() == np.round(mt.numpy()))


@pytest.mark.parametrize("mb", MBS)
def test_prealign_other_axis(mb):
    x = _random_rows(np.random.default_rng(3), b=40, n=24)
    mj, sj = jpre.prealign(jnp.asarray(x), mb, axis=0)
    mt, st = tpre.prealign(torch.from_numpy(x), mb, axis=0)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _bundle(wq, drop_z=False):
    return PlaneBundle(
        packed=torch.from_numpy(np.array(wq.packed)),
        alpha=torch.from_numpy(np.array(wq.alpha)),
        z=None if drop_z else torch.from_numpy(np.array(wq.z)),
        group_size=wq.group_size, in_features=wq.in_features,
        out_features=wq.out_features)


@pytest.fixture(scope="module")
def weights():
    """BCQ-3 weights at g 32 and 128 (ragged in_features), the
    reference's quantizer."""
    rng = np.random.default_rng(0)
    out = {}
    for g, n in ((32, 200), (128, 300)):
        w = rng.normal(size=(72, n)).astype(np.float32)
        out[g] = jbcq.quantize(jnp.asarray(w), bits=3, group_size=g)
    return out


@pytest.mark.parametrize("mb", MBS)
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("with_z", [True, False])
def test_prealigned_matmul_matches(weights, mb, g, with_z):
    wq = weights[g]
    if not with_z:
        # the reference always adds its offset row: a zero row there
        # against the port's ``z=None``
        wq = wq.__class__(packed=wq.packed, alpha=wq.alpha,
                          z=jnp.zeros_like(wq.z), group_size=wq.group_size,
                          in_features=wq.in_features,
                          out_features=wq.out_features)
    rng = np.random.default_rng(10 * mb + g)
    x = rng.normal(size=(2, 3, wq.in_features)).astype(np.float32)
    x[0, 1] = 0.0                                       # a zero row
    x[1, 2, 5] = 2.0 ** 7                               # a power-of-two max
    yj = np.asarray(jpre.prealigned_bcq_matmul(jnp.asarray(x), wq, mb))
    yt = tpre.prealigned_bcq_matmul(torch.from_numpy(x),
                                    _bundle(wq, not with_z), mb).numpy()
    assert yt.shape == yj.shape == (2, 3, wq.out_features)
    scale = np.abs(yj).max()
    assert np.abs(yt - yj).max() <= TOL * scale
    assert np.all(yt[0, 1] == 0)


@pytest.mark.parametrize("mb", MBS)
def test_partial_sums_are_integers(weights, mb):
    """``part`` is exact: integers, and the same sums in f64."""
    wq = weights[128]
    b = _bundle(wq)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, wq.in_features)).astype(np.float32))
    y, part = tpre.prealigned_bcq_matmul(x, b, mb, with_partials=True)
    assert torch.equal(y, tpre.prealigned_bcq_matmul(x, b, mb))
    assert torch.equal(part, torch.round(part))
    mant, _ = tpre.prealign(torch.nn.functional.pad(
        x, (0, b.packed.shape[-1] * 8 - x.shape[-1])), mb)
    from repro_torch.core.plane import unpack_planes
    pm1 = unpack_planes(b.packed, torch.float64).reshape(
        3, b.out_features, b.n_groups, b.group_size)
    want = torch.einsum("bGn,qmGn->qbmG",
                        mant.double().reshape(4, b.n_groups, -1), pm1)
    assert torch.equal(part.double(), want)


def test_ternary_refused():
    b = PlaneBundle(packed=torch.zeros((2, 4, 4), dtype=torch.uint8),
                    alpha=torch.ones((1, 4, 1)), z=None, group_size=32,
                    in_features=32, out_features=4, kind="ternary")
    with pytest.raises(ValueError, match="BCQ"):
        tpre.prealigned_bcq_matmul(torch.zeros(1, 32), b)
