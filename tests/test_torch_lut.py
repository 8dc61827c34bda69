"""Port parity: the host LUT math (``repro_torch.core.lut`` against
``repro.core.lut``), at mu 2, 3, 4 and 8.

Sign matrices, keys and adder counts are integers and must be equal;
the tables are sums of mu signed f32 terms in one order on both sides,
held within 1e-6; the half-table decode reads the full table exactly.
The generator's count is the paper's 14 adds at mu 4 (half table).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro_torch.core import lut as tlut

MUS = [2, 3, 4, 8]
TOL = 1e-6


def _x(mu, seed=0):
    return np.random.default_rng(seed + mu).normal(
        size=(3, 5 * mu * 8)).astype(np.float32)


def _planes(mu, seed=1):
    rng = np.random.default_rng(seed + mu)
    return np.where(rng.random((2, 7, 8 * mu)) > 0.5, 1.0, -1.0).astype(
        np.float32)


@pytest.mark.parametrize("mu", MUS)
def test_sign_matrix_matches(mu):
    np.testing.assert_array_equal(tlut.sign_matrix(mu).numpy(),
                                  np.asarray(jlut.sign_matrix(mu)))


@pytest.mark.parametrize("mu", MUS)
def test_build_luts_match(mu):
    x = _x(mu)
    for tf, jf in ((tlut.build_lut, jlut.build_lut),
                   (tlut.build_half_lut, jlut.build_half_lut)):
        got = tf(torch.from_numpy(x), mu).numpy()
        want = np.asarray(jf(jnp.asarray(x), mu))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mu", MUS)
def test_keys_and_half_decode_match(mu):
    planes = _planes(mu)
    keys_t = tlut.extract_keys(torch.from_numpy(planes), mu)
    keys_j = np.asarray(jlut.extract_keys(jnp.asarray(planes), mu))
    assert keys_t.dtype == torch.int32
    np.testing.assert_array_equal(keys_t.numpy(), keys_j)
    # decode every key of one plane row against a half table of x
    x = _x(mu)[:1, :planes.shape[-1]]
    half = tlut.build_half_lut(torch.from_numpy(x), mu)         # [1, G, H]
    full = tlut.build_lut(torch.from_numpy(x), mu)              # [1, G, P]
    k = keys_t[0, :1]                                           # [1, G]
    got = tlut.decode_half_lut(half, k, mu)
    want_j = np.asarray(jlut.decode_half_lut(
        jnp.asarray(half.numpy()), jnp.asarray(k.numpy()), mu))
    np.testing.assert_array_equal(got.numpy(), want_j)
    np.testing.assert_array_equal(
        got.numpy(), torch.gather(full, -1, k.long()[..., None])[..., 0])


@pytest.mark.parametrize("mu", MUS)
def test_keys_from_packed_match(mu):
    from repro_torch.core.plane import pack_planes
    planes = _planes(mu)
    packed = pack_planes(torch.from_numpy(planes))
    if 8 % mu:
        for f in (tlut.keys_from_packed,
                  lambda p, m: jlut.keys_from_packed(jnp.asarray(p.numpy()),
                                                     m)):
            with pytest.raises(ValueError, match="must divide 8"):
                f(packed, mu)
        return
    got = tlut.keys_from_packed(packed, mu)
    want = np.asarray(jlut.keys_from_packed(jnp.asarray(packed.numpy()), mu))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tlut.extract_keys(torch.from_numpy(planes), mu).numpy())


@pytest.mark.parametrize("mu", MUS)
def test_adder_counts_match(mu):
    for half in (True, False):
        assert tlut.naive_adder_count(mu, half) == \
            jlut.naive_adder_count(mu, half)
        assert tlut.generator_adder_count(mu, half) == \
            jlut.generator_adder_count(mu, half)
    if mu == 4:
        assert tlut.generator_adder_count(4) == 14
        assert tlut.naive_adder_count(4) == 24


def test_kernel_helpers_use_core_lut():
    """The kernels' plain-version helpers read through ``core.lut``: the
    half and full reads of ``lut_common`` equal the full table's keyed
    read."""
    from repro_torch.kernels import lut_common
    mu = 4
    x = torch.from_numpy(_x(mu)[:2])
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(0, 16, (6, x.shape[-1] // mu)))
    full = lut_common.build_lut(x, mu, False)
    want = torch.gather(full[:, None].expand(2, 6, *full.shape[1:]), 3,
                        keys[None, :, :, None].expand(2, 6, -1, 1))[..., 0]
    for half in (True, False):
        got = lut_common.read_lut(lut_common.build_lut(x, mu, half), keys,
                                  mu, half)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(
        lut_common.sign_matrix(mu, True).numpy(),
        np.asarray(jlut.sign_matrix(mu))[8:])
