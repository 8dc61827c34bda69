"""Port parity: the plane layout (``repro_torch.core.plane``).

Packed bytes and dequantized weights must be BIT-equal to the reference
(tolerance 0): both sides compute the same f32 expression in the same
order.  ``unpack_planes`` returns ±1 planes (the reference's contract,
``repro/core/plane.py:144-150``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcq as jbcq
from repro.core import plane as jplane
from repro_torch.core import plane as tplane

from torch_port_cases import torch_bundle


@pytest.mark.parametrize("q,out,n", [(1, 4, 8), (3, 33, 136), (4, 64, 256)])
def test_pack_planes_bit_equal(q, out, n):
    rng = np.random.default_rng(q * 100 + out)
    planes = np.where(rng.random((q, out, n)) < 0.5, -1.0, 1.0) \
        .astype(np.float32)
    want = np.asarray(jplane.pack_planes(jnp.asarray(planes)))
    got = tplane.pack_planes(torch.from_numpy(planes)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unpack_planes_returns_pm1_and_matches(seed):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (3, 7, 5), dtype=np.uint8)
    got = tplane.unpack_planes(torch.from_numpy(packed)).numpy()
    want = np.asarray(jplane.unpack_planes(jnp.asarray(packed)))
    assert set(np.unique(got)) <= {-1.0, 1.0}          # ±1, never {0, 1}
    np.testing.assert_array_equal(got, want)
    # round trip: pack(unpack(p)) == p
    back = tplane.pack_planes(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back, packed)


@pytest.mark.parametrize("m,n,bits,g", [(33, 130, 2, 64), (64, 128, 3, 32),
                                        (16, 256, 4, 128)])
def test_dequantize_bit_equal(m, n, bits, g):
    rng = np.random.default_rng(m + n + bits)
    w = rng.normal(size=(m, n)).astype(np.float32)
    wj = jbcq.from_uniform(jnp.asarray(w), bits=bits, group_size=g)
    wt = torch_bundle(wj)
    want = np.asarray(jplane.dequantize(wj))
    got = tplane.dequantize(wt).numpy()
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got, want)
    assert wt.nbytes() == wj.nbytes()
    assert wt.bits == wj.bits and wt.n_groups == wj.n_groups


def test_pad_operands_zero_pads_to_weight_width():
    rng = np.random.default_rng(4)
    wj = jbcq.from_uniform(jnp.asarray(rng.normal(size=(8, 130))
                                       .astype(np.float32)), bits=2,
                           group_size=64)
    x = torch.ones(3, 130)
    xp = tplane.pad_operands(x, torch_bundle(wj))
    assert xp.shape == (3, 192)
    assert float(xp[:, 130:].abs().sum()) == 0.0


def test_unported_kind_raises():
    """ternary is a bundle kind now; an unknown kind still raises."""
    kw = dict(packed=torch.zeros(2, 1, 1, dtype=torch.uint8),
              alpha=torch.zeros(1, 1, 1), z=None, group_size=8,
              in_features=8, out_features=1)
    w = tplane.PlaneBundle(kind="ternary", **kw)
    assert w.effective_bits == tplane.TERNARY_BITS == jplane.TERNARY_BITS
    assert tplane.KINDS == jplane.KINDS
    with pytest.raises(ValueError, match="kind"):
        tplane.PlaneBundle(kind="nf4", **kw)
