"""``repro_torch.quant.optq`` against ``repro.quant.optq`` on the CPU.

The same seeded numpy inputs go through both packages.  Tolerances:
the reconstruction equals the reference's within 1e-4 of the weight's
scale on at least 99.9% of entries, and where it differs, by one grid
step (a column rounded the other way at a grid boundary, after f32
sums in another order); the output error on the calibration set within
1% of the reference's; the uniform-to-BCQ mapping exactly; captured
calibration rows within 1e-5; the OPTQ'd reduced OPT's logits within
1e-3 of the logit scale of the reference's OPTQ'd model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcq as jbcq
from repro.quant import optq as joptq
from repro_torch.core import bcq as tbcq
from repro_torch.core.plane import dequantize
from repro_torch.quant import optq as toptq

from torch_port_cases import port_pair


def _aniso(seed, n_samples, n):
    """Calibration rows with per-column scales 1-7 (anisotropic)."""
    rng = np.random.default_rng(seed)
    scales = 1 + np.abs(rng.normal(size=n)) * 2
    return (rng.normal(size=(n_samples, n)) * scales).astype(np.float32)


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("out,n", [(64, 128), (48, 200)])
def test_optq_quantize_matches_reference(bits, out, n):
    rng = np.random.default_rng(bits * 100 + n)
    w = rng.normal(size=(out, n)).astype(np.float32)
    x = _aniso(n + bits, 512, n)
    jw = joptq.optq_quantize(jnp.asarray(w), jnp.asarray(x), bits=bits,
                             group_size=64)
    tw = toptq.optq_quantize(torch.from_numpy(w), torch.from_numpy(x),
                             bits=bits, group_size=64)
    assert (tw.in_features, tw.out_features, tw.group_size) == \
        (n, out, 64) and tw.packed.shape == tuple(jw.packed.shape)
    jd = np.asarray(jbcq.dequantize(jw))
    td = dequantize(tw, torch.float32).numpy()
    wscale = np.abs(w).max()
    diff = np.abs(td - jd)
    close = diff <= 1e-4 * wscale
    assert close.mean() >= 0.999, close.mean()
    # entries that differ sit one grid step apart (step = 2 alpha_0)
    step = np.repeat(2 * np.asarray(jw.alpha)[0], 64, axis=-1)[:, :n]
    far = ~close
    np.testing.assert_allclose(diff[far], step[far], atol=1e-4 * wscale)
    y = x @ w.T
    err_j = np.mean((x @ jd.T - y) ** 2)
    err_t = np.mean((x @ td.T - y) ** 2)
    assert abs(err_t - err_j) <= 0.01 * err_j, (err_t, err_j)


def test_uniform_to_bcq_is_exact():
    rng = np.random.default_rng(4)
    scale = np.abs(rng.normal(size=(8, 2))).astype(np.float32) + 0.1
    zero = rng.integers(0, 15, size=(8, 2)).astype(np.float32)
    codes = rng.integers(0, 16, size=(8, 2, 64))
    w_q = ((codes - zero[..., None]) * scale[..., None]).astype(
        np.float32).reshape(8, 128)
    tw = toptq.uniform_to_bcq(torch.from_numpy(w_q), torch.from_numpy(scale),
                              torch.from_numpy(zero), bits=4, group_size=64,
                              in_features=128)
    np.testing.assert_allclose(dequantize(tw, torch.float32).numpy(), w_q,
                               atol=1e-5)
    jw = joptq.uniform_to_bcq(jnp.asarray(w_q), jnp.asarray(scale),
                              jnp.asarray(zero), bits=4, group_size=64,
                              in_features=128)
    assert np.array_equal(tw.packed.numpy(), np.asarray(jw.packed))
    assert np.array_equal(tw.alpha.numpy(), np.asarray(jw.alpha))
    assert np.array_equal(tw.z.numpy(), np.asarray(jw.z))


def test_optq_beats_rtn_on_output_error():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(128, 256)).astype(np.float32))
    x = torch.from_numpy(_aniso(1, 512, 256))
    y = x @ w.T
    mse = lambda wq: float(((x @ dequantize(wq, torch.float32).T - y) ** 2)
                           .mean())
    for bits in (3, 4):
        assert mse(toptq.optq_quantize(w, x, bits=bits, group_size=64)) < \
            mse(tbcq.from_uniform(w, bits=bits, group_size=64))


@pytest.fixture(scope="module")
def opt_case():
    """Reduced OPT in both packages, two seeded token batches, each
    package's captured calibration rows (48 rows a call, 40 kept, so the
    rows are drawn) and the reference's OPTQ'd parameters and logits."""
    jm, params, tm = port_pair("opt_6_7b")
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, jm.cfg.vocab_size, (2, 24)).astype(np.int32)
               for _ in range(2)]
    jcal = joptq.capture_calibration(
        jm, params, [{"tokens": jnp.asarray(b)} for b in batches],
        max_samples=40)
    tcal = toptq.capture_calibration(tm, batches, max_samples=40)
    qparams = joptq.optq_quantize_model(
        params, jm.axes(), lambda p, n: jnp.asarray(jcal[p]), bits=3,
        group_size=64)
    want = np.asarray(jax.jit(jm.forward)(
        qparams, {"tokens": jnp.asarray(batches[0])}))
    return tm, batches, jcal, tcal, want


def test_capture_calibration_matches_reference(opt_case):
    tm, batches, jcal, tcal, _ = opt_case
    keys = {"/".join(map(str, p)) for p in jcal}
    assert keys == set(tcal) and len(keys) == 12
    for p, rows in jcal.items():
        got = tcal["/".join(map(str, p))].numpy()
        assert got.shape == (40, rows.shape[1])
        np.testing.assert_allclose(got, rows, atol=1e-5, rtol=0)


def test_optq_model_logits_match_reference(opt_case):
    tm, batches, jcal, tcal, want = opt_case
    done = toptq.optq_quantize_model(
        tm, lambda p, n: tcal[p], bits=3, group_size=64)
    assert len(done) == 12
    assert all(w.group_size == 64 and w.bits == 3 for w in done.values())
    got = tm.forward(torch.from_numpy(batches[0])).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-3)
