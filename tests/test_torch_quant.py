"""Port parity: quantizers, spec, manifest and the backend registry.

Tolerances: quantizer outputs within 1e-5 (f32); manifest byte counts
exactly equal; backend numerics within 1e-5 relative (the same f32 or
bf16-operand arithmetic, summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import bcq as jbcq
from repro.core import lut_gemm as jlg
from repro.models import Model as JModel
from repro import quant as jquant
from repro.quant import backends as jbackends
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.core import bcq as tbcq
from repro_torch.core import lut_gemm as tlg
from repro_torch.models import from_jax_params
from repro_torch.quant import QuantSpec, backends as tbackends, quantize_model

from torch_port_cases import f32_params, to_numpy_tree, torch_bundle

TOL = 1e-5


def _w(m, n, seed):
    return np.random.default_rng(seed).normal(size=(m, n)).astype(np.float32)


def _assert_bundle_close(wt, wj, tol=TOL):
    np.testing.assert_array_equal(wt.packed.numpy(), np.asarray(wj.packed))
    np.testing.assert_allclose(wt.alpha.numpy(), np.asarray(wj.alpha),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(wt.z.numpy(), np.asarray(wj.z), rtol=tol,
                               atol=tol)
    assert (wt.group_size, wt.in_features, wt.out_features) == \
        (wj.group_size, wj.in_features, wj.out_features)


@pytest.mark.parametrize("m,n,bits,g", [(33, 130, 2, 64), (64, 256, 3, 128),
                                        (16, 96, 4, 32)])
def test_from_uniform_matches(m, n, bits, g):
    w = _w(m, n, m + bits)
    wj = jbcq.from_uniform(jnp.asarray(w), bits=bits, group_size=g)
    wt = tbcq.from_uniform(torch.from_numpy(w), bits=bits, group_size=g)
    _assert_bundle_close(wt, wj)


@pytest.mark.parametrize("m,n,bits,g", [(32, 128, 2, 64), (24, 256, 3, 128),
                                        (17, 72, 3, 32)])
def test_bcq_quantize_matches(m, n, bits, g):
    w = _w(m, n, 7 * m + bits)
    wj = jbcq.quantize(jnp.asarray(w), bits=bits, group_size=g, iters=3)
    wt = tbcq.quantize(torch.from_numpy(w), bits=bits, group_size=g, iters=3)
    # the solvers agree on the quantized WEIGHTS within 1e-5.  Individual
    # planes/alphas may differ where the fit is degenerate (a plane that
    # is constant over a group is collinear with the offset column, and
    # near-equidistant codewords flip on the last f32 bit), but the
    # reconstruction they encode does not.
    np.testing.assert_allclose(wt.dequantize().numpy(),
                               np.asarray(wj.dequantize()), rtol=TOL,
                               atol=TOL)
    assert wt.packed.shape == tuple(wj.packed.shape)
    assert wt.alpha.shape == tuple(wj.alpha.shape)
    err_t = np.abs(w - wt.dequantize().numpy()).mean()
    err_j = np.abs(w - np.asarray(wj.dequantize())).mean()
    assert abs(err_t - err_j) <= TOL


def test_spec_rejects_unported_formats():
    """ternary is ported; a fractional width on another format is mixed
    precision, planned over candidates (2, 3, 4) at 2.4 bits; a format
    the port does not carry is refused."""
    t = QuantSpec(format="ternary")
    assert t.bits == 1.585 and t.int_bits == 2
    m = QuantSpec(bits=2.4)
    assert m.is_fractional and m.is_mixed
    assert m.candidate_bits == (2, 3, 4)
    with pytest.raises(ValueError, match="unknown quant format"):
        QuantSpec(format="fp4")
    s = QuantSpec(format="uniform", bits=3.0)
    assert s.format == "rtn" and s.bits == 3 and isinstance(s.bits, int)


@pytest.mark.parametrize("fmt", ["bcq", "rtn"])
def test_manifest_bytes_equal(fmt):
    cfg = get_reduced("opt_6_7b").replace(remat=False, dtype="float32")
    jm = JModel(cfg)
    params = f32_params(jm.init(jax.random.PRNGKey(0)))
    jspec = jquant.QuantSpec(format=fmt, bits=3, group_size=32, iters=2)
    _, jman = jquant.quantize_model(params, jspec, jm.axes())
    tcfg = t_reduced("opt_6_7b").replace(dtype="float32")
    tm = from_jax_params(to_numpy_tree(params), tcfg, device="cpu")
    tman = quantize_model(tm, QuantSpec(format=fmt, bits=3, group_size=32,
                                        iters=2))
    assert tman.quant_bytes == jman.quant_bytes
    assert tman.n_weights == jman.n_weights
    assert tman.dense_bytes == jman.dense_bytes
    assert [l["path"] for l in tman.layers] == [l["path"] for l in
                                                jman.layers]
    assert [l["quant_bytes"] for l in tman.layers] == \
        [l["quant_bytes"] for l in jman.layers]
    # embeddings and norms stay FP
    assert isinstance(tm.embed.tok, torch.Tensor)
    assert not any("tok" in l["path"] or "pos" in l["path"]
                   for l in tman.layers)


@pytest.mark.parametrize("arch", ["opt_6_7b", "minicpm3_4b"])
def test_scan_layers_manifest_matches_reference(arch):
    """Under ``scan_layers=True`` the reference keys each projection by its
    stacked leaf (``stack/scan/0/mixer/q``, [L, out, in]); the port's
    manifest has the same entries, entry for entry."""
    cfg = get_reduced(arch).replace(remat=False, dtype="float32",
                                    scan_layers=True)
    jm = JModel(cfg)
    params = f32_params(jm.init(jax.random.PRNGKey(0)))
    jspec = jquant.QuantSpec(bits=3, group_size=32, iters=2)
    _, jman = jquant.quantize_model(params, jspec, jm.axes())
    tcfg = t_reduced(arch).replace(dtype="float32", scan_layers=True)
    tm = from_jax_params(to_numpy_tree(params), tcfg, device="cpu")
    tman = quantize_model(tm, QuantSpec(bits=3, group_size=32, iters=2))
    assert any("/scan/0/" in l["path"] for l in jman.layers)
    assert tman.layers == jman.layers
    assert tman.to_dict() == jman.to_dict()


def test_chains_match_reference():
    assert tbackends.AUTO_CHAIN == jbackends.AUTO_CHAIN
    for k, v in jbackends.FALLBACK_CHAINS.items():
        assert tbackends.FALLBACK_CHAINS[k] == v


def test_resolution_on_cpu_host(monkeypatch):
    """Off the card ``auto`` lands on bcq_xla (the kernels are not
    native); an explicit kernel preference resolves to the kernel's
    wrapper, which runs its plain version on CPU tensors; an unsupported
    shape negotiates down the chain."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tbackends.on_h100.cache_clear()
    try:
        _check_cpu_resolution()
    finally:
        monkeypatch.undo()
        tbackends.on_h100.cache_clear()


def _check_cpu_resolution():
    w = tbcq.from_uniform(torch.from_numpy(_w(8, 64, 1)), bits=2,
                          group_size=32)
    assert tbackends.resolve_backend("auto", w) == "bcq_xla"
    assert tbackends.resolve_backend("mxu_pallas", w) == "mxu_pallas"
    assert tbackends.resolve_backend("lut_pallas", w) == "lut_pallas"
    odd = tbcq.from_uniform(torch.from_numpy(_w(8, 72, 2)), bits=2,
                            group_size=12)
    assert tbackends.resolve_backend("mxu_pallas", odd) == "bcq_xla"
    assert tbackends.matmul_unsupported_reason("lut_gemm", odd) == \
        "group_size"


@pytest.mark.parametrize("backend", ["dense", "bcq_xla", "bcq_xla_planes"])
def test_plain_backends_match(backend):
    rng = np.random.default_rng(3)
    w = _w(48, 130, 5)
    x = rng.normal(size=(2, 3, 130)).astype(np.float32)
    wj = jbcq.from_uniform(jnp.asarray(w), bits=3, group_size=64)
    want = np.asarray(jlg.bcq_apply(jnp.asarray(x), wj, backend=backend))
    got = tlg.bcq_apply(torch.from_numpy(x), torch_bundle(wj),
                        backend=backend).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=TOL)
