"""Port parity: reduced OPT, dense and BCQ, both packages in float32.

``prefill_chunk`` (into a scrambled, non-contiguous block table) and
``decode_step`` logits must agree within 1e-4 relative to the logit
scale; so must full-sequence ``forward`` logits after carrying a
scan-stacked parameter tree across (``from_jax_params``).

With an int8 KV cache (``kv_cache_bits=8``) ``_quantize_kv`` is
bit-exact against the reference, and the gathered path agrees within
1e-4 as above.  The fused path is held within 1e-2: there the reference
runs its Pallas kernels (interpret mode), which round p * v_scale to
bf16 before normalizing, while the port's CPU wrappers run the plain
versions, which round after it (the reference oracles' order); the
one-ulp bf16 differences compound over the layers (measured 2.2e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import set_block_tables as j_set_tables
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models import set_block_tables

from torch_port_cases import port_pair

TOL = 1e-4
KV8_FUSED_TOL = 1e-2
G = 32          # group size for the reduced widths (d_model 64, d_ff 128)


def _pair(quantized: bool, scan: bool = False, paged_kernel="auto",
          kv_cache_bits=16):
    return port_pair("opt_6_7b",
                     quant=dict(bits=3, group_size=G, iters=2)
                     if quantized else None, paged_kernel=paged_kernel,
                     scan_layers=scan, kv_cache_bits=kv_cache_bits)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _prefill_then_decode(jm, params, tm, rel_tol):
    """Two prefill chunks into a scrambled block table, then three decode
    steps; every step's logits within ``rel_tol`` of the logit scale."""
    vocab = jm.cfg.vocab_size
    rng = np.random.default_rng(3)
    toks = rng.integers(0, vocab, (1, 20)).astype(np.int32)
    bs, nblk = 4, 8
    table = np.full((1, nblk), -1, np.int32)
    table[0, :6] = [11, 3, 7, 14, 2, 9]
    jc = j_set_tables(jm.init_paged_cache(1, 16, bs, nblk), table)
    tc = set_block_tables(tm.init_paged_cache(1, 16, bs, nblk), table)
    for c0, c1, pad in ((0, 7, 1), (7, 16, 0)):
        chunk = np.zeros((1, c1 - c0 + pad), np.int32)
        chunk[0, :c1 - c0] = toks[0, c0:c1]
        jl, jc = jm.prefill_chunk(params, {"tokens": jnp.asarray(chunk)}, jc,
                                  jnp.int32(c0), jnp.int32(c1 - c0 - 1))
        tl, tc = tm.prefill_chunk(torch.from_numpy(chunk), tc, c0,
                                  c1 - c0 - 1)
        assert tl.shape == (1, vocab) and tl.dtype == torch.float32
        assert _rel(tl, jl) < rel_tol
    for t in range(16, 19):
        step = toks[:, t:t + 1]
        jl, jc = jm.decode_step(params, jnp.asarray(step), jc, t)
        tl, tc = tm.decode_step(torch.from_numpy(step), tc, t)
        assert _rel(tl, jl) < rel_tol
    return tc, jc


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_chunk_and_decode_match(quantized):
    tc, jc = _prefill_then_decode(*_pair(quantized), TOL)
    # the pools hold the same KV at the same slots
    np.testing.assert_array_equal(tc["layers"][0]["pos"].numpy(),
                                  np.asarray(jc["layers"][0]["self"]["pos"]))
    np.testing.assert_allclose(tc["layers"][1]["k"].numpy(),
                               np.asarray(jc["layers"][1]["self"]["k"]),
                               atol=1e-5)


def test_quantize_kv_bit_exact():
    from repro.models.attention import _quantize_kv as j_qkv
    from repro_torch.models.attention import _quantize_kv as t_qkv
    rng = np.random.default_rng(0)
    t = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    t[0, 0, 0] = 0.0                              # an all-zero vector
    t[1, 2, 3, :2] = [127.5, -127.5]              # half-way ties
    for x in (t, t.astype(jnp.bfloat16)):
        jq, js = j_qkv(jnp.asarray(x))
        xt = torch.from_numpy(np.asarray(x, np.float32))
        if x.dtype != np.float32:
            xt = xt.to(torch.bfloat16)
        tq, ts = t_qkv(xt)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("paged_kernel,tol", [("gather", TOL),
                                              ("fused", KV8_FUSED_TOL)])
@pytest.mark.parametrize("quantized", [False, True])
def test_int8_kv_prefill_chunk_and_decode_match(paged_kernel, tol,
                                                quantized):
    jm, params, tm = _pair(quantized, paged_kernel=paged_kernel,
                           kv_cache_bits=8)
    tc, jc = _prefill_then_decode(jm, params, tm, tol)
    layer = tc["layers"][0]
    assert layer["k"].dtype == torch.int8
    assert layer["k_scale"].shape == layer["k"].shape[:3]
    # layer 0 sees the same embeddings: the same int8 KV at the same slots
    np.testing.assert_array_equal(layer["pos"].numpy(),
                                  np.asarray(jc["layers"][0]["self"]["pos"]))
    np.testing.assert_array_equal(layer["k"].numpy(),
                                  np.asarray(jc["layers"][0]["self"]["k"]))


def test_fused_paged_path_matches_gathered():
    """paged_kernel='fused' (the kernels' plain versions on the CPU) and
    'gather' give the same logits."""
    _, _, tm = _pair(True)
    tg = tm.with_config(paged_kernel="gather")
    tf = tm.with_config(paged_kernel="fused")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 9)).astype(np.int32))
    table = np.array([[4, 9, 1, -1], [6, 2, 12, -1]], np.int32)
    outs = []
    for m in (tg, tf):
        c = set_block_tables(m.init_paged_cache(2, 16, 4, 4), table)
        lp, c = m.prefill_chunk(toks, c, 0, 8)
        ld, c = m.decode_step(toks[:, :1], c, torch.tensor([9, 9]))
        outs.append((lp, ld))
    assert _rel(outs[1][0], outs[0][0]) < TOL
    assert _rel(outs[1][1], outs[0][1]) < TOL


@pytest.mark.parametrize("quantized", [False, True])
def test_scan_stacked_tree_forward_matches(quantized):
    jm, params, tm = _pair(quantized, scan=True)
    assert "scan" in params["stack"]
    toks = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(
        np.int32)
    want = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    assert got.shape == tuple(want.shape)
    assert _rel(got, want) < TOL


def test_unported_variants_raise():
    """A stack whose layers are attention layers of kind "none" (no SSM
    state: no mixer to build) is refused, and an unknown arch is refused
    where it is looked up; GQA with rotary positions and sliding windows
    are ported (both were refused here before) and build and run, as do
    the last three configs (Jamba, Pixtral, Whisper), which
    ``get_config`` refused before.  Attention-free SSM stacks are built
    in ``test_torch_ssm.py``, the last three in ``test_torch_hybrid.py``,
    ``test_torch_vlm.py`` and ``test_torch_encdec.py``."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro.configs import get_config as j_config
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import Model
    cfg = t_reduced("opt_6_7b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg.replace(attention="none"), device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt_2")
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)
    for arch in ("jamba_1_5_large_398b", "pixtral_12b", "whisper_medium"):
        assert get_config(arch).name == j_config(arch).name
    for over in (dict(pos="rope"), dict(pos="rope", sliding_window=2)):
        m = Model(cfg.replace(**over), device="cpu").init_params(
            torch.Generator().manual_seed(0))
        logits = m.forward(torch.zeros((1, 4), dtype=torch.int32))
        assert logits.shape == (1, 4, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())


def test_kv_cache_bits_view_writes_int8_pools():
    """A ``with_config(kv_cache_bits=8)`` view shares the attention
    modules of a model built for a bf16 cache: its pools must still be
    quantized by ``_quantize_kv`` (not cast), giving the logits of a
    model built with ``kv_cache_bits=8``."""
    _, _, built = _pair(True, kv_cache_bits=8)
    _, _, base = _pair(True)
    view = base.with_config(kv_cache_bits=8)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (1, 9)).astype(np.int32))
    table = np.array([[4, 9, 1, -1]], np.int32)
    outs = []
    for m in (built, view):
        c = set_block_tables(m.init_paged_cache(1, 16, 4, 4), table)
        lp, c = m.prefill_chunk(toks, c, 0, 8)
        ld, c = m.decode_step(toks[:, :1], c, 9)
        assert float(c["layers"][0]["k_scale"].abs().max()) > 0
        outs.append((lp, ld, c["layers"][1]["k"]))
    assert torch.equal(outs[0][2], outs[1][2])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
