"""Port parity: MiniCPM3 (MLA) against the reference, on the CPU.

Inputs are made with numpy from seeds and handed to both packages;
reference parameter trees cross over as numpy arrays.  Tolerances:

- absorbed MLA decode, plain version against the reference's oracle and
  its Pallas kernel (interpret mode): atol 1e-5, the reference test's own;
- ``apply_rope``: 1e-6 (f32 trigonometry in both);
- model logits (``forward``, chunked prefill, decode): 1e-4 of the logit
  scale, the ``TOL`` of ``test_torch_model.py`` (f32 on both sides; only
  the summation order differs);
- greedy serving streams: token for token (tolerance 0 on token ids).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_config as j_config
from repro.configs import get_reduced as j_reduced
from repro.kernels.paged_attention import paged_attention_mla as j_mla_kernel
from repro.kernels.paged_attention import paged_decode_mla_ref as j_mla_ref
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models.layers import apply_rope as j_rope
from repro.serve import Request as JRequest
from repro.serve import set_block_tables as j_set_tables
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.kernels.paged_attention import (paged_attention_mla,
                                                 paged_decode_mla_ref,
                                                 paged_decode_mla_split_ref)
from repro_torch.models import attention as tattn
from repro_torch.models import from_jax_params, set_block_tables
from repro_torch.models.layers import apply_rope as t_rope
from repro_torch.quant import QuantSpec, quantize_model
from repro_torch.serve import PagedServeEngine, Request

from torch_port_cases import (f32_params, live_slots, mla_pool_case,
                              port_pair, ref_paged_engine, to_numpy_tree)

TOL = 1e-4
MLA_ATOL = 1e-5
G = 16          # divides every reduced MLA input width (16, 32, 64, 128)
ARCH = "minicpm3_4b"


def _pair(quantized: bool, scan: bool = False, paged_kernel="auto",
          backend=None):
    quant = None
    if quantized:
        quant = dict(bits=3, group_size=G, iters=2)
        if backend:
            quant["backend"] = backend
    return port_pair(ARCH, quant=quant, paged_kernel=paged_kernel,
                     scan_layers=scan)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, {}), (2, dict(h=6)),
                                     (3, dict(lora=20, dr=6, bs=5))])
def test_paged_decode_mla_matches_reference(seed, kw):
    """The reference's ``_mla_pool_case`` shapes (and a ragged variant):
    the port's wrapper on CPU tensors (its plain version) against the
    reference's oracle and its Pallas kernel in interpret mode."""
    case = mla_pool_case(seed, **kw)
    lora, dr = case[0].shape[-1], case[1].shape[-1]
    sc = (lora + dr) ** -0.5
    got = paged_attention_mla(*map(torch.from_numpy, case), scale=sc)
    jcase = [jnp.asarray(a) for a in case]
    want = j_mla_ref(*jcase, scale=sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MLA_ATOL)
    kern = j_mla_kernel(*jcase, scale=sc, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern),
                               atol=MLA_ATOL)


def test_paged_decode_mla_zero_live_and_stale_slots():
    """Row 0 has no live slot: zeros, never NaN.  Every non-live slot
    (trash block, unused blocks, the recycled block's stale positions,
    slots past a row's position) may hold anything."""
    q_eff, q_rope, ckv, krope, pos, tables, positions = mla_pool_case(5)
    sc = 20 ** -0.5
    args = lambda c, r: [torch.from_numpy(a) for a in
                         (q_eff, q_rope, c, r, pos, tables, positions)]
    base = paged_attention_mla(*args(ckv, krope), scale=sc)
    assert torch.isfinite(base).all()
    assert float(base[0].abs().max()) == 0.0
    dead = ~live_slots(pos, tables, positions)
    assert dead.any() and not dead.all()
    c2, r2 = ckv.copy(), krope.copy()
    c2[dead], r2[dead] = 7.7, -7.7
    again = paged_attention_mla(*args(c2, r2), scale=sc)
    np.testing.assert_allclose(again.numpy(), base.numpy(), atol=1e-6)


# the MLA decode kernel's split walk: whole pages per split, so the
# 6-page tables of ``mla_pool_case`` take 1-6 splits (6 splits put one
# page in each, more splits than a short row has live pages)
_JAX_MLA = {}


def _jax_mla(seed, kw):
    """The case, its scale and the reference kernel's output (interpret
    mode), once per case."""
    key = (seed, tuple(sorted(kw.items())))
    if key not in _JAX_MLA:
        case = mla_pool_case(seed, **kw)
        sc = (case[0].shape[-1] + case[1].shape[-1]) ** -0.5
        kern = j_mla_kernel(*map(jnp.asarray, case), scale=sc,
                            interpret=True)
        _JAX_MLA[key] = (case, sc, np.asarray(kern))
    return _JAX_MLA[key]


@pytest.mark.parametrize("splits", [1, 2, 3, 6])
@pytest.mark.parametrize("seed,kw", [(0, {}), (2, dict(h=6)),
                                     (3, dict(lora=20, dr=6, bs=5))])
def test_paged_decode_mla_split_matches_reference(seed, kw, splits):
    """Partials per range of whole pages merged in split order equal the
    unsplit plain version and the reference kernel (interpret mode)
    within 1e-5: idle row 0 (zeros), -1 pads, a stale recycled block,
    splits past a short row's live pages (empty, merged as such)."""
    case, sc, want = _jax_mla(seed, kw)
    args = list(map(torch.from_numpy, case))
    got = paged_decode_mla_split_ref(*args, splits, scale=sc).numpy()
    plain = paged_decode_mla_ref(*args, scale=sc).numpy()
    np.testing.assert_allclose(got, plain, atol=MLA_ATOL)
    np.testing.assert_allclose(got, want, atol=MLA_ATOL)
    assert np.abs(got[0]).max() == 0.0


def test_paged_decode_mla_split_empty_splits():
    """With a split per page, some splits of a live row hold no live slot
    (pages past its position, -1 pads): their partials are (NEG_INF, 0,
    0), and the merge still gives the plain result."""
    from repro_torch.kernels.paged_attention.ref import (NEG_INF,
                                                         mla_split_partials)
    case, sc, want = _jax_mla(0, {})
    args = list(map(torch.from_numpy, case))
    m, l, acc = mla_split_partials(*args, 6, scale=sc)
    empty = l == 0
    assert empty[:, 1:].any() and empty[:, 0].all()
    assert (m[empty] == NEG_INF).all() and (acc[empty] == 0).all()


@pytest.mark.parametrize("b,h,pages,sms", [
    (8, 40, 32, 132), (1, 40, 32, 132), (3, 40, 6, 132), (3, 8, 6, 132),
    (64, 40, 32, 132), (200, 40, 32, 132), (8, 72, 32, 132),
    (2, 13, 3, 8), (1, 40, 1, 132)])
def test_mla_split_count_covers_the_table(b, h, pages, sms):
    """Every split is a whole number of pages, every page of the table is
    in one and no split lies past it; the serve batch (B 8, 40 heads,
    32-page tables) takes 16 splits of two pages (one block per SM), and
    a batch that fills the card takes none."""
    from repro_torch.kernels.paged_attention.ops import mla_splits
    s = mla_splits(b, h, pages, sms)
    per = -(-pages // s)
    assert 1 <= s <= pages and (s - 1) * per < pages <= s * per
    if (b, h, pages) == (8, 40, 32):
        assert s == 16
    if b >= 200:
        assert s == 1


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.array([[-1, 0, 1, 7, 300], [4, 5, 6, -1, -1]], np.int32)
    for theta in (10000.0, 500.0):
        want = j_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = t_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # 1-D positions broadcast over the batch; bf16 in, bf16 out
    got = t_rope(torch.from_numpy(x).to(torch.bfloat16),
                 torch.from_numpy(pos[0]), 10000.0)
    assert got.dtype == torch.bfloat16
    want = j_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos[0]), 10000.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-6)


def test_rms_eps_is_the_references():
    from repro.models.attention import _rms as j_rms
    x = np.random.default_rng(1).normal(size=(2, 3, 16)).astype(np.float32)
    x[0, 0] *= 1e-4                    # small rows: eps matters
    scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
    want = j_rms(jnp.asarray(x), jnp.asarray(scale))
    got = tattn._rms(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_forward_matches_reference(quantized, scan):
    jm, params, tm = _pair(quantized, scan=scan)
    assert ("scan" in params["stack"]) == scan
    toks = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(
        np.int32)
    want = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    assert got.shape == tuple(want.shape)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("paged_kernel", ["gather", "fused"])
@pytest.mark.parametrize("quantized", [False, True])
def test_chunked_prefill_then_decode_matches(quantized, paged_kernel):
    """prefill_chunk x3 into a scrambled block table, then decode steps:
    each step's logits against the reference model's, and against the
    port's own full-sequence forward (teacher forcing)."""
    jm, params, tm = _pair(quantized, paged_kernel=paged_kernel,
                           backend="bcq_xla" if quantized else None)
    rng = np.random.default_rng(3)
    s = 24
    toks = rng.integers(0, 256, (1, s)).astype(np.int32)
    full = tm.forward(torch.from_numpy(toks))
    bs, nblk = 4, 10
    table = np.full((1, nblk), -1, np.int32)
    table[0, :8] = [11, 3, 7, 14, 2, 9, 5, 12]
    jc = j_set_tables(jm.init_paged_cache(1, 16, bs, nblk), table)
    tc = set_block_tables(tm.init_paged_cache(1, 16, bs, nblk), table)
    for c0, c1 in ((0, 7), (7, 15), (15, s - 4)):
        chunk = toks[:, c0:c1]
        jl, jc = jm.prefill_chunk(params, {"tokens": jnp.asarray(chunk)}, jc,
                                  jnp.int32(c0), jnp.int32(c1 - c0 - 1))
        tl, tc = tm.prefill_chunk(torch.from_numpy(chunk), tc, c0,
                                  c1 - c0 - 1)
        assert _rel(tl, jl) < TOL
        assert _rel(tl, full[:, c1 - 1]) < TOL
    for t in range(s - 4, s - 1):
        step = toks[:, t:t + 1]
        jl, jc = jm.decode_step(params, jnp.asarray(step), jc, t)
        tl, tc = tm.decode_step(torch.from_numpy(step), tc, t)
        assert _rel(tl, jl) < TOL
        assert _rel(tl, full[:, t]) < TOL
    # the latent pools hold the same entries at the same slots
    jl0 = jc["layers"][0]["self"]
    np.testing.assert_array_equal(tc["layers"][0]["pos"].numpy(),
                                  np.asarray(jl0["pos"]))
    np.testing.assert_allclose(tc["layers"][0]["ckv"].numpy(),
                               np.asarray(jl0["ckv"]), atol=1e-5)
    np.testing.assert_allclose(tc["layers"][0]["krope"].numpy(),
                               np.asarray(jl0["krope"]), atol=1e-5)


def test_absorbed_weights_follow_the_weight_object():
    """w_uk / w_uv are computed once per kv_b weight object: quantizing
    the model swaps the weight and the split is recomputed."""
    _, _, tm = _pair(False)
    mixer = tm.stack.layers[0].mixer
    uk, uv = mixer.absorbed_weights()
    assert mixer.absorbed_weights()[0] is uk            # cached
    cfg = tm.cfg
    assert tuple(uk.shape) == (cfg.n_heads, cfg.qk_nope_head_dim,
                               cfg.kv_lora_rank)
    assert tuple(uv.shape) == (cfg.n_heads, cfg.v_head_dim, cfg.kv_lora_rank)
    quantize_model(tm, QuantSpec(bits=3, group_size=G, iters=2))
    uk2, _ = mixer.absorbed_weights()
    assert uk2 is not uk and not torch.equal(uk2, uk)
    from repro_torch.core.plane import dequantize
    w = dequantize(mixer.kv_b.weight, torch.float32)
    np.testing.assert_array_equal(
        uk2.numpy(), w.reshape(cfg.n_heads, -1, cfg.kv_lora_rank)
        [:, :cfg.qk_nope_head_dim].numpy())


@pytest.mark.parametrize("reduced", [True, False])
def test_kv_entry_bytes_and_pool_match_reference(reduced):
    jcfg = (j_reduced if reduced else j_config)(ARCH)
    tcfg = (t_reduced if reduced else t_config)(ARCH)
    for kv_bits in (16, 8):              # kv_cache_bits is ignored for MLA
        assert tattn.kv_entry_bytes(tcfg.replace(kv_cache_bits=kv_bits)) \
            == jattn.kv_entry_bytes(jcfg.replace(kv_cache_bits=kv_bits))
    if not reduced:
        assert tattn.kv_entry_bytes(tcfg) * tcfg.n_layers == 35712
        return
    desc = jattn.paged_cache_desc(jcfg, 2, 9, 4, 5)
    pool = tattn.init_paged_layer_cache(tcfg.replace(kv_cache_bits=8), 2, 9,
                                        4, 5, "cpu")
    assert set(pool) == set(desc)
    for key, d in desc.items():
        assert tuple(pool[key].shape) == tuple(d.shape), key
    assert pool["ckv"].dtype == torch.bfloat16
    assert int(pool["pos"].min()) == -1 and int(pool["block_tables"].max()) \
        == -1


def test_quant_manifest_matches_reference():
    cfg = j_reduced(ARCH).replace(remat=False, dtype="float32")
    jm = JModel(cfg)
    params = f32_params(jm.init(jax.random.PRNGKey(0)))
    spec = dict(bits=3, group_size=G, iters=2)
    _, jman = jquant.quantize_model(params, jquant.QuantSpec(**spec),
                                    jm.axes())
    tm = from_jax_params(to_numpy_tree(params),
                         t_reduced(ARCH).replace(dtype="float32"),
                         device="cpu")
    tman = quantize_model(tm, QuantSpec(**spec))
    assert [l["path"] for l in tman.layers] == [l["path"] for l in
                                                jman.layers]
    assert [l["quant_bytes"] for l in tman.layers] == \
        [l["quant_bytes"] for l in jman.layers]
    assert (tman.n_weights, tman.quant_bytes, tman.dense_bytes) == \
        (jman.n_weights, jman.quant_bytes, jman.dense_bytes)
    paths = {l["path"].rsplit("/", 1)[-1] for l in tman.layers}
    assert {"q_a", "q_b", "kv_a", "kv_b", "o", "gate", "up", "down",
            "unembed"} == paths
    assert isinstance(tm.stack.layers[0].mixer.q_a_norm, torch.Tensor)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _run_both(paged_kernel, lens, max_new, **kw):
    jm, params, tm = _pair(True, paged_kernel=paged_kernel,
                           backend="bcq_xla")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (int(n),)).astype(np.int32)
               for n in lens]
    je = ref_paged_engine(jm, params, **kw)
    jdone = je.run([JRequest(uid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)], max_ticks=400)
    te = PagedServeEngine(tm, **kw)
    tdone = te.run([Request(uid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)], max_ticks=400)
    by_uid = lambda reqs: {r.uid: list(r.out_tokens) for r in reqs}
    return je, by_uid(jdone), te, by_uid(tdone)


@pytest.mark.parametrize("paged_kernel", ["gather", "fused"])
def test_greedy_stream_matches_reference(paged_kernel):
    kw = dict(num_blocks=16, block_size=4, max_batch=2, max_seq_len=32,
              prefill_buckets=(8,))
    je, jout, te, tout = _run_both(paged_kernel, [6, 11], 4, **kw)
    assert tout == jout and all(len(v) == 4 for v in tout.values())
    assert (te.decode_path, te.prefill_path) == (je.decode_path,
                                                 je.prefill_path)
    assert te.decode_path == paged_kernel and te.prefill_path == "gather"
    tpk = te.metrics.summary()["paged_kernel"]
    jpk = je.metrics.summary()["paged_kernel"]
    for key in ("kv_bytes_per_token_fused", "kv_bytes_per_token_gathered"):
        assert tpk[key] == jpk[key]


def test_preemption_keeps_stream_identical():
    """A pool too small for every request forces preempt-by-recompute on
    the latent pool; the greedy stream must not change."""
    kw = dict(num_blocks=10, block_size=4, max_batch=3, max_seq_len=40,
              prefill_buckets=(8, 16))
    je, jout, te, tout = _run_both("gather", [3, 9, 17, 5], 6, **kw)
    assert te.metrics.counters["preempted"] >= 1
    assert te.metrics.counters["preempted"] == \
        je.metrics.counters["preempted"]
    assert tout == jout
    te.pool.check()


def test_launcher_serves_minicpm3_on_cpu():
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", "minicpm3_4b", "--reduced", "1",
                        "--device", "cpu", "--bits", "3", "--group-size",
                        "16", "--requests", "2", "--max-new", "3",
                        "--paged-kernel", "fused", "--num-blocks", "24"])
    assert len(done) == 2 and all(len(r.out_tokens) == 3 and not r.error
                                  for r in done)
