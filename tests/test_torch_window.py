"""Port parity: sliding-window attention and Mixtral through the slots
engine, against the reference, on the CPU, in float32.

Cases:

- ``blockwise_attention`` and ``decode_attend`` with a window, against
  the reference's functions (the reference's online softmax over small
  chunks, so its blocking is exercised), f32 pools and int8 decode
  views: 1e-5 of the output scale (only the f32 summation order
  differs);
- reduced Mixtral-8x7B (window 32, 4 experts top-2): full-sequence
  logits longer than the window, a left-padded whole-prompt prefill
  longer than the ring (only its trailing entries stay) and decode
  steps past the ring's wrap, float and BCQ-3 weights: 1e-4 of the logit
  scale (``TOL`` of ``test_torch_model.py``);
- the slots ``ServeEngine`` on BCQ-3 weights: a prompt longer than the
  window and decode past the wrap, greedy tokens identical to the
  reference ``ServeEngine``'s (tolerance 0 on token ids);
- the paged pool refusing a window, ``supports_paging`` and the
  launcher's ``--engine auto`` picking the slots engine.

The reference outputs that several tests read are computed once per
module (fixtures).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.serve import Request as JRequest
from repro_torch.models import attention as tattn
from repro_torch.serve import Request, ServeEngine

from torch_port_cases import port_pair, prompts_of, ref_slots_engine

TOL = 1e-4
ATTN_TOL = 1e-5
BCQ3 = dict(bits=3, group_size=32, iters=2, backend="bcq_xla")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def mixtral():
    """{"float" | "bcq3": (reference Model, params, port Model)}."""
    return {name: port_pair("mixtral_8x7b", quant=quant, perturb=5)
            for name, quant in (("float", None), ("bcq3", BCQ3))}


# ---------------------------------------------------------------------------
# the window term of the attention functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 5, 16])
def test_blockwise_attention_window_matches_reference(window, causal):
    """Ragged queries and keys (queries at negative positions, empty key
    slots), GQA rep 2; the reference runs its online softmax over 8-wide
    chunks."""
    rng = np.random.default_rng(window + 100 * causal)
    b, sq, sk, h, hkv, d = 2, 19, 27, 4, 2, 8
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    qpos = (np.arange(sq)[None] + np.array([[8], [-3]])).astype(np.int32)
    kpos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    kpos[1, 20:] = -1
    kpos[0, :2] = -1
    want = jattn.blockwise_attention(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), causal=causal,
        window=window, q_chunk=8, kv_chunk=8)
    got = tattn.blockwise_attention(
        *map(torch.from_numpy, (q, k, v, qpos, kpos)), causal=causal,
        window=window)
    # query rows that see no key (pads before every key) are left out:
    # both packages average over whatever keys their blocking holds
    ok = np.broadcast_to(kpos[:, None, :] >= 0, (b, sq, sk))
    if causal:
        ok = ok & (kpos[:, None, :] <= qpos[:, :, None])
    if window:
        ok = ok & (qpos[:, :, None] - kpos[:, None, :] < window)
    seen = ok.any(-1)
    assert seen.sum() > sq
    assert _rel(got.numpy()[seen], np.asarray(want)[seen]) < ATTN_TOL


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [0, 1, 6, 12])
def test_decode_attend_window_matches_reference(window, int8):
    """A ring of 12 slots holding positions behind and past each row's
    window (a wrapped ring: stored positions out of slot order), an
    empty slot, rows at different positions."""
    rng = np.random.default_rng(window + 10 * int8)
    b, length, h, hkv, d = 3, 12, 6, 2, 8
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    positions = np.array([[5], [17], [30]], np.int32)
    pos = np.stack([np.where(np.arange(length) <= 5, np.arange(length), -1),
                    (np.arange(length) + 12) % 18 + 0,
                    np.arange(19, 31)]).astype(np.int32)
    cache = {"pos": pos}
    for key in ("k", "v"):
        t = rng.normal(size=(b, length, hkv, d)).astype(np.float32)
        if int8:
            cache[key] = rng.integers(-127, 128, t.shape).astype(np.int8)
            cache[key + "_scale"] = rng.random((b, length, hkv)).astype(
                np.float32) * 0.02
        else:
            cache[key] = t
    want = jattn.decode_attend(jnp.asarray(q),
                               {k: jnp.asarray(v) for k, v in cache.items()},
                               jnp.asarray(positions), window=window)
    got = tattn.decode_attend(torch.from_numpy(q),
                              {k: torch.from_numpy(v)
                               for k, v in cache.items()},
                              torch.from_numpy(positions), window=window)
    # int8 views compute in bf16 on both sides: the reference's tolerance
    tol = 1e-2 if int8 else ATTN_TOL
    assert _rel(got, want) < tol


def test_paged_pool_refuses_a_window():
    """A sliding window serves only from the ring, in both packages."""
    from repro.configs import get_reduced as j_reduced
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    with pytest.raises(ValueError, match="sliding_window"):
        jattn.paged_cache_desc(j_reduced("mixtral_8x7b"), 1, 8, 4, 4)
    m = Model(get_reduced("mixtral_8x7b"), device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        m.init_paged_cache(1, 8, 4, 4)
    assert m.init_cache(2, 100)["layers"][0]["pos"].shape == (2, 32)


# ---------------------------------------------------------------------------
# reduced Mixtral: forward, prefill past the ring, decode past the wrap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["float", "bcq3"])
def test_mixtral_forward_matches_reference(mixtral, weights):
    """Full-sequence logits of 40 tokens, 8 past the window of 32."""
    jm, params, tm = mixtral[weights]
    assert tm.cfg.sliding_window == 32
    toks = np.random.default_rng(1).integers(0, 256, (2, 40)).astype(
        np.int32)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("weights", ["float", "bcq3"])
def test_mixtral_prefill_past_the_ring_then_decode(mixtral, weights):
    """A 40-token prompt left-padded into 48 prefilled into a ring of 32
    (cache_len 64 capped at the window): only the trailing 32 entries
    stay, as in the reference; then decode steps at positions 40-43,
    each writing over the oldest slot.  Logits and the rings' stored
    positions against the reference."""
    jm, params, tm = mixtral[weights]
    rng = np.random.default_rng(2)
    plen, bucket, length = 40, 48, 64
    toks = np.zeros((1, bucket), np.int32)
    toks[0, -plen:] = rng.integers(0, 256, plen)
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(1, length),
                                 jnp.int32(plen - bucket))
    tl, tc = tm.prefill(torch.from_numpy(toks), tm.init_cache(1, length),
                        plen - bucket)
    assert tc["layers"][0]["pos"].shape == (1, 32)
    assert sorted(tc["layers"][0]["pos"][0].tolist()) == list(range(8, 40))
    assert _rel(tl, jl) < TOL
    decode = jax.jit(jm.decode_step)
    for t in range(plen, plen + 4):
        step = rng.integers(0, 256, (1, 1)).astype(np.int32)
        jl, jc = decode(params, jnp.asarray(step), jc, jnp.int32(t))
        tl, tc = tm.decode_step(torch.from_numpy(step), tc, t)
        assert _rel(tl, jl) < TOL
    for jlay, tlay in zip(jc["layers"], tc["layers"]):
        np.testing.assert_array_equal(tlay["pos"].numpy(),
                                      np.asarray(jlay["self"]["pos"]))


def test_mixtral_slots_stream_wraps_the_window(mixtral):
    """BCQ-3 Mixtral through both packages' slots engines (2 slots, ring
    of 32 under cache_len 72): prompts of 40 and 35 tokens (past the
    window, rounded up to 48 by the top bucket: 8 and 13 left-pads), 16
    new tokens each, so both decode past the ring's wrap.  Greedy tokens
    identical."""
    jm, params, tm = mixtral["bcq3"]
    prompts = prompts_of([40, 35])
    kw = dict(slots=2, cache_len=72, prefill_buckets=(8, 16))
    jdone = ref_slots_engine(jm, params, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=16)
         for i, p in enumerate(prompts)], max_ticks=400)
    eng = ServeEngine(tm, **kw)
    assert eng.cache["layers"][0]["pos"].shape == (2, 32)
    tdone = eng.run([Request(uid=i, prompt=p, max_new_tokens=16)
                     for i, p in enumerate(prompts)], max_ticks=400)
    by = lambda reqs: {r.uid: (list(r.out_tokens), r.error) for r in reqs}
    assert by(tdone) == by(jdone)
    assert all(len(t) == 16 and e is None for t, e in by(tdone).values())


# ---------------------------------------------------------------------------
# configuration, engine choice, launcher
# ---------------------------------------------------------------------------


def test_mixtral_configs_are_the_references():
    from repro.configs import get_config as j_config
    from repro.configs import get_reduced as j_reduced
    from repro.serve.engine import supports_paging as j_supports_paging
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.transformer import layer_plan, scan_grouping
    from repro_torch.serve import supports_paging
    for t, j in ((get_config("mixtral_8x7b"), j_config("mixtral_8x7b")),
                 (get_reduced("mixtral_8x7b"), j_reduced("mixtral_8x7b"))):
        for field in ("name", "family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "sliding_window", "rope_theta", "n_experts",
                      "n_shared_experts", "experts_per_token", "moe_d_ff",
                      "moe_layer_period", "first_dense_layers",
                      "capacity_factor", "mlp_act", "norm",
                      "tie_embeddings", "max_seq_len", "scan_layers"):
            assert getattr(t, field) == getattr(j, field), field
        assert layer_plan(t) == [(j.layer_kind(i), j.mlp_kind(i))
                                 for i in range(j.n_layers)]
        assert supports_paging(t) == j_supports_paging(j) is False
    from repro.models.transformer import scan_grouping as j_grouping
    for over in ({}, dict(n_layers=6, moe_layer_period=2),
                 dict(n_layers=5, first_dense_layers=1)):
        cfg = j_reduced("mixtral_8x7b").replace(**over)
        assert scan_grouping(get_reduced("mixtral_8x7b").replace(**over)) \
            == j_grouping(cfg)


def test_launcher_serves_mixtral_on_the_slots_engine(capsys):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", "mixtral_8x7b", "--reduced", "1",
                        "--device", "cpu", "--engine", "auto", "--bits", "3",
                        "--group-size", "32", "--slots", "2",
                        "--cache-len", "64", "--requests", "3",
                        "--max-new", "3"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 and not r.error
                                  for r in done)
    out = capsys.readouterr().out
    assert "engine=auto -> slots" in out
