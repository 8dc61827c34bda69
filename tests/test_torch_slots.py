"""Port parity: the contiguous cache, ``Model.prefill`` and the slots
``ServeEngine``, against the reference, on the CPU, in float32.

Cases: Phi-4-mini (rotary GQA, cut to a group of 3 as in
``test_torch_dense.py``), OPT (learned positions, clamped at 0 under
left-pads), OPT with an int8 KV cache (whose whole-prompt prefill attends
over the fresh K/V, not the cache) and MiniCPM3 (the MLA latent cache),
each at one layer, each pair built once per module and shared.  The
reference's prefill and decode are jitted in the logit test (its
engine prefills eagerly, as it does).  Tolerances:

- ``cache_insert`` into a contiguous cache: exact (a ring write);
- logits (``prefill`` with left-pads, then ``decode_step``): 1e-4 of the
  logit scale, the ``TOL`` of ``test_torch_model.py``;
- greedy serving streams: token for token (tolerance 0 on token ids),
  against the reference ``ServeEngine`` and against the port's own
  ``PagedServeEngine`` on the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.serve import Request as JRequest
from repro.serve.engine import supports_paging as j_supports_paging
from repro_torch.models import attention as tattn
from repro_torch.serve import (PagedServeEngine, Request, ServeEngine,
                               supports_paging)

from torch_port_cases import (port_pair, prompts_of, quantized_pair,
                              ref_slots_engine)

TOL = 1e-4
# case -> (arch, config overrides on both sides, BCQ group size); one
# layer each (the reduced configs have two): the cases test the cache
# and the engines, not depth, and the reference's compiles scale with it
CASES = {
    "phi4": ("phi4_mini_3_8b", dict(n_heads=6, n_kv_heads=2, n_layers=1),
             32),
    "opt": ("opt_6_7b", dict(n_layers=1), 32),
    "opt_int8kv": ("opt_6_7b", dict(kv_cache_bits=8, n_layers=1), 32),
    "minicpm3": ("minicpm3_4b", dict(n_layers=1), 16),
}


_PAIRS = {}


def _pair(case, quantized=False):
    """(reference Model, params, port Model) of a case, built once and
    shared by the tests that read it (none changes a pair); the BCQ-3
    pair quantizes the float pair's reference tree (``bcq_xla``)."""
    key = case, quantized
    if key not in _PAIRS:
        arch, base, g = CASES[case]
        if quantized:
            jm, params, tm = _pair(case)
            _PAIRS[key] = quantized_pair(
                jm, params, tm.cfg,
                dict(bits=3, group_size=g, iters=2, backend="bcq_xla"))
        else:
            _PAIRS[key] = port_pair(arch, perturb=5, **base)
    return _PAIRS[key]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# the contiguous cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_init_cache_matches_reference(case):
    jm, _, tm = _pair(case)
    jc, tc = jm.init_cache(3, 12), tm.init_cache(3, 12)
    assert len(tc["layers"]) == len(jc["layers"]) == tm.cfg.n_layers
    for jl, tl in zip(jc["layers"], tc["layers"]):
        jl = jl["self"]
        assert tl.keys() == jl.keys()
        for key in jl:
            want = np.asarray(jl[key])
            got = _np(tl[key])
            assert got.shape == want.shape and \
                str(got.dtype) == str(want.dtype), key
            np.testing.assert_array_equal(got, want, err_msg=key)
    assert all(bool((l["pos"] == -1).all()) for l in tc["layers"])


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_layer_cache_caps_length_at_the_window(kv_bits):
    """A sliding window caps the ring at the window, as the reference's
    ``cache_desc_gqa`` does."""
    from repro.configs import get_reduced as j_reduced
    from repro_torch.configs import get_reduced
    over = dict(sliding_window=8, kv_cache_bits=kv_bits)
    got = tattn.init_layer_cache(get_reduced("phi4_mini_3_8b").replace(
        **over), 2, 32, "cpu")
    want = jattn.cache_desc_gqa(j_reduced("phi4_mini_3_8b").replace(**over),
                                2, 32)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["pos"].shape == (2, 8)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("at,s", [
    ([0, 3, 9], 4),          # per-row starts, one write wraps the ring
    ([-5, -2, 0], 6),        # left-pads at negative positions
    (-3, 12),                # S > L: only the trailing L entries stay
    ([7, 11, 2], 1)])        # decode
def test_cache_insert_matches_reference(at, s, int8):
    """The ring write into a contiguous cache equals the reference's
    ``cache_insert`` exactly (values, scales and positions), starting from
    a cache that already holds entries."""
    rng = np.random.default_rng(s + 10 * int8)
    b, length, h, d = 3, 8, 2, 4
    cache = {"k": rng.normal(size=(b, length, h, d)).astype(np.float32),
             "v": rng.normal(size=(b, length, h, d)).astype(np.float32),
             "pos": rng.integers(-1, 20, (b, length)).astype(np.int32)}
    upd = {"k": rng.normal(size=(b, s, h, d)).astype(np.float32),
           "v": rng.normal(size=(b, s, h, d)).astype(np.float32)}
    if int8:
        for key in ("k", "v"):
            cache[key] = rng.integers(-127, 128, cache[key].shape).astype(
                np.int8)
            upd[key] = rng.integers(-127, 128, upd[key].shape).astype(
                np.int8)
            cache[key + "_scale"] = rng.random((b, length, h)).astype(
                np.float32)
            upd[key + "_scale"] = rng.random((b, s, h)).astype(np.float32)
    at_np = np.asarray(at, np.int32)
    want = jattn.cache_insert({k: jnp.asarray(v) for k, v in cache.items()},
                              {k: jnp.asarray(v) for k, v in upd.items()},
                              jnp.asarray(at_np))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got = tattn.cache_insert(tc, {k: torch.from_numpy(v)
                                  for k, v in upd.items()},
                             torch.from_numpy(at_np))
    assert got is tc                         # written in place
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]),
                                      err_msg=key)
    if s <= length:
        # every negative position is stored as such: never live
        pos = np.asarray(at_np).reshape(-1, 1) + np.arange(s)
        assert int((_np(got["pos"]) < 0).sum()) >= int((pos < 0).sum())


# ---------------------------------------------------------------------------
# Model.prefill and decode over the contiguous cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_with_left_pads_matches_reference(case):
    """A left-padded whole-prompt prefill (pads at negative positions),
    then two decode steps, against the reference; and the padded prefill
    against the same prompt without pads."""
    jm, params, tm = _pair(case)
    rng = np.random.default_rng(2)
    b, plen, bucket, length = 2, 7, 12, 24
    prompt = rng.integers(0, 256, (b, plen)).astype(np.int32)
    toks = np.zeros((b, bucket), np.int32)
    toks[:, -plen:] = prompt
    start = plen - bucket
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(b, length), jnp.int32(start))
    tl, tc = tm.prefill(torch.from_numpy(toks), tm.init_cache(b, length),
                        start)
    assert tl.shape == (b, tm.cfg.vocab_size) and tl.dtype == torch.float32
    assert _rel(tl, jl) < TOL
    ul, _ = tm.prefill(torch.from_numpy(prompt), tm.init_cache(b, length), 0)
    assert _rel(tl, ul) < TOL
    decode = jax.jit(jm.decode_step)
    for t in range(2):
        step = rng.integers(0, 256, (b, 1)).astype(np.int32)
        pos = np.full(b, plen + t, np.int32)
        jl, jc = decode(params, jnp.asarray(step), jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(torch.from_numpy(step), tc,
                                torch.from_numpy(pos))
        assert _rel(tl, jl) < TOL
    for jlay, tlay in zip(jc["layers"], tc["layers"]):
        np.testing.assert_array_equal(_np(tlay["pos"]),
                                      np.asarray(jlay["self"]["pos"]))


def test_int8_prefill_attends_over_the_fresh_kv():
    """The whole-prompt prefill into an int8 cache reads the fresh K/V:
    its logits equal the float cache's (the quantization reaches only the
    decode reads), as in the reference."""
    _, _, tm = _pair("opt_int8kv")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (1, 9)).astype(np.int32))
    l8, c8 = tm.prefill(toks, tm.init_cache(1, 16), 0)
    f = tm.with_config(kv_cache_bits=16)
    l16, _ = f.prefill(toks, f.init_cache(1, 16), 0)
    assert c8["layers"][0]["k"].dtype == torch.int8
    assert torch.equal(l8, l16)


# ---------------------------------------------------------------------------
# the slots engine
# ---------------------------------------------------------------------------


def _streams(engine, prompts, max_new):
    done = engine.run([Request(uid=i, prompt=p, max_new_tokens=max_new)
                       for i, p in enumerate(prompts)], max_ticks=400)
    return {r.uid: (list(r.out_tokens), r.error) for r in done}


def _j_streams(engine, prompts, max_new):
    done = engine.run([JRequest(uid=i, prompt=p, max_new_tokens=max_new)
                       for i, p in enumerate(prompts)], max_ticks=400)
    return {r.uid: (list(r.out_tokens), r.error) for r in done}


@pytest.mark.parametrize("case", list(CASES))
def test_slots_greedy_stream_matches_reference(case):
    """BCQ-3 weights through both packages' slots engines: more requests
    than slots, a prompt past the largest bucket (rounded up to it)."""
    jm, params, tm = _pair(case, True)
    prompts = prompts_of([3, 9, 21, 6, 12])
    kw = dict(slots=3, cache_len=40, prefill_buckets=(8, 16))
    want = _j_streams(ref_slots_engine(jm, params, **kw), prompts, 5)
    got = _streams(ServeEngine(tm, **kw), prompts, 5)
    assert got == want
    assert all(len(toks) == 5 and err is None for toks, err in got.values())


@pytest.mark.parametrize("case", ["phi4", "opt", "minicpm3"])
def test_slots_engine_matches_paged_engine(case):
    """The port's two engines on the same weights give the same greedy
    streams (the reference's equivalence test, on the port)."""
    _, _, tm = _pair(case, True)
    prompts = prompts_of([3, 9, 17, 30, 5, 12])
    paged = PagedServeEngine(tm, num_blocks=24, block_size=8, max_batch=3,
                             max_seq_len=64, prefill_buckets=(8, 16))
    want = _streams(paged, prompts, 6)
    got = _streams(ServeEngine(tm, slots=3, cache_len=64,
                               prefill_buckets=(8, 16)), prompts, 6)
    assert got == want
    assert paged.metrics.counters["prefill_chunks"] > len(prompts)
    paged.pool.check()


def test_slots_engine_rules_match_reference():
    """An empty prompt and one that cannot fit (prompt + 1 decode) are
    errors, not truncations; a request retires at cache_len - 1 whatever
    its max_new_tokens; a request done at its first token leaves its slot
    free.  Both packages alike."""
    jm, params, tm = _pair("phi4", True)
    prompts = [np.zeros(0, np.int32)] + prompts_of([15, 4, 9, 3])
    lens = dict(enumerate([5, 5, 40, 1, 6]))
    kw = dict(slots=2, cache_len=16, prefill_buckets=(8,))
    jdone = ref_slots_engine(jm, params, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=lens[i])
         for i, p in enumerate(prompts)], max_ticks=400)
    tdone = ServeEngine(tm, **kw).run(
        [Request(uid=i, prompt=p, max_new_tokens=lens[i])
         for i, p in enumerate(prompts)], max_ticks=400)
    by = lambda reqs: {r.uid: (list(r.out_tokens), r.error, r.done)
                       for r in reqs}
    assert by(tdone) == by(jdone)
    got = by(tdone)
    assert got[0][1] == "empty_prompt" and got[1][1] == "too_long"
    assert len(got[2][0]) == 16 - 1 - 4 + 1      # retired at cache_len - 1
    assert len(got[3][0]) == 1


def test_supports_paging_matches_reference():
    from repro.configs import get_reduced as j_reduced
    from repro_torch.configs import ARCH_IDS, get_reduced
    for arch in ARCH_IDS:
        # every arch pages but Mixtral (a sliding window), Mamba2 and
        # Jamba (SSM layers) and Whisper (an encoder-decoder)
        assert supports_paging(get_reduced(arch)) == \
            j_supports_paging(j_reduced(arch)) is (
                arch not in ("mixtral_8x7b", "mamba2_2_7b",
                             "jamba_1_5_large_398b", "whisper_medium"))
    assert not supports_paging(get_reduced("phi4_mini_3_8b").replace(
        sliding_window=8))
    # keyed on the encoder layers (``is_encdec``), not on the family name,
    # on both sides
    for over, pages in ((dict(n_encoder_layers=2, encoder_seq=16), False),
                        (dict(family="encdec"), True)):
        assert supports_paging(get_reduced("opt_6_7b").replace(**over)) \
            == j_supports_paging(j_reduced("opt_6_7b").replace(**over)) \
            is pages


@pytest.mark.parametrize("engine,want", [("slots", "slots"),
                                         ("paged", "paged"),
                                         ("auto", "paged")])
def test_launcher_engines_serve_phi4_on_cpu(engine, want, capsys):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", "phi4_mini_3_8b", "--reduced", "1",
                        "--device", "cpu", "--bits", "3", "--group-size",
                        "32", "--engine", engine, "--slots", "2",
                        "--cache-len", "64", "--requests", "3",
                        "--max-new", "3"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 and not r.error
                                  for r in done)
    out = capsys.readouterr().out
    assert ("paged-kernel=" in out) == (want == "paged")
    if engine == "auto":
        assert "engine=auto -> paged" in out
