"""Port parity: sampling keys and sampled tokens.

``core/prng.py`` must give ``jax.random``'s words bit for bit under the
installed JAX (Threefry-2x32, partitionable counters): keys exactly,
random bits and uniforms exactly, Gumbel noise within 2 ulp of
``max(|g|, 1)`` (``log`` is the device's own).  ``sample_tokens`` must
give the reference's tokens wherever the two largest perturbed scores
of a row are further apart than that; the count of rows too close to
call is bounded.  ``request_key`` must equal the reference's for an
explicit seed and for the engine seed folded with the uid, and the
slots engine's seeded streams must equal the reference ``ServeEngine``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import sample_tokens as j_sample_tokens
from repro.serve import Request as JRequest
from repro.serve.engine import request_key as j_request_key
from repro_torch.core import prng
from repro_torch.models.model import sample_tokens
from repro_torch.serve import PagedServeEngine, Request, ServeEngine
from repro_torch.serve import request_key

from torch_port_cases import port_pair, prompts_of, ref_slots_engine

TINY = float(np.finfo(np.float32).tiny)


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _jkeys(n, seed=0):
    return np.stack([_words(jax.random.fold_in(jax.random.PRNGKey(seed), i))
                     for i in range(n)])


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**31, 2**32 + 5,
                                  -1, -7])
def test_prng_key_and_fold_in_match_jax(seed):
    assert (prng.PRNGKey(seed).numpy() ==
            _words(jax.random.PRNGKey(seed))).all()
    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 63, 2**31, 2**32 - 1):
        assert (prng.fold_in(prng.PRNGKey(seed), data).numpy() ==
                _words(jax.random.fold_in(key, data))).all(), data
    # a batch of keys folded with a batch of data at once
    keys = torch.from_numpy(_jkeys(5, seed))
    got = prng.fold_in(keys, torch.arange(5)).numpy()
    want = [_words(jax.random.fold_in(jnp.asarray(k, jnp.uint32), i))
            for i, k in enumerate(keys.numpy())]
    assert (got == np.stack(want)).all()


@pytest.mark.parametrize("n", [1, 7, 50272])
def test_random_bits_and_uniform_match_jax(n):
    keys = _jkeys(3, seed=n)
    bits = prng.random_bits(torch.from_numpy(keys), n).numpy()
    uni = prng.uniform(torch.from_numpy(keys), n, TINY, 1.0).numpy()
    for k, b, u in zip(keys, bits, uni):
        jk = jnp.asarray(k, jnp.uint32)
        assert (b == np.asarray(jax.random.bits(jk, (n,), jnp.uint32))
                .astype(np.int64)).all()
        assert (u == np.asarray(jax.random.uniform(
            jk, (n,), jnp.float32, minval=TINY, maxval=1.0))).all()


def _jgumbel(keys, n):
    """The reference's Gumbel noise under each key of ``keys`` [B, 2]."""
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (n,), jnp.float32))(jnp.asarray(keys, jnp.uint32)))


def test_gumbel_within_two_ulp_of_jax():
    keys = _jkeys(8, seed=11)
    got = prng.gumbel(torch.from_numpy(keys), 50272).numpy()
    want = _jgumbel(keys, 50272)
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got.astype(np.float64) - want) <= 2 * ulp).all()


@pytest.mark.parametrize("mode", ["explicit_seed", "engine_seed"])
def test_request_key_matches_reference(mode):
    seed = 1234 if mode == "explicit_seed" else None
    jreq = JRequest(uid=77, prompt=np.zeros(3, np.int32), seed=seed)
    req = Request(uid=77, prompt=np.zeros(3, np.int32), seed=seed)
    memo = object.__new__(PagedServeEngine)      # only the key memo is used
    memo.rng_seed, memo._key_cache = 9, {}
    for index in range(64):
        want = _words(j_request_key(jreq, index, 9))
        assert (request_key(req, index, 9).numpy() == want).all(), index
        assert (memo._request_key(req, index) == want).all(), index


def test_sample_tokens_match_reference_over_512_rows():
    """512 rows of temperatures 0 / 0.7 / 1.3 and top-k 0 / 1 / 40, a row
    of all-equal logits and a row with ties at the top-k threshold."""
    rng = np.random.default_rng(0)
    b, v = 512, 1000
    logits = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    temps = rng.choice(np.float32([0.0, 0.7, 1.3]), b)
    topk = rng.choice(np.int32([0, 1, 40]), b)
    logits[5] = 1.0                               # every logit tied
    temps[5], topk[5] = 0.7, 40
    logits[6, [3, 7, 9, 11]] = 20.0               # 4 ties at a top-2 cut
    temps[6], topk[6] = 1.3, 2
    keys = _jkeys(b, seed=5)
    want = np.asarray(j_sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys, jnp.uint32),
        jnp.asarray(temps), jnp.asarray(topk)))
    got = sample_tokens(torch.from_numpy(logits), torch.from_numpy(keys),
                        torch.from_numpy(temps),
                        torch.from_numpy(topk)).numpy()
    assert got.dtype == np.int32
    # rows whose two largest perturbed scores are within the noise's
    # 2-ulp bound (on either side) are too close to call
    kk = np.where(topk <= 0, v, topk)
    thresh = -np.sort(-logits, axis=1)[np.arange(b), kk - 1][:, None]
    scaled = np.where(logits < thresh, -np.inf, logits) \
        / np.maximum(temps, 1e-6)[:, None]
    g = _jgumbel(keys, v)
    pert = np.sort(g + scaled, axis=1)
    top = pert[:, -1]
    gap = top - pert[:, -2]
    close = (temps > 0) & (gap <= 4 * np.spacing(
        np.maximum(np.abs(top), 1).astype(np.float32)))
    assert close.sum() <= 2, int(close.sum())
    assert (got[~close] == want[~close]).all(), np.nonzero(got != want)
    assert got[6] in (3, 7, 9, 11)
    # greedy rows and top-k 1 rows are the argmax
    arg = logits.argmax(1)
    assert (got[(temps == 0) | (topk == 1)] ==
            arg[(temps == 0) | (topk == 1)]).all()


def test_slots_engine_seeded_sampling_matches_reference():
    jm, params, tm = port_pair("opt_6_7b")
    prompts = prompts_of([5, 9, 7, 12], seed=3, vocab=jm.cfg.vocab_size)

    def reqs(cls):
        out = [cls(uid=i, prompt=p, max_new_tokens=6)
               for i, p in enumerate(prompts)]
        for r in out[1:]:
            r.temperature, r.top_k = (0.7, 12) if r.uid % 2 else (1.3, 0)
        out[1].seed = 40                          # explicit; others: engine
        return out

    kw = dict(slots=2, cache_len=64, prefill_buckets=(16,), rng_seed=3)
    jdone = ref_slots_engine(jm, params, **kw).run(reqs(JRequest))
    tdone = ServeEngine(tm, **kw).run(reqs(Request))
    assert {r.uid: r.out_tokens for r in tdone} == \
        {r.uid: r.out_tokens for r in jdone}
    # a different engine seed changes the unseeded sampled streams only
    other = ServeEngine(tm, **{**kw, "rng_seed": 4}).run(reqs(Request))
    by = {r.uid: r.out_tokens for r in other}
    assert by[0] == tdone[[r.uid for r in tdone].index(0)].out_tokens
    assert by[1] == tdone[[r.uid for r in tdone].index(1)].out_tokens
    assert any(by[u] != r.out_tokens for r in tdone for u in (2, 3)
               if r.uid == u)
