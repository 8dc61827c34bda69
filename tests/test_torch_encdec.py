"""Port parity: reduced Whisper-medium (an encoder-decoder: the encoder
over stub frames, cross-attention, the cross K/V cache) against the
reference, on the CPU.

Cases and tolerances (f32 activations; the cross K/V cache is bf16 on
both sides, as the reference's ``cache_desc`` has it):

- ``encode`` (learned positions, the stack unmasked, the final norm)
  under both ``scan_layers`` settings: within 1e-5 of the output scale;
- full-sequence logits with frames, both settings: within 1e-4;
- the cross K/V: written at prefill (bf16, within one bf16 ulp of the
  reference's cache), read at decode (no cross ``k`` / ``v`` projection
  runs in a decode step, and a changed cache changes the step's logits
  as it changes the reference's);
- prefill then 8 decode steps, float weights, both settings: every
  step's logits within 1e-4 of the reference's;
- a greedy decode loop on BCQ-3 weights (``bcq_xla``): tokens identical
  (tolerance 0 on token ids);
- ``from_jax_params`` -> ``to_params`` bit for bit, and the quantization
  manifest equal to the reference's entry for entry (the encoder's
  linears and every decoder layer's cross ``q/k/v/o`` included), both
  settings;
- the engines: the reference's ``ServeEngine`` fails on the first
  request with ``KeyError: 'frames'`` (its ``add_request`` passes only
  tokens to ``Model.prefill``); the port's refuses the model at
  construction with ``NotImplementedError`` naming the model API, the
  one departure (raised early instead of on the first request); both
  paged engines refuse it (``ValueError``: the paged cache holds
  attention-only decoders); the launcher exits with the engine's
  message;
- the config, its inherited ``max_seq_len`` of 524,288 included.

The reference's models are built once per module (fixtures).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_config as j_config
from repro.configs import get_reduced as j_reduced
from repro.serve import Request as JRequest, ServeEngine as JSlots
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models import from_jax_params, to_params
from repro_torch.models.attention import CrossAttention
from repro_torch.quant import QuantSpec, quantize_model
from repro_torch.serve import PagedServeEngine, ServeEngine

from torch_port_cases import (port_pair, quantized_pair, ref_paged_engine,
                              to_numpy_tree)

ARCH = "whisper_medium"
TOL = 1e-4
F32_TOL = 1e-5
BF16_ULP = 2.0 ** -8
G = 32           # divides every reduced input width (64, 128)
BCQ3 = dict(bits=3, group_size=G, iters=2, backend="bcq_xla")


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def whisper():
    """{(weights, scan): (reference Model, params, port Model)}, biases
    and norm parameters perturbed; the BCQ-3 pair quantizes the float
    pair's reference tree, and ``("manifest", False)`` holds the
    reference's manifest of that quantization."""
    out = {("float", scan): port_pair(ARCH, perturb=9, scan_layers=scan)
           for scan in (False, True)}
    jm, params, tm = out["float", False]
    out["bcq3", False], out["manifest", False] = quantized_pair(
        jm, params, tm.cfg, BCQ3, with_manifest=True)
    return out


def _inputs(seed, b=2, s=5):
    cfg = t_reduced(ARCH)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return toks, frames


@pytest.mark.parametrize("scan", [False, True])
def test_whisper_encode_matches_reference(whisper, scan):
    jm, params, tm = whisper["float", scan]
    assert ("scan" in params["encoder"]["stack"]) == scan
    _, frames = _inputs(1)
    want = jax.jit(jm.encode)(params, jnp.asarray(frames))
    got = tm.encode(torch.from_numpy(frames))
    assert got.shape == want.shape == frames.shape
    assert _rel(got, want) < F32_TOL


@pytest.mark.parametrize("scan", [False, True])
def test_whisper_forward_matches_reference(whisper, scan):
    jm, params, tm = whisper["float", scan]
    toks, frames = _inputs(2, s=9)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks),
                                        "frames": jnp.asarray(frames)})
    got = tm.forward(torch.from_numpy(toks), frames=torch.from_numpy(frames))
    assert got.shape == want.shape and _rel(got, want) < TOL


@pytest.mark.parametrize("scan", [False, True])
def test_whisper_prefill_then_decode_matches_reference(whisper, scan):
    """A 5-token prompt with frames prefilled into a contiguous cache of
    32, then 8 decode steps: every step's logits within 1e-4."""
    jm, params, tm = whisper["float", scan]
    toks, frames = _inputs(3)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks),
                                          "frames": jnp.asarray(frames)}, jc)
    tl, tc = tm.prefill(torch.from_numpy(toks), tc,
                        frames=torch.from_numpy(frames))
    assert _rel(tl, jl) < TOL
    decode = jax.jit(jm.decode_step)
    steps = np.random.default_rng(4).integers(0, 256, (8, 2, 1)).astype(
        np.int32)
    for t, step in enumerate(steps, start=toks.shape[1]):
        jl, jc = decode(params, jnp.asarray(step), jc, jnp.int32(t))
        tl, tc = tm.decode_step(torch.from_numpy(step), tc, t)
        assert _rel(tl, jl) < TOL, t


def test_whisper_cross_kv_written_at_prefill_read_at_decode(whisper,
                                                             monkeypatch):
    jm, params, tm = whisper["float", False]
    toks, frames = _inputs(5)
    calls = []
    kv = CrossAttention.kv
    monkeypatch.setattr(CrossAttention, "kv",
                        lambda self, *a: calls.append(1) or kv(self, *a))
    jc = jm.init_cache(2, 32)
    tc = tm.init_cache(2, 32)
    _, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks),
                                         "frames": jnp.asarray(frames)}, jc)
    _, tc = tm.prefill(torch.from_numpy(toks), tc,
                       frames=torch.from_numpy(frames))
    n_layers = tm.cfg.n_layers
    assert len(calls) == n_layers
    enc = tm.encode(torch.from_numpy(frames))
    for i in range(n_layers):
        c = tc["layers"][i]
        for key, fresh in zip(("cross_k", "cross_v"),
                              tm.stack.layers[i].cross.kv(enc)):
            want = jc["layers"][i][key]
            assert c[key].dtype == torch.bfloat16
            assert tuple(c[key].shape) == want.shape == (
                2, tm.cfg.encoder_seq, tm.cfg.n_kv_heads, tm.cfg.head_dim_)
            assert _rel(c[key], want) < BF16_ULP
            torch.testing.assert_close(c[key], fresh.to(torch.bfloat16),
                                       rtol=0, atol=0)
    calls.clear()
    step = np.array([[7], [11]], np.int32)
    pos = toks.shape[1]
    tl, _ = tm.decode_step(torch.from_numpy(step), {
        "layers": [dict(c) for c in tc["layers"]]}, pos)
    assert calls == []                    # no cross K/V projection at decode
    # the decode step reads the cache: halving the cached cross values
    # moves the logits on both sides, to the same values
    jc2 = {"layers": [{**c, "cross_v": c["cross_v"] * 0.5}
                      for c in jc["layers"]]}
    tc2 = {"layers": [{**c, "cross_v": c["cross_v"] * 0.5}
                      for c in tc["layers"]]}
    jl2, _ = jax.jit(jm.decode_step)(params, jnp.asarray(step), jc2,
                                     jnp.int32(pos))
    tl2, _ = tm.decode_step(torch.from_numpy(step), tc2, pos)
    assert _rel(tl2, tl) > 1e-3
    assert _rel(tl2, jl2) < TOL


def test_whisper_greedy_decode_loop_matches_reference(whisper):
    """BCQ-3 weights: prefill a 4-token prompt with frames, then feed the
    argmax back for 8 steps on both sides: identical tokens."""
    jm, params, tm = whisper["bcq3", False]
    toks, frames = _inputs(6, s=4)
    out = {}
    for side in ("ref", "port"):
        if side == "ref":
            cache = jm.init_cache(2, 32)
            logits, cache = jax.jit(jm.prefill)(
                params, {"tokens": jnp.asarray(toks),
                         "frames": jnp.asarray(frames)}, cache)
            step = jax.jit(jm.decode_step)
            fn = lambda tok, c, p: step(params, jnp.asarray(tok), c,
                                        jnp.int32(p))
        else:
            cache = tm.init_cache(2, 32)
            logits, cache = tm.prefill(torch.from_numpy(toks), cache,
                                       frames=torch.from_numpy(frames))
            fn = lambda tok, c, p: tm.decode_step(torch.from_numpy(tok), c,
                                                  p)
        seq = []
        for t in range(8):
            tok = np.asarray(logits, np.float32).argmax(-1).astype(np.int32)
            seq.append(tok.tolist())
            logits, cache = fn(tok[:, None], cache, toks.shape[1] + t)
        out[side] = seq
    assert out["port"] == out["ref"]


def _leaves(tree, path=""):
    if isinstance(tree, dict) and "packed" not in tree:
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("key", [("float", False), ("float", True),
                                 ("bcq3", False)])
def test_whisper_params_round_trip(whisper, key):
    _, params, tm = whisper[key]
    want = dict(_leaves(to_numpy_tree(params)))
    got = dict(_leaves(to_params(tm)))
    assert got.keys() == want.keys()
    assert "/encoder/pos" in got and "/encoder/final_norm/bias" in got
    layer = "/stack/scan/0" if key[1] else "/stack/layers/1"
    assert f"{layer}/cross/v" in got and f"{layer}/ln_cross/scale" in got
    for path, w in want.items():
        g = got[path]
        if isinstance(w, dict):
            for k in ("packed", "alpha"):
                np.testing.assert_array_equal(g[k].numpy(), w[k])
        else:
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))


@pytest.mark.parametrize("scan", [False, True])
def test_whisper_manifest_matches_reference(whisper, scan):
    """The encoder's linears, every decoder layer's self- and
    cross-attention and MLP, and the untied head, entry for entry as the
    reference's (path, shape, width, bytes); the positions and norms stay
    FP.  Both sides quantize the float pair's weights (the port a fresh
    copy: ``quantize_model`` replaces its linears in place)."""
    jm, params, tm = whisper["float", scan]
    jman = whisper.get(("manifest", scan))
    if jman is None:            # no BCQ-3 pair of this layout to share
        _, jman = jquant.quantize_model(params, jquant.QuantSpec(**BCQ3),
                                        jm.axes())
    tm = from_jax_params(to_numpy_tree(params), tm.cfg, device="cpu")
    tman = quantize_model(tm, QuantSpec(**BCQ3))
    keys = ("path", "shape", "plane_bits", "quant_bytes", "dense_bytes")
    assert [{k: l[k] for k in keys} for l in tman.layers] == \
        [{k: list(l[k]) if k == "shape" else l[k] for k in keys}
         for l in jman.layers]
    paths = [l["path"] for l in tman.layers]
    pre = "scan/0" if scan else "layers/0"
    for leaf in (f"encoder/stack/{pre}/mixer/q", f"stack/{pre}/cross/k",
                 f"stack/{pre}/cross/o", "embed/unembed"):
        assert leaf in paths
    assert not any(p.endswith("/pos") for p in paths)


def test_whisper_engines_refuse_it(whisper, capsys):
    jm, params, tm = whisper["float", False]
    prompt = np.array([3, 1, 4], np.int32)
    # the reference's slots engine builds, then fails on the first request
    jeng = JSlots(jm, params, slots=2, cache_len=32, prefill_buckets=(8,))
    with pytest.raises(KeyError, match="frames"):
        jeng.add_request(JRequest(uid=0, prompt=prompt, max_new_tokens=2))
    # the port's refuses at construction, naming the model API
    with pytest.raises(NotImplementedError, match="frames") as e:
        ServeEngine(tm, slots=2, cache_len=32)
    assert "Model.prefill" in str(e.value)
    kw = dict(num_blocks=8, block_size=4, max_batch=2, max_seq_len=32)
    for build in (lambda: ref_paged_engine(jm, params, **kw),
                  lambda: PagedServeEngine(tm, **kw)):
        with pytest.raises(ValueError, match="attention-only"):
            build()
    from repro_torch.launch import serve as launch
    with pytest.raises(SystemExit, match="encoder-decoder"):
        launch.main(["--arch", ARCH, "--reduced", "1", "--device", "cpu"])


def test_whisper_configs_are_the_references():
    from repro.models.transformer import scan_grouping as j_grouping
    from repro.serve.engine import supports_paging as j_supports_paging
    from repro_torch.models.model import encoder_config
    from repro_torch.models.transformer import layer_plan, scan_grouping
    from repro_torch.serve import supports_paging
    for t, j in ((t_config(ARCH), j_config(ARCH)),
                 (t_reduced(ARCH), j_reduced(ARCH))):
        for field in ("name", "family", "n_layers", "n_encoder_layers",
                      "encoder_seq", "d_model", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab_size", "pos", "mlp_act",
                      "norm", "qkv_bias", "tie_embeddings", "max_seq_len",
                      "scan_layers", "num_patches"):
            assert getattr(t, field) == getattr(j, field), field
        assert t.is_encdec and j.is_encdec
        assert layer_plan(t) == [(j.layer_kind(i), j.mlp_kind(i))
                                 for i in range(j.n_layers)]
        enc = encoder_config(t)
        assert (enc.n_layers, enc.n_experts) == (t.n_encoder_layers, 0)
        assert scan_grouping(enc) == j_grouping(j.replace(
            n_layers=j.n_encoder_layers, n_experts=0, attn_layer_period=0))
        assert supports_paging(t) == j_supports_paging(j) is False
    # inherited from the base config on both sides: a learned decoder
    # position table of 524,288 x 1024 (the published model has 448)
    assert t_config(ARCH).max_seq_len == j_config(ARCH).max_seq_len == 524288
