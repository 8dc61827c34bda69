"""Port parity: the Mamba2 SSD mixer (``models/ssm.py``) and reduced
Mamba2-2.7B, against the reference, on the CPU.

Cases and tolerances (f32 unless said):

- ``ssd_chunked`` against ``repro.models.ssm.ssd_chunked`` at chunk 16,
  lengths that are and are not chunk multiples (right pad), with and
  without an initial state: within 1e-5 of the output scale; and
  against an independent oracle, a token-by-token loop of the decode
  recurrence (``state = exp(dt A) state + dt B x``, ``y = C state``),
  within 1e-5;
- the reference-side overflow: at chunk 128, A = -1 and dt 0.8 the
  reference's ``exp(diff) * tri`` is not finite; the port, which masks
  before the exponent, is finite and equals the loop within 1e-5;
- ``SSM.forward`` (``ssm_apply``): a prefill of 37 tokens into a fresh
  cache, then decode steps, outputs and caches within 1e-5 in f32, 2e-2
  of the output scale in bf16; the cache-free path too;
- reduced Mamba2 (the SSM leaves perturbed from 0 / 1): full-sequence
  logits under both ``scan_layers`` settings, float and BCQ-3, within
  1e-4 (the model's gate, as the other reduced models');
  ``from_jax_params`` -> ``to_params`` bit for bit; the quantization
  manifest equal to the reference's leaf for leaf under both settings
  (``in_proj`` and ``out_proj`` quantized, the rest FP);
- the slots engine on BCQ-3 weights with left-padded prompts (the pads
  enter the SSM state on both sides): greedy tokens identical to the
  reference ``ServeEngine``'s (tolerance 0 on token ids);
- the paged cache refuses a Mamba stack, ``supports_paging`` is False on
  both sides, and the launcher's ``--engine auto`` picks the slots
  engine.

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
from repro.models import ssm as jssm
from repro.serve import Request as JRequest
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models import from_jax_params, to_params
from repro_torch.models import ssm as tssm
from repro_torch.quant import QuantSpec, quantize_model
from repro_torch.serve import Request, ServeEngine

from torch_port_cases import (f32_params, port_pair, prompts_of,
                              ref_slots_engine, to_numpy_tree)

ARCH = "mamba2_2_7b"
F32_TOL = 1e-5
BF16_TOL = 2e-2
TOL = 1e-4
BCQ3 = dict(bits=3, group_size=32, iters=2, backend="bcq_xla")


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def mamba():
    """{"float" | "bcq3": (reference Model, params, port Model)}, the SSM
    leaves perturbed."""
    return {name: port_pair(ARCH, quant=quant, perturb=5)
            for name, quant in (("float", None), ("bcq3", BCQ3))}


# ---------------------------------------------------------------------------
# ssd_chunked
# ---------------------------------------------------------------------------


def _ssd_case(seed, *, b=2, l=37, h=4, p=8, n=16, dt=None):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dtv = (np.log1p(np.exp(rng.normal(size=(b, l, h)))) if dt is None
           else np.full((b, l, h), dt)).astype(np.float32)
    A = -np.exp(rng.normal(size=h) * 0.3).astype(np.float32)
    B = rng.normal(size=(b, l, n)).astype(np.float32)
    C = rng.normal(size=(b, l, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return xh, dtv, A, B, C, h0


def _recurrence(xh, dt, A, B, C, h0=None):
    """Token-by-token decode recurrence in float64 (the oracle)."""
    b, l, h, p = xh.shape
    n = B.shape[-1]
    state = np.zeros((b, h, p, n)) if h0 is None else h0.astype(np.float64)
    ys = []
    for t in range(l):
        da = np.exp(dt[:, t] * A[None])                       # [b, h]
        state = da[:, :, None, None] * state + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B[:, t], xh[:, t])
        ys.append(np.einsum("bn,bhpn->bhp", C[:, t], state))
    return np.stack(ys, 1), state


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("l", [16, 37, 5])
def test_ssd_chunked_matches_reference_and_recurrence(l, with_h0):
    xh, dt, A, B, C, h0 = _ssd_case(l, l=l)
    h0 = h0 if with_h0 else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    y, hl = tssm.ssd_chunked(t(xh), t(dt), t(A), t(B), t(C), 16, h0=t(h0))
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, B, C)),
                              16, h0=None if h0 is None else jnp.asarray(h0))
    assert y.shape == (2, l, 4, 8) and hl.dtype == torch.float32
    assert _rel(y, jy) < F32_TOL and _rel(hl, jh) < F32_TOL
    ry, rh = _recurrence(xh, dt, A, B, C, h0)
    assert _rel(y, ry) < F32_TOL and _rel(hl, rh) < F32_TOL


def test_ssd_overflow_is_reference_side():
    """At the full config's chunk 128 with A = -1 and dt 0.8 the cumulative
    decay reaches -102 inside a chunk, so ``exp(diff)`` above the
    diagonal overflows and the reference's ``exp(diff) * tri`` gives NaN;
    the port masks before the exponent and stays finite and exact."""
    xh, dt, _, B, C, _ = _ssd_case(3, b=1, l=128, dt=0.8)
    A = -np.ones(4, np.float32)
    jy, _ = jssm.ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, B, C)),
                             128)
    assert not np.isfinite(np.asarray(jy)).all()
    y, hl = tssm.ssd_chunked(*(torch.from_numpy(a)
                               for a in (xh, dt, A, B, C)), 128)
    assert torch.isfinite(y).all() and torch.isfinite(hl).all()
    ry, rh = _recurrence(xh, dt, A, B, C)
    assert _rel(y, ry) < F32_TOL and _rel(hl, rh) < F32_TOL


# ---------------------------------------------------------------------------
# the mixer (ssm_apply)
# ---------------------------------------------------------------------------


def _mixer_pair(mamba, dtype):
    """(reference mixer params, reference cfg, port SSM) of layer 0, in
    ``dtype`` (the projections and conv weight rounded for bf16)."""
    jm, params, tm = mamba["float"]
    jp = params["stack"]["layers"][0]["mixer"]
    jcfg = jm.cfg.replace(dtype=dtype)
    if dtype == "bfloat16":
        jp = {k: (v.astype(jnp.bfloat16) if k in ("in_proj", "out_proj",
                                                   "conv_w") else v)
              for k, v in jp.items()}
    tcfg = tm.cfg.replace(dtype=dtype)
    tm2 = from_jax_params(to_numpy_tree({**params, "stack": {
        "layers": [{**params["stack"]["layers"][0], "mixer": jp}]}}),
        tcfg.replace(n_layers=1), device="cpu")
    return jp, jcfg, tm2.stack.layers[0].mixer


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_ssm_prefill_then_decode_matches_reference(mamba, dtype, tol):
    jp, jcfg, mixer = _mixer_pair(mamba, dtype)
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(tdt)
    # the cache-free path
    assert _rel(mixer(tx), jssm.ssm_apply(jp, jcfg, jx)) < tol
    jc = {k: jnp.zeros(d.shape, d.dtype)
          for k, d in jssm.ssm_cache_desc(jcfg, 2).items()}
    tc = tssm.init_ssm_cache(mixer.cfg, 2, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == {
        k: (tuple(v.shape), getattr(torch, str(v.dtype)))
        for k, v in jc.items()}
    jy, jc = jssm.ssm_apply(jp, jcfg, jx, cache=jc)
    ty, tc = mixer(tx, cache=tc)
    assert ty.dtype == tdt and _rel(ty, jy) < tol
    for key in ("conv", "state"):
        assert tc[key].dtype == getattr(torch, str(jc[key].dtype))
        assert _rel(tc[key], jc[key]) < tol, key
    for t in range(3):
        step = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jssm.ssm_apply(jp, jcfg, jnp.asarray(step, jx.dtype),
                                cache=jc)
        ty, tc = mixer(torch.from_numpy(step).to(tdt), cache=tc)
        assert _rel(ty, jy) < tol
        assert _rel(tc["state"], jc["state"]) < tol
        assert _rel(tc["conv"], jc["conv"]) < tol


# ---------------------------------------------------------------------------
# reduced Mamba2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("weights", ["float", "bcq3"])
def test_mamba_forward_matches_reference(mamba, weights, scan):
    """37 tokens: two chunks of 16 and a right-padded third."""
    jm, params, tm = (port_pair(ARCH, quant=BCQ3 if weights == "bcq3"
                                else None, perturb=5, scan_layers=True)
                      if scan else mamba[weights])
    assert ("scan" in params["stack"]) == scan
    toks = np.random.default_rng(1).integers(0, 256, (2, 37)).astype(
        np.int32)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    assert got.shape == want.shape and _rel(got, want) < TOL
    assert tm.stack.layers[0].mlp is None and tm.stack.layers[0].ln2 is None


def _leaves(tree, path=""):
    if isinstance(tree, dict) and "packed" not in tree:
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("weights", ["float", "bcq3"])
def test_mamba_params_round_trip(mamba, weights):
    """``to_params`` gives back the reference's tree, leaf for leaf and
    bit for bit (bundles field by field)."""
    _, params, tm = mamba[weights]
    want = dict(_leaves(to_numpy_tree(params)))
    got = dict(_leaves(to_params(tm)))
    assert got.keys() == want.keys()
    assert {p.rsplit("/", 1)[-1] for p in got if "/mixer/" in p} == {
        "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
        "out_norm", "out_proj"}
    for path, w in want.items():
        g = got[path]
        if isinstance(w, dict):
            for k in ("packed", "alpha"):
                np.testing.assert_array_equal(g[k].numpy(), w[k])
        else:
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))


@pytest.mark.parametrize("scan", [False, True])
def test_mamba_manifest_matches_reference(scan):
    """in_proj / out_proj quantized, every other SSM leaf FP, entry for
    entry equal to the reference's manifest (path, shape, bytes)."""
    cfg = j_reduced(ARCH).replace(remat=False, dtype="float32",
                                  scan_layers=scan)
    from repro.models import Model as JModel
    jm = JModel(cfg)
    params = f32_params(jm.init(jax.random.PRNGKey(0)))
    spec = dict(bits=3, group_size=32, iters=2)
    _, jman = jquant.quantize_model(params, jquant.QuantSpec(**spec),
                                    jm.axes())
    tm = from_jax_params(to_numpy_tree(params), t_reduced(ARCH).replace(
        dtype="float32", scan_layers=scan), device="cpu")
    tman = quantize_model(tm, QuantSpec(**spec))
    keys = ("path", "shape", "plane_bits", "quant_bytes", "dense_bytes")
    assert [{k: l[k] for k in keys} for l in tman.layers] == \
        [{k: list(l[k]) if k == "shape" else l[k] for k in keys}
         for l in jman.layers]
    assert {l["path"].rsplit("/", 1)[-1] for l in tman.layers} == {
        "in_proj", "out_proj"}
    assert (tman.n_weights, tman.quant_bytes) == (jman.n_weights,
                                                  jman.quant_bytes)
    mixer = tm.stack.layers[0].mixer
    assert all(isinstance(getattr(mixer, k), torch.Tensor)
               for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias",
                         "out_norm"))


def test_mamba_slots_stream_matches_reference(mamba):
    """BCQ-3 reduced Mamba2 through both packages' slots engines (2 slots,
    prompts left-padded into buckets 8 / 16 / 32, so pads run through
    the conv and the scan): greedy tokens identical."""
    jm, params, tm = mamba["bcq3"]
    prompts = prompts_of([5, 13, 29])
    kw = dict(slots=2, cache_len=64, prefill_buckets=(8, 16, 32))
    jdone = ref_slots_engine(jm, params, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)], max_ticks=400)
    eng = ServeEngine(tm, **kw)
    assert set(eng.cache["layers"][0]) == {"conv", "state"}
    tdone = eng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                     for i, p in enumerate(prompts)], max_ticks=400)
    by = lambda reqs: {r.uid: (list(r.out_tokens), r.error) for r in reqs}
    assert by(tdone) == by(jdone)
    assert all(len(t) == 6 and e is None for t, e in by(tdone).values())


# ---------------------------------------------------------------------------
# configuration, engine choice, launcher
# ---------------------------------------------------------------------------


def test_mamba_configs_are_the_references():
    from repro.serve.engine import supports_paging as j_supports_paging
    from repro_torch.models.transformer import layer_plan, scan_grouping
    from repro.models.transformer import scan_grouping as j_grouping
    from repro_torch.serve import supports_paging
    for t, j in ((t_config(ARCH), j_config(ARCH)),
                 (t_reduced(ARCH), j_reduced(ARCH))):
        for field in ("name", "family", "n_layers", "d_model", "d_ff",
                      "vocab_size", "attention", "ssm_state",
                      "ssm_head_dim", "ssm_expand", "ssm_conv", "ssm_chunk",
                      "attn_layer_period", "attn_layer_offset", "norm",
                      "tie_embeddings", "max_seq_len", "scan_layers"):
            assert getattr(t, field) == getattr(j, field), field
        assert (t.is_ssm_only, t.is_hybrid) == (j.is_ssm_only, j.is_hybrid)
        assert layer_plan(t) == [(j.layer_kind(i), j.mlp_kind(i))
                                 for i in range(j.n_layers)]
        assert supports_paging(t) == j_supports_paging(j) is False
    # the hybrid interleave (Jamba's period 8, offset 4), on both sides
    hyb = dict(attention="gqa", attn_layer_period=8, attn_layer_offset=4,
               n_layers=16, n_heads=4, n_kv_heads=4)
    t, j = t_reduced(ARCH).replace(**hyb), j_reduced(ARCH).replace(**hyb)
    assert [t.layer_kind(i) for i in range(16)] == \
        [j.layer_kind(i) for i in range(16)]
    assert scan_grouping(t) == j_grouping(j)


def test_paged_cache_refuses_mamba_layers(mamba):
    _, _, tm = mamba["float"]
    with pytest.raises(ValueError, match="attention-only"):
        tm.init_paged_cache(1, 8, 4, 4)


def test_launcher_serves_mamba_on_the_slots_engine(capsys):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", ARCH, "--reduced", "1", "--device", "cpu",
                        "--engine", "auto", "--bits", "3", "--group-size",
                        "32", "--slots", "2", "--cache-len", "64",
                        "--requests", "3", "--max-new", "3"])
    assert "engine=auto -> slots" in capsys.readouterr().out
    assert len(done) == 3 and all(len(r.out_tokens) == 3 and not r.error
                                  for r in done)
