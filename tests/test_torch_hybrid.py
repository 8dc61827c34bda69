"""Port parity: reduced Jamba-1.5-Large (the hybrid interleave: Mamba
layers, attention layers, MoE layers) against the reference, on the
CPU.

The reduced config has 8 layers, attention at i % 4 == 2 and MoE on
every odd layer (period 4, two repeats under ``scan_layers``).  Cases
and tolerances (f32 activations, norms and biases perturbed):

- full-sequence logits under both ``scan_layers`` settings: float
  weights within 1e-4 of the logit scale; BCQ-3 (g 16, ``bcq_xla``)
  within one bf16 ulp of it (2^-7), the MoE tolerance of the Mixtral
  and DeepSeek-V2 files: the reference's BCQ linears and bf16 expert
  banks round to bf16, so an f32 summation-order difference upstream
  can move single roundings that the random reduced stack amplifies;
- ``Model.prefill`` with left-pads (negative start positions) into a
  contiguous cache, then decode steps, float weights: each step's
  logits within 1e-4;
- the slots engine on BCQ-3 weights, prompts left-padded into their
  buckets (the pads enter the Mamba layers' state and take expert
  capacity, on both sides): greedy tokens identical to the reference
  ``ServeEngine``'s (tolerance 0 on token ids);
- ``from_jax_params`` -> ``to_params`` bit for bit and the quantization
  manifest equal to the reference's leaf for leaf, both settings
  (``in_proj`` / ``out_proj``, ``q/k/v/o``, dense MLPs, expert banks E
  leading, the head);
- the config, the layer plan, the paged cache's refusal and the
  launcher's ``--engine auto`` (slots).

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
from repro.models import Model as JModel
from repro.serve import Request as JRequest
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models import from_jax_params, to_params
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM
from repro_torch.quant import QuantSpec, quantize_model
from repro_torch.serve import Request, ServeEngine

from torch_port_cases import (port_pair, prompts_of, ref_slots_engine,
                              to_numpy_tree)

ARCH = "jamba_1_5_large_398b"
TOL = {"float": 1e-4, "bcq3": 2.0 ** -7}
G = 16           # divides every reduced input width (64, 128)
BCQ3 = dict(bits=3, group_size=G, iters=2, backend="bcq_xla")


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def jamba():
    """{(weights, scan): (reference Model, params, port Model)}, biases,
    norms and the Mamba leaves perturbed; the BCQ-3 pair quantizes the
    float pair's reference tree, and ``("manifest", scan)`` holds the
    reference's manifest of that quantization."""
    out = {}
    for scan in (False, True):
        jm, params, tm = port_pair(ARCH, perturb=11, scan_layers=scan)
        out["float", scan] = jm, params, tm
        spec = jquant.QuantSpec(**BCQ3)
        qparams, out["manifest", scan] = jquant.quantize_model(
            params, spec, jm.axes())
        out["bcq3", scan] = (
            JModel(jm.cfg.replace(quant=spec)), qparams,
            from_jax_params(to_numpy_tree(qparams), tm.cfg.replace(
                quant=QuantSpec(**BCQ3)), device="cpu"))
    return out


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("weights", ["float", "bcq3"])
def test_jamba_forward_matches_reference(jamba, weights, scan):
    jm, params, tm = jamba[weights, scan]
    assert ("scan" in params["stack"]) == scan
    kinds = [(type(b.mixer).__name__, type(b.mlp).__name__)
             for b in tm.stack.layers]
    assert kinds == [("SSM", "MLP"), ("SSM", "MoE"), ("Attention", "MLP"),
                     ("SSM", "MoE")] * 2
    toks = np.random.default_rng(1).integers(0, 256, (2, 19)).astype(
        np.int32)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    assert got.shape == want.shape and _rel(got, want) < TOL[weights]


def test_jamba_padded_prefill_then_decode(jamba):
    """Two rows, left-padded by 3 and 0 into 12 positions, prefilled into
    a contiguous cache of 32 (attention rows and Mamba states), then
    four decode steps (float weights; the BCQ-3 path is the slots
    stream's)."""
    weights = "float"
    jm, params, tm = jamba[weights, False]
    toks = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(
        np.int32)
    start = np.array([-3, 0], np.int32)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    jl, jc = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)}, jc,
                                 jnp.asarray(start))
    tl, tc = tm.prefill(torch.from_numpy(toks), tc, torch.from_numpy(start))
    assert _rel(tl, jl) < TOL[weights]
    assert set(tc["layers"][0]) == {"conv", "state"}
    assert set(tc["layers"][2]) == {"k", "v", "pos"}
    decode = jax.jit(jm.decode_step)
    for t in range(4):
        step = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        pos = start + 12 + t
        jl, jc = decode(params, jnp.asarray(step), jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(torch.from_numpy(step), tc,
                                torch.from_numpy(pos))
        assert _rel(tl, jl) < TOL[weights], t


def test_jamba_slots_stream_matches_reference(jamba):
    jm, params, tm = jamba["bcq3", False]
    prompts = prompts_of([5, 13, 29], seed=3)
    # one bucket: 27, 19 and 3 left-pads (and one prefill trace); three
    # requests on two slots, so the third reuses a freed slot.  Three new
    # tokens each: the reference engine's steps are the file's cost
    kw = dict(slots=2, cache_len=64, prefill_buckets=(32,))
    jdone = ref_slots_engine(jm, params, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=3)
         for i, p in enumerate(prompts)], max_ticks=400)
    tdone = ServeEngine(tm, **kw).run(
        [Request(uid=i, prompt=p, max_new_tokens=3)
         for i, p in enumerate(prompts)], max_ticks=400)
    by = lambda reqs: {r.uid: (list(r.out_tokens), r.error) for r in reqs}
    assert by(tdone) == by(jdone)
    assert all(len(t) == 3 and e is None for t, e in by(tdone).values())


def _leaves(tree, path=""):
    if isinstance(tree, dict) and "packed" not in tree:
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("weights", ["float", "bcq3"])
def test_jamba_params_round_trip(jamba, weights, scan):
    _, params, tm = jamba[weights, scan]
    want = dict(_leaves(to_numpy_tree(params)))
    got = dict(_leaves(to_params(tm)))
    assert got.keys() == want.keys()
    if scan:
        assert {p.split("/")[3] for p in got if p.startswith("/stack/")} \
            == {"0", "1", "2", "3"}
        assert "/stack/scan/1/mlp/router" in got
        assert "/stack/scan/2/mixer/q" in got
        assert "/stack/scan/3/mixer/A_log" in got
    for path, w in want.items():
        g = got[path]
        if isinstance(w, dict):
            for k in ("packed", "alpha"):
                np.testing.assert_array_equal(g[k].numpy(), w[k])
        else:
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))


@pytest.mark.parametrize("scan", [False, True])
def test_jamba_manifest_matches_reference(jamba, scan):
    _, params, tm = jamba["float", scan]
    jman = jamba["manifest", scan]
    tm = from_jax_params(to_numpy_tree(params), tm.cfg, device="cpu")
    tman = quantize_model(tm, QuantSpec(**BCQ3))
    keys = ("path", "shape", "plane_bits", "quant_bytes", "dense_bytes")
    assert [{k: l[k] for k in keys} for l in tman.layers] == \
        [{k: list(l[k]) if k == "shape" else l[k] for k in keys}
         for l in jman.layers]
    paths = [l["path"] for l in tman.layers]
    pre = "scan" if scan else "layers"
    for leaf in (f"{pre}/0/mixer/in_proj", f"{pre}/1/mlp/gate",
                 f"{pre}/2/mixer/k", f"{pre}/3/mixer/out_proj"):
        assert f"stack/{leaf}" in paths
    assert isinstance(tm.stack.layers[1].mlp, MoE)
    assert tm.stack.layers[1].mlp.gate.weight.packed.shape[0] == 4
    assert isinstance(tm.stack.layers[0].mixer, SSM)


def test_jamba_configs_are_the_references():
    from repro.models.transformer import scan_grouping as j_grouping
    from repro.serve.engine import supports_paging as j_supports_paging
    from repro_torch.models.transformer import layer_plan, scan_grouping
    from repro_torch.serve import supports_paging
    for t, j in ((t_config(ARCH), j_config(ARCH)),
                 (t_reduced(ARCH), j_reduced(ARCH))):
        for field in ("name", "family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "attention", "attn_layer_period", "attn_layer_offset",
                      "n_experts", "experts_per_token", "moe_d_ff",
                      "moe_layer_period", "ssm_state", "ssm_head_dim",
                      "ssm_expand", "ssm_conv", "ssm_chunk", "mlp_act",
                      "norm", "tie_embeddings", "max_seq_len",
                      "scan_layers"):
            assert getattr(t, field) == getattr(j, field), field
        assert (t.is_hybrid, t.is_ssm_only, t.is_encdec) == \
            (j.is_hybrid, j.is_ssm_only, j.is_encdec) == (True, False, False)
        assert layer_plan(t) == [(j.layer_kind(i), j.mlp_kind(i))
                                 for i in range(j.n_layers)]
        assert scan_grouping(t) == j_grouping(j)
        assert supports_paging(t) == j_supports_paging(j) is False
    # the full config's first five layers: Mamba 0-3, attention at 4,
    # MoE at 1 and 3 (the depth the card runs)
    assert layer_plan(t_config(ARCH))[:5] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attn", "dense")]


def test_paged_cache_refuses_jamba(jamba):
    _, _, tm = jamba["float", False]
    with pytest.raises(ValueError, match="attention-only"):
        tm.init_paged_cache(1, 8, 4, 4)


def test_launcher_serves_jamba_on_the_slots_engine(capsys):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", ARCH, "--reduced", "1", "--device", "cpu",
                        "--engine", "auto", "--bits", "3", "--group-size",
                        "16", "--slots", "2", "--cache-len", "64",
                        "--requests", "3", "--max-new", "3"])
    assert "engine=auto -> slots" in capsys.readouterr().out
    assert len(done) == 3 and all(len(r.out_tokens) == 3 and not r.error
                                  for r in done)
