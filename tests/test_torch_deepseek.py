"""Port parity: reduced DeepSeek-V2 (MLA, MoE layers with a shared
expert, one dense prefix layer) against the reference, on the CPU.

Cases and tolerances (f32 activations):

- full-sequence logits under both ``scan_layers`` settings, float and
  BCQ-3 (g 16: it divides every reduced input width, kv_b's 16 too):
  within 1e-4 of the logit scale, the reduced models' gate, on float
  weights; on BCQ-3 weights within one bf16 ulp of the logit scale
  (2^-7): the reference's BCQ linears (``bcq_xla``) round their input
  and the dequantized weight to bf16, and its expert banks are
  dequantized to bf16 with the expert input rounded to match, so an f32
  summation-order difference upstream (1e-7) can move single roundings,
  which the random reduced stack amplifies (measured on 8-token
  prompts: 5 seeds read 6e-8 to 1.8e-3; the port's and the reference's
  own paged paths each equal their forward within 1.4e-7);
- the same BCQ-3 weights with every bf16 cast taken out on both sides
  (the ``dense`` backend: f32 dequantize and f32 activations; the
  routed banks dequantized to dense f32 [E, out, in] for the reference,
  ``bank_dtype`` f32 for the port's MoE layers): within 1e-5, the f32
  tolerance, which a cast departure of the quantized or expert paths
  that the 2^-7 gate would let through breaks (the port's banks left
  in bf16 do);
- chunked prefill into a scrambled block table, then decode steps on
  the paged latent pool (``fused``: the MLA decode wrapper, its plain
  version on the CPU; ``gather``): each step's logits within the same
  tolerances of the reference's;
- ``from_jax_params`` -> ``to_params`` bit for bit in both stack layouts
  (``stack/prefix/0`` is the dense layer, ``stack/scan/0`` stacks the
  MoE layers);
- the quantization manifest equal to the reference's entry for entry
  under both ``scan_layers`` settings, ``stack/prefix/0`` included;
- the paged engine on BCQ-3 weights, prompts right-padded into their
  chunk buckets (the pads route through the MoE layers like any token,
  as in the reference): greedy tokens identical to the reference
  ``PagedServeEngine``'s (tolerance 0 on token ids);
- the config and the launcher's ``--engine auto`` (paged).

The reference's models are built once per module (fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_reduced as j_reduced
from repro.core.plane import dequantize as j_dequantize
from repro.models import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import set_block_tables as j_set_tables
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models import from_jax_params, set_block_tables, to_params
from repro_torch.models.moe import MoE
from repro_torch.quant import QuantSpec, quantize_model
from repro_torch.serve import PagedServeEngine, Request

from torch_port_cases import (port_pair, prompts_of, quantized_pair,
                              ref_paged_engine, to_numpy_tree)

ARCH = "deepseek_v2_236b"
TOL = {"float": 1e-4, "bcq3": 2.0 ** -7, "f32": 1e-5}
BCQ3 = dict(bits=3, group_size=16, iters=2, backend="bcq_xla")


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def deepseek():
    """{(weights, scan): (reference Model, params, port Model)}, biases
    and norm scales perturbed, the fused paged path; the BCQ-3 pair
    quantizes the float pair's reference tree, and ``("manifest", scan)``
    holds the reference's manifest of that quantization."""
    out = {}
    for scan in (False, True):
        jm, params, tm = out["float", scan] = port_pair(
            ARCH, perturb=3, scan_layers=scan, paged_kernel="fused")
        out["bcq3", scan], out["manifest", scan] = quantized_pair(
            jm, params, tm.cfg, BCQ3, with_manifest=True)
    return out


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("weights", ["float", "bcq3"])
def test_deepseek_forward_matches_reference(deepseek, weights, scan):
    jm, params, tm = deepseek[weights, scan]
    assert ("prefix" in params["stack"]) == scan
    assert [type(b.mlp).__name__ for b in tm.stack.layers] == \
        ["MLP", "MoE", "MoE"]
    toks = np.random.default_rng(2).integers(0, 256, (2, 21)).astype(
        np.int32)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    assert got.shape == want.shape and _rel(got, want) < TOL[weights]


def _f32_banks(params):
    """``params`` with every MoE layer's quantized expert banks replaced by
    their dense f32 reconstruction [E, out, in], one expert at a time."""
    def dense(w):
        return jnp.stack([j_dequantize(dataclasses.replace(
            w, packed=w.packed[e], alpha=w.alpha[e],
            z=None if w.z is None else w.z[e]), jnp.float32)
            for e in range(w.packed.shape[0])])
    layers = []
    for layer in params["stack"]["layers"]:
        mlp = layer["mlp"]
        if "router" in mlp:
            mlp = {**mlp, **{k: dense(mlp[k]) for k in ("gate", "up", "down")}}
        layers.append({**layer, "mlp": mlp})
    return {**params, "stack": {"layers": layers}}


def test_deepseek_bcq3_f32_forward_matches_reference(deepseek):
    """BCQ-3 weights with no bf16 cast on either side (the ``dense``
    backend, the routed banks in f32): only the f32 summation order
    differs, so the f32 tolerance (1e-5) holds."""
    jm, params, tm = deepseek["bcq3", False]
    jm = JModel(jm.cfg.replace(quant=dataclasses.replace(
        jm.cfg.quant, backend="dense")))
    tm = tm.with_config(quant=tm.cfg.quant.replace(backend="dense"))
    moes = [b.mlp for b in tm.stack.layers if isinstance(b.mlp, MoE)]
    assert len(moes) == 2
    toks = np.random.default_rng(2).integers(0, 256, (2, 21)).astype(
        np.int32)
    want = jax.jit(jm.forward)(_f32_banks(params),
                               {"tokens": jnp.asarray(toks)})
    try:
        for m in moes:
            m.bank_dtype = torch.float32
        got = tm.forward(torch.from_numpy(toks))
    finally:
        for m in moes:
            del m.bank_dtype
    assert got.shape == want.shape and _rel(got, want) < TOL["f32"]


@pytest.mark.parametrize("paged_kernel,weights", [("fused", "bcq3"),
                                                  ("gather", "float")])
def test_deepseek_chunked_prefill_then_decode(deepseek, paged_kernel,
                                              weights):
    """prefill_chunk x2 (the second right-padded to 8 rows: its pads pass
    the MoE layers) into a scrambled table of block size 4, then three
    decode steps on the latent pool."""
    jm, params, tm = deepseek[weights, False]
    tm = tm.with_config(paged_kernel=paged_kernel)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (1, 16)).astype(np.int32)
    bs, nblk = 4, 8
    table = np.full((1, nblk), -1, np.int32)
    table[0, :5] = [7, 2, 11, 4, 9]
    jc = j_set_tables(jm.init_paged_cache(1, 12, bs, nblk), table)
    tc = set_block_tables(tm.init_paged_cache(1, 12, bs, nblk), table)
    prefill = jax.jit(jm.prefill_chunk)
    for c0, c1 in ((0, 8), (8, 13)):
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :c1 - c0] = toks[0, c0:c1]
        jl, jc = prefill(params, {"tokens": jnp.asarray(chunk)}, jc,
                         jnp.int32(c0), jnp.int32(c1 - c0 - 1))
        tl, tc = tm.prefill_chunk(torch.from_numpy(chunk), tc, c0,
                                  c1 - c0 - 1)
        assert _rel(tl, jl) < TOL[weights]
    decode = jax.jit(jm.decode_step)
    for t in range(13, 16):
        step = toks[:, t:t + 1]
        jl, jc = decode(params, jnp.asarray(step), jc, jnp.int32(t))
        tl, tc = tm.decode_step(torch.from_numpy(step), tc, t)
        assert _rel(tl, jl) < TOL[weights]
    np.testing.assert_array_equal(tc["layers"][2]["pos"].numpy(),
                                  np.asarray(jc["layers"][2]["self"]["pos"]))


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
def test_deepseek_params_round_trip(deepseek, weights, scan):
    _, params, tm = deepseek[weights, scan]
    want = dict(_leaves(to_numpy_tree(params)))
    got = dict(_leaves(to_params(tm)))
    assert got.keys() == want.keys()
    if scan:
        assert {p.split("/")[2] for p in got if p.startswith("/stack/")} \
            == {"prefix", "scan"}
        assert "/stack/prefix/0/mlp/up" in got
        assert "/stack/scan/0/mlp/shared_up" in got
    for path, w in want.items():
        g = got[path]
        if isinstance(w, dict):
            for k in ("packed", "alpha"):
                np.testing.assert_array_equal(g[k].numpy(), w[k])
        else:
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))


@pytest.mark.parametrize("scan", [False, True])
def test_deepseek_manifest_matches_reference(deepseek, scan):
    """Every MLA projection, the dense prefix layer's MLP, the expert
    banks (per expert, E leading), the shared expert and the head, entry
    for entry as the reference's (path, shape, width, bytes).  Both sides
    quantize the float pair's weights (the reference's in the fixture,
    the port a fresh copy: ``quantize_model`` replaces its linears in
    place)."""
    _, params, tm = deepseek["float", scan]
    jman = deepseek["manifest", scan]
    tm = from_jax_params(to_numpy_tree(params), tm.cfg, device="cpu")
    tman = quantize_model(tm, QuantSpec(**BCQ3))
    keys = ("path", "shape", "plane_bits", "quant_bytes", "dense_bytes")
    assert [{k: l[k] for k in keys} for l in tman.layers] == \
        [{k: list(l[k]) if k == "shape" else l[k] for k in keys}
         for l in jman.layers]
    paths = [l["path"] for l in tman.layers]
    if scan:
        assert "stack/prefix/0/mlp/gate" in paths
        assert "stack/scan/0/mlp/gate" in paths
    assert isinstance(tm.stack.layers[1].mlp, MoE)
    assert tm.stack.layers[1].mlp.gate.weight.packed.shape[0] == 8


def test_deepseek_paged_stream_matches_reference(deepseek):
    """BCQ-3 reduced DeepSeek-V2 through both packages' paged engines (2
    rows, block 4, chunk buckets 8 / 16: every chunk right-padded):
    greedy tokens identical."""
    jm, params, tm = deepseek["bcq3", False]
    prompts = prompts_of([5, 11, 19])
    kw = dict(num_blocks=24, block_size=4, max_batch=2, max_seq_len=40,
              prefill_buckets=(8, 16))
    je = ref_paged_engine(jm, params, **kw)
    jdone = je.run([JRequest(uid=i, prompt=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)], max_ticks=400)
    te = PagedServeEngine(tm, **kw)
    tdone = te.run([Request(uid=i, prompt=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)], max_ticks=400)
    by = lambda reqs: {r.uid: (list(r.out_tokens), r.error) for r in reqs}
    assert by(tdone) == by(jdone)
    assert all(len(t) == 5 and e is None for t, e in by(tdone).values())
    assert te.decode_path == je.decode_path == "fused"


def test_deepseek_configs_are_the_references():
    from repro.models.transformer import scan_grouping as j_grouping
    from repro.serve.engine import supports_paging as j_supports_paging
    from repro_torch.models.transformer import layer_plan, scan_grouping
    from repro_torch.serve import supports_paging
    for t, j in ((t_config(ARCH), j_config(ARCH)),
                 (t_reduced(ARCH), j_reduced(ARCH))):
        for field in ("name", "family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab_size", "attention",
                      "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
                      "qk_rope_head_dim", "v_head_dim", "n_experts",
                      "n_shared_experts", "experts_per_token", "moe_d_ff",
                      "first_dense_layers", "capacity_factor", "mlp_act",
                      "norm", "tie_embeddings", "max_seq_len",
                      "scan_layers"):
            assert getattr(t, field) == getattr(j, field), field
        assert layer_plan(t) == [(j.layer_kind(i), j.mlp_kind(i))
                                 for i in range(j.n_layers)]
        assert scan_grouping(t) == j_grouping(j) == (1, 1, j.n_layers - 1)
        assert supports_paging(t) == j_supports_paging(j) is True


def test_launcher_serves_deepseek_on_the_paged_engine(capsys):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", ARCH, "--reduced", "1", "--device", "cpu",
                        "--engine", "auto", "--bits", "3", "--group-size",
                        "16", "--requests", "2", "--max-new", "3",
                        "--paged-kernel", "fused", "--num-blocks", "24"])
    assert "engine=auto -> paged" in capsys.readouterr().out
    assert len(done) == 2 and all(len(r.out_tokens) == 3 and not r.error
                                  for r in done)
