"""Port parity: the MoE layer (``models/moe.py``), expert banks in the
quantizer, the parameter trees and quantized checkpoints, against the
reference, on the CPU.

Cases and tolerances:

- ``moe_apply`` against ``repro.models.moe.moe_apply`` on the reduced
  Mixtral widths (4 experts, top-2, d 64, f 128): f32 banks within 1e-5
  of the output scale (only the f32 summation order differs); BCQ-3
  banks (dequantized to bf16 on both sides) within 1e-3 on f32
  activations, and on bf16 activations within one bf16 ulp of the output
  scale (2^-7: the output is rounded to bf16, so an f32 difference in the
  summation order can move one element by an ulp); shared experts on (``n_shared_experts=1`` on both
  sides); a router biased to one expert (assignments dropped beyond
  capacity); left-pads that take capacity ahead of the real tokens
  (identical rows route alike, and a stable argsort ranks lower token
  indices first); a router with exact ties (two equal rows: the lower
  expert index wins, as ``jax.lax.top_k``);
- ``quantize_model`` on reduced Mixtral: the manifest equal to the
  reference's entry for entry under both ``scan_layers`` settings, each
  bank quantized per expert with E leading (packed [E, q, out, in/8]),
  its reconstruction within 1e-5 of the reference's;
- ``from_jax_params`` -> ``to_params`` bit for bit, float and quantized,
  and a quantized checkpoint of expert-stacked bundles written by either
  package read back bit for bit;
- a stacked bundle never reaches ``execute_linear``.

The reference's model trees are built once per module (fixtures).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_reduced as j_reduced
from repro.core import plane as jplane
from repro.core.plane import PlaneBundle as JBundle
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.core.plane import PlaneBundle, dequantize
from repro_torch.models import from_jax_params, to_params
from repro_torch.models.moe import MoE, route
from repro_torch.quant import (QuantSpec, load_quantized, quantize_model,
                               save_quantized)

from torch_port_cases import f32_params, to_numpy_tree, torch_bundle

F32_TOL = 1e-5
BCQ_TOL = 1e-3
BF16_TOL = 2.0 ** -7
G = 32
BANK_AXES = {"gate": ("experts", "mlp", "embed"),
             "up": ("experts", "mlp", "embed"),
             "down": ("experts", "embed", "mlp"),
             "shared_gate": ("mlp", "embed"), "shared_up": ("mlp", "embed"),
             "shared_down": ("embed", "mlp"), "router": ("experts", "embed")}


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@functools.lru_cache(maxsize=None)
def _j_moe(cfg):
    return jax.jit(lambda p, x: jmoe.moe_apply(p, cfg, x))


def _layer(cfg, seed, *, quantized=False, router=None):
    """(reference MoE params, port MoE) from numpy ``seed``: N(0, 0.02)
    banks in ``cfg.dtype``, an f32 router (``router`` overrides it);
    with ``quantized`` the banks and shared linears are BCQ-3 g 32,
    quantized by the reference per expert and carried across."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    shapes = {"gate": (e, f, d), "up": (e, f, d), "down": (e, d, f)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shapes.update(shared_gate=(fs, d), shared_up=(fs, d),
                      shared_down=(d, fs))
    dt = jnp.dtype(cfg.dtype)
    params = {k: jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.02,
                             dt) for k, s in shapes.items()}
    params["router"] = jnp.asarray(
        router if router is not None else
        rng.normal(size=(e, d)).astype(np.float32) * 0.02)
    if quantized:
        spec = jquant.QuantSpec(bits=3, group_size=G, iters=2)
        params, _ = jquant.quantize_model(
            params, spec, {k: BANK_AXES[k] for k in params})
        assert params["gate"].packed.shape == (e, 3, f, d // 8)
    tdt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    mod = MoE(cfg, dtype=tdt, device="cpu")
    for name, leaf in params.items():
        if isinstance(leaf, JBundle):
            w = torch_bundle(leaf)
        else:
            a = np.asarray(leaf.astype(jnp.float32))
            w = torch.from_numpy(a.copy()).to(
                torch.float32 if name == "router" else tdt)
        if name == "router":
            mod.router = w
        else:
            getattr(mod, name).weight = w
    return params, mod


def _x(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed + 1000)
    return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _run(cfg, params, mod, x):
    dt = jnp.dtype(cfg.dtype)
    want = _j_moe(cfg)(params, jnp.asarray(x, dt))
    xt = torch.from_numpy(x)
    if cfg.dtype != "float32":
        xt = xt.to(torch.bfloat16)
    got = mod(xt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    return got, want


def _cfg(**over):
    return t_reduced("mixtral_8x7b").replace(**over), \
        j_reduced("mixtral_8x7b").replace(**over)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,tol", [
    ("f32", F32_TOL), ("f32_shared", F32_TOL), ("bcq3_f32x", BCQ_TOL),
    ("bcq3_bf16", BF16_TOL), ("bcq3_shared", BCQ_TOL)])
def test_moe_apply_matches_reference(case, tol):
    over = dict(dtype="bfloat16" if "bf16" in case else "float32",
                n_shared_experts=1 if "shared" in case else 0)
    tcfg, jcfg = _cfg(**over)
    params, mod = _layer(jcfg, 3, quantized=case.startswith("bcq3"))
    mod.cfg = tcfg
    x = _x(jcfg, 3)
    got, want = _run(jcfg, params, mod, x)
    assert _rel(got, want) < tol
    assert mod.last_keep.shape == (2, 16, 2)


def test_moe_drops_beyond_capacity_match_reference():
    """A router that sends every token to expert 0 first: each row keeps
    cap = 10 of its 16 expert-0 assignments, lowest token index first,
    and drops the rest."""
    tcfg, jcfg = _cfg(dtype="float32")
    router = np.zeros((4, 64), np.float32)
    router[0] = 5.0
    router[1:] = np.random.default_rng(7).normal(size=(3, 64)) * 0.02
    params, mod = _layer(jcfg, 5, router=router)
    mod.cfg = tcfg
    x = np.abs(_x(jcfg, 5)) + 0.1                  # x . router[0] > 0
    got, want = _run(jcfg, params, mod, x)
    assert _rel(got, want) < F32_TOL
    dropped = ~mod.last_keep
    # each row keeps its first 10 first choices (the stable ranking)
    assert int(dropped[:, :, 0].sum()) == 2 * (16 - 10)
    assert not dropped[:, :10, 0].any()


def test_moe_pads_take_capacity_ahead_of_real_tokens():
    """Twelve identical left-pad rows (one token embedding) ahead of four
    real tokens: the pads route to one expert pair and, ranked first by
    the stable argsort, fill its capacity (cap 10), so real tokens routed
    there are dropped, in both packages alike."""
    tcfg, jcfg = _cfg(dtype="float32")
    params, mod = _layer(jcfg, 11)
    mod.cfg = tcfg
    x = _x(jcfg, 11, b=1)
    x[0, :12] = x[0, 0]
    pad_experts = set(route(mod.router, torch.from_numpy(x[:, :1]), 2)[1]
                      .flatten().tolist())
    real = route(mod.router, torch.from_numpy(x[:, 12:]), 2)[1][0]
    got, want = _run(jcfg, params, mod, x)
    assert _rel(got, want) < F32_TOL
    keep = mod.last_keep[0]
    assert not keep[10:12].any()                    # pads beyond capacity
    assert keep[:10].all()
    real_dropped = [(t, j) for t in range(4) for j in range(2)
                    if not keep[12 + t, j]]
    assert real_dropped and all(int(real[t, j]) in pad_experts
                                for t, j in real_dropped)


def test_moe_router_ties_match_reference():
    """Experts 1 and 2 have the same router row, so their probabilities
    tie exactly: the lower index is chosen first, as ``jax.lax.top_k``."""
    tcfg, jcfg = _cfg(dtype="float32")
    rng = np.random.default_rng(13)
    router = rng.normal(size=(4, 64)).astype(np.float32) * 0.02
    router[2] = router[1]
    router[1:3] += 0.5 * np.abs(router).max()    # make them the top two
    params, mod = _layer(jcfg, 13, router=router)
    mod.cfg = tcfg
    x = np.abs(_x(jcfg, 13))
    _, j_exp = jax.lax.top_k(jax.nn.softmax(
        jnp.einsum("bsd,ed->bse", jnp.asarray(x), jnp.asarray(router)),
        axis=-1), 2)
    gates, t_exp = route(mod.router, torch.from_numpy(x), 2)
    np.testing.assert_array_equal(t_exp.numpy(), np.asarray(j_exp))
    assert bool((gates[..., 0] == gates[..., 1]).any())
    assert (t_exp[..., 0] == 1).any()
    got, want = _run(jcfg, params, mod, x)
    assert _rel(got, want) < F32_TOL


def test_stacked_bundle_never_reaches_execute_linear():
    from repro_torch.quant.backends import execute_linear
    _, mod = _layer(_cfg(dtype="float32")[1], 17, quantized=True)
    bank = mod.gate.weight
    assert isinstance(bank, PlaneBundle) and bank.packed.ndim == 4
    with pytest.raises(ValueError, match="2-D weights"):
        execute_linear(torch.zeros(1, 64), bank)
    dense = dequantize(bank, torch.float32)
    assert dense.shape == (4, 128, 64)
    assert torch.equal(dense[2], dequantize(bank.index(2), torch.float32))


# ---------------------------------------------------------------------------
# the model: quantizer manifests, parameter trees, checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["unrolled",
                                                           "scan"])
def pair(request):
    """(reference Model, f32 params, BCQ-3 params, manifest, port Model of
    the f32 params) for reduced Mixtral in one stack layout."""
    scan = request.param
    cfg = j_reduced("mixtral_8x7b").replace(remat=False, dtype="float32",
                                            scan_layers=scan)
    jm = JModel(cfg)
    params = f32_params(jm.init(jax.random.PRNGKey(0)))
    jspec = jquant.QuantSpec(bits=3, group_size=G, iters=2)
    qparams, jman = jquant.quantize_model(params, jspec, jm.axes())
    tcfg = t_reduced("mixtral_8x7b").replace(dtype="float32",
                                             scan_layers=scan)
    tm = from_jax_params(to_numpy_tree(params), tcfg, device="cpu")
    return jm, params, qparams, jman, tm


def test_manifest_and_banks_match_reference(pair):
    jm, _, qparams, jman, tm = pair
    tman = quantize_model(tm, QuantSpec(bits=3, group_size=G, iters=2))
    assert any(l["path"].endswith("mlp/gate") for l in tman.layers)
    assert tman.layers == jman.layers
    assert tman.to_dict() == jman.to_dict()
    assert isinstance(tm.stack.layers[0].mlp.router, torch.Tensor)
    stack = qparams["stack"]
    jbank = (stack["scan"][0]["mlp"]["up"] if jm.cfg.scan_layers
             else stack["layers"][0]["mlp"]["up"])
    tbank = tm.stack.layers[0].mlp.up.weight
    assert tbank.packed.shape == (4, 3, 128, 8)
    if jm.cfg.scan_layers:                   # layer 0 of the stacked leaf
        jbank = jax.tree_util.tree_map(lambda a: a[0], jbank)
    for e in range(4):
        want = jplane.dequantize(
            jax.tree_util.tree_map(lambda a: a[e], jbank), jnp.float32)
        assert _rel(dequantize(tbank.index(e)), want) < F32_TOL


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, JBundle):
        yield from _leaves({k: getattr(tree, k) for k in (
            "packed", "alpha", "z", "group_size", "in_features",
            "out_features", "kind")}, path)
    else:
        yield path, tree


def _assert_same(got, want):
    """Two trees leaf for leaf: same keys, dtypes and bits."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        if w[k] is None or isinstance(w[k], (int, str)):
            assert g[k] == w[k], k
            continue
        a = g[k].detach().cpu() if isinstance(g[k], torch.Tensor) else g[k]
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            a = a.float()
        a, b = np.asarray(a), np.asarray(w[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)


@pytest.mark.parametrize("quantized", [False, True])
def test_params_round_trip_bit_identical(pair, quantized):
    jm, params, qparams, _, tm = pair
    tree = qparams if quantized else params
    spec = QuantSpec(bits=3, group_size=G, iters=2)
    model = from_jax_params(to_numpy_tree(tree), tm.cfg.replace(
        quant=spec if quantized else None), device="cpu")
    _assert_same(to_params(model), tree)
    mlp = model.stack.layers[1].mlp
    assert isinstance(mlp, MoE)
    if quantized:
        assert mlp.gate.weight.packed.shape == (4, 3, 128, 8)


def test_expert_bank_checkpoints_round_trip(pair, tmp_path):
    """Expert-stacked bundles through quantized checkpoints: the port's
    own, read back bit for bit (serving the same logits), and the
    reference's, read by the port."""
    from repro_torch.quant.checkpoint import load_quantized_model
    jm, _, qparams, jman, tm = pair
    spec = QuantSpec(bits=3, group_size=G, iters=2, backend="bcq_xla")
    model = from_jax_params(to_numpy_tree(qparams),
                            tm.cfg.replace(quant=spec), device="cpu")
    save_quantized(str(tmp_path / "port"), model, spec, arch=tm.cfg.name)
    back, spec2, _, _ = load_quantized_model(str(tmp_path / "port"),
                                             tm.cfg, device="cpu")
    assert spec2 == spec
    _assert_same(to_params(back), to_params(model))
    toks = torch.from_numpy(np.arange(12, dtype=np.int32)[None])
    assert torch.equal(back.forward(toks), model.forward(toks))
    jspec = jquant.QuantSpec(bits=3, group_size=G, iters=2)
    jquant.save_quantized(str(tmp_path / "ref"), qparams, jspec, jman,
                          arch=jm.cfg.name)
    tree, _, man, _ = load_quantized(str(tmp_path / "ref"))
    assert man.to_dict() == jman.to_dict()
    _assert_same(tree, qparams)
