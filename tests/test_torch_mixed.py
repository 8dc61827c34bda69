"""Port parity: mixed-precision BCQ (``QuantSpec(bits=2.4)``, paper
Fig. 17) against the reference.

  * the spec: bits, flags, candidates, ``describe`` and the JSON round
    trip, in both directions between the packages;
  * the probe's row subsample exactly, and ``layer_sensitivity`` within
    1e-3 relative: the two BCQ solvers agree on the reconstruction
    within 1e-5, but where the least-squares fit is degenerate they can
    return different planes for the same reconstruction (ROADMAP.md
    queue 3), so the error is compared, not the planes;
  * ``allocate_bits`` on one injected error table (no probe): the same
    map, a tie decided by leaf order;
  * ``plan_bits`` and ``quantize_model``: identical bit maps and
    manifests, entry for entry, on reduced OPT (``scan_layers`` False
    and True) and reduced MiniCPM3 (``scan_layers`` True), at 2.4 and
    1.8 bits and with an override; the reference's refusals;
  * a mixed model quantized by the reference, carried across by
    ``from_jax_params``: plain-path logits within 1e-3 of the logit
    scale, in f32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_reduced as j_reduced
from repro.core import mixed_precision as jmp
from repro.models import Model as JModel
from repro.quant import ptq as jptq
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.core import mixed_precision as tmp
from repro_torch.models import from_jax_params
from repro_torch.quant import (QuantSpec, collect_linears, format_for_bits,
                               plan_bits, quantize_model)

from torch_port_cases import f32_params, to_numpy_tree

SENS_RTOL = 1e-3
LOGIT_TOL = 1e-3
G = 32          # group size for the reduced widths (d_model 64, d_ff 128)


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------

SPEC_CASES = [
    dict(bits=1.58), dict(bits=1.8), dict(bits=2.4), dict(bits=3.5),
    dict(bits=2.4, candidates=(2, 4)),
    dict(bits=3, overrides={"stack/scan/0/mixer/q": 2,
                            "stack/scan/0/mlp/up": 1.585}),
    dict(format="uniform", bits=2.5, group_size=64),
    dict(format="ternary"),
]


@pytest.mark.parametrize("kw", SPEC_CASES, ids=lambda kw: repr(kw))
def test_spec_matches_reference(kw):
    t, j = QuantSpec(**kw), jquant.QuantSpec(**kw)
    assert float(t.bits) == j.bits
    assert t.format == j.format
    assert t.is_fractional == j.is_fractional
    assert t.is_mixed == j.is_mixed
    assert t.candidate_bits == j.candidate_bits
    assert t.overrides == j.overrides
    assert t.overrides_map == j.overrides_map
    assert t.describe() == j.describe()
    assert t.to_dict() == j.to_dict()
    assert QuantSpec.from_json(t.to_json()) == t
    # each package reads the other's dict
    assert QuantSpec.from_dict(j.to_dict()) == t
    assert jquant.QuantSpec.from_dict(t.to_dict()) == j


def test_spec_reads_legacy_and_canonical_spellings(tmp_path):
    assert QuantSpec.from_dict({"method": "ternary", "group_size": 64}) == \
        QuantSpec(format="ternary", group_size=64)
    assert QuantSpec(bits=1.58).bits == 1.585
    assert QuantSpec(bits=1.58).candidate_bits == (1.585, 2, 3)
    path = tmp_path / "spec.json"
    spec = QuantSpec(bits=2.4, overrides={"embed/unembed": 4})
    spec.save(str(path))
    assert QuantSpec.load(str(path)) == spec
    assert jquant.QuantSpec.load(str(path)).to_dict() == spec.to_dict()
    with pytest.raises(ValueError, match="unknown QuantSpec fields"):
        QuantSpec.from_dict({"groupsize": 64})


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------


def _weights(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.02).astype(
        np.float32)


def _port_leaf(w):
    """A numpy leaf as the port holds it: 2-D tensor or LayerStack."""
    if w.ndim == 3:
        return tmp.LayerStack([torch.from_numpy(x.copy()) for x in w])
    return torch.from_numpy(w)


@pytest.mark.parametrize("shape", [(300, 128), (4, 80, 128), (3, 64, 96)])
@pytest.mark.parametrize("max_rows", [0, 192])
def test_probe_rows_match_reference(shape, max_rows):
    w = _weights(shape, sum(shape))
    want = np.asarray(jmp._as_2d(jnp.asarray(w), max_rows))
    got = tmp._as_2d(_port_leaf(w), max_rows).numpy()
    np.testing.assert_array_equal(got, want)


def _probe(pkg_format_for_bits, fmt="bcq"):
    def q(w2, *, bits, group_size, iters):
        f = pkg_format_for_bits(fmt, bits)
        return f.quantize(w2, bits=f.plane_bits(max(bits, 1)),
                          group_size=group_size, iters=iters)
    return q


@pytest.mark.parametrize("bits", [2, 3, 1.585])
@pytest.mark.parametrize("max_rows", [0, 192])
@pytest.mark.parametrize("shape", [(300, 128), (4, 80, 128)])
def test_layer_sensitivity_matches_reference(shape, max_rows, bits):
    w = _weights(shape, 7 + len(shape))
    want = jmp.layer_sensitivity(jnp.asarray(w), bits, G, iters=2,
                                 max_rows=max_rows,
                                 quantizer=_probe(jquant.format_for_bits))
    got = tmp.layer_sensitivity(_port_leaf(w), bits, G, iters=2,
                                max_rows=max_rows,
                                quantizer=_probe(format_for_bits))
    assert want > 0
    assert abs(got - want) <= SENS_RTOL * want


def test_layer_sensitivity_with_calibration_matches_reference():
    w = _weights((4, 80, 128), 11)
    x = np.random.default_rng(12).normal(size=(5, 128)).astype(np.float32)
    want = jmp.layer_sensitivity(jnp.asarray(w), 3, G, x_cal=jnp.asarray(x),
                                 iters=2, max_rows=192)
    got = tmp.layer_sensitivity(_port_leaf(w), 3, G,
                                x_cal=torch.from_numpy(x), iters=2,
                                max_rows=192)
    assert abs(got - want) <= SENS_RTOL * want


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------


def _table_case():
    """Leaves of three sizes, one error table for both packages.  ``a``
    and ``b`` are the same size with the same errors: at a budget of 2.2
    bits only one of their upgrades fits, a tie that leaf order
    decides."""
    shapes = {"b": (8, 16), "a": (8, 16), "big": (32, 16), "c": (4, 16)}
    table = {"a": {2: 4.0, 3: 1.0, 4: 0.5}, "b": {2: 4.0, 3: 1.0, 4: 0.5},
             "big": {2: 9.0, 3: 2.0, 4: 1.8}, "c": {2: 1.0, 3: 0.9, 4: 0.1}}
    return shapes, table


@pytest.mark.parametrize("budget", [2.0, 2.2, 2.3, 2.55, 3.2, 4.0])
def test_allocate_bits_injected_table_matches_reference(budget):
    shapes, table = _table_case()
    fn = lambda w, b, g, x: table[w.key][b]

    class Leaf:
        def __init__(self, key, shape):
            self.key, self.shape = key, shape
    leaves = {k: Leaf(k, s) for k, s in shapes.items()}
    want = jmp.allocate_bits(leaves, budget, candidates=(2, 3, 4),
                             sensitivity_fn=fn)
    got = tmp.allocate_bits(leaves, budget, candidates=(2, 3, 4),
                            sensitivity_fn=fn)
    assert got == want
    assert tmp.average_bits(got, leaves) <= budget + 1e-9
    if budget == 2.2:
        # a and b tie for the best gain and only one fits: the first in
        # iteration order ("b") takes it
        assert got == {"b": 3, "a": 2, "big": 2, "c": 2}


# ---------------------------------------------------------------------------
# plans and manifests
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_model(arch, scan):
    """The reference's reduced ``arch`` in f32 and its parameters, built
    once per module (nothing changes them)."""
    cfg = j_reduced(arch).replace(remat=False, dtype="float32",
                                  scan_layers=scan)
    jm = JModel(cfg)
    return jm, f32_params(jm.init(jax.random.PRNGKey(0)))


_REF_QUANT = {}


def _ref_quant(arch, scan, bits, over=None):
    """The reference's plan (``plan_bits``), quantized tree and manifest
    of ``_ref_model(arch, scan)`` at ``bits`` (group size G, 2
    iterations), computed once and shared by the plan and forward tests.
    The tree and manifest are the reference's ``quantize_model`` step by
    step (``plan_bits``, ``ptq.quantize_model`` with that plan,
    ``build_manifest``), so its sensitivity probe runs once, not twice."""
    key = arch, scan, bits, repr(over)
    if key not in _REF_QUANT:
        jm, params = _ref_model(arch, scan)
        jspec = jquant.QuantSpec(bits=bits, group_size=G, iters=2,
                                 overrides=over or {})
        linears = jptq.collect_linears(params, jm.axes())
        plan = jquant.plan_bits(linears, jspec)
        fmt = jquant.get_format(jspec.format)
        qparams = jptq.quantize_model(
            params, jm.axes(), bits=fmt.plane_bits(max(jspec.bits, 1)),
            method=jspec.format, group_size=jspec.group_size,
            iters=jspec.iters, bit_map=plan)
        jman = jquant.build_manifest(qparams, jspec, plan, linears,
                                     axes_tree=jm.axes())
        _REF_QUANT[key] = plan, qparams, jman
    return _REF_QUANT[key]


def _port_model(arch, scan, params, spec=None, dtype="float32"):
    cfg = t_reduced(arch).replace(dtype=dtype, scan_layers=scan, quant=spec)
    return from_jax_params(to_numpy_tree(params), cfg, device="cpu")


PLAN_CASES = [("opt_6_7b", False, 2.4, None), ("opt_6_7b", False, 1.8, None),
              ("opt_6_7b", True, 2.4, None), ("opt_6_7b", True, 1.8, None),
              ("minicpm3_4b", True, 2.4, None),
              ("minicpm3_4b", True, 1.8, None),
              ("opt_6_7b", True, 1.8, {"stack/scan/0/mlp/up": 4})]


@pytest.mark.parametrize("arch,scan,bits,over", PLAN_CASES)
def test_plan_and_manifest_match_reference(arch, scan, bits, over):
    kw = dict(bits=bits, group_size=G, iters=2, overrides=over or {})
    jm, params = _ref_model(arch, scan)
    jlin = jptq.collect_linears(params, jm.axes())
    want_plan, _, jman = _ref_quant(arch, scan, bits, over)
    tm = _port_model(arch, scan, params)
    tlin = collect_linears(tm)
    assert list(tlin) == list(jlin)                # keys and their order
    assert {k: tuple(v.shape) for k, v in tlin.items()} == \
        {k: tuple(v.shape) for k, v in jlin.items()}
    spec = QuantSpec(**kw)
    plan = plan_bits(tlin, spec)
    assert plan == want_plan
    if over:
        assert all(plan[k] == v for k, v in over.items())
    man = quantize_model(tm, spec)
    assert man.to_dict() == jman.to_dict()
    widths = set(plan.values())
    if bits == 1.8:
        assert 1.585 in widths and widths - {1.585}, widths
    else:
        assert len(widths) > 1, widths


def test_plan_with_calibration_matches_reference():
    jm, params = _ref_model("opt_6_7b", False)
    jlin = jptq.collect_linears(params, jm.axes())
    rng = np.random.default_rng(5)
    x_np = {k: rng.normal(size=(4, v.shape[-1])).astype(np.float32)
            for k, v in jlin.items()}
    spec_kw = dict(bits=2.4, group_size=G, iters=2)
    want = jquant.plan_bits(jlin, jquant.QuantSpec(**spec_kw),
                            x_cal={k: jnp.asarray(v) for k, v in x_np.items()})
    tm = _port_model("opt_6_7b", False, params)
    got = plan_bits(collect_linears(tm), QuantSpec(**spec_kw),
                    x_cal={k: torch.from_numpy(v) for k, v in x_np.items()})
    assert got == want
    # and through quantize_model's keyword
    man = quantize_model(tm, QuantSpec(**spec_kw),
                         x_cal={k: torch.from_numpy(v)
                                for k, v in x_np.items()})
    assert {l["path"]: l["plane_bits"] for l in man.layers} == \
        {k: int(b) for k, b in got.items()}


@pytest.mark.parametrize("kw,match", [
    (dict(bits=2.4, overrides={"stack/layers/0/mixer/qq": 3}),
     "not quantizable linears"),
    (dict(format="ternary", overrides={"stack/layers/0/mixer/q": 3}),
     "fixed 2 planes"),
    (dict(bits=0.5), "need >= 1 bit"),
])
def test_plan_refusals_match_reference(kw, match):
    jm, params = _ref_model("opt_6_7b", False)
    with pytest.raises(ValueError, match=match):
        jquant.plan_bits(jptq.collect_linears(params, jm.axes()),
                         jquant.QuantSpec(**kw))
    tm = _port_model("opt_6_7b", False, params)
    with pytest.raises(ValueError, match=match):
        plan_bits(collect_linears(tm), QuantSpec(**kw))


def test_stacked_leaf_layers_share_one_width():
    """Under ``scan_layers`` every layer of a leaf gets the leaf's width
    and format; below 2 bits that is a ternary bundle."""
    _, params = _ref_model("opt_6_7b", True)
    tm = _port_model("opt_6_7b", True, params)
    plan = plan_bits(collect_linears(tm), QuantSpec(bits=1.8, group_size=G,
                                                    iters=2))
    quantize_model(tm, QuantSpec(bits=1.8, group_size=G, iters=2))
    for key, b in plan.items():
        name = key.split("/", 3)[3]
        for block in tm.stack.layers:
            mod = block.mixer if name.startswith("mixer") else block.mlp
            w = getattr(mod, name.split("/")[1]).weight
            assert w.kind == ("ternary" if b < 2 else "bcq")
            assert w.bits == (2 if b < 2 else b)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,bits", [("opt_6_7b", 2.4), ("opt_6_7b", 1.8),
                                       ("minicpm3_4b", 1.8)])
def test_mixed_forward_matches_reference(arch, bits):
    """A mixed model quantized by the reference, served by the port's plain
    path (``dense`` backend: dequantize and matmul in f32): logits within
    1e-3 of the logit scale."""
    jm, _ = _ref_model(arch, True)
    # the reference's quantization at this width (the backend is not
    # part of it), served by its dense backend
    _, params, jman = _ref_quant(arch, True, bits)
    assert len({(l["format"], l["plane_bits"]) for l in jman.layers}) > 1
    jspec = jquant.QuantSpec(bits=bits, group_size=G, iters=2,
                             backend="dense")
    jm = JModel(jm.cfg.replace(quant=jspec))
    spec = QuantSpec(bits=bits, group_size=G, iters=2, backend="dense")
    tm = _port_model(arch, True, params, spec)
    toks = np.random.default_rng(9).integers(0, 256, (2, 12)).astype(
        np.int32)
    want = np.asarray(jm.forward(params, {"tokens": jnp.asarray(toks)}))
    got = tm.forward(torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < LOGIT_TOL, rel


def test_quantize_mixed_and_average_bits_match_reference():
    """``quantize_mixed`` applies a plan with BCQ, reconstructing what the
    reference's does within 1e-5; ``average_bits`` weighs widths by leaf
    size (a LayerStack by its stacked shape) as the reference does."""
    from repro_torch.quant import available_formats
    assert available_formats() == jquant.available_formats()
    w2, w3 = _weights((24, 64), 1), _weights((40, 64), 2)
    plan = {"a": 2, "b": 4}
    want = jmp.quantize_mixed({"a": jnp.asarray(w2), "b": jnp.asarray(w3)},
                              plan, group_size=G, iters=2)
    got = tmp.quantize_mixed({"a": torch.from_numpy(w2),
                              "b": torch.from_numpy(w3)}, plan,
                             group_size=G, iters=2)
    for k in plan:
        assert got[k].bits == plan[k]
        np.testing.assert_allclose(got[k].dequantize().numpy(),
                                   np.asarray(want[k].dequantize()),
                                   rtol=1e-5, atol=1e-5)
    stacked = _weights((3, 16, 64), 3)
    assert tmp.average_bits(plan, {"a": torch.from_numpy(w2),
                                   "b": _port_leaf(stacked)}) == \
        pytest.approx(jmp.average_bits(plan, {"a": jnp.asarray(w2),
                                              "b": jnp.asarray(stacked)}))
