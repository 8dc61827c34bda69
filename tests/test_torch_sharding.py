"""The port's sharding layer against the reference's, on the CPU.

``parallel/sharding.py``'s ``spec_for`` and bundle specs equal
``repro.parallel.sharding``'s over every leaf of every config's
``Model.axes()`` (float and abstractly quantized), on meshes (1, 2),
(2, 2), (1, 4), (2, 4), (16, 16) and a two-pod (2, 16, 16), under
``make_rules(fsdp=, multi_pod=)``.  The reference's ``spec_for`` reads
only a mesh's axis names and shape, so it runs here on a shape-only
mesh, its ``NamedSharding`` taken apart into the spec; one case builds
real meshes of 8 host devices in a subprocess, as ``tests/test_sharding.py``
does, and checks the two agree.  The one rule the port adds (a
row-parallel bundle's ``alpha`` / ``z`` follow its packed input dim,
and a shard boundary inside a group replicates the input instead) is
applied to the reference's specs before they are compared.

Also: ``models/module.py``'s ``logical_axes`` / ``paged_cache_axes``
against ``Model.axes()`` / ``Model.paged_cache_axes`` under both
``scan_layers`` settings, the parameter counts, ``launch/mesh.py``'s
``parse_mesh`` refusals word for word (bar the hint, which names the
port's launcher), rank coordinates, ``local_shard`` / ``shard_tree``,
and the paged kernels' ``tp`` capability reason and mode negotiation.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

from repro_torch.configs import ARCH_IDS  # noqa: E402

MESHES = [(1, 2), (2, 2), (1, 4), (2, 4), (16, 16), (2, 16, 16)]
RULES = [dict(fsdp=f, multi_pod=p) for f in (False, True)
         for p in (False, True)]


def _axes_names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def ref_mesh(shape):
    """What the reference's ``spec_for`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=_axes_names(shape),
                                 devices=np.empty(shape))


class PortMesh:
    """A shape-only mesh at given coordinates (for ``dim_slice``)."""

    def __init__(self, shape, coords=None):
        self.axis_names = _axes_names(shape)
        self.shape = tuple(shape)
        self.coords = coords or (0,) * len(shape)

    def index(self, axis):
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)


def _ptuple(spec):
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in spec)


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    """(abstract params, abstractly quantized params, axes) of a full
    config: shapes only."""
    from repro.configs import get_config
    from repro.models import Model
    from repro.quant.ptq import abstract_quantized_params
    m = Model(get_config(arch))
    abstract, axes = m.abstract(), m.axes()
    qtree = abstract_quantized_params(abstract, axes, bits=3,
                                      group_size=128)
    return abstract, qtree, axes


def _ref_build(mesh_shape, tree, axes, rules, monkeypatch):
    """The reference's ``build_shardings`` with each NamedSharding taken
    apart into its spec."""
    from repro.parallel import sharding as shd
    monkeypatch.setattr(shd, "NamedSharding", lambda mesh, spec: spec)
    return shd.build_shardings(ref_mesh(mesh_shape), tree, axes, rules)


def _port_tree(tree):
    """A reference abstract tree with its BCQWeight leaves as the port's
    bundle dicts."""
    import jax
    from repro.core.bcq import BCQWeight

    def leaf(x):
        if isinstance(x, BCQWeight):
            return {"packed": x.packed, "alpha": x.alpha, "z": x.z,
                    "group_size": x.group_size,
                    "in_features": x.in_features,
                    "out_features": x.out_features, "kind": "bcq"}
        return x
    return jax.tree_util.tree_map(
        leaf, tree, is_leaf=lambda x: isinstance(x, BCQWeight))


def _expected_bundle(ref_w, alpha_shape, sizes):
    """The reference's field specs with the port's group rule applied."""
    from repro_torch.parallel.sharding import BundleSpecs
    packed = list(_ptuple(ref_w.packed))
    packed += [None] * (len(alpha_shape) - len(packed))
    alpha = list(_ptuple(ref_w.alpha))
    alpha += [None] * (len(alpha_shape) - len(alpha))
    z = None
    if ref_w.z is not None:
        z = list(_ptuple(ref_w.z))
        z += [None] * (len(alpha_shape) - 1 - len(z))
    entry = packed[-1]
    if entry is not None:
        names = (entry,) if isinstance(entry, str) else entry
        extent = int(np.prod([sizes[a] for a in names]))
        if alpha_shape[-1] % extent:
            packed[-1] = None
        else:
            alpha[-1] = entry
            if z is not None:
                z[-1] = entry

    def trim(p):
        while p and p[-1] is None:
            p.pop()
        return tuple(p)
    return BundleSpecs(trim(packed), trim(alpha),
                       None if z is None else trim(z))


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=["x".join(map(str, m)) for m in MESHES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, mesh_shape, monkeypatch):
    import jax
    from repro.core.bcq import BCQWeight
    from repro.parallel import sharding as ref_shd
    from repro_torch.parallel import sharding as shd
    abstract, qtree, axes = _ref_trees(arch)
    pmesh = PortMesh(mesh_shape)
    sizes = dict(zip(pmesh.axis_names, pmesh.shape))
    n_leaves = n_bundles = 0
    for kw in RULES:
        rules = shd.make_rules(**kw)
        assert rules == ref_shd.make_rules(**kw)
        # float leaves: spec_for on every leaf
        ref = _ref_build(mesh_shape, abstract, axes, rules, monkeypatch)
        got = shd.build_specs(abstract, axes, pmesh, rules)
        ref_l = jax.tree_util.tree_leaves(
            ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got_l = [g for _, g in shd._walk(got)]
        assert [_ptuple(r) for r in ref_l] == got_l, (arch, kw)
        n_leaves += len(got_l)
        # quantized leaves: the bundle specs
        ref_q = _ref_build(mesh_shape, qtree, axes, rules, monkeypatch)
        got_q = shd.build_specs(_port_tree(qtree), axes, pmesh, rules)
        for path, g in shd._walk(got_q):
            r = shd._get(ref_q, path)
            if isinstance(r, BCQWeight):
                alpha_shape = shd._get(qtree, path).alpha.shape
                assert g == _expected_bundle(r, alpha_shape, sizes), path
                n_bundles += 1
            else:
                assert g == _ptuple(r), path
    assert n_leaves > 0 and n_bundles > 0


@pytest.mark.parametrize("mesh_shape", [(2, 2), (3, 2), (2, 16, 16)])
def test_batch_specs_match_reference(mesh_shape, monkeypatch):
    """An input batch's leading dim on the data axes where it divides."""
    from repro.parallel import sharding as ref_shd
    from repro_torch.parallel import sharding as shd
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda mesh, spec: spec)
    shapes = {"tokens": np.empty((8, 16)), "odd": np.empty((3, 5, 2)),
              "vec": np.empty((16,))}
    for kw in RULES:
        rules = shd.make_rules(**kw)
        want = ref_shd.batch_shardings(ref_mesh(mesh_shape), shapes, rules)
        got = shd.batch_specs(PortMesh(mesh_shape), shapes, rules)
        assert got == {k: _ptuple(v) for k, v in want.items()}, kw


def test_real_meshes_agree_with_shape_only():
    """On real meshes of 8 host devices the reference's shardings are
    the specs the shape-only meshes give, and the port's equal them."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.module import logical_axes
    from repro_torch.parallel import sharding as shd
    prog = textwrap.dedent("""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
    import json, jax
    from repro.configs import get_reduced
    from repro.models import Model
    from repro.parallel import sharding as shd
    from repro.quant.ptq import abstract_quantized_params
    from repro.launch.mesh import make_mesh, make_mesh_for
    from repro.core.bcq import BCQWeight
    out = {}
    for arch in ("opt_6_7b", "phi4_mini_3_8b", "minicpm3_4b"):
        m = Model(get_reduced(arch))
        q = abstract_quantized_params(m.abstract(), m.axes(), bits=3,
                                      group_size=16)
        for shape in ((1, 2), (2, 2), (1, 4), (2, 4)):
            mesh = make_mesh(shape, ("data", "model"))
            sh = shd.build_shardings(mesh, q, m.axes(), shd.make_rules())
            def js(spec):
                return [list(e) if isinstance(e, tuple) else e
                        for e in spec]
            out[f"{arch}/{shape}"] = [
                js(leaf.packed.spec if isinstance(leaf, BCQWeight)
                   else leaf.spec)
                for _, leaf in shd._walk(sh) if leaf is not None]
    out["mesh_for"] = [list(make_mesh_for(8, mp).devices.shape)
                       for mp in (0, 3, 4, 16)]
    print(json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    from repro.configs import get_reduced as j_reduced
    from repro.models import Model
    from repro.quant.ptq import abstract_quantized_params
    from repro_torch.launch.mesh import mesh_shape_for
    for arch in ("opt_6_7b", "phi4_mini_3_8b", "minicpm3_4b"):
        m = Model(j_reduced(arch))
        q = abstract_quantized_params(m.abstract(), m.axes(), bits=3,
                                      group_size=16)
        axes = logical_axes(get_reduced(arch))
        for shape in ((1, 2), (2, 2), (1, 4), (2, 4)):
            got = shd.build_specs(_port_tree(q), axes, PortMesh(shape),
                                  shd.make_rules())
            specs = [[list(e) if isinstance(e, tuple) else e
                      for e in (g.packed if isinstance(g, shd.BundleSpecs)
                                else g)]
                     for _, g in shd._walk(got) if g is not None]
            # group size 16 keeps every reduced shard boundary on a group
            # boundary, so the packed specs are the reference's
            assert specs == ref[f"{arch}/{shape}"], (arch, shape)
    assert ref["mesh_for"] == [list(mesh_shape_for(8, mp))
                               for mp in (0, 3, 4, 16)]


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_match_reference(arch, scan):
    from repro.configs import get_config as j_config
    from repro.models import Model
    from repro_torch.configs import get_config
    from repro_torch.models.module import logical_axes, paged_cache_axes

    def lists(t):
        if isinstance(t, dict):
            return {k: lists(v) for k, v in t.items()}
        if isinstance(t, list):
            return [lists(v) for v in t]
        return tuple(t)
    jm = Model(j_config(arch).replace(scan_layers=scan))
    cfg = get_config(arch).replace(scan_layers=scan)
    assert logical_axes(cfg) == lists(jm.axes())
    try:
        want = lists(jm.paged_cache_axes(4, 32, 16, 8))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            paged_cache_axes(cfg, 4, 32, 16, 8)
        assert str(got.value) == str(e)
    else:
        assert paged_cache_axes(cfg, 4, 32, 16, 8) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_reference(arch):
    """``param_count`` of the port's parameter tree is the reference's
    count of its descriptors; ``param_bytes`` of the reference's own
    initialized tree agrees with its descriptors."""
    import jax
    from repro.configs import get_reduced as j_reduced
    from repro.models import Model as JModel
    from repro.models.module import param_bytes as j_bytes
    from repro.models.module import param_count as j_count
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model, to_params
    from repro_torch.models.module import param_bytes, param_count
    jm = JModel(j_reduced(arch))
    model = Model(get_reduced(arch), device="cpu")
    assert param_count(to_params(model)) == j_count(jm.desc())
    params = jm.init(jax.random.PRNGKey(0))
    assert param_bytes(params) == j_bytes(jm.desc())


@pytest.mark.parametrize("spec,tp,n", [
    ("auto", 3, 1), ("2by2", 0, 1), ("1x2", 4, 1), ("1x2", 0, 1),
    ("2x2", 0, 2), ("auto", 0, 1), ("1x1", 1, 1)])
def test_parse_mesh_refusals_match_reference(monkeypatch, spec, tp, n):
    """The same refusal text as the reference (up to its hint, which
    names the JAX flag); the same shape where both accept."""
    from repro.launch import mesh as ref_mesh_mod
    from repro_torch.launch.mesh import parse_mesh_shape
    monkeypatch.setenv("WORLD_SIZE", str(n))
    monkeypatch.setattr(ref_mesh_mod.jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(ref_mesh_mod, "make_mesh",
                        lambda shape, axes: tuple(shape))
    try:
        want = ref_mesh_mod.parse_mesh(spec, tp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_shape(spec, tp)
        assert str(got.value).split(" (hint:")[0] == \
            str(e).split(" (hint:")[0]
    else:
        assert parse_mesh_shape(spec, tp) == tuple(want)


def test_production_mesh_refuses_other_world_sizes(monkeypatch):
    from repro_torch.launch.mesh import make_production_mesh
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)


def test_rank_coordinates_row_major():
    from repro_torch.launch.mesh import _coords, _rank_of
    shape = (2, 3, 4)
    seen = [_coords(r, shape) for r in range(24)]
    assert seen == [(a, b, c) for a in range(2) for b in range(3)
                    for c in range(4)]
    assert [_rank_of(c, shape) for c in seen] == list(range(24))


def test_local_shard_and_dense_tree():
    import torch
    from repro_torch.parallel import sharding as shd
    t = torch.arange(8 * 6).reshape(8, 6)
    for m in range(2):
        mesh = PortMesh((1, 2), (0, m))
        got = shd.local_shard(t, ("model",), mesh)
        assert torch.equal(got, t[4 * m:4 * m + 4])
        got = shd.local_shard(t, (None, "model"), mesh)
        assert got.is_contiguous() and torch.equal(got, t[:, 3 * m:3 * m + 3])
    # two axes on one dim: major to minor, as a PartitionSpec
    mesh = PortMesh((2, 2), (1, 0))
    got = shd.local_shard(t, (("data", "model"),), mesh)
    assert torch.equal(got, t[4:6])
    tree = {"a": t, "b": [None, t.float()]}
    specs = {"a": (None, "model"), "b": [None, ("model",)]}
    out = shd.shard_tree(tree, specs, PortMesh((1, 2), (0, 1)), "cpu")
    assert torch.equal(out["a"], t[:, 3:]) and out["b"][0] is None
    assert torch.equal(out["b"][1], t.float()[4:])


def test_bundle_group_boundary_falls_back():
    """in 96 at g 32 (3 groups) on tp 2: the reference shards the packed
    input (12 bytes divide) and leaves alpha / z whole; the port keeps
    the input replicated, since a shard boundary would cut a group.  At
    g 16 (6 groups) both shard it, and the port's alpha / z follow."""
    import torch
    from repro_torch.core.plane import PlaneBundle
    from repro_torch.parallel import sharding as shd
    mesh = PortMesh((1, 2), (0, 1))
    rules = shd.make_rules()

    def bundle(g):
        gen = torch.Generator().manual_seed(0)
        return PlaneBundle(
            packed=torch.randint(0, 255, (3, 16, 12), dtype=torch.uint8,
                                 generator=gen),
            alpha=torch.rand((3, 16, 96 // g), generator=gen),
            z=torch.rand((16, 96 // g), generator=gen), group_size=g,
            in_features=96, out_features=16)
    row_par = ("embed", "mlp")
    sp = shd.bundle_specs(bundle(32), row_par, mesh, rules)
    assert sp == shd.BundleSpecs(packed=(), alpha=(), z=())
    assert shd.spec_for((3, 16, 12), (None, "embed", "mlp"), mesh,
                        rules) == (None, None, "model")
    w = bundle(16)
    sp = shd.bundle_specs(w, row_par, mesh, rules)
    assert sp == shd.BundleSpecs(packed=(None, None, "model"),
                                 alpha=(None, None, "model"),
                                 z=(None, "model"))
    local = shd.shard_tree({"w": w}, {"w": sp}, mesh)["w"]
    assert local.in_features == 48 and local.out_features == 16
    assert torch.equal(local.packed, w.packed[..., 6:])
    assert torch.equal(local.alpha, w.alpha[..., 3:])
    assert torch.equal(local.z, w.z[:, 3:])
    # the two row-parallel halves sum to the whole product
    x = torch.randn(5, 96)
    whole = x @ w.dequantize().T
    halves = sum(x[:, 48 * m:48 * m + 48] @ shd.shard_tree(
        {"w": w}, {"w": sp}, PortMesh((1, 2), (0, m)))["w"].dequantize().T
        for m in range(2))
    torch.testing.assert_close(halves, whole, rtol=1e-5, atol=1e-5)
    # a column-parallel cut keeps whole groups: out rows split
    sp = shd.bundle_specs(w, ("mlp", "embed"), mesh, rules)
    local = shd.shard_tree({"w": w}, {"w": sp}, mesh)["w"]
    assert local.out_features == 8 and local.in_features == 96
    assert torch.equal(local.alpha, w.alpha[:, 8:])


@pytest.mark.parametrize("kernel,ref_kernel", [
    ("paged_decode", "paged_attention"), ("paged_prefill", "paged_prefill")])
def test_tp_capability_reason_matches_reference(kernel, ref_kernel):
    from repro.tune.dispatch import _unsupported_reason as ref_reason
    from repro_torch.tune.dispatch import kernel_unsupported_reason
    for m in (8, 6, 24, 32):
        for hkv in (1, 2, 3, 4, 8):
            if m % hkv:
                continue
            for tp in (1, 2, 4, 16):
                want = ref_reason(ref_kernel, m=m, n=64, group_size=16,
                                  n_kv_heads=hkv, tp=tp)
                got = kernel_unsupported_reason(kernel, m=m, n=64,
                                                group_size=16,
                                                n_kv_heads=hkv, tp=tp)
                assert got == want, (m, hkv, tp, got, want)


@pytest.mark.parametrize("arch", ["opt_6_7b", "phi4_mini_3_8b",
                                  "qwen1_5_32b", "stablelm_1_6b",
                                  "pixtral_12b", "minicpm3_4b",
                                  "deepseek_v2_236b"])
def test_paged_modes_negotiate_as_reference(arch):
    from repro.configs import get_config as j_config
    from repro.models import attention as jattn
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    for mode in ("fused", "gather"):
        for tp in (1, 2, 4, 8, 16, 3):
            jc = j_config(arch).replace(paged_kernel=mode)
            cfg = get_config(arch).replace(paged_kernel=mode)
            for fn in ("paged_kernel_mode", "paged_prefill_mode"):
                want = getattr(jattn, fn)(jc, block_size=16, pages=8, tp=tp)
                assert getattr(attn, fn)(cfg, tp=tp) == want, (fn, mode, tp)


def test_mesh_refuses_unported_configs():
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import check_meshable
    check_meshable(get_reduced("opt_6_7b"))
    for arch, what in (("minicpm3_4b", "MLA"), ("mixtral_8x7b", "MoE"),
                       ("mamba2_2_7b", "Mamba"),
                       ("whisper_medium", "encoder-decoder")):
        with pytest.raises(NotImplementedError, match=what):
            check_meshable(get_reduced(arch))
    with pytest.raises(NotImplementedError, match="int8 KV"):
        check_meshable(get_reduced("opt_6_7b").replace(kv_cache_bits=8))
