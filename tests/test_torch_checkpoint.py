"""Port parity: quantized checkpoints, in both directions.

  * a mixed-precision checkpoint written by the reference
    (``repro.quant.save_quantized``, reduced OPT at 2.4 and 1.8 bits)
    loads in the port with every bundle equal, and the port's paged
    engine serves greedy tokens identical to the reference engine's on
    the same checkpoint (exact: tolerance 0 on token ids; both in f32 on
    the gathered path);
  * one written by the port loads in the reference as the same tree,
    leaf for leaf and bit for bit, bf16 leaves included, in both stack
    layouts;
  * the numpy checkpoint layout (``train.checkpoint``): atomic steps,
    bf16 as uint16, read by either package;
  * the launcher's refusals around ``--load-quantized``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_reduced as j_reduced
from repro.models import Model as JModel
from repro.serve import Request as JRequest
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.launch import serve as launch
from repro_torch.models import from_jax_params, to_params
from repro_torch.quant import (QuantSpec, load_quantized, quantize_model,
                               save_quantized)
from repro_torch.quant.checkpoint import load_quantized_model
from repro_torch.serve import PagedServeEngine, Request
from repro_torch.train import checkpoint as tckpt

from torch_port_cases import f32_params, ref_paged_engine, to_numpy_tree

G = 32


def _flat(tree, path=()):
    """{path: (dtype name, numpy array or python value)} of a tree of
    torch tensors, numpy / jax arrays or bundles (PlaneBundle objects and
    dicts alike); bf16 compared through its bits."""
    from repro.core.plane import PlaneBundle as JBundle
    from repro_torch.core.plane import PlaneBundle as TBundle
    if isinstance(tree, (JBundle, TBundle)):
        tree = {"packed": tree.packed, "alpha": tree.alpha, "z": tree.z,
                "group_size": tree.group_size,
                "in_features": tree.in_features,
                "out_features": tree.out_features, "kind": tree.kind}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    key = "/".join(path)
    if tree is None or isinstance(tree, (int, str)):
        return {key: ("py", tree)}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {key: ("bfloat16", t.view(torch.int16).numpy())}
        return {key: (str(t.numpy().dtype), t.numpy())}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return {key: ("bfloat16", a.view(np.int16))}
    return {key: (str(a.dtype), a)}


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k][0] == w[k][0], (k, g[k][0], w[k][0])
        if g[k][0] == "py":
            assert g[k][1] == w[k][1], k
        else:
            np.testing.assert_array_equal(g[k][1], w[k][1], err_msg=k)


def _ref_quantized(bits, scan=False, dtype="float32", backend="bcq_xla"):
    cfg = j_reduced("opt_6_7b").replace(remat=False, dtype=dtype,
                                        scan_layers=scan)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        params = f32_params(params)
    spec = jquant.QuantSpec(bits=bits, group_size=G, iters=2,
                            backend=backend)
    qparams, man = jquant.quantize_model(params, spec, jm.axes())
    return jm, params, qparams, spec, man


@pytest.mark.parametrize("bits", [2.4, 1.8])
def test_reference_checkpoint_serves_identically_in_port(tmp_path, bits):
    jm, _, qparams, jspec, jman = _ref_quantized(bits)
    path = str(tmp_path / "ck")
    jquant.save_quantized(path, qparams, jspec, jman, arch=jm.cfg.name)
    tcfg = t_reduced("opt_6_7b").replace(dtype="float32",
                                         paged_kernel="gather")
    tm, spec, man, extra = load_quantized_model(path, tcfg, device="cpu")
    assert spec.to_dict() == jspec.to_dict()
    assert man.to_dict() == jman.to_dict()
    assert extra["arch"] == jm.cfg.name
    kinds = {l["format"] for l in man.layers}
    assert kinds == ({"ternary", "bcq"} if bits < 2 else {"bcq"})
    jparams, jspec2, _, _ = jquant.load_quantized(path)
    _assert_trees_equal(to_params(tm), jparams)

    kw = dict(num_blocks=24, block_size=8, max_batch=3, max_seq_len=64,
              prefill_buckets=(8, 16))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (3, 9, 17, 30)]
    jmq = JModel(jm.cfg.replace(quant=jspec2, paged_kernel="gather"))
    jdone = ref_paged_engine(jmq, jparams, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)], max_ticks=400)
    tdone = PagedServeEngine(tm, **kw).run(
        [Request(uid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)], max_ticks=400)
    want = {r.uid: list(r.out_tokens) for r in jdone}
    assert all(r.error is None for r in tdone)
    assert {r.uid: list(r.out_tokens) for r in tdone} == want
    assert all(len(v) == 5 for v in want.values())


@pytest.mark.parametrize("bits,scan", [(2.4, False), (1.8, True)])
def test_port_checkpoint_loads_in_reference(tmp_path, bits, scan):
    cfg = j_reduced("opt_6_7b").replace(remat=False, scan_layers=scan)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(1))                   # bf16 weights
    tcfg = t_reduced("opt_6_7b").replace(scan_layers=scan)
    tm = from_jax_params(to_numpy_tree(params), tcfg, device="cpu")
    assert tm.embed.tok.dtype == torch.bfloat16
    spec = QuantSpec(bits=bits, group_size=G, iters=2)
    man = quantize_model(tm, spec)
    tm = tm.with_config(quant=spec)
    path = str(tmp_path / "ck")
    save_quantized(path, tm, spec, man, arch=tcfg.name,
                   extra_meta={"d_model": tcfg.d_model})
    jparams, jspec, jman, extra = jquant.load_quantized(path)
    assert jspec.to_dict() == spec.to_dict()
    assert jman.to_dict() == man.to_dict()
    assert extra["d_model"] == tcfg.d_model
    assert ("scan" in jparams["stack"]) == scan
    _assert_trees_equal(jparams, to_params(tm))
    assert jparams["embed"]["tok"].dtype == jnp.bfloat16
    # the reference serves the tree it read
    jmq = JModel(cfg.replace(quant=jspec.replace(backend="bcq_xla")))
    logits = jmq.forward(jparams, {"tokens": jnp.zeros((1, 4), jnp.int32)})
    assert bool(jnp.isfinite(logits).all())
    # and the port reads its own checkpoint back to the same tree
    back, spec2, _, _ = load_quantized(path)
    assert spec2 == spec
    _assert_trees_equal(back, to_params(tm))


def test_numpy_checkpoint_layout(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.tensor([1.5, -2.25]).to(torch.bfloat16), None],
            "c": {"n": np.int64(7)}}
    assert tckpt.latest_step(d) is None
    tckpt.save(d, 3, tree, extra={"k": 1})
    tckpt.save(d, 10, tree)
    os.makedirs(os.path.join(d, "step_00000020.tmp"))   # an aborted write
    assert tckpt.list_steps(d) == [3, 10]
    assert tckpt.latest_step(d) == 10
    with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
        mani = json.load(f)
    assert mani["leaves"]["b/0"] == {"file": "b__0.npy", "dtype": "bfloat16",
                                     "shape": [2]}
    got, step, extra = tckpt.restore(d, 3)
    assert step == 3 and extra == {"k": 1}
    assert got["b"][1] is None and int(got["c"]["n"]) == 7
    assert got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["b"][0], tree["b"][0])
    # each package reads the other's steps
    jtree, _, _ = jckpt.restore(d, 3)
    np.testing.assert_array_equal(np.asarray(jtree["b"][0], np.float32),
                                  [1.5, -2.25])
    jckpt.save(d, 30, {"w": jnp.asarray([0.5, 3.0], jnp.bfloat16)})
    back, _, _ = tckpt.restore(d)
    assert back["w"].dtype == torch.bfloat16
    assert back["w"].tolist() == [0.5, 3.0]


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ck") / "opt")
    launch.main(["--device", "cpu", "--bits", "2.4", "--group-size", "32",
                 "--requests", "1", "--max-new", "2",
                 "--save-quantized", path])
    return path


@pytest.mark.parametrize("flags", [["--bits", "3"], ["--method", "rtn"],
                                   ["--group-size", "64"], ["--iters", "2"],
                                   ["--spec", "s.json"],
                                   ["--save-quantized", "x"]])
def test_launcher_refuses_weight_flags_with_load(port_ckpt, flags):
    with pytest.raises(SystemExit, match="cannot be combined with "
                                         "--load-quantized"):
        launch.main(["--device", "cpu", "--load-quantized", port_ckpt]
                    + flags)


def test_launcher_checks_checkpoint_dims_and_arch(port_ckpt, capsys):
    with pytest.raises(SystemExit, match="model dims do not match"):
        launch.main(["--device", "cpu", "--reduced", "0",
                     "--load-quantized", port_ckpt])
    with pytest.raises(SystemExit, match="does not match --arch"):
        launch.main(["--device", "cpu", "--arch", "minicpm3_4b",
                     "--load-quantized", port_ckpt])
    done = launch.main(["--device", "cpu", "--requests", "2", "--max-new",
                        "2", "--load-quantized", port_ckpt,
                        "--backend", "bcq_xla"])
    assert len(done) == 2 and all(len(r.out_tokens) == 2 for r in done)
    assert "bcq-2.4bit (mixed" in capsys.readouterr().out
