"""Port parity: the rotary GQA decoders (Phi-4-mini, Qwen1.5, StableLM)
against the reference, on the CPU, in float32.

Reduced configs; Phi-4-mini is cut to 6 heads over 2 kv heads on both
sides, so its GQA group is 3 wide (the full model's), where the reduced
config's is 2.  Qwen runs with its q/k/v biases, StableLM with its
LayerNorm; the biases and norm parameters are drawn at random (numpy,
from a seed) so that they count.  Tolerances:

- logits (``forward``, paged ``prefill_chunk`` and ``decode_step``):
  1e-4 of the logit scale, the ``TOL`` of ``test_torch_model.py`` (only
  the f32 summation order differs);
- greedy serving streams: token for token (tolerance 0 on token ids);
- ``from_jax_params`` -> ``to_params``: bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import Request as JRequest
from repro.serve import set_block_tables as j_set_tables
from repro_torch.models import set_block_tables, to_params
from repro_torch.serve import PagedServeEngine, Request

from torch_port_cases import (port_pair, prompts_of, ref_paged_engine,
                              to_numpy_tree)

TOL = 1e-4
G = 32           # divides every reduced input width (64, 96, 128)
# logits tests run the bcq_matmul kernel's path (the reference's Pallas
# kernel in interpret mode, the port's wrapper on its plain version): f32
# throughout.  ``bcq_xla`` rounds x to bf16 on both sides, so an f32
# difference of one ulp upstream can flip a bf16 rounding and move a
# logit by ~2e-4 of the scale (seen on Phi-4-mini's rep-3 cut); the
# greedy-stream tests keep ``bcq_xla`` (fast, and token ids are exact).
BCQ3 = dict(bits=3, group_size=G, iters=2, backend="mxu_pallas")
# arch -> config overrides on both sides
ARCHS = {"phi4_mini_3_8b": dict(n_heads=6, n_kv_heads=2),
         "qwen1_5_32b": {}, "stablelm_1_6b": {}}


def _pair(arch, quantized=False, **over):
    return port_pair(arch, quant=BCQ3 if quantized else None, perturb=7,
                     **ARCHS[arch], **over)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def test_reduced_configs_are_the_references():
    from repro.configs import get_config as j_config
    from repro.configs import get_reduced as j_reduced
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    for arch in ARCHS:
        assert arch in ARCH_IDS
        for t, j in ((get_config(arch), j_config(arch)),
                     (get_reduced(arch), j_reduced(arch))):
            for field in ("name", "n_layers", "d_model", "n_heads",
                          "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                          "qkv_bias", "pos", "rope_theta", "mlp_act",
                          "norm", "tie_embeddings", "max_seq_len",
                          "scan_layers"):
                assert getattr(t, field) == getattr(j, field), (arch, field)
    # as the reference has it: Qwen1.5-32B with 40 kv heads (MHA)
    assert get_config("qwen1_5_32b").n_kv_heads == 40


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_reference(arch, quantized):
    jm, params, tm = _pair(arch, quantized)
    if arch == "phi4_mini_3_8b":
        assert tm.cfg.n_heads // tm.cfg.n_kv_heads == 3
    if arch == "qwen1_5_32b":
        assert float(tm.stack.layers[0].mixer.q.bias.abs().max()) > 0
    if arch == "stablelm_1_6b":
        assert float(tm.stack.layers[0].ln1.bias.abs().max()) > 0
    toks = np.random.default_rng(1).integers(0, 256, (2, 13)).astype(
        np.int32)
    want = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("paged_kernel", ["gather", "fused"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_paged_prefill_then_decode_matches(arch, paged_kernel):
    """Two prefill chunks into a scrambled block table (the first ends in
    a pad), then three decode steps: rotary positions through the paged
    insert and both attention paths."""
    jm, params, tm = _pair(arch, True, paged_kernel=paged_kernel)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (1, 19)).astype(np.int32)
    bs, nblk = 4, 8
    table = np.full((1, nblk), -1, np.int32)
    table[0, :6] = [11, 3, 7, 14, 2, 9]
    jc = j_set_tables(jm.init_paged_cache(1, 16, bs, nblk), table)
    tc = set_block_tables(tm.init_paged_cache(1, 16, bs, nblk), table)
    for c0, c1, pad in ((0, 7, 1), (7, 16, 0)):
        chunk = np.zeros((1, c1 - c0 + pad), np.int32)
        chunk[0, :c1 - c0] = toks[0, c0:c1]
        jl, jc = jm.prefill_chunk(params, {"tokens": jnp.asarray(chunk)},
                                  jc, jnp.int32(c0), jnp.int32(c1 - c0 - 1))
        tl, tc = tm.prefill_chunk(torch.from_numpy(chunk), tc, c0,
                                  c1 - c0 - 1)
        assert _rel(tl, jl) < TOL
    for t in range(16, 19):
        step = toks[:, t:t + 1]
        jl, jc = jm.decode_step(params, jnp.asarray(step), jc,
                                jnp.int32(t))
        tl, tc = tm.decode_step(torch.from_numpy(step), tc, t)
        assert _rel(tl, jl) < TOL


@pytest.mark.parametrize("paged_kernel", ["gather", "fused"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_paged_greedy_stream_matches_reference(arch, paged_kernel):
    """BCQ-3 weights through both packages' paged engines, with prompts
    longer than the largest bucket (chunked prefill)."""
    jm, params, tm = port_pair(arch, paged_kernel=paged_kernel,
                               quant=dict(BCQ3, backend="bcq_xla"),
                               perturb=7, **ARCHS[arch])
    kw = dict(num_blocks=24, block_size=4, max_batch=3, max_seq_len=48,
              prefill_buckets=(8, 16))
    prompts = prompts_of([3, 9, 21, 6])
    je = ref_paged_engine(jm, params, **kw)
    jdone = je.run([JRequest(uid=i, prompt=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)], max_ticks=400)
    te = PagedServeEngine(tm, **kw)
    tdone = te.run([Request(uid=i, prompt=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)], max_ticks=400)
    by_uid = lambda reqs: {r.uid: list(r.out_tokens) for r in reqs}
    assert by_uid(tdone) == by_uid(jdone)
    assert all(len(r.out_tokens) == 5 and r.error is None for r in tdone)
    assert te.decode_path == paged_kernel
    te.pool.check()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_round_trip_bit_identical(arch, quantized):
    """``from_jax_params`` then ``to_params`` gives back the reference tree
    bit for bit: Qwen's q/k/v biases, StableLM's LayerNorm biases and
    Phi-4-mini's tied embedding (no ``unembed`` leaf) included."""
    jm, params, tm = _pair(arch, quantized)
    want = dict(_leaves(to_numpy_tree(params)))
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in _leaves(to_params(tm))}
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    names = {k.rsplit("/", 1)[-1] for k in want}
    if arch == "qwen1_5_32b":
        assert {"q_b", "k_b", "v_b"} <= names
    if arch == "stablelm_1_6b":
        assert "bias" in names
    if arch == "phi4_mini_3_8b":
        assert not any("unembed" in k for k in want)


def test_bcq_quantize_in_row_blocks_is_unchanged(monkeypatch):
    """``bcq.quantize`` fits a weight wider than ``QUANTIZE_CHUNK`` in
    blocks of rows (Qwen's [152064 x 5120] head on the card): each row is
    fitted on its own, so the blocks give the same bundle."""
    from repro_torch.core import bcq
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(300, 256)).astype(np.float32) * 0.02)
    whole = bcq.quantize(w, bits=3, group_size=64)
    monkeypatch.setattr(bcq, "QUANTIZE_CHUNK", 256 * 37)   # 9 blocks
    blocks = bcq.quantize(w, bits=3, group_size=64)
    assert blocks.packed.shape == whole.packed.shape
    for a, b in ((whole.packed, blocks.packed), (whole.alpha, blocks.alpha),
                 (whole.z, blocks.z)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("engine", ["auto", "slots"])
@pytest.mark.parametrize("arch", ["qwen1_5_32b", "stablelm_1_6b"])
def test_launcher_serves_dense_archs_on_cpu(arch, engine):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", arch, "--reduced", "1", "--device",
                        "cpu", "--bits", "3", "--group-size", "32",
                        "--engine", engine, "--requests", "2",
                        "--max-new", "3"])
    assert len(done) == 2 and all(len(r.out_tokens) == 3 and not r.error
                                  for r in done)
