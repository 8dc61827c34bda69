"""Port parity: reduced Pixtral-12B (rotary GQA behind the stub patch
frontend) against the reference, on the CPU.

Cases and tolerances (f32 activations, norms perturbed):

- ``Model._embed`` with ``patch_embeds`` [B, P, d] at per-row start
  positions: the patches then the text, numbered on through both,
  equal to the reference's (exact: a concatenation and a lookup);
- full-sequence logits with patches under both ``scan_layers``
  settings: within 1e-4 of the logit scale;
- a prefill with patches, into a contiguous cache (``Model.prefill``)
  and into a scrambled paged table (``Model.prefill_chunk``), then
  decode steps: every step's logits within 1e-4;
- the reference-side fact, pinned on both sides: with left-pads (a
  negative start), the first ``|start|`` patches, not the pads, take
  the negative positions, so zeroing those patches leaves the logits
  exactly as they were while the padded prompt's logits part from the
  unpadded prompt's; the port's padded logits within 1e-4 of the
  reference's;
- text-only requests through both packages' paged engines on BCQ-3
  weights (``bcq_xla``): greedy tokens identical (tolerance 0 on token
  ids);
- the config and the launcher's ``--engine auto`` (paged).

The reference's models are built once per module (fixtures).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_reduced as j_reduced
from repro.serve import Request as JRequest
from repro.serve import set_block_tables as j_set_tables
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models import set_block_tables
from repro_torch.serve import PagedServeEngine, Request

from torch_port_cases import port_pair, prompts_of, ref_paged_engine

ARCH = "pixtral_12b"
TOL = 1e-4
G = 32           # divides every reduced input width (64, 128)
BCQ3 = dict(bits=3, group_size=G, iters=2, backend="bcq_xla")


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def pixtral():
    """{(weights, scan): (reference Model, params, port Model)}, norms
    perturbed."""
    out = {("float", scan): port_pair(ARCH, perturb=13, scan_layers=scan)
           for scan in (False, True)}
    out["bcq3", False] = port_pair(ARCH, quant=BCQ3, perturb=13)
    return out


def _inputs(seed, b=2, s=6):
    cfg = t_reduced(ARCH)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    patches = rng.normal(size=(b, cfg.num_patches, cfg.d_model)).astype(
        np.float32)
    return toks, patches


def test_pixtral_embed_with_patches_matches_reference(pixtral):
    jm, params, tm = pixtral["float", False]
    toks, patches = _inputs(1)
    start = np.array([0, -3], np.int32)
    jx, jpos = jm._embed(params, {"tokens": jnp.asarray(toks),
                                  "patch_embeds": jnp.asarray(patches)},
                         jnp.asarray(start))
    tx, tpos = tm._embed(torch.from_numpy(toks), torch.from_numpy(start),
                         torch.from_numpy(patches))
    p = tm.cfg.num_patches
    assert tuple(tx.shape) == jx.shape == (2, p + toks.shape[1], 64)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tpos[1, :4].numpy(), [-3, -2, -1, 0])
    np.testing.assert_array_equal(tx[:, :p].numpy(), patches)


@pytest.mark.parametrize("scan", [False, True])
def test_pixtral_forward_with_patches_matches_reference(pixtral, scan):
    jm, params, tm = pixtral["float", scan]
    assert ("scan" in params["stack"]) == scan
    toks, patches = _inputs(2, s=9)
    want = jax.jit(jm.forward)(params, {
        "tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)})
    got = tm.forward(torch.from_numpy(toks),
                     patch_embeds=torch.from_numpy(patches))
    assert got.shape == want.shape == (2, 17, 256)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_pixtral_prefill_with_patches_then_decode(pixtral, cache):
    """Patches + 6 tokens (14 positions) prefilled, then four decode
    steps; ``paged``: one row through ``prefill_chunk`` into a
    scrambled block table of block size 4 (``fused``: the paged
    kernels' plain versions on the CPU)."""
    jm, params, tm = pixtral["float", False]
    toks, patches = _inputs(3)
    batch = {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)}
    kw = dict(patch_embeds=torch.from_numpy(patches))
    if cache == "contiguous":
        jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
        jl, jc = jax.jit(jm.prefill)(params, batch, jc)
        tl, tc = tm.prefill(torch.from_numpy(toks), tc, **kw)
    else:
        tm = tm.with_config(paged_kernel="fused")
        table = np.full((2, 6), -1, np.int32)
        table[0, :5] = [7, 2, 11, 4, 9]
        table[1, :5] = [3, 12, 5, 1, 8]
        jc = j_set_tables(jm.init_paged_cache(2, 16, 4, 6), table)
        tc = set_block_tables(tm.init_paged_cache(2, 16, 4, 6), table)
        last = np.array([13, 13], np.int32)
        jl, jc = jax.jit(jm.prefill_chunk)(params, batch, jc, jnp.int32(0),
                                           jnp.asarray(last))
        tl, tc = tm.prefill_chunk(torch.from_numpy(toks), tc, 0,
                                  torch.from_numpy(last), **kw)
    assert _rel(tl, jl) < TOL
    decode = jax.jit(jm.decode_step)
    for t in range(14, 18):
        step = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = decode(params, jnp.asarray(step), jc, jnp.int32(t))
        tl, tc = tm.decode_step(torch.from_numpy(step), tc, t)
        assert _rel(tl, jl) < TOL, t


def test_left_padded_prompt_masks_its_first_patches_on_both_sides(pixtral):
    """A prompt left-padded by 6 (start -6): the patches take positions
    -6..1, so the first 6 patches are masked (zeroing them changes no
    logit) and the 6 pads are attended; the padded prompt's logits part
    from the unpadded prompt's.  The reference's behaviour
    (``repro/models/model.py:186-195``), reproduced."""
    jm, params, tm = pixtral["float", False]
    toks, patches = _inputs(4, b=1)
    pads = 6
    padded = np.concatenate([np.zeros((1, pads), np.int32), toks], 1)
    zeroed = patches.copy()
    zeroed[:, :pads] = 0.0
    jpre = jax.jit(jm.prefill)

    def ref(t, p, start):
        logits, _ = jpre(params, {"tokens": jnp.asarray(t),
                                  "patch_embeds": jnp.asarray(p)},
                         jm.init_cache(1, 32), jnp.int32(start))
        return np.asarray(logits)

    def port(t, p, start):
        logits, _ = tm.prefill(torch.from_numpy(t), tm.init_cache(1, 32),
                               start, patch_embeds=torch.from_numpy(p))
        return logits.numpy()

    for side in (ref, port):
        base = side(padded, patches, -pads)
        np.testing.assert_array_equal(side(padded, zeroed, -pads), base)
        assert _rel(base, side(toks, patches, 0)) > 1e-2
    assert _rel(port(padded, patches, -pads), ref(padded, patches, -pads)) \
        < TOL


def test_pixtral_paged_text_stream_matches_reference(pixtral):
    """Text-only requests (the engines carry no patches, on either side)
    through both packages' paged engines, chunked prefill included."""
    jm, params, tm = pixtral["bcq3", False]
    kw = dict(num_blocks=24, block_size=4, max_batch=3, max_seq_len=48,
              prefill_buckets=(8, 16))
    prompts = prompts_of([3, 9, 21, 6], seed=5)
    jdone = ref_paged_engine(jm, params, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)], max_ticks=400)
    te = PagedServeEngine(tm, paged_kernel="fused", **kw)
    tdone = te.run([Request(uid=i, prompt=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)], max_ticks=400)
    by = lambda reqs: {r.uid: (list(r.out_tokens), r.error) for r in reqs}
    assert by(tdone) == by(jdone)
    assert all(len(t) == 5 and e is None for t, e in by(tdone).values())
    te.pool.check()


def test_pixtral_configs_are_the_references():
    from repro.serve.engine import supports_paging as j_supports_paging
    from repro_torch.models.transformer import layer_plan
    from repro_torch.serve import supports_paging
    for t, j in ((t_config(ARCH), j_config(ARCH)),
                 (t_reduced(ARCH), j_reduced(ARCH))):
        for field in ("name", "family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "attention", "pos", "rope_theta", "num_patches",
                      "mlp_act", "norm", "tie_embeddings", "max_seq_len",
                      "scan_layers", "n_encoder_layers"):
            assert getattr(t, field) == getattr(j, field), field
        assert layer_plan(t) == [(j.layer_kind(i), j.mlp_kind(i))
                                 for i in range(j.n_layers)]
        assert supports_paging(t) == j_supports_paging(j) is True
    assert t_config(ARCH).n_heads // t_config(ARCH).n_kv_heads == 4


def test_launcher_serves_pixtral_on_the_paged_engine(capsys):
    from repro_torch.launch import serve as launch
    done = launch.main(["--arch", ARCH, "--reduced", "1", "--device", "cpu",
                        "--engine", "auto", "--bits", "3", "--group-size",
                        "32", "--requests", "2", "--max-new", "3",
                        "--paged-kernel", "fused", "--num-blocks", "24"])
    assert "engine=auto -> paged" in capsys.readouterr().out
    assert len(done) == 2 and all(len(r.out_tokens) == 3 and not r.error
                                  for r in done)
