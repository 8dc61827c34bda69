"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages;
reference parameter trees cross over as numpy arrays.  Whether a card is
present is decided inside tests (``require_cuda``), never at import.
"""
import contextlib

import numpy as np
import pytest
import torch


def require_cuda():
    """Skip the calling test unless an H100-class CUDA device is present
    (the kernels are built for sm_90a)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability (9, 0) for sm_90a kernels")


def to_numpy_tree(tree):
    """Reference parameter tree -> numpy leaves; PlaneBundle leaves become
    dicts of arrays + static fields (what ``from_jax_params`` takes)."""
    import jax
    from repro.core.plane import PlaneBundle

    def leaf(x):
        if isinstance(x, PlaneBundle):
            return {"packed": np.asarray(x.packed),
                    "alpha": np.asarray(x.alpha),
                    "z": None if x.z is None else np.asarray(x.z),
                    "group_size": x.group_size,
                    "in_features": x.in_features,
                    "out_features": x.out_features, "kind": x.kind}
        return np.asarray(x)
    return jax.tree_util.tree_map(
        leaf, tree, is_leaf=lambda x: isinstance(x, PlaneBundle))


def torch_bundle(wj):
    """A reference PlaneBundle as the port's PlaneBundle (CPU)."""
    from repro_torch.core.plane import PlaneBundle
    return PlaneBundle(
        packed=torch.from_numpy(np.asarray(wj.packed).copy()),
        alpha=torch.from_numpy(np.asarray(wj.alpha).copy()),
        z=None if wj.z is None else torch.from_numpy(np.asarray(wj.z).copy()),
        group_size=wj.group_size, in_features=wj.in_features,
        out_features=wj.out_features, kind=wj.kind)


def f32_params(params):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
        params)


# a Mamba mixer's FP leaves that the reference initializes to 0 or 1
_SSM_LEAVES = ("A_log", "D", "dt_bias", "out_norm")


def _perturb(params, seed):
    """Random (numpy, from ``seed``) linear biases (``*_b``, a Mamba
    mixer's ``conv_b`` among them), norm biases and norm scales, and a
    Mamba mixer's ``A_log``, ``D``, ``dt_bias`` and ``out_norm``, which
    the reference initializes to 0 and 1, so that parity tests exercise
    them."""
    import jax
    rng = np.random.default_rng(seed)

    def fix(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name.endswith("_b") or name in ("bias", "scale") \
                or name in _SSM_LEAVES:
            return x + rng.normal(size=x.shape).astype(np.float32) * 0.1
        return x
    return jax.tree_util.tree_map_with_path(fix, params)


def port_pair(arch, *, quant=None, perturb=None, **over):
    """(reference Model, its f32 parameters, port Model on the CPU) for the
    reduced config of ``arch``, with ``over`` applied to both configs
    (f32 by default).  ``quant`` (QuantSpec fields) quantizes the
    reference tree and carries the bundles across; ``perturb`` (a seed)
    draws the biases and norm parameters (``_perturb``) first."""
    import jax
    from repro.configs import get_reduced as j_reduced
    from repro.models import Model as JModel
    from repro_torch.configs import get_reduced as t_reduced
    from repro_torch.models import from_jax_params
    over = {"dtype": "float32", **over}
    jcfg = j_reduced(arch).replace(remat=False, **over)
    jm = JModel(jcfg)
    params = f32_params(jm.init(jax.random.PRNGKey(0)))
    if perturb is not None:
        params = _perturb(params, perturb)
    tcfg = t_reduced(arch).replace(**over)
    if quant:
        return quantized_pair(jm, params, tcfg, quant)
    return jm, params, from_jax_params(to_numpy_tree(params), tcfg,
                                       device="cpu")


def quantized_pair(jm, params, tcfg, quant, with_manifest=False):
    """``port_pair``'s quantized triple from a float one: the reference
    tree quantized with ``quant`` (QuantSpec fields), the reference Model
    that reads it and the port Model (config ``tcfg``) it is carried
    into; with ``with_manifest``, (that triple, the reference's manifest
    of the quantization)."""
    from repro import quant as jquant
    from repro.models import Model as JModel
    from repro_torch.models import from_jax_params
    from repro_torch.quant import QuantSpec
    jspec = jquant.QuantSpec(**quant)
    qparams, jman = jquant.quantize_model(params, jspec, jm.axes())
    triple = (JModel(jm.cfg.replace(quant=jspec)), qparams,
              from_jax_params(to_numpy_tree(qparams),
                              tcfg.replace(quant=QuantSpec(**quant)),
                              device="cpu"))
    return (triple, jman) if with_manifest else triple


class _JitPrefill:
    """A reference Model whose ``prefill`` is jitted (every other
    attribute is the model's own)."""

    def __init__(self, jm):
        import jax
        self._jm = jm
        self.prefill = jax.jit(jm.prefill)

    def __getattr__(self, name):
        return getattr(self._jm, name)


def ref_slots_engine(jm, params, **kw):
    """The reference's ``ServeEngine`` over ``jm``, its prefill jitted as
    its decode step already is.  The engine calls ``Model.prefill``
    eagerly, op by op, which takes tens of seconds on the CPU for the
    reduced stacks; the function and its inputs are the same."""
    from repro.serve import ServeEngine
    eng = ServeEngine(jm, params, **kw)
    eng.model = _JitPrefill(jm)
    return eng


@contextlib.contextmanager
def _ref_tables_copied():
    """While active, the reference engine's ``set_block_tables`` gets a
    copy of the tables it is handed."""
    import repro.serve.engine as ref_engine
    set_tables = ref_engine.set_block_tables
    ref_engine.set_block_tables = \
        lambda cache, tables: set_tables(cache, np.array(tables))
    try:
        yield
    finally:
        ref_engine.set_block_tables = set_tables


class _RefPaged:
    """A reference ``PagedServeEngine`` whose every method call runs
    under :func:`_ref_tables_copied` (attributes pass through)."""

    def __init__(self, eng):
        object.__setattr__(self, "_eng", eng)

    def __getattr__(self, name):
        attr = getattr(self._eng, name)
        if not callable(attr):
            return attr

        def call(*args, **kw):
            with _ref_tables_copied():
                return attr(*args, **kw)
        return call

    def __setattr__(self, name, value):
        setattr(self._eng, name, value)


def ref_paged_engine(jm, params, **kw):
    """The reference's ``PagedServeEngine`` over ``jm``, handed a copy of
    its block tables on every tick.  Its ticks give the engine's own
    ``tables`` array (a row slice of it at prefill) to ``jnp.asarray``,
    which on the CPU may alias that host memory, and the engine rewrites
    the array in place every tick: its tokens then vary from run to run
    (greedy ones too, by whether the buffer happened to alias).  The
    function is the same."""
    from repro.serve import PagedServeEngine
    with _ref_tables_copied():
        return _RefPaged(PagedServeEngine(jm, params, **kw))


def prompts_of(lens, seed=0, vocab=256):
    """int32 prompts of the given lengths, from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(n),)).astype(np.int32)
            for n in lens]


def pool_case(seed, *, b=3, h=8, hkv=4, d=16, nb=24, bs=4, pages=6,
              chunk=0):
    """Scrambled paged problem as numpy arrays: ragged live lengths, -1
    table pads, a recycled block holding stale positions, an idle row
    (decode) or pad query rows at position -1 (prefill, ``chunk`` > 0)."""
    assert nb > b * pages
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(nb, bs, hkv, d)).astype(np.float32)
    v = rng.normal(size=(nb, bs, hkv, d)).astype(np.float32)
    tables = np.full((b, pages), -1, np.int32)
    pos = np.full((nb, bs), -1, np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    cap = pages * bs
    if chunk:
        positions = np.full((b, chunk), -1, np.int32)
        q = rng.normal(size=(b, chunk, h, d)).astype(np.float32)
    else:
        positions = np.zeros(b, np.int32)
        q = rng.normal(size=(b, h, d)).astype(np.float32)
    for row in range(b):
        if chunk:
            ctx = int(rng.integers(0, cap - chunk + 1))
            real = chunk - (2 if row == b - 1 else 0)
            positions[row, :real] = ctx + np.arange(real)
            live = ctx + real
        else:
            if row == 0:
                continue                       # idle row: all entries -1
            live = int(rng.integers(1, cap))
            positions[row] = live - 1
        for j in range(-(-live // bs)):
            blk = free.pop()
            tables[row, j] = blk
            pos[blk] = j * bs + np.arange(bs)
    stale = free.pop()
    pos[stale] = np.arange(bs)                 # claims positions 0..bs-1
    j = int(np.argmax(tables[b - 1] < 0))
    if j > 0:                                  # at a logical index != 0
        tables[b - 1, j] = stale
    return q, k, v, pos, tables, positions


def int8_pools(k, v, seed=None, pow2=False):
    """Float pools [NB, BS, Hkv, D] -> (int8 k, int8 v, f32 k_scale,
    f32 v_scale), quantized per (slot, head) as ``_quantize_kv`` does.
    With ``pow2`` the scales are powers of two (so products with them
    are exact) and the int8 values are drawn from ``seed``."""
    if pow2:
        rng = np.random.default_rng(seed)
        shape, sshape = k.shape, k.shape[:3]
        kq = rng.integers(-127, 128, shape).astype(np.int8)
        vq = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (2.0 ** rng.integers(-9, -5, sshape)).astype(np.float32)
        vs = (2.0 ** rng.integers(-9, -5, sshape)).astype(np.float32)
        return kq, vq, ks, vs

    def quant(t):
        scale = (np.abs(t).max(-1) / np.float32(127.0)
                 + np.float32(1e-9)).astype(np.float32)
        q = np.clip(np.round(t / scale[..., None]), -127, 127)
        return q.astype(np.int8), scale
    kq, ks = quant(k)
    vq, vs = quant(v)
    return kq, vq, ks, vs


def mla_pool_case(seed, *, b=3, h=8, lora=12, dr=8, nb=24, bs=4, pages=6):
    """Latent-pool analogue of ``pool_case`` (absorbed MLA decode inputs),
    at the reference's ``_mla_pool_case`` shapes: the same scrambled
    tables with a recycled stale block and an idle (zero-live) row 0."""
    _, _, _, pos, tables, positions = pool_case(seed, b=b, nb=nb, bs=bs,
                                                pages=pages)
    rng = np.random.default_rng(seed + 200)
    ckv = rng.normal(size=(nb, bs, lora)).astype(np.float32)
    krope = rng.normal(size=(nb, bs, dr)).astype(np.float32)
    q_eff = rng.normal(size=(b, h, lora)).astype(np.float32)
    q_rope = rng.normal(size=(b, h, dr)).astype(np.float32)
    return q_eff, q_rope, ckv, krope, pos, tables, positions


def live_slots(pos, tables, positions):
    """[NB, BS] bool: the pool slots some row's decode attends to (the
    paged liveness rule, positions [B])."""
    bs = pos.shape[1]
    live = np.zeros(pos.shape, bool)
    for row, table in enumerate(tables):
        for j, entry in enumerate(table):
            if entry >= 0:
                want = j * bs + np.arange(bs)
                live[entry] |= (pos[entry] == want) & \
                    (pos[entry] <= positions[row])
    return live
