"""GQA/MHA and MLA attention over a paged KV pool or a contiguous cache.

Counterpart of the GQA and MLA parts of ``repro.models.attention``.
GQA rotates q and k with rotary positions (``cfg.pos == "rope"``) after
the projections and before the cache insert, as the reference does; pad
rows at negative positions are rotated too and masked later.

Paged layout: every layer's cache is a shared pool ``k, v: [NB, BS, Hkv,
D]`` plus ``pos: [NB, BS]`` (the absolute position stored in each slot,
-1 = empty) and a ``block_tables: [B, max_blocks_per_seq]`` leaf mapping
each sequence's logical block to a physical one (-1 = unallocated).
Physical block 0 is the trash block: writes with a negative position, a
logical block past the table or an unallocated entry land there, and no
read ever counts its slots.  A slot is live iff its table entry is
allocated AND its stored position equals its logical index (which makes
recycled blocks safe) AND it is causally visible.

Contiguous layout (the slots engine's): ``k, v: [B, L, Hkv, D]`` and
``pos: [B, L]`` per row, a ring in which position p lives at slot
``p % L`` (``L`` capped at the sliding window, as in the reference);
pads at negative positions write their negative position, so they never
count.  MLA rows hold ``ckv [B, L, kv_lora]`` and ``krope [B, L,
qk_rope]``.  The contiguous path's attention is plain PyTorch
(``decode_attend``, ``blockwise_attention``, ``_mla_absorbed_ctx``),
as the reference leaves it to XLA.

The port writes both caches **in place** (``index_put_`` into views of
the cache tensors) where the reference returns an updated copy: at full
width one layer's pool is tens of megabytes per step.

With ``kv_cache_bits=8`` the cache holds int8 ``k``/``v`` plus f32
``k_scale``/``v_scale`` [.., Hkv]: each new (token, head) vector is
quantized symmetrically at insertion (``_quantize_kv``), and attention
folds the scales in (k_scale on the scores before the softmax, v_scale on
the probabilities after it).  A whole-prompt prefill into a contiguous
int8 cache attends over the fresh K/V, not the cache (the reference's
branch).

MLA (``attention="mla"``) caches hold the compressed latent instead:
``ckv`` and the shared rotary key ``krope`` in ``cfg.dtype``
(``kv_cache_bits`` does not apply, as in the reference).  Decode uses
the absorbed formulation (scores in latent space, ``paged_attention_mla``
on a pool); prefill decompresses the latent through ``kv_b``.

Paged decode and chunked prefill route to the fused CUDA kernels
(``kernels/paged_attention``) or to the gathered plain path
(``paged_view`` + ``decode_attend`` / ``blockwise_attention``, int8
pools dequantized for prefill), by the reference's rule: ``fused``
forces the kernels (on the CPU their wrappers run the plain versions),
``auto`` takes them where they are native (an H100), ``gather`` never
does.

An encoder-decoder's decoder layers cross-attend (``CrossAttention``)
to the encoder output: queries at position 0, keys at ``arange(Senc)``,
no mask and no rotary positions; their K/V are projected at prefill and
read from the contiguous cache at decode (``models/model.py``).  The
encoder's self-attention runs with ``causal=False``.  Both are plain
PyTorch, as the reference leaves them to XLA.

A sliding window (``cfg.sliding_window`` W > 0) masks every key at or
more than W positions behind its query, in full-sequence attention, in
the contiguous prefill and in decode.  A paged pool refuses a window,
as the reference's does: the ring is already a fixed reservation.  A
prompt longer than the ring is written whole and only its trailing L
entries stay, and the prefill attends over the cache after that write
(the reference's path), so its queries before the last see only those
entries, not their full window.

Over a mesh (``shard_model``), each rank attends for its slice of the
query heads against its slice of the pool, as the reference's
``paged_shard_scope`` runs the kernels per model shard.  Where the kv
heads divide the ``model`` axis, the pool holds ``Hkv / tp`` heads and
the fused decode and prefill kernels run on that slice.  Where they do
not (narrow GQA: 2 kv heads on tp 4), the pool shards ``head_dim``
instead (the reference's divisibility fallback), the capability check
refuses the fused kernels with reason ``tp`` even when ``fused`` is
forced, and the gathered view is assembled across the ``model`` group
before attention (:class:`AttnTP`).  An int8 pool's scale pools take
its kv-heads cut; where it cuts ``head_dim`` each (token, head) row is
quantized whole before the cut and the scale pools hold every head.
An MLA layer runs its query heads per rank (``q_b`` column-parallel,
``kv_b`` cut to the rank's heads, ``o`` row-parallel) against the
latent pool, which every rank holds whole and writes alike (the
reference's shard_map keeps it replicated); heads that do not divide
the axis run whole on every rank, gathered.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.launch.mesh import enter_parallel
from repro_torch.models.layers import Linear, apply_rope, enter_for, reslice

NEG_INF = -1e30
PAGED_KERNEL_MODES = ("auto", "fused", "gather")


def check_supported(cfg) -> None:
    """Refuse the attention variants the port does not carry."""
    if cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"attention={cfg.attention!r} is not ported yet (ROADMAP.md "
            "queue 1 item 7)")
    if cfg.kv_cache_bits not in (8, 16):
        raise ValueError(f"kv_cache_bits must be 8 or 16, got "
                         f"{cfg.kv_cache_bits}")


# ---------------------------------------------------------------------------
# plain attention
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, qpos, kpos, *, causal=True, window=0,
                        scale=None):
    """Masked softmax attention, f32 accumulation (the plain version of the
    reference's online-softmax ``blockwise_attention``: one block).

    q, k: [B, Sq|Sk, H|Hkv, D]; v: [B, Sk, Hkv, Dv]; qpos [B, Sq]; kpos
    [B, Sk] (-1 = empty); ``window`` > 0 keeps keys with qpos - kpos <
    window.  Returns [B, Sq, H, Dv] in q.dtype."""
    b, sq, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = (q.reshape(b, sq, hkv, rep, d).float() * scale).to(q.dtype)
    s = torch.einsum("bqhrd,bkhd->bqhrk", qg.float(),
                     k.to(q.dtype).float())
    ok = kpos[:, None, :] >= 0
    if causal:
        ok = ok & (kpos[:, None, :] <= qpos[:, :, None])
    if window:
        ok = ok & (qpos[:, :, None] - kpos[:, None, :] < window)
    s = s + torch.where(ok, 0.0, NEG_INF)[:, :, None, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    out = torch.einsum("bqhrk,bkhd->bqhrd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, dv).to(q.dtype)


def decode_attend(q, cache, positions, *, window=0, scale=None):
    """Single-token attention against a contiguous view.
    q: [B, 1, H, D]; positions: [B, 1]; ``window`` as in
    :func:`blockwise_attention`.  int8 views compute in bf16 with
    k_scale folded into the scores and v_scale into the probabilities."""
    k, v, kpos = cache["k"], cache["v"], cache["pos"]
    b, _, h, d = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    int8 = k.dtype == torch.int8
    cdt = torch.bfloat16 if int8 else k.dtype
    qg = (q.reshape(b, hkv, rep, d).float() * scale).to(cdt)
    sc = torch.einsum("bhrd,blhd->bhrl", qg.float(), k.float())
    if int8:
        sc = sc * cache["k_scale"].transpose(1, 2)[:, :, None, :]
    ok = (kpos >= 0) & (kpos <= positions[:, :1])
    if window:
        ok = ok & (positions[:, :1] - kpos < window)
    sc = torch.where(ok[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    if int8:
        p = p * cache["v_scale"].transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhrl,blhd->bhrd", p.to(cdt).float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def _cache_leaves(cfg, rows: int, slots: int, device, kv_shape=None) -> dict:
    """One layer's KV leaves [rows, slots, ...], every ``pos`` -1 (empty):
    a contiguous cache's (batch, length) or a pool's (blocks, block
    size), as the reference derives its pool descriptors from the
    contiguous ones.  int8 caches add the f32 per-(slot, head) scales;
    MLA caches hold the latent ``ckv`` and the shared rotary key
    ``krope``."""
    pos = torch.full((rows, slots), -1, dtype=torch.int32, device=device)
    if cfg.attention == "mla":
        dt = getattr(torch, cfg.dtype)
        return {
            "ckv": torch.zeros((rows, slots, cfg.kv_lora_rank), dtype=dt,
                               device=device),
            "krope": torch.zeros((rows, slots, cfg.qk_rope_head_dim),
                                 dtype=dt, device=device),
            "pos": pos}
    hkv = cfg.n_kv_heads * cfg.kv_replication
    int8 = cfg.kv_cache_bits == 8
    dt = torch.int8 if int8 else getattr(torch, cfg.dtype)
    shape = (rows, slots, *(kv_shape or (hkv, cfg.head_dim_)))
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device), "pos": pos}
    if int8:
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros(shape[:3], dtype=torch.float32,
                                     device=device)
    return cache


def init_paged_layer_cache(cfg, batch: int, num_blocks: int, block_size: int,
                           max_blocks_per_seq: int, device,
                           kv_shape=None) -> dict:
    """One layer's pool + block table (``paged_cache_desc`` + init).  A
    sliding window is refused, as in the reference: its ring cache is
    already a fixed-size reservation.  ``kv_shape`` (kv heads, head
    width) is a rank's slice of the pool over a mesh."""
    check_supported(cfg)
    if cfg.sliding_window:
        raise ValueError("paged KV cache requires sliding_window == 0 "
                         "(ring caches are already fixed-size)")
    cache = _cache_leaves(cfg, num_blocks, block_size, device, kv_shape)
    cache["block_tables"] = torch.full((batch, max_blocks_per_seq), -1,
                                       dtype=torch.int32, device=device)
    return cache


def init_layer_cache(cfg, batch: int, length: int, device) -> dict:
    """One layer's contiguous cache (``cache_desc_gqa`` / ``cache_desc_mla``
    + init): ``length`` slots per row, capped at the sliding window."""
    if cfg.sliding_window:
        length = min(length, cfg.sliding_window)
    return _cache_leaves(cfg, batch, length, device)


def _quantize_kv(t: torch.Tensor):
    """[B, S, H, D] -> (int8 values, f32 per-(token, head) scales):
    scale = max|t| / 127 + 1e-9, round half to even, clip to ±127."""
    tf = t.float()
    scale = tf.abs().amax(dim=-1) / 127.0 + 1e-9
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def is_paged(cache: dict) -> bool:
    return "block_tables" in cache


def kv_entry_bytes(cfg) -> int:
    """KV-cache bytes per (token, layer): the latent + rotary key for
    MLA; int8 K/V plus their f32 scale rows on an int8 pool."""
    if cfg.attention == "mla":
        return (cfg.kv_lora_rank + cfg.qk_rope_head_dim) \
            * getattr(torch, cfg.dtype).itemsize
    hkv = cfg.n_kv_heads * cfg.kv_replication
    if cfg.kv_cache_bits == 8:
        return 2 * hkv * cfg.head_dim_ + 2 * hkv * 4
    return 2 * hkv * cfg.head_dim_ * getattr(torch, cfg.dtype).itemsize


def paged_view(cache: dict) -> dict:
    """Per-sequence contiguous view [B, nblk * bs, ...]; ``pos`` is -1
    wherever the slot is not live."""
    table = cache["block_tables"]
    b, nblk = table.shape
    bs = cache["pos"].shape[1]
    safe = torch.clamp(table, min=0).reshape(-1).long()
    view = {}
    for key, val in cache.items():
        if key == "block_tables":
            continue
        g = val.index_select(0, safe)
        view[key] = g.reshape(b, nblk * bs, *val.shape[2:])
    allocated = torch.repeat_interleave(table >= 0, bs, dim=1)
    iota = torch.arange(nblk * bs, dtype=torch.int32, device=table.device)
    live = allocated & (view["pos"] == iota[None])
    view["pos"] = torch.where(live, view["pos"],
                              torch.full_like(view["pos"], -1))
    return view


def _paged_insert(cache: dict, updates: dict, at: torch.Tensor) -> dict:
    """Scatter S new entries into the pool through the block table, in
    place.  Position p of row b lives at slot ``table[b, p // bs] * bs +
    p % bs``; invalid writes go to trash block 0."""
    table = cache["block_tables"]
    nb, bs = cache["pos"].shape
    b, nblk = table.shape
    s = next(iter(updates.values())).shape[1]
    at = torch.as_tensor(at, dtype=torch.int32, device=table.device)
    if at.ndim == 0:
        at = at.expand(b)
    positions = at[:, None] + torch.arange(s, dtype=torch.int32,
                                           device=table.device)[None]
    blk = torch.div(positions, bs, rounding_mode="floor")
    phys = torch.gather(table, 1, torch.clamp(blk, 0, nblk - 1).long())
    valid = (positions >= 0) & (blk < nblk) & (phys >= 0)
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    flat = (phys * bs + torch.remainder(positions, bs)).reshape(-1).long()
    for key, val in updates.items():
        buf = cache[key]
        fb = buf.view(nb * bs, *buf.shape[2:])
        fb[flat] = val.reshape(b * s, *val.shape[2:]).to(buf.dtype)
    posf = cache["pos"].view(nb * bs)
    posf[flat] = torch.where(valid, positions,
                             torch.full_like(positions, -1)).reshape(-1)
    return cache


def _ring_insert(cache: dict, updates: dict, at) -> dict:
    """Write S new entries into a contiguous cache, in place: position p
    of row b lives at slot ``p % L`` (floor modulo, so pads at negative
    positions land at the ring's end with their negative position, dead).
    When S > L only the trailing L entries survive."""
    b, length = cache["pos"].shape
    s = next(iter(updates.values())).shape[1]
    at = torch.as_tensor(at, dtype=torch.int32, device=cache["pos"].device)
    if s > length:
        updates = {k: v[:, -length:] for k, v in updates.items()}
        at = at + (s - length)
        s = length
    if at.ndim == 0:
        at = at.expand(b)
    positions = at[:, None] + torch.arange(s, dtype=torch.int32,
                                           device=at.device)[None]
    slots = torch.remainder(positions, length).long()
    bidx = torch.arange(b, device=at.device)[:, None]
    for key, val in updates.items():
        cache[key][bidx, slots] = val.to(cache[key].dtype)
    cache["pos"][bidx, slots] = positions
    return cache


def cache_insert(cache: dict, updates: dict, at) -> dict:
    """Write S new entries starting at absolute position ``at`` (scalar
    or per-row [B]): through the block table into a paged pool, or into
    a contiguous cache's ring."""
    if is_paged(cache):
        return _paged_insert(cache, updates, at)
    return _ring_insert(cache, updates, at)


def fused_selected(mode: str) -> bool:
    """The fused-vs-gather routing rule for GQA pools (float and int8
    alike: both have kernels)."""
    if mode not in PAGED_KERNEL_MODES:
        raise ValueError(f"paged_kernel must be one of "
                         f"{PAGED_KERNEL_MODES}, got {mode!r}")
    if mode == "gather":
        return False
    if mode == "fused":
        return True
    from repro_torch.quant.backends import on_h100
    return on_h100()


def tp_supported(cfg, kernel: str, tp: int = 1) -> bool:
    """Whether the paged kernels can run per model shard at ``tp``: the
    capability check's ``tp`` and ``heads`` reasons on the config's
    query and pool heads (``tune.dispatch.kernel_unsupported_reason``),
    as the reference negotiates (MLA: kv heads are the query heads)."""
    from repro_torch.tune.dispatch import kernel_unsupported_reason
    mla = cfg.attention == "mla"
    hkv = cfg.n_heads if mla else cfg.n_kv_heads * cfg.kv_replication
    return kernel_unsupported_reason(
        kernel, m=cfg.n_heads, n=1, group_size=1, n_kv_heads=hkv,
        tp=tp) is None


def paged_kernel_mode(cfg, tp: int = 1) -> str:
    """Host-side label of the path a paged decode step takes ("fused" |
    "gather"): GQA pools (float and int8) and MLA latent pools all have
    a decode kernel; over a ``tp``-way model axis only where the heads
    divide it (else even a forced "fused" negotiates down to "gather")."""
    kernel = "paged_decode_mla" if cfg.attention == "mla" else "paged_decode"
    fused = fused_selected(cfg.paged_kernel) and tp_supported(cfg, kernel, tp)
    return "fused" if fused else "gather"


def paged_prefill_mode(cfg, tp: int = 1) -> str:
    """Host-side label of the chunked-prefill path: as decode for GQA
    pools; MLA prefill always resolves to "gather" (the latent must be
    decompressed through ``kv_b``, which the prefill kernel does not
    fold)."""
    if cfg.attention == "mla":
        return "gather"
    fused = fused_selected(cfg.paged_kernel) and \
        tp_supported(cfg, "paged_prefill", tp)
    return "fused" if fused else "gather"


def paged_decode_attend(q, cache, positions, *, scale=None, mode="auto"):
    """Single-token attention on a paged cache.  q [B, 1, H, D]."""
    if fused_selected(mode):
        from repro_torch.kernels.paged_attention import (
            paged_attention, paged_attention_int8)
        if cache["k"].dtype == torch.int8:
            out = paged_attention_int8(
                q[:, 0], cache["k"], cache["v"], cache["k_scale"],
                cache["v_scale"], cache["pos"], cache["block_tables"],
                positions[:, 0], scale=scale)
        else:
            out = paged_attention(q[:, 0], cache["k"], cache["v"],
                                  cache["pos"], cache["block_tables"],
                                  positions[:, 0], scale=scale)
        return out[:, None]
    return decode_attend(q, paged_view(cache), positions, scale=scale)


def paged_prefill_attend(q, cache, positions, *, scale=None, mode="auto"):
    """Chunked-prefill attention on a paged cache (chunk already inserted).
    q [B, C, H, D]; positions [B, C].  The gathered path dequantizes an
    int8 view to q's dtype first."""
    int8 = cache["k"].dtype == torch.int8
    if fused_selected(mode):
        from repro_torch.kernels.paged_attention import paged_prefill
        return paged_prefill(q, cache["k"], cache["v"], cache["pos"],
                             cache["block_tables"], positions, scale=scale,
                             k_scale=cache["k_scale"] if int8 else None,
                             v_scale=cache["v_scale"] if int8 else None)
    kv = paged_view(cache)
    k, v = kv["k"], kv["v"]
    if int8:
        k = (k.float() * kv["k_scale"][..., None]).to(q.dtype)
        v = (v.float() * kv["v_scale"][..., None]).to(q.dtype)
    return blockwise_attention(q, k, v, positions, kv["pos"], causal=True,
                               scale=scale)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


class AttnTP:
    """An attention layer's cut over the ``model`` axis.  ``heads`` (h0,
    h1): the query heads this rank attends for (all of them where the
    heads do not divide tp); ``pool``: how its pool slice is cut,
    ``("kv_heads", k0, k1)``, ``("head_dim", d0, d1)`` or None
    (replicated: an MLA layer's latent pool always).  A GQA layer's fused
    kernels run only on a kv-heads slice (``local``)."""

    def __init__(self, mesh, heads, pool):
        self.mesh = mesh
        self.heads = heads
        self.pool = pool

    @property
    def local(self) -> bool:
        return self.pool is not None and self.pool[0] == "kv_heads"


def _heads_of(kv, h0: int, h1: int, rep: int):
    """The kv entry of each query head in [h0, h1) ([B, L, h1-h0, D])."""
    idx = torch.arange(h0, h1, device=kv.device) // rep
    return kv.index_select(2, idx)


class Attention(nn.Module):
    """GQA/MHA self-attention: q/k/v/o linears (optional q/k/v biases),
    rotary or learned positions, a paged or contiguous KV cache.  ``tp``
    (None: the whole layer) is its tensor-parallel cut."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.tp: Optional[AttnTP] = None
        hd = cfg.head_dim_
        d = cfg.d_model
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        self.q = Linear(h * hd, d, bias=cfg.qkv_bias, dtype=dtype,
                        device=device)
        self.k = Linear(hkv * hd, d, bias=cfg.qkv_bias, dtype=dtype,
                        device=device)
        self.v = Linear(hkv * hd, d, bias=cfg.qkv_bias, dtype=dtype,
                        device=device)
        self.o = Linear(d, h * hd, bias=False, dtype=dtype, device=device)

    def forward(self, x, positions, *, cache: Optional[dict] = None,
                cache_at=None, causal: bool = True, backend=None,
                paged_kernel: str = "auto"):
        if self.tp is not None:
            return self._forward_tp(x, positions, cache, cache_at, causal,
                                    backend, paged_kernel)
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim_
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        q = self.q(x, backend).reshape(b, s, h, hd)
        k = self.k(x, backend).reshape(b, s, hkv, hd)
        v = self.v(x, backend).reshape(b, s, hkv, hd)
        if cfg.kv_replication > 1:
            k = torch.repeat_interleave(k, cfg.kv_replication, dim=2)
            v = torch.repeat_interleave(v, cfg.kv_replication, dim=2)
        if cfg.pos == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        window = cfg.sliding_window
        if cache is None:
            out = blockwise_attention(q, k, v, positions, positions,
                                      causal=causal, window=window)
        else:
            # the cache's dtype decides, not this module's config: a
            # ``with_config(kv_cache_bits=8)`` view shares the modules
            int8 = cache["k"].dtype == torch.int8
            if int8:
                kq, ks = _quantize_kv(k)
                vq, vs = _quantize_kv(v)
                updates = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
            else:
                updates = {"k": k, "v": v}
            cache = cache_insert(cache, updates, cache_at)
            if is_paged(cache):
                attend = (paged_decode_attend if s == 1
                          else paged_prefill_attend)
                out = attend(q, cache, positions, mode=paged_kernel)
            elif s == 1:
                out = decode_attend(q, cache, positions, window=window)
            elif int8:
                # whole-prompt prefill into an empty int8 cache: attend
                # over the fresh K/V (the reference's branch), so the
                # quantization error reaches only later decode reads
                out = blockwise_attention(q, k, v, positions, positions,
                                          causal=True, window=window)
            else:
                out = blockwise_attention(q, cache["k"], cache["v"],
                                          positions, cache["pos"],
                                          causal=True, window=window)
        out = self.o(out.reshape(b, s, h * hd), backend)
        return (out, cache) if cache is not None else out

    def _forward_tp(self, x, positions, cache, cache_at, causal, backend,
                    paged_kernel):
        """This rank's share of the layer: its query heads against its
        pool slice, then ``o`` (row-parallel: all-reduced)."""
        cfg, tp = self.cfg, self.tp
        mesh = tp.mesh
        b, s, _ = x.shape
        hd, h = cfg.head_dim_, cfg.n_heads
        h0, h1 = tp.heads
        rep = h // (cfg.n_kv_heads * cfg.kv_replication)
        heads = None if (h0, h1) == (0, h) else (h0 * hd, h1 * hd)
        x = enter_for(x, (self.q, self.k, self.v), mesh)
        q = reslice(self.q(x, backend), self.q.out_slice, heads, mesh)
        q = q.reshape(b, s, h1 - h0, hd)
        # k / v: this rank's kv heads where the pool holds whole heads
        # (and no replication renumbers them), else every head
        kind = tp.pool[0] if tp.pool else None
        want = (tp.pool[1] * hd, tp.pool[2] * hd) \
            if kind == "kv_heads" and cfg.kv_replication == 1 else None
        k = reslice(self.k(x, backend), self.k.out_slice, want, mesh)
        v = reslice(self.v(x, backend), self.v.out_slice, want, mesh)
        k, v = k.reshape(b, s, -1, hd), v.reshape(b, s, -1, hd)
        if cfg.kv_replication > 1:
            k = torch.repeat_interleave(k, cfg.kv_replication, dim=2)
            v = torch.repeat_interleave(v, cfg.kv_replication, dim=2)
        if cfg.pos == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if kind == "kv_heads" and k.shape[2] != tp.pool[2] - tp.pool[1]:
            k, v = (enter_parallel(t, mesh)[:, :, tp.pool[1]:tp.pool[2]]
                    for t in (k, v))
        if cache is None:
            if kind != "kv_heads" and heads is not None:
                k, v = (_heads_of(enter_parallel(t, mesh), h0, h1, rep)
                        for t in (k, v))
            elif kind != "kv_heads":
                k, v = _heads_of(k, h0, h1, rep), _heads_of(v, h0, h1, rep)
            # the window's mask is per head, so a rank's heads take it as
            # the whole layer does (training; a paged cache has no window)
            out = blockwise_attention(q, k, v, positions, positions,
                                      causal=causal,
                                      window=cfg.sliding_window)
        else:
            if cache["k"].dtype == torch.int8:
                # each (token, head) row quantized whole, then cut: a
                # head_dim slice keeps the full row's scale (the scale
                # pools hold every kv head there)
                (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
                updates = {"k_scale": ks, "v_scale": vs}
            else:
                updates = {}
            if kind == "head_dim":
                k, v = (t[..., tp.pool[1]:tp.pool[2]] for t in (k, v))
            cache = cache_insert(cache, {"k": k, "v": v, **updates},
                                 cache_at)
            if kind == "kv_heads":
                attend = (paged_decode_attend if s == 1
                          else paged_prefill_attend)
                out = attend(q, cache, positions, mode=paged_kernel)
            else:
                # negotiated down: the gathered view, whole across the
                # model group, then every local query head's kv entry
                view = paged_view(cache)
                if kind == "head_dim":
                    for key in ("k", "v"):
                        view[key] = mesh.all_gather(view[key], "model",
                                                    dim=-1)
                for key in ("k", "v", "k_scale", "v_scale"):
                    if key in view:
                        view[key] = _heads_of(view[key], h0, h1, rep)
                if s == 1:
                    out = decode_attend(q, view, positions)
                else:
                    kf, vf = view["k"], view["v"]
                    if "k_scale" in view:
                        kf = (kf.float() * view["k_scale"][..., None]
                              ).to(q.dtype)
                        vf = (vf.float() * view["v_scale"][..., None]
                              ).to(q.dtype)
                    out = blockwise_attention(q, kf, vf, positions,
                                              view["pos"], causal=True)
        out = reslice(out.reshape(b, s, (h1 - h0) * hd), heads,
                      self.o.in_slice, mesh)
        out = self.o(out, backend)
        return (out, cache) if cache is not None else out


class CrossAttention(nn.Module):
    """Decoder cross-attention of an encoder-decoder (the reference's
    ``cross_attn_desc`` / ``cross_kv`` / ``cross_attend``): q/k/v/o
    linears as self-attention's (q/k/v biases where ``qkv_bias``),
    queries at position 0 against keys at ``arange(Senc)``, no causal
    mask and no rotary positions.  ``kv`` projects the encoder output
    (at prefill; the caller keeps the result in the cache), ``forward``
    attends to given K/V (fresh at prefill, the cache's at decode).  The
    attention is plain PyTorch, as the reference leaves it to XLA."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim_
        d = cfg.d_model
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        self.q = Linear(h * hd, d, bias=cfg.qkv_bias, dtype=dtype,
                        device=device)
        self.k = Linear(hkv * hd, d, bias=cfg.qkv_bias, dtype=dtype,
                        device=device)
        self.v = Linear(hkv * hd, d, bias=cfg.qkv_bias, dtype=dtype,
                        device=device)
        self.o = Linear(d, h * hd, bias=False, dtype=dtype, device=device)

    def kv(self, enc_out: torch.Tensor, backend=None):
        """(k, v) [B, Senc, Hkv, hd] of the encoder output."""
        cfg = self.cfg
        b, s, _ = enc_out.shape
        shape = (b, s, cfg.n_kv_heads, cfg.head_dim_)
        return (self.k(enc_out, backend).reshape(shape),
                self.v(enc_out, backend).reshape(shape))

    def forward(self, x, k, v, backend=None):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hd = cfg.n_heads, cfg.head_dim_
        q = self.q(x, backend).reshape(b, s, h, hd)
        qpos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
        kpos = torch.arange(k.shape[1], dtype=torch.int32,
                            device=x.device)[None].expand(b, -1)
        out = blockwise_attention(q, k, v, qpos, kpos, causal=False)
        return self.o(out.reshape(b, s, h * hd), backend)


# ---------------------------------------------------------------------------
# MLA block (minicpm3)
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """The MLA latents' RMSNorm (eps 1e-6, not the blocks' 1e-5)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * scale
    return y.to(x.dtype)


def _mla_absorbed_ctx(q_eff, q_rope, ckv_all, krope_all, kpos, positions,
                      scale):
    """Gathered absorbed-decode math: latent-space scores + softmax +
    latent context.  q_eff: f32 [B, 1, H, lora]; returns [B, 1, H, lora]
    f32 (the caller applies ``w_uv``).  ``kpos`` is -1 on every non-live
    slot (``paged_view`` sets it)."""
    sc = torch.einsum("bshl,bkl->bshk", q_eff, ckv_all.float())
    sc = sc + torch.einsum("bshr,bkr->bshk", q_rope.float(),
                           krope_all.float())
    sc = sc * scale
    m = (kpos >= 0)[:, None, None, :] & \
        (kpos[:, None, None, :] <= positions[:, 0][:, None, None, None])
    sc = torch.where(m, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bshk,bkl->bshl", p, ckv_all.float())


def mla_paged_decode_attend(q_eff, q_rope, cache, positions, *, scale,
                            mode="auto"):
    """Absorbed MLA decode on a paged latent cache.  q_eff: f32 [B, 1, H,
    lora] (``w_uk`` absorbed); q_rope: [B, 1, H, rope_dim].  Returns the
    latent context f32 [B, 1, H, lora]; the caller applies ``w_uv``."""
    if fused_selected(mode):
        from repro_torch.kernels.paged_attention import paged_attention_mla
        ctx = paged_attention_mla(
            q_eff[:, 0].contiguous(), q_rope[:, 0].float().contiguous(),
            cache["ckv"], cache["krope"], cache["pos"],
            cache["block_tables"], positions[:, 0].contiguous(),
            scale=float(scale))
        return ctx[:, None]
    kv = paged_view(cache)
    return _mla_absorbed_ctx(q_eff, q_rope, kv["ckv"], kv["krope"],
                             kv["pos"], positions, scale)


class MLAttention(nn.Module):
    """Multi-head latent attention (``mla_apply``): low-rank queries, a
    compressed latent KV cache plus one shared rotary key head.

    ``kv_b`` decompresses the latent into per-head ``w_uk [H, dn, lora]``
    and ``w_uv [H, dv, lora]``.  The reference dequantizes it on every
    call; here the f32 split is computed once per weight object and
    reused while ``kv_b.weight`` is that same object (``quantize_model``
    swapping the weight recomputes it)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        lora = cfg.kv_lora_rank
        if not cfg.q_lora_rank:
            raise NotImplementedError("MLA without a query LoRA is not "
                                      "ported yet (ROADMAP.md queue 1 item 7)")
        self.q_a = Linear(cfg.q_lora_rank, d, bias=False, dtype=dtype,
                          device=device)
        self.q_a_norm = torch.ones(cfg.q_lora_rank, dtype=torch.float32,
                                   device=device)
        self.q_b = Linear(h * (dn + dr), cfg.q_lora_rank, bias=False,
                          dtype=dtype, device=device)
        self.kv_a = Linear(lora + dr, d, bias=False, dtype=dtype,
                           device=device)
        self.kv_a_norm = torch.ones(lora, dtype=torch.float32, device=device)
        self.kv_b = Linear(h * (dn + dv), lora, bias=False, dtype=dtype,
                           device=device)
        self.o = Linear(d, h * dv, bias=False, dtype=dtype, device=device)
        self._kv_b_split = None     # (weight, version, w_uk, w_uv)
        self.tp: Optional[AttnTP] = None

    def init_params(self, generator: torch.Generator) -> None:
        self.q_a_norm.fill_(1.0)
        self.kv_a_norm.fill_(1.0)

    def absorbed_weights(self):
        """(w_uk [H, dn, lora], w_uv [H, dv, lora]) in f32 for the current
        ``kv_b`` weight: over a mesh, of the heads whose rows this rank's
        ``kv_b`` holds."""
        from repro_torch.core.plane import PlaneBundle, dequantize
        w = self.kv_b.weight
        cfg = self.cfg
        dn = cfg.qk_nope_head_dim
        if isinstance(w, torch.Tensor) and w.requires_grad \
                and torch.is_grad_enabled():
            # a training forward: the split is part of what autograd
            # differentiates, so it is computed anew, never kept
            w3 = w.float().reshape(-1, dn + cfg.v_head_dim,
                                   cfg.kv_lora_rank)
            return w3[:, :dn], w3[:, dn:]
        # keyed by the weight object and, for a tensor, its version (an
        # optimizer step writes it in place)
        key = (w, getattr(w, "_version", None))
        if self._kv_b_split is None or self._kv_b_split[0] is not key[0] \
                or self._kv_b_split[1] != key[1]:
            dense = (dequantize(w, torch.float32)
                     if isinstance(w, PlaneBundle) else w.detach().float())
            w3 = dense.reshape(-1, dn + cfg.v_head_dim, cfg.kv_lora_rank)
            self._kv_b_split = (w, key[1], w3[:, :dn].contiguous(),
                                w3[:, dn:].contiguous())
        return self._kv_b_split[2], self._kv_b_split[3]

    def forward(self, x, positions, *, cache: Optional[dict] = None,
                cache_at=None, backend=None, paged_kernel: str = "auto"):
        """The layer, or over a mesh (``tp``) this rank's query heads of
        it: ``q_a``, ``kv_a`` and the latent pool whole on every rank
        (each inserts the same latent), ``q_b`` column-parallel and
        ``kv_b`` cut on the rank's heads, ``o`` row-parallel.  Where the
        heads do not divide the model axis every rank attends for all of
        them on the gathered path, as the reference negotiates."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = cfg.n_heads
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        dv, lora = cfg.v_head_dim, cfg.kv_lora_rank
        scale = (dn + dr) ** -0.5
        tp = self.tp
        mesh = tp.mesh if tp is not None else None
        h0, h1 = tp.heads if tp is not None else (0, h)
        hl = h1 - h0
        whole = hl == h
        if tp is not None and not tp_supported(cfg, "paged_decode_mla",
                                               mesh.size("model")):
            paged_kernel = "gather"

        qa = _rms(self.q_a(x, backend), self.q_a_norm)
        q = reslice(self.q_b(qa, backend), self.q_b.out_slice,
                    None if whole else (h0 * (dn + dr), h1 * (dn + dr)),
                    mesh).reshape(b, s, hl, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

        kv_a = self.kv_a(x, backend)                         # [B, S, lora+dr]
        ckv = _rms(kv_a[..., :lora], self.kv_a_norm)
        krope = apply_rope(kv_a[..., lora:][:, :, None, :], positions,
                           cfg.rope_theta)[:, :, 0, :]       # shared head
        w_uk, w_uv = self.absorbed_weights()
        if w_uk.shape[0] != hl:
            w_uk, w_uv = w_uk[h0:h1], w_uv[h0:h1]

        if cache is not None:
            cache = cache_insert(cache, {"ckv": ckv, "krope": krope},
                                 cache_at)
        if s == 1 and cache is not None:
            # absorbed decode: scores and context in latent space
            q_eff = torch.einsum("bshn,hnl->bshl", q_nope.float(), w_uk)
            if is_paged(cache):
                ctx = mla_paged_decode_attend(q_eff, q_rope, cache,
                                              positions, scale=scale,
                                              mode=paged_kernel)
            else:
                ctx = _mla_absorbed_ctx(q_eff, q_rope, cache["ckv"],
                                        cache["krope"], cache["pos"],
                                        positions, scale)
            out = torch.einsum("bshl,hvl->bshv", ctx, w_uv)
        else:
            if cache is not None:
                kv = paged_view(cache) if is_paged(cache) else cache
                ckv_all, krope_all, kpos = kv["ckv"], kv["krope"], kv["pos"]
            else:
                ckv_all, krope_all, kpos = ckv, krope, positions
            if not whole:
                # the latent, whole on every rank, meets the rank's heads
                ckv_all, krope_all = (enter_parallel(t, mesh)
                                      for t in (ckv_all, krope_all))
            # decompress the latent (the reference's per-block kv_map, here
            # over the whole view at once), all in f32
            c = ckv_all.float()
            k_nope = torch.einsum("bkl,hnl->bkhn", c, w_uk)
            v = torch.einsum("bkl,hvl->bkhv", c, w_uv)
            k_full = torch.cat([k_nope, krope_all.float()[:, :, None, :]
                                .expand(-1, -1, hl, dr)], dim=-1)
            q_full = torch.cat([q_nope, q_rope], dim=-1).float()
            out = blockwise_attention(q_full, k_full, v, positions, kpos,
                                      causal=True, scale=scale)
        out = reslice(out.reshape(b, s, hl * dv).to(x.dtype),
                      None if whole else (h0 * dv, h1 * dv),
                      self.o.in_slice, mesh)
        out = self.o(out, backend)
        return (out, cache) if cache is not None else out
