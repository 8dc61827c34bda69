"""Plain versions of paged decode and chunked prefill (float and int8
pools) and of absorbed MLA decode over a latent pool.

Counterpart of ``repro.kernels.paged_attention.ref``: gather the
per-sequence view of the pool through the block table, then attend with
a full masked softmax and f32 accumulation.  A slot is live iff its
table entry is allocated, its stored position equals its logical view
index, and it is causally visible; rows with no live slot return zeros.

int8 pools follow ``decode_attend``'s ordering: scores are computed from
q and K in the compute type (bf16, as the reference), multiplied by the
per-slot ``k_scale`` before the softmax, and the normalized
probabilities are multiplied by ``v_scale`` and rounded to the compute
type before the PV product.  ``compute_dtype`` may be set to f32 to
check the arithmetic without bf16 rounding.

``paged_decode_split_ref`` is the plain version of the decode kernel's
walk (``csrc/paged_decode.cu``): the table cut into splits of whole
16-slot tiles, partial (max, sum, accumulator) per split, and a merge in
split order in which a split with no live slot counts as empty.
``paged_decode_mla_split_ref`` is the same for the MLA decode kernel
(``csrc/paged_attention_mla.cu``), whose splits are whole pages.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gather_view(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[NB, BS, ...] pool + [B, pages] tables -> [B, pages*BS, ...]."""
    b, pages = tables.shape
    bs = pool.shape[1]
    safe = torch.clamp(tables, min=0).reshape(-1).long()
    g = pool.index_select(0, safe)
    return g.reshape(b, pages * bs, *pool.shape[2:])


def _live(pos_pool, tables):
    b, pages = tables.shape
    bs = pos_pool.shape[1]
    vpos = gather_view(pos_pool, tables)                       # [B, L]
    allocated = torch.repeat_interleave(tables >= 0, bs, dim=1)
    iota = torch.arange(pages * bs, dtype=vpos.dtype,
                        device=vpos.device)[None]
    return allocated & (vpos == iota), vpos


def paged_decode_ref(q, k_pool, v_pool, pos_pool, tables, positions, *,
                     scale=None, out_dtype=None):
    """q: [B, H, D]; pools [NB, BS, Hkv, D]; pos_pool [NB, BS]; tables
    [B, pages]; positions [B].  Returns [B, H, D]."""
    b, h, d = q.shape
    hkv = k_pool.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    kv = gather_view(k_pool, tables)
    vv = gather_view(v_pool, tables)
    live, vpos = _live(pos_pool, tables)
    ok = live & (vpos <= positions[:, None])
    qg = (q.reshape(b, hkv, rep, d).float() * scale).to(k_pool.dtype)
    s = torch.einsum("bhrd,blhd->bhrl", qg.float(), kv.float())
    okb = ok[:, None, None, :]
    s = torch.where(okb, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(okb, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1)
    out = torch.einsum("bhrl,blhd->bhrd", p.to(v_pool.dtype).float(),
                       vv.float())
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(out_dtype or q.dtype)


def paged_decode_int8_ref(q, k_pool, v_pool, k_scale, v_scale, pos_pool,
                          tables, positions, *, scale=None, out_dtype=None,
                          compute_dtype=torch.bfloat16):
    """int8-KV decode.  q: [B, H, D] float; pools int8 [NB, BS, Hkv, D];
    k_scale / v_scale f32 [NB, BS, Hkv].  Returns [B, H, D]."""
    b, h, d = q.shape
    hkv = k_pool.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    kv = gather_view(k_pool, tables).float()                # [B, L, Hkv, D]
    vv = gather_view(v_pool, tables).float()
    ksv = gather_view(k_scale, tables).transpose(1, 2)      # [B, Hkv, L]
    vsv = gather_view(v_scale, tables).transpose(1, 2)
    live, vpos = _live(pos_pool, tables)
    ok = live & (vpos <= positions[:, None])
    qg = (q.reshape(b, hkv, rep, d).float() * scale).to(compute_dtype)
    s = torch.einsum("bhrd,blhd->bhrl", qg.float(), kv)
    s = s * ksv[:, :, None, :]                               # dequant fold
    okb = ok[:, None, None, :]
    s = torch.where(okb, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(okb, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1)
    p = p / torch.clamp(l, min=1e-30)[..., None]             # softmax first
    p = p * vsv[:, :, None, :]                               # then v_scale
    out = torch.einsum("bhrl,blhd->bhrd", p.to(compute_dtype).float(), vv)
    return out.reshape(b, h, d).to(out_dtype or q.dtype)


def paged_decode_mla_ref(q_eff, q_rope, ckv_pool, krope_pool, pos_pool,
                         tables, positions, *, scale):
    """Absorbed MLA decode.  q_eff: f32 [B, H, lora]; q_rope: f32 [B, H,
    rope_dim]; latent pools [NB, BS, lora] / [NB, BS, rope_dim].  Returns
    the latent context, f32 [B, H, lora] (the caller applies ``w_uv``)."""
    ckv = gather_view(ckv_pool, tables).float()               # [B, L, lora]
    kr = gather_view(krope_pool, tables).float()              # [B, L, dr]
    live, vpos = _live(pos_pool, tables)
    ok = (live & (vpos <= positions[:, None]))[:, None, :]    # [B, 1, L]
    s = (torch.einsum("bhl,bkl->bhk", q_eff.float(), ckv)
         + torch.einsum("bhr,bkr->bhk", q_rope.float(), kr)) * scale
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("bhk,bkl->bhl", p, ckv)


def mla_split_partials(q_eff, q_rope, ckv_pool, krope_pool, pos_pool,
                       tables, positions, splits, *, scale):
    """The MLA decode kernel's split walk: the table's pages cut into
    ``splits`` ranges of whole pages; per range its max m over the live
    scores, l = sum exp(s - m) and acc = sum exp(s - m) ckv, all f32.
    Returns (m, l) [S, B, H] and acc [S, B, H, lora]; a range with no
    live slot gives m = NEG_INF, l = 0, acc = 0."""
    ckv = gather_view(ckv_pool, tables).float()               # [B, L, lora]
    kr = gather_view(krope_pool, tables).float()
    live, vpos = _live(pos_pool, tables)
    ok = (live & (vpos <= positions[:, None]))[:, None, :]    # [B, 1, L]
    s = (torch.einsum("bhl,bkl->bhk", q_eff.float(), ckv)
         + torch.einsum("bhr,bkr->bhk", q_rope.float(), kr)) * scale
    pages, bs = tables.shape[1], pos_pool.shape[1]
    per = -(-pages // splits)
    if -(-pages // per) != splits:
        raise ValueError(f"{splits} splits of {pages} pages leave one empty "
                         "by construction")
    ms, ls, accs = [], [], []
    for sp in range(splits):
        lo, hi = sp * per * bs, min((sp + 1) * per * bs, pages * bs)
        okr = ok[..., lo:hi]
        sr = torch.where(okr, s[..., lo:hi], torch.full_like(s[..., lo:hi],
                                                             NEG_INF))
        m = sr.amax(-1)
        p = torch.where(okr, torch.exp(sr - m[..., None]),
                        torch.zeros_like(sr))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhk,bkl->bhl", p, ckv[:, lo:hi]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def paged_decode_mla_split_ref(q_eff, q_rope, ckv_pool, krope_pool, pos_pool,
                               tables, positions, splits, *, scale):
    """Absorbed MLA decode by the kernel's split-and-merge walk.  Returns
    the latent context, f32 [B, H, lora]."""
    return merge_split_partials(*mla_split_partials(
        q_eff, q_rope, ckv_pool, krope_pool, pos_pool, tables, positions,
        splits, scale=scale))


def paged_prefill_ref(q, k_pool, v_pool, pos_pool, tables, positions, *,
                      scale=None, k_scale=None, v_scale=None,
                      out_dtype=None, compute_dtype=None):
    """q: [B, C, H, D]; positions [B, C] (-1 on pad rows, which return
    zeros).  ``k_scale``/``v_scale`` (f32 [NB, BS, Hkv]) select the int8
    fold, computed in ``compute_dtype`` (default bf16; float pools use
    their storage type).  Returns [B, C, H, D]."""
    b, c, h, d = q.shape
    hkv = k_pool.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    int8 = k_scale is not None
    cdt = compute_dtype or (torch.bfloat16 if int8 else k_pool.dtype)
    kv = gather_view(k_pool, tables)
    vv = gather_view(v_pool, tables)
    live, vpos = _live(pos_pool, tables)
    ok = live[:, None, :] & (vpos[:, None, :] <= positions[:, :, None])
    qg = (q.reshape(b, c, hkv, rep, d).float() * scale).to(cdt)
    s = torch.einsum("bchrd,blhd->bchrl", qg.float(), kv.float())
    if int8:
        ksv = gather_view(k_scale, tables).transpose(1, 2)  # [B, Hkv, L]
        s = s * ksv[:, None, :, None, :]
    okb = ok[:, :, None, None, :]
    s = torch.where(okb, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(okb, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1)
    p = p / torch.clamp(l, min=1e-30)[..., None]
    if int8:
        vsv = gather_view(v_scale, tables).transpose(1, 2)
        p = p * vsv[:, None, :, None, :]
    out = torch.einsum("bchrl,blhd->bchrd", p.to(cdt).float(), vv.float())
    return out.reshape(b, c, h, d).to(out_dtype or q.dtype)


def decode_split_partials(q, k_pool, v_pool, pos_pool, tables, positions,
                          splits, *, scale=None, k_scale=None, v_scale=None,
                          compute_dtype=None, tile=16):
    """The decode kernel's split walk: the table's logical slots cut into
    ``splits`` ranges of whole ``tile``-slot tiles; per range its max m
    over the live scores, l = sum exp(s - m) and acc = sum round(p [*
    v_scale]) v with p = exp(s - m), rounded to the compute type as the
    kernel rounds it.  Returns (m, l) [S, B, Hkv, rep] and acc [S, B, Hkv,
    rep, D], f32; a range with no live slot gives m = NEG_INF, l = 0,
    acc = 0."""
    b, h, d = q.shape
    hkv = k_pool.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    int8 = k_scale is not None
    cdt = compute_dtype or (torch.bfloat16 if int8 else k_pool.dtype)
    kv = gather_view(k_pool, tables).float()                # [B, L, Hkv, D]
    vv = gather_view(v_pool, tables).float()
    live, vpos = _live(pos_pool, tables)
    ok = (live & (vpos <= positions[:, None]))[:, None, None, :]
    qg = (q.reshape(b, hkv, rep, d).float() * scale).to(cdt)
    s = torch.einsum("bhrd,blhd->bhrl", qg.float(), kv)
    if int8:
        s = s * gather_view(k_scale, tables).transpose(1, 2)[:, :, None, :]
        vsv = gather_view(v_scale, tables).transpose(1, 2)[:, :, None, :]
    n = tables.shape[1] * k_pool.shape[1]
    tiles = -(-n // tile)
    per = -(-tiles // splits)
    if -(-tiles // per) != splits:
        raise ValueError(f"{splits} splits of {tiles} tiles leave one empty "
                         "by construction")
    ms, ls, accs = [], [], []
    for sp in range(splits):
        lo, hi = sp * per * tile, min((sp + 1) * per * tile, n)
        okr = ok[..., lo:hi]
        sr = torch.where(okr, s[..., lo:hi], torch.full_like(s[..., lo:hi],
                                                             NEG_INF))
        m = sr.amax(-1)
        p = torch.where(okr, torch.exp(sr - m[..., None]),
                        torch.zeros_like(sr))
        ls.append(p.sum(-1))
        if int8:
            p = p * vsv[..., lo:hi]
        accs.append(torch.einsum("bhrl,blhd->bhrd", p.to(cdt).float(),
                                 vv[:, lo:hi]))
        ms.append(m)
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_split_partials(m, l, acc):
    """Out = sum_s acc_s e_s / sum_s l_s e_s, e_s = exp(m_s - max m),
    summed in split order; a row with no live slot gives 0."""
    mx = m.amax(0)
    out = torch.zeros_like(acc[0])
    tot = torch.zeros_like(l[0])
    for sp in range(m.shape[0]):
        f = torch.exp(m[sp] - mx)
        tot = tot + l[sp] * f
        out = out + acc[sp] * f[..., None]
    return out / torch.clamp(tot, min=1e-30)[..., None]


def paged_decode_split_ref(q, k_pool, v_pool, pos_pool, tables, positions,
                           splits, *, scale=None, k_scale=None, v_scale=None,
                           out_dtype=None, compute_dtype=None):
    """Decode (float pools, or int8 pools with ``k_scale``/``v_scale``) by
    the kernel's split-and-merge walk.  Returns [B, H, D]."""
    b, h, d = q.shape
    parts = decode_split_partials(q, k_pool, v_pool, pos_pool, tables,
                                  positions, splits, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale,
                                  compute_dtype=compute_dtype)
    out = merge_split_partials(*parts)
    return out.reshape(b, h, d).to(out_dtype or q.dtype)
