"""Wrappers of the paged decode, chunked-prefill and MLA decode CUDA
kernels.

Float pools keep the reference's q handling: q is scaled in f32, then
rounded to the pool's storage dtype before the score product
(``repro/kernels/paged_attention/ops.py:60-63``).  int8 pools (with
per-slot ``k_scale``/``v_scale``) round q to the compute type instead,
bf16 as in the reference (``ops.py:104-107``), never to int8.  Chunked
prefill in bf16 runs the tensor-core kernel, which does that scaling
and rounding itself and writes the output in ``out_dtype``; in f32 the
wrapper pre-scales q and casts the f32 output as the decode wrappers
do.  On CPU
tensors the wrappers run the plain versions in ``ref``; on CUDA tensors
they launch the kernel or raise.  MLA decode keeps q_eff and q_rope in
f32, as the reference's ``paged_attention_mla`` does (no rounding to the
pool's type), and splits each row's table over ``mla_splits`` blocks of
whole pages (all of a row's heads, up to 40, in each), merged in the
kernel the same way as decode's
(``ref.paged_decode_mla_split_ref`` is the plain version of that walk).

Decode (float and int8, ``csrc/paged_decode.cu``) scales and rounds q
and writes the output in its dtype itself, as the tensor-core prefill
does, and splits each row's block table over ``decode_splits`` blocks, a
fixed rule of the batch, the kv heads, the table's width (the live pages
as the host knows them without reading the device) and the SM count.
The wrapper allocates the partials; the last block of each (row, head
group) to finish merges them in split order, counted by a per-device
buffer of int32 counters that every call leaves at 0 (so decode calls
on one device run in stream order, as the port's do).
(``ref.paged_decode_split_ref`` is the plain version of that walk.)

Every launch resolves its config through
``repro_torch.tune.dispatch.launch_config``: the decode kernels' split
count is a tuned cache entry where there is one, else ``decode_splits``
/ ``mla_splits``; ``splits=`` pins it.  Chunked prefill has no launch
choice and resolves to its one config.  The head-width caps are the
capability probe's (``dispatch.kernel_unsupported_reason``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.tune import dispatch as _dispatch
from repro_torch.tune.space import decode_problem
from . import ref as _ref

_KV_DTYPES = (torch.bfloat16, torch.float32)
_Q_DTYPES = (torch.bfloat16, torch.float32)
# the widest head the tensor-core prefill takes (csrc/paged_prefill.cuh)
MMA_MAX_HEAD_DIM = 256
# the decode kernel (csrc/paged_decode.cu): logical slots per staged tile,
# query heads per block, and the head widths it takes (D % 16 == 0, <= 256)
DECODE_TILE, DECODE_HEADS, DECODE_MAX_HEAD_DIM = 16, 8, 256
DECODE_MIN_TILES = 4


def decode_splits(b: int, hkv: int, rep: int, pages: int, bs: int,
                  sms: int) -> int:
    """How many blocks share one (row, kv head, head group)'s walk over
    its table: enough for about four blocks per SM, but at least
    ``DECODE_MIN_TILES`` 16-slot tiles a split (a block's fixed costs,
    its first round trip and its merge, stay small beside its walk);
    every split a whole number of tiles."""
    tiles = -(-pages * bs // DECODE_TILE)
    blocks = b * hkv * -(-rep // DECODE_HEADS)
    return _lib.split_count(tiles, blocks, sms, 4,
                            most=-(-tiles // DECODE_MIN_TILES))


# the MLA decode kernel (csrc/paged_attention_mla.cu): query heads per
# warp, the widest head tile (20 warps) and the widest latent it takes
MLA_HEADS_PER_WARP, MLA_MAX_TILE, MLA_MAX_LORA = 2, 40, 512


def mla_heads_per_block(h: int) -> int:
    """The MLA kernel's head tile: all of a row's heads in one block (an
    even number, the heads of its warps), up to 40."""
    return min(MLA_MAX_TILE, -(-h // MLA_HEADS_PER_WARP) * MLA_HEADS_PER_WARP)


def mla_splits(b: int, h: int, pages: int, sms: int) -> int:
    """How many blocks share one (row, head tile)'s walk over its table
    on the MLA decode kernel: enough for about one block (of up to 20
    warps) per SM, never more than the table has pages; every split a
    whole number of pages (the table's width: the host does not read how
    many are live)."""
    tiles = b * -(-h // mla_heads_per_block(h))
    return _lib.split_count(pages, tiles, sms, 1)


def _check_pool(name, q, k_pool, v_pool, pos_pool, tables, positions,
                k_scale=None, v_scale=None):
    nb, bs, hkv, d = k_pool.shape
    if q.shape[-1] != d:
        raise ValueError(f"{name}: head_dim mismatch q {q.shape[-1]} vs "
                         f"pool {d}")
    if q.shape[-2] % hkv:
        raise ValueError(f"{name}: q heads {q.shape[-2]} not a multiple "
                         f"of kv heads {hkv}")
    if v_pool.shape != k_pool.shape or tuple(pos_pool.shape) != (nb, bs):
        raise ValueError(f"{name}: pool buffers disagree on "
                         "[num_blocks, block_size]")
    int8 = k_scale is not None
    if int8 and (v_scale is None or tuple(k_scale.shape) != (nb, bs, hkv)
                 or tuple(v_scale.shape) != (nb, bs, hkv)):
        raise ValueError(f"{name}: scale pools disagree with KV pool "
                         "geometry")
    if q.device.type != "cuda":
        return
    if int8:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError(f"{name}: scaled pools must be int8, got "
                            f"{k_pool.dtype}/{v_pool.dtype}")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be float32")
    elif k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{name}: float pools must be bf16 or f32, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    extra = (k_scale, v_scale) if int8 else ()
    for t in (k_pool, v_pool, pos_pool, tables, positions) + extra:
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: pool/table operands must be "
                             "contiguous")


def _launch(kernel, qg, k_pool, v_pool, scales, pos_pool, tables,
            positions, out, b, c, hkv, rep, d, bs, pages, flag, extra=(),
            parts=()):
    """``flag``: kv_is_bf16 (float pools) or the bf16-compute flag (int8
    pools); ``extra``: the prefill launchers' (scale, q_is_bf16,
    out_is_bf16) or the decode launchers' (scale, q_is_bf16,
    out_is_bf16, splits); ``parts``: the decode launchers' split
    partials and counters (tensors or None)."""
    i32 = torch.int32
    pos_pool = pos_pool.to(i32).contiguous()
    tables = tables.to(i32).contiguous()
    positions = positions.to(i32).contiguous()
    ptrs = (qg.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr())
    if scales:
        ptrs += (scales[0].data_ptr(), scales[1].data_ptr())
    rc = getattr(_lib.lib(), f"launch_{kernel}")(
        *ptrs, pos_pool.data_ptr(), tables.data_ptr(), positions.data_ptr(),
        out.data_ptr(), *(t.data_ptr() if t is not None else None
                          for t in parts),
        b, c, hkv, rep, d, bs, pages, flag, *extra,
        _lib.stream_ptr(qg.device))
    _lib.check(rc, kernel)
    _lib.count_launch(kernel)


def _compute_dtype(k_pool, int8, compute_dtype):
    cdt = compute_dtype or (torch.bfloat16 if int8 else k_pool.dtype)
    if int8 and cdt not in _Q_DTYPES:
        raise TypeError(f"int8 pools compute in bf16 or f32, got {cdt}")
    if not int8 and cdt != k_pool.dtype:
        raise TypeError(f"float pools compute in their storage type "
                        f"{k_pool.dtype}, got {cdt}")
    return cdt


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, pos_pool: torch.Tensor,
                    tables: torch.Tensor, positions: torch.Tensor, *,
                    scale: Optional[float] = None, out_dtype=None,
                    splits: Optional[int] = None) -> torch.Tensor:
    """Fused decode attention from a float pool.  q [B, H, D];
    positions [B].  Returns [B, H, D] in ``out_dtype`` (default q.dtype).
    ``splits`` pins the table split (CUDA only)."""
    _check_pool("paged_attention", q, k_pool, v_pool, pos_pool, tables,
                positions)
    if q.device.type == "cpu":
        return _ref.paged_decode_ref(q, k_pool, v_pool, pos_pool, tables,
                                     positions, scale=scale,
                                     out_dtype=out_dtype)
    return _decode(q, k_pool, v_pool, None, pos_pool, tables, positions,
                   scale, out_dtype, k_pool.dtype, "paged_decode", splits)


def paged_attention_int8(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, k_scale: torch.Tensor,
                         v_scale: torch.Tensor, pos_pool: torch.Tensor,
                         tables: torch.Tensor, positions: torch.Tensor, *,
                         scale: Optional[float] = None, out_dtype=None,
                         compute_dtype=None,
                         splits: Optional[int] = None) -> torch.Tensor:
    """Fused int8-KV decode attention: the per-slot scales fold in the
    kernel (``decode_attend``'s ordering).  q [B, H, D] float; pools int8
    [NB, BS, Hkv, D]; k_scale / v_scale f32 [NB, BS, Hkv].  Returns
    [B, H, D].  ``splits`` pins the table split (CUDA only)."""
    _check_pool("paged_attention_int8", q, k_pool, v_pool, pos_pool,
                tables, positions, k_scale, v_scale)
    cdt = _compute_dtype(k_pool, True, compute_dtype)
    if q.device.type == "cpu":
        return _ref.paged_decode_int8_ref(
            q, k_pool, v_pool, k_scale, v_scale, pos_pool, tables,
            positions, scale=scale, out_dtype=out_dtype, compute_dtype=cdt)
    return _decode(q, k_pool, v_pool, (k_scale, v_scale), pos_pool, tables,
                   positions, scale, out_dtype, cdt, "paged_decode_int8",
                   splits)


def _decode(q, k_pool, v_pool, scales, pos_pool, tables, positions, scale,
            out_dtype, cdt, kernel, splits):
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {q.device}")
    b, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    rep = h // hkv
    pages = tables.shape[1]
    if _dispatch.kernel_unsupported_reason(
            kernel, m=h, n=pages * bs, group_size=bs, n_kv_heads=hkv,
            head_dim=d) == "head_dim":
        raise ValueError(f"{kernel}: takes head_dim % 16 == 0 and <= "
                         f"{DECODE_MAX_HEAD_DIM}, got {d}")
    scale = scale if scale is not None else d ** -0.5
    # the kernel scales and rounds q and writes the output in its dtype
    qk = (q if q.dtype in _Q_DTYPES else q.float()).contiguous()
    if qk.data_ptr() % 16:
        qk = qk.clone()
    out_dtype = out_dtype or q.dtype
    direct = out_dtype in _Q_DTYPES
    out = torch.empty((b, h, d), device=q.device,
                      dtype=out_dtype if direct else torch.float32)
    if b:
        sms, device = _dispatch.device_of(q)
        splits = _dispatch.launch_config(
            kernel, splits=splits, sms=sms, device=device,
            **decode_problem(kernel, b=b, h=h, hkv=hkv, pages=pages, bs=bs,
                             dtype=cdt)).splits
        parts = (None, None, None)
        if splits > 1:
            parts = tuple(torch.empty((splits, b, hkv, rep, n),
                                      dtype=torch.float32, device=q.device)
                          for n in (d, 2))
            parts += (_lib.split_counters(
                kernel, q.device, b * hkv * -(-rep // DECODE_HEADS)),)
        _launch(kernel, qk, k_pool, v_pool, scales, pos_pool, tables,
                positions, out, b, 1, hkv, rep, d, bs, pages,
                int(cdt == torch.bfloat16),
                (float(scale), int(qk.dtype == torch.bfloat16),
                 int(out.dtype == torch.bfloat16), splits), parts)
    return out if direct else out.to(out_dtype)


def paged_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, pos_pool: torch.Tensor,
                  tables: torch.Tensor, positions: torch.Tensor, *,
                  scale: Optional[float] = None,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None,
                  out_dtype=None, compute_dtype=None) -> torch.Tensor:
    """Fused chunked-prefill attention from the pool (the chunk is already
    inserted).  q [B, C, H, D]; positions [B, C], -1 on pad rows (which
    return zeros).  ``k_scale``/``v_scale`` (f32 [NB, BS, Hkv]) select
    the int8 kernel.  Returns [B, C, H, D]."""
    _check_pool("paged_prefill", q, k_pool, v_pool, pos_pool, tables,
                positions, k_scale, v_scale)
    b, c, h, d = q.shape
    if tuple(positions.shape) != (b, c):
        raise ValueError("positions must be [B, C] for chunked prefill")
    int8 = k_scale is not None
    cdt = _compute_dtype(k_pool, int8, compute_dtype)
    if q.device.type == "cpu":
        return _ref.paged_prefill_ref(q, k_pool, v_pool, pos_pool, tables,
                                      positions, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale,
                                      out_dtype=out_dtype, compute_dtype=cdt)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill: unsupported device {q.device}")
    nb, bs, hkv, _ = k_pool.shape
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    kernel = "paged_prefill_int8" if int8 else "paged_prefill"
    scales = (k_scale, v_scale) if int8 else None
    pages = tables.shape[1]
    out_dtype = out_dtype or q.dtype
    if _dispatch.kernel_unsupported_reason(
            kernel, m=h, n=pages * bs, group_size=bs, n_kv_heads=hkv,
            head_dim=d, bf16=cdt == torch.bfloat16) == "head_dim":
        raise ValueError(f"paged_prefill: bf16 compute takes head_dim "
                         f"<= {MMA_MAX_HEAD_DIM}, got {d}")
    if b and c:
        # no launch choice: the one config, resolved like every launch's
        sms, device = _dispatch.device_of(q)
        _dispatch.launch_config(kernel, sms=sms, device=device, b=b, m=hkv,
                                n=pages * bs, dtype=cdt, mu=rep,
                                group_size=bs)
    if cdt == torch.bfloat16:
        # the tensor-core kernel scales and rounds q and writes the output
        # in its dtype itself: no pass of the wrapper's own
        qk = (q if q.dtype in _Q_DTYPES else q.float()).contiguous()
        direct = out_dtype in _Q_DTYPES
        out = torch.empty((b, c, h, d), device=q.device,
                          dtype=out_dtype if direct else torch.float32)
        if b and c:
            _launch(kernel, qk, k_pool, v_pool, scales, pos_pool, tables,
                    positions, out, b, c, hkv, rep, d, bs, pages, 1,
                    (float(scale), int(qk.dtype == torch.bfloat16),
                     int(out.dtype == torch.bfloat16)))
        return out if direct else out.to(out_dtype)
    # f32 compute (the CUDA-core body): q pre-scaled in f32, f32 out
    qg = (q.reshape(b, c, hkv, rep, d).float() * scale).contiguous()
    out = torch.empty((b, c, hkv, rep, d), dtype=torch.float32,
                      device=q.device)
    if b and c:
        _launch(kernel, qg, k_pool, v_pool, scales, pos_pool, tables,
                positions, out, b, c, hkv, rep, d, bs, pages, 0,
                (1.0, 0, 0))
    return out.reshape(b, c, h, d).to(out_dtype)


def paged_attention_mla(q_eff: torch.Tensor, q_rope: torch.Tensor,
                        ckv_pool: torch.Tensor, krope_pool: torch.Tensor,
                        pos_pool: torch.Tensor, tables: torch.Tensor,
                        positions: torch.Tensor, *, scale: float,
                        splits: Optional[int] = None) -> torch.Tensor:
    """Fused absorbed MLA decode over the latent pool.  q_eff: f32 [B, H,
    lora] (``w_uk`` absorbed by the caller); q_rope: f32 [B, H,
    rope_dim]; ckv_pool [NB, BS, lora], krope_pool [NB, BS, rope_dim]
    (bf16 or f32, one type); pos_pool int32 [NB, BS]; tables int32 [B,
    pages]; positions int32 [B].  Returns the latent context, f32 [B, H,
    lora].  ``splits`` pins the table split (CUDA only)."""
    name = "paged_attention_mla"
    b, h, lora = q_eff.shape
    nb, bs = pos_pool.shape
    dr = q_rope.shape[-1]
    if tuple(q_rope.shape) != (b, h, dr):
        raise ValueError(f"{name}: q_rope {tuple(q_rope.shape)} disagrees "
                         f"with q_eff {tuple(q_eff.shape)}")
    if tuple(ckv_pool.shape) != (nb, bs, lora):
        raise ValueError(f"{name}: ckv pool {tuple(ckv_pool.shape)} "
                         f"disagrees with q_eff lora {lora} / pos pool")
    if tuple(krope_pool.shape) != (nb, bs, dr):
        raise ValueError(f"{name}: krope pool {tuple(krope_pool.shape)} "
                         f"disagrees with q_rope / pos pool")
    if tables.shape[0] != b or tuple(positions.shape) != (b,):
        raise ValueError(f"{name}: tables / positions disagree with B={b}")
    if q_eff.device.type == "cpu":
        return _ref.paged_decode_mla_ref(q_eff, q_rope, ckv_pool, krope_pool,
                                         pos_pool, tables, positions,
                                         scale=scale)
    if q_eff.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q_eff.device}")
    if q_eff.dtype != torch.float32 or q_rope.dtype != torch.float32:
        raise TypeError(f"{name}: q_eff and q_rope must be float32, got "
                        f"{q_eff.dtype}/{q_rope.dtype}")
    if ckv_pool.dtype not in _KV_DTYPES or krope_pool.dtype != ckv_pool.dtype:
        raise TypeError(f"{name}: latent pools must be bf16 or f32 (one "
                        f"type), got {ckv_pool.dtype}/{krope_pool.dtype}")
    if pos_pool.dtype != torch.int32 or tables.dtype != torch.int32 \
            or positions.dtype != torch.int32:
        raise TypeError(f"{name}: pos pool, tables and positions must be "
                        "int32")
    for t in (q_rope, ckv_pool, krope_pool, pos_pool, tables, positions):
        if t.device != q_eff.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{q_eff.device}")
    for t in (q_eff, q_rope, ckv_pool, krope_pool, pos_pool, tables,
              positions):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    pages = tables.shape[1]
    if _dispatch.kernel_unsupported_reason(
            "paged_decode_mla", m=h, n=pages * bs, group_size=bs,
            lora=lora) == "head_dim":
        raise ValueError(f"{name}: takes kv_lora_rank <= {MLA_MAX_LORA}, "
                         f"got {lora}")
    out = torch.empty((b, h, lora), dtype=torch.float32,
                      device=q_eff.device)
    if b and h:
        hb = mla_heads_per_block(h)
        sms, device = _dispatch.device_of(q_eff)
        splits = _dispatch.launch_config(
            "paged_decode_mla", splits=splits, sms=sms, device=device,
            **decode_problem("paged_decode_mla", b=b, h=h, hkv=h,
                             pages=pages, bs=bs, dtype=ckv_pool.dtype)).splits
        part_o = part_ml = sem = None
        if splits > 1:
            part_o = torch.empty((splits, b, h, lora), dtype=torch.float32,
                                 device=q_eff.device)
            part_ml = torch.empty((splits, b, h, 2), dtype=torch.float32,
                                  device=q_eff.device)
            sem = _lib.split_counters("paged_decode_mla", q_eff.device,
                                      b * -(-h // hb))
        rc = _lib.lib().launch_paged_decode_mla(
            q_eff.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
            krope_pool.data_ptr(), pos_pool.data_ptr(), tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None
              for t in (part_o, part_ml, sem)),
            b, h, lora, dr, bs, pages, float(scale),
            int(ckv_pool.dtype == torch.bfloat16), hb, splits,
            _lib.stream_ptr(q_eff.device))
        _lib.check(rc, "paged_decode_mla")
        _lib.count_launch("paged_decode_mla")
    return out
