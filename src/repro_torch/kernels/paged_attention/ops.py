"""Wrappers of the float paged decode and chunked-prefill CUDA kernels.

Both keep the reference's q handling: q is scaled in f32, then rounded
to the pool's storage dtype before the score product
(``repro/kernels/paged_attention/ops.py:60-63``).  On CPU tensors they
run the plain versions in ``ref``; on CUDA tensors they launch the
kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from . import ref as _ref

_KV_DTYPES = (torch.bfloat16, torch.float32)


def _check_pool(name, q, k_pool, v_pool, pos_pool, tables, positions):
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
    if q.device.type == "cuda":
        if k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
            raise TypeError(f"{name}: float pools must be bf16 or f32, got "
                            f"{k_pool.dtype}/{v_pool.dtype}")
        for t in (k_pool, v_pool, pos_pool, tables, positions):
            if t.device != q.device:
                raise ValueError(f"{name}: operands on {t.device} and "
                                 f"{q.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: pool/table operands must be "
                                 "contiguous")


def _launch(fn_name, counter, qg, k_pool, v_pool, pos_pool, tables,
            positions, out, b, c, hkv, rep, d, bs, pages):
    i32 = torch.int32
    pos_pool = pos_pool.to(i32).contiguous()
    tables = tables.to(i32).contiguous()
    positions = positions.to(i32).contiguous()
    rc = getattr(_lib.lib(), fn_name)(
        qg.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos_pool.data_ptr(), tables.data_ptr(), positions.data_ptr(),
        out.data_ptr(), b, c, hkv, rep, d, bs, pages,
        int(k_pool.dtype == torch.bfloat16), _lib.stream_ptr(qg.device))
    _lib.check(rc, counter)
    _lib.count_launch(counter)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, pos_pool: torch.Tensor,
                    tables: torch.Tensor, positions: torch.Tensor, *,
                    scale: Optional[float] = None,
                    out_dtype=None) -> torch.Tensor:
    """Fused decode attention from the pool.  q [B, H, D]; positions [B].
    Returns [B, H, D] in ``out_dtype`` (default q.dtype)."""
    _check_pool("paged_attention", q, k_pool, v_pool, pos_pool, tables,
                positions)
    if q.device.type == "cpu":
        return _ref.paged_decode_ref(q, k_pool, v_pool, pos_pool, tables,
                                     positions, scale=scale,
                                     out_dtype=out_dtype)
    b, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = (q.reshape(b, hkv, rep, d).float() * scale).to(k_pool.dtype)
    qg = qg.contiguous()
    out = torch.empty((b, hkv, rep, d), dtype=torch.float32, device=q.device)
    if b:
        _launch("launch_paged_decode", "paged_decode", qg, k_pool, v_pool,
                pos_pool, tables, positions, out, b, 1, hkv, rep, d, bs,
                tables.shape[1])
    return out.reshape(b, h, d).to(out_dtype or q.dtype)


def paged_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, pos_pool: torch.Tensor,
                  tables: torch.Tensor, positions: torch.Tensor, *,
                  scale: Optional[float] = None,
                  out_dtype=None) -> torch.Tensor:
    """Fused chunked-prefill attention from the pool (the chunk is already
    inserted).  q [B, C, H, D]; positions [B, C], -1 on pad rows (which
    return zeros).  Returns [B, C, H, D]."""
    _check_pool("paged_prefill", q, k_pool, v_pool, pos_pool, tables,
                positions)
    b, c, h, d = q.shape
    if tuple(positions.shape) != (b, c):
        raise ValueError("positions must be [B, C] for chunked prefill")
    if q.device.type == "cpu":
        return _ref.paged_prefill_ref(q, k_pool, v_pool, pos_pool, tables,
                                      positions, scale=scale,
                                      out_dtype=out_dtype)
    nb, bs, hkv, _ = k_pool.shape
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = (q.reshape(b, c, hkv, rep, d).float() * scale).to(k_pool.dtype)
    qg = qg.contiguous()
    out = torch.empty((b, c, hkv, rep, d), dtype=torch.float32,
                      device=q.device)
    if b and c:
        _launch("launch_paged_prefill", "paged_prefill", qg, k_pool, v_pool,
                pos_pool, tables, positions, out, b, c, hkv, rep, d, bs,
                tables.shape[1])
    return out.reshape(b, c, h, d).to(out_dtype or q.dtype)
