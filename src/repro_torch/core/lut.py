"""LUT construction and keying for the LUT-based FP-INT GEMM (FIGLUT
§III-A/D/E), host-side, in plain PyTorch.

Counterpart of ``repro.core.lut``.  For activations split into groups
of ``mu`` consecutive elements, the table of group G holds every signed
combination

    LUT[G, p] = sum_{j<mu} sign_j(p) * x[G*mu + j],
    sign_j(p) = +1 if bit j of p is set else -1,   p in [0, 2^mu)

so one weight row's contribution over the group is one read keyed by
its mu-bit pattern (bit j <-> input G*mu + j, LSB-first, as
``plane.pack_planes`` packs).  The table is odd-symmetric, LUT[p] =
-LUT[2^mu - 1 - p], so the half table (hFFLUT, §III-D) keeps the MSB=1
rows and :func:`decode_half_lut` restores the rest by a sign.  The
generator's adder count (§III-E) is :func:`generator_adder_count`: 14
adds at mu 4 for the half table, against 24 built entry by entry.

The kernels' plain versions (``kernels/lut_common.py``) build on these.
"""
from __future__ import annotations

import torch

__all__ = ["sign_matrix", "build_lut", "build_half_lut", "decode_half_lut",
           "extract_keys", "keys_from_packed", "generator_adder_count",
           "naive_adder_count"]


def sign_matrix(mu: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """S[p, j] = ±1 by bit j of p, [2^mu, mu]: the LUT is x_groups @ S^T."""
    p = torch.arange(1 << mu, device=device)[:, None]
    j = torch.arange(mu, device=device)[None, :]
    return (((p >> j) & 1) * 2 - 1).to(dtype)


def _groups(x: torch.Tensor, mu: int) -> torch.Tensor:
    n = x.shape[-1]
    if n % mu:
        raise ValueError(f"N={n} not divisible by mu={mu}")
    return x.reshape(*x.shape[:-1], n // mu, mu)


def build_lut(x: torch.Tensor, mu: int) -> torch.Tensor:
    """Full tables: x [..., N] -> [..., N // mu, 2^mu] in x's dtype."""
    return _groups(x, mu) @ sign_matrix(mu, x.dtype, x.device).T


def build_half_lut(x: torch.Tensor, mu: int) -> torch.Tensor:
    """The MSB=1 half: [..., N // mu, 2^(mu-1)], half[.., h] =
    LUT[.., h + 2^(mu-1)]."""
    s = sign_matrix(mu, x.dtype, x.device)[(1 << (mu - 1)):]
    return _groups(x, mu) @ s.T


def decode_half_lut(half: torch.Tensor, keys: torch.Tensor,
                    mu: int) -> torch.Tensor:
    """Read a half table (the paper's Fig. 10 decoder): half [..., G,
    2^(mu-1)], keys int [..., G] in [0, 2^mu); value = half[key - H] if
    the MSB is set, else -half[H - 1 - key], H = 2^(mu-1)."""
    hsz = 1 << (mu - 1)
    keys = keys.long()
    msb = keys >= hsz
    idx = torch.where(msb, keys - hsz, hsz - 1 - keys)
    vals = torch.gather(half, -1, idx[..., None])[..., 0]
    return torch.where(msb, vals, -vals)


def extract_keys(planes_pm1: torch.Tensor, mu: int) -> torch.Tensor:
    """Keys from ±1 planes: [q, out, N] -> int32 [q, out, N // mu]."""
    q, out, n = planes_pm1.shape
    bits = (planes_pm1 > 0).to(torch.int32).reshape(q, out, n // mu, mu)
    shifts = torch.arange(mu, dtype=torch.int32, device=bits.device)
    return (bits << shifts).sum(-1, dtype=torch.int32)


def keys_from_packed(packed: torch.Tensor, mu: int) -> torch.Tensor:
    """mu-bit keys straight from uint8 planes: [..., N // 8] -> int32
    [..., N // mu]; mu must divide 8."""
    if 8 % mu:
        raise ValueError(f"mu={mu} must divide 8 for byte-packed keys")
    per_byte = 8 // mu
    p = packed.to(torch.int32)
    shifts = torch.arange(per_byte, dtype=torch.int32,
                          device=p.device) * mu
    keys = (p[..., None] >> shifts) & ((1 << mu) - 1)
    return keys.reshape(*packed.shape[:-1], packed.shape[-1] * per_byte)


# ---------------------------------------------------------------------------
# generator cost model (§III-E, Fig. 11)
# ---------------------------------------------------------------------------


def naive_adder_count(mu: int, half: bool = True) -> int:
    """Adds to build each entry on its own: mu - 1 per entry."""
    entries = 1 << (mu - 1) if half else 1 << mu
    return entries * (mu - 1)


def generator_adder_count(mu: int, half: bool = True) -> int:
    """Adds of the two-step tree generator: the signed combinations of
    the low floor(mu/2) inputs and of the high ceil(mu/2) inputs (MSB
    fixed to + for the half table) are built once, then each entry is
    one add of a high and a low combination.  mu 4, half: 4 + 2 + 8 =
    14, the paper's count (24 built entry by entry)."""
    lo = mu // 2
    hi = mu - lo
    lo_adds = (1 << lo) * (lo - 1) if lo > 1 else 0
    hi_patterns = 1 << (hi - 1) if half else 1 << hi
    hi_adds = hi_patterns * (hi - 1) if hi > 1 else 0
    final = 1 << (mu - 1) if half else 1 << mu
    return lo_adds + hi_adds + final
