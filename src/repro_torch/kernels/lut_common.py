"""Shared LUT math (FIGLUT §III-C/D/E) in plain PyTorch.

Counterpart of ``repro.kernels.lut_common``: the sign matrix, the LUT
build, mu-bit key extraction from packed planes, the half-table
sign-decoding read and the ternary (sign, mask) -> (b1, b2) byte decode.
The CUDA kernels (``csrc/lut_gemm.cu``, ``csrc/ternary_matmul.cu``) do
the same math in shared memory and registers; these functions are their
plain versions' pieces.

``read_mode`` (select / onehot / gather) names TPU lowerings of the
keyed read.  On the card a direct keyed shared-memory read is the RAC,
so every mode computes the same values here and in the kernel.
"""
from __future__ import annotations

import torch

READ_MODES = ("select", "onehot", "gather")


def sign_matrix(mu: int, half: bool, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """±1 sign matrix [P, mu]: entry (p, j) is bit j of the pattern."""
    rows = (1 << (mu - 1)) if half else (1 << mu)
    base = (1 << (mu - 1)) if half else 0
    p = torch.arange(rows, device=device)[:, None] + base
    j = torch.arange(mu, device=device)[None, :]
    return (((p >> j) & 1) * 2 - 1).to(dtype)


def build_lut(x: torch.Tensor, mu: int, half: bool) -> torch.Tensor:
    """Activations [B, N] -> LUT [B, N // mu, P] of signed mu-sums."""
    b, n = x.shape
    s = sign_matrix(mu, half, torch.float32, x.device)
    return (x.float().reshape(b, n // mu, mu) @ s.T)


def extract_keys(packed: torch.Tensor, mu: int) -> torch.Tensor:
    """uint8 [..., nb] plane bytes -> int64 keys [..., nb * 8 // mu]."""
    per_byte = 8 // mu
    p = packed.to(torch.int64)
    keys = torch.stack([(p >> (s * mu)) & ((1 << mu) - 1)
                        for s in range(per_byte)], dim=-1)
    return keys.reshape(*packed.shape[:-1], packed.shape[-1] * per_byte)


def read_lut(lut: torch.Tensor, keys: torch.Tensor, mu: int,
             half: bool) -> torch.Tensor:
    """vals[b, m, u] = LUT[b, u, key[m, u]] (sign-decoded when half)."""
    if half:
        hsz = 1 << (mu - 1)
        msb = keys >= hsz
        idx = torch.where(msb, keys - hsz, (hsz - 1) - keys)
        sign = torch.where(msb, 1.0, -1.0).to(lut.dtype)
    else:
        idx, sign = keys, None
    b, u, p = lut.shape
    m = keys.shape[0]
    vals = torch.gather(lut[:, None].expand(b, m, u, p), 3,
                        idx[None, :, :, None].expand(b, m, u, 1))[..., 0]
    if sign is not None:
        vals = vals * sign[None]
    return vals


def ternary_plane_bytes(sign_byte: torch.Tensor, mask_byte: torch.Tensor):
    """A ternary bundle's (sign, mask) bytes -> BCQ plane bytes (b1, b2).

    w = (a/2)(b1 + b2) with b1 = mask ? sign : +1 and b2 = mask ? sign :
    -1; on the packed bit level (bit 1 = +1) that is b1 = sign | ~mask
    and b2 = sign & mask.  Returns uint8 planes for :func:`extract_keys`.
    """
    s = sign_byte.to(torch.uint8)
    m = mask_byte.to(torch.uint8)
    return s | ~m, s & m
