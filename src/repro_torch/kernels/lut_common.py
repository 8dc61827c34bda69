"""Shared LUT math (FIGLUT §III-C/D/E) in plain PyTorch.

Counterpart of ``repro.kernels.lut_common``: the sign matrix, the LUT
build, mu-bit key extraction from packed planes, the half-table
sign-decoding read and the ternary (sign, mask) -> (b1, b2) byte decode.
The CUDA kernels (``csrc/lut_gemm.cu``, ``csrc/ternary_matmul.cu``) do
the same math in shared memory and registers; these functions are their
plain versions' pieces, built on the host LUT math of
:mod:`repro_torch.core.lut`.

``read_mode`` (select / onehot / gather) names TPU lowerings of the
keyed read.  On the card a direct keyed shared-memory read is the RAC,
so every mode computes the same values here and in the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut as core_lut

READ_MODES = ("select", "onehot", "gather")


def sign_matrix(mu: int, half: bool, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """±1 sign matrix [P, mu]: entry (p, j) is bit j of the pattern (the
    MSB=1 rows when ``half``)."""
    s = core_lut.sign_matrix(mu, dtype, device)
    return s[(1 << (mu - 1)):] if half else s


def build_lut(x: torch.Tensor, mu: int, half: bool) -> torch.Tensor:
    """Activations [B, N] -> f32 LUT [B, N // mu, P] of signed mu-sums."""
    build = core_lut.build_half_lut if half else core_lut.build_lut
    return build(x.float(), mu)


def extract_keys(packed: torch.Tensor, mu: int) -> torch.Tensor:
    """uint8 [..., nb] plane bytes -> int64 keys [..., nb * 8 // mu]."""
    return core_lut.keys_from_packed(packed, mu).long()


def read_lut(lut: torch.Tensor, keys: torch.Tensor, mu: int,
             half: bool) -> torch.Tensor:
    """vals[b, m, u] = LUT[b, u, key[m, u]] (sign-decoded when half)."""
    b, u, p = lut.shape
    m = keys.shape[0]
    table = lut[:, None].expand(b, m, u, p)
    keys = keys[None].expand(b, m, u)
    if half:
        return core_lut.decode_half_lut(table, keys, mu)
    return torch.gather(table, 3, keys[..., None])[..., 0]


def ternary_plane_bytes(sign_byte: torch.Tensor, mask_byte: torch.Tensor):
    """A ternary bundle's (sign, mask) bytes -> BCQ plane bytes (b1, b2).

    w = (a/2)(b1 + b2) with b1 = mask ? sign : +1 and b2 = mask ? sign :
    -1; on the packed bit level (bit 1 = +1) that is b1 = sign | ~mask
    and b2 = sign & mask.  Returns uint8 planes for :func:`extract_keys`.
    """
    s = sign_byte.to(torch.uint8)
    m = mask_byte.to(torch.uint8)
    return s | ~m, s & m
