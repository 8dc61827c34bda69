"""Counter-based random numbers, bit for bit as ``jax.random`` draws them.

The serving engines derive a sampling key per request and token
(``serve.engine.request_key``) and draw the Gumbel noise of
``models.model.sample_tokens`` from it.  The reference does both with
``jax.random`` under its default implementation: Threefry-2x32 (20
rounds) with the partitionable counter layout
(``jax_threefry_partitionable = True``, the default since JAX 0.5).
This module computes the same functions in plain PyTorch, so the port's
keys and sampled tokens equal the reference's:

  * a key is the pair of uint32 words ``[k0, k1]``, held in an int64
    tensor (``[..., 2]``; every value in ``[0, 2**32)``);
  * ``PRNGKey(seed)`` is ``[0, seed & 0xFFFFFFFF]`` (JAX without x64
    takes the seed as 32 bits; negative and wider seeds wrap);
  * ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
  * the ``i``-th of ``n`` random 32-bit words under a key is ``y0 ^ y1``
    with ``(y0, y1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
  * a uniform float32 in ``[minval, maxval)`` takes the top 23 bits of a
    word as the mantissa of a float in ``[1, 2)``, less 1, scaled and
    shifted in float32 and floored at ``minval``;
  * Gumbel noise is ``-log(-log(u))`` with ``u`` uniform in ``[tiny,
    1)`` (JAX's ``mode="low"``, its default);
  * ``categorical(key, logits)`` is ``argmax(gumbel + logits)``, ties
    to the lowest index.

The Threefry block runs on Python ints, numpy integers or int64 tensors
alike (every step masks to 32 bits), on any device; a CPU and a CUDA
tensor give the same words.  ``log`` is the device's own: on the CPU
the inner ``log`` lands within 1 ulp of XLA's and the noise within 2
ulp of ``max(|g|, 1)``; the tests bound that and pin the bits, keys and
counter layout against the installed JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRNGKey", "categorical", "fold_in", "gumbel", "random_bits",
           "threefry2x32", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds, JAX's rotation and key
    schedule) on uint32 words held in Python ints, numpy int64 or int64
    tensors (broadcast).  Returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data: int64 [2]."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` on key data ``[..., 2]``;
    ``data`` (an int or an integer tensor, broadcast against the keys'
    leading axes) is taken modulo 2**32, as JAX's uint32 cast does."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=key.device, dtype=torch.int64) & _MASK
    else:
        data = int(data) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` random uint32 words per key (int64 [..., n]) for keys
    ``[..., 2]``: the partitionable layout, word ``i`` from counter
    ``(i >> 32, i & 0xFFFFFFFF)`` (``n < 2**32`` here, so the high word
    is 0)."""
    counter = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], 0, counter)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for keys
    ``[..., 2]``: float32 [..., n]."""
    bits = random_bits(keys, n)
    # 0x3F800000 | bits >> 9 < 2**31: an int32 holds it, then a float32 view
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo                  # the float32 difference
    return torch.clamp_min(f * float(span) + float(lo), float(lo))


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (``mode="low"``) for
    keys ``[..., 2]``: float32 [..., n]."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)``: one draw per
    row of float32 ``logits`` [B, V] under key ``keys[b]`` [B, 2];
    int64 [B]."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)
