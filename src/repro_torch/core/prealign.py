"""FIGLUT-I numerics: exponent pre-alignment + integer-mantissa accumulate.

Counterpart of ``repro.core.prealign``.  The paper's -I variant (after
iFPU / FIGNA) aligns every FP activation in a reduction row to the
row's maximum exponent, truncating the mantissa bits that fall off, then
runs the LUT / RAC arithmetic on integers.  The card has no separate
integer-mantissa datapath to target either, so this module exists for
numerical modelling: it measures the accuracy of -I against -F (the
``bcq_matmul`` kernel) and the dense product (paper Table IV).  It is
plain PyTorch, as the reference is plain JAX: no kernel.

The arithmetic is the reference's, step for step, in f32:

  * the exponent is ``floor(log2(max(amax, 1e-30)))`` with ``log2``
    computed as XLA computes it, ``log(x) * f32(1 / ln 2)`` (a correctly
    rounded ``log2`` or ``frexp`` gives another exponent for some inputs
    at or just under a power of two: XLA's log2(8192) floors to 12);
  * the scale is ``exp2(e - (mb - 1))`` as XLA computes it,
    ``exp(k * f32(ln 2))``: not an exact power of two (up to 4e-6 off).
    It is read from a table of ``exp(k ln 2)`` built once on the host
    with PyTorch's CPU ``exp``, so the card and the host use the same
    scales; that ``exp`` rounds as XLA's does at every k in [-126, 127]
    but k = 32 (rows whose max is 2^42 or more at mb 11);
  * mantissas are ``round(x / scale)`` (half to even), integers stored in
    f32 with ``|m| <= 2^mb`` (the scale's error can round the row's max
    up to 2^mb);
  * the +-1-weighted mantissa sums ``part`` are exact integer sums while
    ``g * 2^mb <= 2^24`` (g the group size); outside that range they
    round in f32 as the reference's do, in the order the einsum takes
    (not widened here);
  * alpha, z and the scale return the sums to FP in f32.

Products run with TF32 off where the caller has set it so
(``torch.backends.cuda.matmul.allow_tf32``): with TF32 the mantissas'
products lose bits and ``part`` is no longer exact.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.plane import PlaneBundle, unpack_planes

__all__ = ["prealign", "prealigned_bcq_matmul"]

_LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)
_INV_LN2 = torch.tensor(1.0 / math.log(2.0), dtype=torch.float32)
# exponents the table covers: the normal f32 range.  The 1e-30 guard
# keeps e >= -100, so k = e - (mb - 1) >= -123 for mb <= 24.
_K_MIN, _K_MAX = -126, 127
_EXP2 = {}


def _exp2_table(device) -> torch.Tensor:
    """f32 ``exp(k * ln 2)`` for k in [_K_MIN, _K_MAX], on ``device``."""
    key = torch.device(device)
    if key not in _EXP2:
        k = torch.arange(_K_MIN, _K_MAX + 1, dtype=torch.float32)
        _EXP2[key] = torch.exp(k * _LN2).to(key)
    return _EXP2[key]


def prealign(x: torch.Tensor, mantissa_bits: int = 11, axis: int = -1):
    """Align activations to the max exponent along ``axis``.

    Returns (mantissa, scale), both f32, with x ~= mantissa * scale and
    the mantissa integer-valued; ``scale`` keeps ``axis`` with size 1.
    ``mantissa_bits`` 11 models FP16 inputs (1 implicit + 10 stored
    bits); use 8 for bf16."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    log2 = torch.log(torch.clamp(amax, min=1e-30)) * _INV_LN2.to(xf.device)
    k = torch.floor(log2) - (mantissa_bits - 1)
    idx = (k.to(torch.int64) - _K_MIN).clamp(0, _K_MAX - _K_MIN)
    scale = _exp2_table(xf.device)[idx]
    mant = torch.round(xf / scale)
    return mant, scale


def _operands(x: torch.Tensor, w: PlaneBundle, mantissa_bits: int):
    """(lead dims, mantissas [B, G, g], scales [B, 1], +-1 planes [q, out,
    G, g]) of a call: x padded to the planes' width and pre-aligned."""
    if w.kind != "bcq":
        raise ValueError(f"prealigned_bcq_matmul takes BCQ bundles, got "
                         f"kind={w.kind!r}")
    if w.packed.ndim != 3:
        raise ValueError(f"prealigned_bcq_matmul takes a 2-D bundle "
                         f"(packed [q, out, in/8]), got "
                         f"{tuple(w.packed.shape)}")
    q, m, nb = w.packed.shape
    n_pad = nb * 8
    xf = x.float()
    if xf.shape[-1] != n_pad:
        xf = torch.nn.functional.pad(xf, (0, n_pad - xf.shape[-1]))
    lead = xf.shape[:-1]
    mant, scale = prealign(xf.reshape(-1, n_pad), mantissa_bits)
    mg = mant.reshape(-1, w.n_groups, w.group_size)
    pm1 = unpack_planes(w.packed, torch.float32).reshape(
        q, m, w.n_groups, w.group_size)
    return lead, mg, scale, pm1


def prealigned_bcq_matmul(x: torch.Tensor, w: PlaneBundle,
                          mantissa_bits: int = 11, out_dtype=None, *,
                          with_partials: bool = False):
    """FIGLUT-I: the integer-mantissa BCQ GEMM, y = x @ dequant(w).T.

    x [..., in_features]; w a 2-D BCQ bundle (a ``z`` of None adds no
    offset term).  The +-1-weighted sums over mantissas are the
    hardware's integer adder tree / LUT reads; only the alpha / z scaling
    and the de-alignment return to FP.  A ternary bundle is refused: the
    reference takes BCQ weights only.  ``with_partials`` also returns the
    integer partial sums [q, B, out, n_groups] (exact in f32 for
    g * 2^mb <= 2^24): (y, part)."""
    out_dtype = out_dtype or x.dtype
    lead, mg, scale, pm1 = _operands(x, w, mantissa_bits)
    part = torch.einsum("bGn,qmGn->qbmG", mg, pm1)
    y = torch.einsum("qbmG,qmG->bm", part, w.alpha.float())
    if w.z is not None:
        y = y + torch.einsum("bG,mG->bm", mg.sum(-1), w.z.float())
    y = y * scale                                         # de-align
    y = y.reshape(*lead, w.out_features).to(out_dtype)
    return (y, part) if with_partials else y
