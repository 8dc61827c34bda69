"""OPTQ/GPTQ — the uniform-quantization baseline the paper compares
against (Fig. 17), in plain PyTorch on the weight's device.

Counterpart of ``repro.quant.optq``.  Columns are quantized one at a
time; each column's rounding error is propagated into the columns not
yet quantized through the upper Cholesky factor of the damped inverse
Hessian of a calibration set, which minimizes the output error on it:

    H     = 2 X^T X / n + damp * mean(diag H) I      (X: calibration rows)
    U     = cholesky(H^{-1}), upper
    for i in columns:
        q_i   = round_to_grid(w_i)
        err_i = (w_i - q_i) / U[i, i]
        W[:, i+1:] -= err_i (x) U[i, i+1:]

The per-(row, group) asymmetric grids are taken from the weights before
any compensation.  The update runs in blocks of ``BLOCK`` columns (the
columns inside a block each step, the later columns once a block as one
product): it touches only columns ``i+1:``, as the reference's mask
makes its full-width update do, so it is the same function in another
summation order.

The integer codes map exactly into BCQ + offset (alpha_i = s 2^(i-1),
z = s ((2^q - 1) / 2 - z0)), so an OPTQ checkpoint runs on FIGLUT's own
GEMM kernels (``bcq_matmul``, ``lut_gemm``): the interoperability the
paper's Table I claims.  The reference has no kernel for the column
loop, and neither has the port.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.plane import PlaneBundle, pack_planes

BLOCK = 128          # columns a block of the lazy update holds


def _recip(v: float, device) -> torch.Tensor:
    """The f32 reciprocal of a constant.  The reference divides by
    constants (the grid's levels, the sample count, the mean's count),
    and XLA compiles each such division into a product with the f32
    reciprocal; the port multiplies by the same value, so its grids are
    the reference's bit for bit (a one-ulp difference in a scale moves a
    rounding boundary, and OPTQ carries every moved rounding into the
    later columns)."""
    one = torch.ones((), dtype=torch.float32, device=device)
    return one / torch.tensor(float(v), dtype=torch.float32, device=device)


def _grid_quant(col, scale, zero, levels):
    """Round one column to its per-row uniform grid."""
    q = torch.clamp(torch.round(col / scale + zero), 0, levels)
    return (q - zero) * scale


@torch.no_grad()
def _optq_core(w: torch.Tensor, h: torch.Tensor, bits: int, group_size: int,
               damp: float = 0.01):
    """w: [out, in] f32 (in a multiple of ``group_size``); h: [in, in]
    Hessian (2 X^T X / n).  Returns (the quantized weight, scale, zero),
    scale and zero [out, n_groups]."""
    out, n = w.shape
    levels = (1 << bits) - 1
    g = group_size
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    diag_mean = torch.diagonal(h).sum() * _recip(n, h.device)
    hd = h + damp * diag_mean * eye
    # the inverse and its factor in f64: with fewer calibration rows than
    # columns (256 rows against a down projection's 16,384) the damped
    # Hessian's condition number reaches ~1e6, where an f32 inverse is no
    # longer positive definite
    hinv_u = torch.linalg.cholesky(torch.linalg.inv(hd.double()),
                                   upper=True).float()
    wg = w.reshape(out, n // g, g)
    wmin, wmax = wg.amin(-1), wg.amax(-1)
    scale = torch.clamp((wmax - wmin) * _recip(levels, w.device), min=1e-12)
    zero = torch.round(-wmin / scale)
    work = w.clone()
    w_q = torch.empty_like(w)
    for i1 in range(0, n, BLOCK):
        i2 = min(i1 + BLOCK, n)
        blk = work[:, i1:i2]
        err = torch.empty_like(blk)
        u = hinv_u[i1:i2, i1:i2]
        for j in range(i2 - i1):
            gi = (i1 + j) // g
            col = blk[:, j]
            qcol = _grid_quant(col, scale[:, gi], zero[:, gi], levels)
            e = (col - qcol) / torch.clamp(u[j, j], min=1e-9)
            blk[:, j + 1:] -= torch.outer(e, u[j, j + 1:])
            w_q[:, i1 + j] = qcol
            err[:, j] = e
        if i2 < n:
            work[:, i2:] -= err @ hinv_u[i1:i2, i2:]
    return w_q, scale, zero


def uniform_to_bcq(w_q: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, bits: int, group_size: int,
                   in_features: int) -> PlaneBundle:
    """Exact mapping of uniform (code, scale, zero) grids into the BCQ +
    offset bundle (``core.bcq.from_uniform``'s layout)."""
    out, n = w_q.shape
    levels = (1 << bits) - 1
    wg = w_q.reshape(out, n // group_size, group_size)
    codes = torch.clamp(torch.round(wg / scale[..., None] + zero[..., None]),
                        0, levels).to(torch.int32)
    planes = torch.stack([((codes >> i) & 1).float() * 2 - 1
                          for i in range(bits)]).reshape(bits, out, n)
    pow2 = (2.0 ** torch.arange(bits, dtype=torch.float32,
                                device=w_q.device)) / 2.0
    alpha = scale[None] * pow2[:, None, None]
    z = scale * (levels / 2.0 - zero)
    return PlaneBundle(packed=pack_planes(planes),
                       alpha=alpha.float().contiguous(),
                       z=z.float().contiguous(), group_size=group_size,
                       in_features=in_features, out_features=out)


def optq_quantize(w: torch.Tensor, x_cal: torch.Tensor, bits: int,
                  group_size: int = 128, damp: float = 0.01) -> PlaneBundle:
    """OPTQ-quantize one [out, in] weight given calibration inputs x_cal
    [n_samples, in], on the weight's device; returns the BCQ bundle the
    GEMM kernels run.  A ragged width is edge-padded (the calibration
    rows zero-padded) to whole groups, as the reference pads it."""
    w = w.float()
    out, n = w.shape
    g = int(group_size)
    npad = -(-n // g) * g
    x_cal = x_cal.to(w.device, torch.float32)
    if npad != n:
        w = F.pad(w[None], (0, npad - n), mode="replicate")[0]
        x_cal = F.pad(x_cal, (0, npad - n))
    h = 2.0 * (x_cal.T @ x_cal) * _recip(x_cal.shape[0], w.device)
    w_q, scale, zero = _optq_core(w, h, int(bits), g, damp)
    return uniform_to_bcq(w_q, scale, zero, int(bits), g, n)


def _quant_linears(model):
    """(module path, Linear) of every quantizable 2-D linear: expert
    banks are left out, as the reference skips its 3-D leaves."""
    from repro_torch.quant.api import _is_quant_leaf, walk_linears
    for path, lin in walk_linears(model):
        if _is_quant_leaf(path.rsplit("/", 1)[-1], lin.weight):
            yield path, lin


@torch.no_grad()
def capture_calibration(model, batches: Iterable, max_samples: int = 256
                        ) -> dict:
    """Run forward passes and record each linear's input rows.

    ``batches``: token arrays [B, S], or the reference's batch dicts
    (``{"tokens": ...}``).  Returns {module path: f32 [n_samples,
    in_features]} on the model's device.  Each call of a linear keeps
    ``max_samples`` of its rows, drawn by
    ``np.random.default_rng(0).choice`` as the reference draws them, and
    the first ``max_samples`` over all batches are returned."""
    from repro_torch.core import quantized_linear as ql
    id2path = {id(lin.weight): path for path, lin in _quant_linears(model)}
    store: dict = {}

    def hook(w, x):
        path = id2path.get(id(w))
        if path is None:
            return
        flat = x.reshape(-1, x.shape[-1])
        take = min(max_samples, flat.shape[0])
        idx = np.random.default_rng(0).choice(flat.shape[0], take,
                                              replace=False)
        rows = flat[torch.as_tensor(idx, device=flat.device)].float()
        store.setdefault(path, []).append(rows)

    ql.set_capture(hook)
    try:
        for batch in batches:
            tokens = batch["tokens"] if isinstance(batch, dict) else batch
            if not isinstance(tokens, torch.Tensor):
                tokens = torch.as_tensor(np.asarray(tokens))
            model.forward(tokens)
    finally:
        ql.set_capture(None)
    return {p: torch.cat(v)[:max_samples] for p, v in store.items()}


def optq_quantize_model(model, calib_fn: Callable, *, bits: int = 4,
                        group_size: int = 64,
                        keys: Optional[Iterable[str]] = None) -> dict:
    """OPTQ over a model's linears, in place, one at a time on the device
    they lie on.  ``calib_fn(path, in_features)`` gives each weight's
    calibration rows (e.g. ``capture_calibration``'s, by module path);
    ``keys`` limits it to linears of those names.  The port keeps one
    ``Linear`` per layer under either ``scan_layers`` (it has no stacked
    weight layout), so every layer is quantized as the reference
    quantizes its unstacked leaves (``scan_layers=False``).  Returns
    {module path: the bundle that replaced its weight}."""
    keys = None if keys is None else set(keys)
    done = {}
    for path, lin in list(_quant_linears(model)):
        if keys is not None and path.rsplit("/", 1)[-1] not in keys:
            continue
        x_cal = calib_fn(path, lin.weight.shape[-1])
        lin.weight = optq_quantize(lin.weight, x_cal, bits=bits,
                                   group_size=group_size)
        done[path] = lin.weight
    return done


__all__ = ["capture_calibration", "optq_quantize", "optq_quantize_model",
           "uniform_to_bcq"]
