"""Build, load and count the port's CUDA kernels.

The sources under ``repro_torch/csrc`` are compiled at first use with
``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all started
together, then one link into a shared library with a plain C
interface) and loaded with ``ctypes``.  Nothing here runs when the
module is imported: the CPU tests import every module of the port.

The library lands in ``build/repro_torch/`` at the root of the checkout
(``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the sources
and flags, so a rebuilt source never loads a stale library.

``launch_counts`` holds one integer per kernel; a wrapper adds one at
the point where it launches its kernel and nowhere else.  A kernel with
several bodies (``bcq_matmul``, ``lut_gemm``, ``ternary_matmul``) also
adds one to ``route_counts["<kernel>/<route>"]`` for the body it
launched, so a run can show which body ran.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

KERNELS = ("bcq_matmul", "lut_gemm", "paged_decode", "paged_prefill",
           "ternary_matmul", "paged_decode_int8", "paged_prefill_int8",
           "paged_decode_mla")
launch_counts: Dict[str, int] = {k: 0 for k in KERNELS}
route_counts: Dict[str, int] = {}

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, packed, alpha, z, y, part, sem, B, M, N, NB, G, q, group_size,
    # x_is_bf16, route, splits, stream
    "launch_bcq_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _P],
    # x, packed, alpha, z, y, part, B, M, N, NB, G, q, group_size,
    # x_is_bf16, mu, half_lut, route, splits, stream
    "launch_lut_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
    # q, k, v, pos, tables, positions, out, part_o, part_ml, sem, B, C,
    # Hkv, rep, D, BS, pages, kv_is_bf16, scale, q_is_bf16, out_is_bf16,
    # splits, stream
    "launch_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # q, k, v, pos, tables, positions, out, B, C, Hkv, rep, D, BS, pages,
    # kv_is_bf16, scale, q_is_bf16, out_is_bf16, stream
    "launch_paged_prefill": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _F, _I, _I, _P],
    # x, packed, alpha, y, part, sem, B, M, N, NB, G, group_size,
    # x_is_bf16, route, splits, stream
    "launch_ternary_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P],
    # q, k, v, k_scale, v_scale, pos, tables, positions, out, part_o,
    # part_ml, sem, B, C, Hkv, rep, D, BS, pages, compute_bf16, scale,
    # q_is_bf16, out_is_bf16, splits, stream
    "launch_paged_decode_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                 _I, _I, _P],
    # ... pages, compute_bf16, scale, q_is_bf16, out_is_bf16, stream
    "launch_paged_prefill_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                  _P],
    # q_eff, q_rope, ckv, krope, pos, tables, positions, out, part_o,
    # part_ml, sem, B, H, lora, dr, BS, pages, scale, kv_is_bf16,
    # heads_per_block, splits, stream
    "launch_paged_decode_mla": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    route_counts.clear()


def count_launch(kernel: str, route: Optional[str] = None) -> None:
    launch_counts[kernel] += 1
    if route is not None:
        key = f"{kernel}/{route}"
        route_counts[key] = route_counts.get(key, 0) + 1


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_lib.py -> <checkout>/build/repro_torch
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set NVCC or PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link one ``.so``.
    Returns its path; a library already built from the same sources is
    reused."""
    global build_seconds
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"librepro_torch_{_digest()}.so"
    if lib.exists():
        build_seconds = 0.0 if build_seconds is None else build_seconds
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs, objs = [], []
    for src in _sources():
        obj = out_dir / f"{src.stem}_{_digest()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
        objs.append(str(obj))
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        if verbose or p.returncode:
            print(f"[nvcc {src.name}]\n{out}")
        if p.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}")
    tmp = lib.with_suffix(".tmp.so")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *objs]
    r = subprocess.run(link, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib)
    build_seconds = time.perf_counter() - t0
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a launcher returned."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def split_count(units: int, tiles: int, sms: int, per_sm: int,
                most: Optional[int] = None) -> int:
    """How many blocks share one output tile's ``units`` steps of the
    reduction axis (chunks, alpha groups or table tiles): enough for
    about ``per_sm`` blocks per SM over ``tiles`` output tiles, never
    more than there are units (nor ``most``), and every split a whole
    number of units (the split launches take ``ceil(units / splits)``
    units each)."""
    cap = units if most is None else min(units, most)
    want = max(1, min(cap, -(-per_sm * sms // tiles)))
    per = -(-units // want)
    return -(-units // per)


_COUNTERS: Dict[tuple, object] = {}


def split_counters(kernel: str, device, n: int):
    """At least ``n`` zeroed int32 counters on ``device`` for ``kernel``'s
    in-kernel split merge: the last block of each output tile to finish
    counts the others in and sets its counter back to 0, so every launch
    leaves them at 0 (calls of one kernel on one device run in stream
    order, as the port's do)."""
    import torch
    key = (kernel, device.index or 0)
    t = _COUNTERS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = t
    return t


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
