"""JSON persistence for tuned launch configs.

Counterpart of ``repro.tune.cache``.  One flat JSON file maps

    <kernel>|b<batch-bucket>|m<M>|n<N>|<dtype>|mu<mu>|g<group>|<device>

to the winning :class:`~repro_torch.tune.space.KernelConfig` and its
measurement.  Rows are bucketed to the next power of two with a floor
of 8, so every decode row count (1-8) shares one bucket and every
bucket lies on one side of the wrappers' 8-row limit.  The device tag
is the card's name, its SM count and the digest of the kernel sources
(``_lib._digest()``), so an entry tuned on another card, or for bodies
that a later change rewrote, is never read.

The path is ``REPRO_TORCH_TUNE_CACHE``, else
``~/.cache/repro_torch/tune_cache.json``.  Writes are atomic (a
temporary file, then a rename) with sorted keys, so saving the same
entries twice gives byte-identical files; a missing or corrupt file is
a cold cache.
"""
from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Optional

from .space import KernelConfig

SCHEMA_VERSION = 1

ENV_PATH = "REPRO_TORCH_TUNE_CACHE"
_DEFAULT_PATH = os.path.join("~", ".cache", "repro_torch", "tune_cache.json")


def bucket_batch(b: int) -> int:
    """Next power of two, floor 8 (the wrappers' decode-row limit)."""
    return max(8, 1 << max(0, int(b) - 1).bit_length())


def device_tag(name: str, sms: int, digest: Optional[str] = None) -> str:
    """``<card name>+sm<SMs>+src<digest>``; ``digest`` defaults to the
    kernel library's source digest."""
    if digest is None:
        from repro_torch.kernels import _lib
        digest = _lib._digest()
    clean = name.replace(" ", "_").replace("|", "_").replace("+", "_")
    return f"{clean}+sm{int(sms)}+src{digest}"


@functools.lru_cache(maxsize=None)
def cuda_device_tag(index: int) -> str:
    """The device tag of CUDA device ``index``."""
    import torch
    from repro_torch.kernels import _lib
    return device_tag(torch.cuda.get_device_name(index),
                      _lib.sm_count(index))


def cache_key(kernel: str, *, b: int, m: int, n: int, dtype, mu: int,
              group_size: int, device: str) -> str:
    dt = str(dtype).replace("torch.", "")
    return (f"{kernel}|b{bucket_batch(b)}|m{int(m)}|n{int(n)}|{dt}"
            f"|mu{int(mu)}|g{int(group_size)}|{device}")


def default_path() -> str:
    return os.path.expanduser(os.environ.get(ENV_PATH) or _DEFAULT_PATH)


class TuneCache:
    """In-memory view over one JSON cache file.  ``generation`` counts
    loads and stores, so resolvers can tell when what they read went
    stale."""

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.expanduser(path) if path else default_path()
        self.entries: dict = {}
        self.generation = 0
        self.load()

    def load(self) -> "TuneCache":
        self.entries = {}
        try:
            with open(self.path) as f:
                blob = json.load(f)
            if isinstance(blob, dict) and \
                    blob.get("version") == SCHEMA_VERSION and \
                    isinstance(blob.get("entries"), dict):
                self.entries = dict(blob["entries"])
        except (OSError, ValueError):
            pass                                  # cold or corrupt: empty
        self.generation += 1
        return self

    def save(self) -> str:
        folder = os.path.dirname(self.path) or "."
        os.makedirs(folder, exist_ok=True)
        blob = {"version": SCHEMA_VERSION,
                "entries": dict(sorted(self.entries.items()))}
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return self.path

    def lookup(self, key: str) -> Optional[KernelConfig]:
        ent = self.entries.get(key)
        if not isinstance(ent, dict):
            return None
        try:
            return KernelConfig.from_dict(ent["config"])
        except (KeyError, TypeError):
            return None

    def store(self, key: str, cfg: KernelConfig, **meta) -> None:
        self.entries[key] = {"config": cfg.to_dict(), **meta}
        self.generation += 1

    def __contains__(self, key: str) -> bool:
        return self.lookup(key) is not None

    def __len__(self) -> int:
        return len(self.entries)


_DEFAULT: Optional[TuneCache] = None


def default_cache() -> TuneCache:
    """The process-wide cache at :func:`default_path` (re-read when the
    path changes)."""
    global _DEFAULT
    path = default_path()
    if _DEFAULT is None or _DEFAULT.path != path:
        _DEFAULT = TuneCache(path)
    return _DEFAULT


def reset_default_cache() -> None:
    """Drop the process-wide cache (after the file or the path changed)."""
    global _DEFAULT
    _DEFAULT = None
