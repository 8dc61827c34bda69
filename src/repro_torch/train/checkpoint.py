"""Atomic numpy-backed checkpoints in the reference's on-disk layout.

Counterpart of the blocking part of ``repro.train.checkpoint`` (the
async checkpointer is training work, ROADMAP.md queue 1 item 11):

    <dir>/step_<N:08d>/
        manifest.json   {"step", "leaves": {key: {file, dtype, shape}},
                         "extra", "skeleton"}
        <key with / -> __>.npy   one file per leaf

A step is written to ``step_<N>.tmp`` and renamed into place, so a
crash never leaves a half-written latest step.  bf16 leaves are stored
as ``uint16`` with dtype name ``bfloat16`` (numpy has no bf16) and come
back through ``torch.from_numpy(a).view(torch.bfloat16)``, so no
``ml_dtypes`` is needed.  Leaves may be torch tensors (any device) or
numpy arrays; :func:`restore` returns CPU torch tensors.  Checkpoints
written by either package load in the other.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, tree


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None if tree is None else "leaf"


def _unflatten(skeleton, leaves: dict, path=()):
    if isinstance(skeleton, dict):
        if skeleton.get("__namedtuple__"):     # restored as a plain dict
            skeleton = skeleton["fields"]
        return {k: _unflatten(v, leaves, path + (str(k),))
                for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_unflatten(v, leaves, path + (str(i),))
                for i, v in enumerate(skeleton)]
    if skeleton is None:
        return None
    return leaves["/".join(path)]


def _host_array(leaf):
    """(numpy array to write, dtype name to record)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[dict] = None) -> str:
    """Blocking atomic save of a tree of dicts / lists / array leaves."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {},
                "skeleton": _skeleton(tree)}
    for path, leaf in _flatten(tree):
        if leaf is None:
            continue
        key = "/".join(path)
        arr, dtype_name = _host_array(leaf)
        fn = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "dtype": dtype_name,
                                   "shape": list(arr.shape)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    return final


def list_steps(ckpt_dir: str):
    """Steps with a complete manifest, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None):
    """(tree of CPU torch tensors, step, extra) of ``step`` (default: the
    latest complete one)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for key, meta in manifest["leaves"].items():
        t = torch.from_numpy(np.load(os.path.join(d, meta["file"])))
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        leaves[key] = t
    tree = _unflatten(manifest["skeleton"], leaves)
    return tree, manifest["step"], manifest.get("extra", {})


__all__ = ["latest_step", "list_steps", "restore", "save"]
