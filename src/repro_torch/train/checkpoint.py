"""Atomic, async, numpy-backed checkpoints in the reference's on-disk
layout (counterpart of ``repro.train.checkpoint``):

    <dir>/step_<N:08d>/
        manifest.json   {"step", "leaves": {key: {file, dtype, shape}},
                         "extra", "skeleton"}
        <key with / -> __>.npy   one file per leaf

A step is written to ``step_<N>.tmp`` and renamed into place, so a
crash never leaves a half-written latest step.  bf16 leaves are stored
as ``uint16`` with dtype name ``bfloat16`` (numpy has no bf16) and come
back through ``torch.from_numpy(a).view(torch.bfloat16)``, so no
``ml_dtypes`` is needed.  Leaves may be torch tensors (any device) or
numpy arrays.  A named tuple (``AdamWState``) is written as the
reference writes it (its fields by name, marked ``__namedtuple__`` in
the skeleton) and restores as a plain dict, as in the reference, so
checkpoints written by either package load in the other.

:class:`AsyncCheckpointer` snapshots a tree to host memory before
``save_async`` returns (a CPU copy of every tensor, so a later in-place
optimizer step cannot reach the file being written), then writes it in
a daemon thread, one write in flight at a time, keeping the newest
``keep`` steps.  Over a mesh (``save_sharded_async``) the step has the
same layout, one whole file per leaf, but no process holds the whole
state: rank 0 creates every leaf's file at its whole shape
(``np.lib.format.open_memmap``), every rank writes the slices it is to
write into them from its own snapshot, in its writer thread, and the
commit (manifest, rename, GC) waits for every rank's writes: the next
``wait``, which every rank calls, brackets it with the mesh's host
barriers.  :func:`restore` returns CPU tensors (with ``mmap``,
memory-mapped: a caller that slices them reads only its slices), or
places them: on a device, or sliced for one rank of a mesh
(``shard_tree``, memory-mapped).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import is_namedtuple, leaves_with_path, tree_map


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if is_namedtuple(tree):
        return {"__namedtuple__": True,
                "fields": {k: _skeleton(getattr(tree, k))
                           for k in tree._fields}}
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


def _np_dtype(dtype: torch.dtype) -> tuple:
    """(numpy dtype a file holds, dtype name to record) of a torch
    dtype."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16), "bfloat16"
    a = torch.empty(0, dtype=dtype).numpy()
    return a.dtype, str(a.dtype)


def _file_of(key: str) -> str:
    return key.replace("/", "__") + ".npy"


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
    for path, leaf in leaves_with_path(tree):
        key = "/".join(map(str, path))
        arr, dtype_name = _host_array(leaf)
        fn = _file_of(key)
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "dtype": dtype_name,
                                   "shape": list(arr.shape)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    return final


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if np.dtype(dtype).name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _snapshot(leaf):
    """A host copy of a leaf that nothing else references."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.cpu() if t.device.type != "cpu" else t.clone()
    return np.array(leaf)


class AsyncCheckpointer:
    """Snapshot to host memory at once, write to disk in a daemon thread.

    ``save_async`` waits for the previous write (one in flight at a
    time), copies every tensor of the tree to CPU memory, starts the
    write and returns; ``wait`` joins it.  After each write the steps
    beyond the newest ``keep`` are deleted.  ``last_snapshot_s`` and
    ``last_write_s`` time the latest save (the write's once it has
    been waited for)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = None       # a sharded step to commit: (mesh, tmp,
        #                            final, manifest)
        self.last_snapshot_s = 0.0
        self.last_write_s = 0.0
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self._pending is not None:
            self._commit(err is None)
        if err is not None:
            raise err

    def _commit(self, mine_ok: bool) -> None:
        """Every rank's writes of the pending sharded step are done (each
        rank is here): rank 0 commits it if every rank wrote its slices,
        then all pass a barrier, so each sees the step or none."""
        import torch.distributed as dist
        mesh, tmp, final, manifest = self._pending
        self._pending = None
        ok = all(mesh.gather_objects(mine_ok))
        if ok and mesh.rank == 0:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                  # atomic commit
            self._gc()
        dist.barrier(group=mesh.host_group)
        if not ok and mine_ok:
            raise RuntimeError(f"checkpoint {os.path.basename(final)}: "
                               "another rank failed to write its slices")

    def save_sharded_async(self, step: int, meta_tree: Any, parts: list,
                           mesh, extra: Optional[dict] = None) -> None:
        """A step written by every rank of ``mesh`` (each calls this, in
        the same order): ``meta_tree`` gives the tree's structure and each
        leaf's whole shape and dtype (meta tensors), ``parts`` this rank's
        writes, ``(key, index, tensor)``: the leaf's "/"-joined path,
        the index of the slice in the whole leaf (a tuple of ints and
        slices) and its values."""
        import torch.distributed as dist
        self.wait()
        t0 = time.perf_counter()
        host = [(key, index, _snapshot(t)) for key, index, t in parts]
        self.last_snapshot_s = time.perf_counter() - t0
        final = os.path.join(self.ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        manifest = {"step": step, "leaves": {}, "extra": extra or {},
                    "skeleton": _skeleton(meta_tree)}
        for path, leaf in leaves_with_path(meta_tree):
            key = "/".join(map(str, path))
            _, name = _np_dtype(leaf.dtype)
            manifest["leaves"][key] = {"file": _file_of(key), "dtype": name,
                                       "shape": list(leaf.shape)}
        if mesh.rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for path, leaf in leaves_with_path(meta_tree):
                key = "/".join(map(str, path))
                np.lib.format.open_memmap(
                    os.path.join(tmp, _file_of(key)), mode="w+",
                    dtype=_np_dtype(leaf.dtype)[0], shape=tuple(leaf.shape))
        dist.barrier(group=mesh.host_group)     # every file exists
        self._pending = (mesh, tmp, final, manifest)

        def work():
            t1 = time.perf_counter()
            try:
                for key, index, t in host:
                    mm = np.load(os.path.join(tmp, _file_of(key)),
                                 mmap_mode="r+")
                    mm[index] = _host_array(t)[0]
                    mm.flush()
                    del mm
            except BaseException as e:        # re-raised by ``wait``
                self._error = e
            self.last_write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None,
                   layout=None) -> None:
        """Snapshot ``tree`` to host memory, then write it in the
        background; ``layout`` (optional) maps the host copy to the tree
        to write, in the writer thread (the trainer stacks layers
        there)."""
        self.wait()
        t0 = time.perf_counter()
        host_tree = tree_map(_snapshot, tree)
        self.last_snapshot_s = time.perf_counter() - t0

        def work():
            t1 = time.perf_counter()
            try:
                out = host_tree if layout is None else layout(host_tree)
                save(self.ckpt_dir, step, out, extra)
                self._gc()
            except BaseException as e:        # re-raised by ``wait``
                self._error = e
            self.last_write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        for s in list_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


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


def restore(ckpt_dir: str, step: Optional[int] = None, placement=None,
            template: Any = None, mmap: bool = False):
    """(tree, step, extra) of ``step`` (default: the latest complete one).

    Leaves come back as CPU torch tensors (with ``mmap``, backed by
    copy-on-write memory maps of the files, so only what is read of them
    is loaded); with ``template`` (a tree of the same structure, a named
    tuple standing for its restored dict) each is cast to the template
    leaf's dtype.  ``placement`` moves them: a device, or ``(mesh,
    specs)`` to keep only this rank's slice of every leaf
    (``parallel.sharding.shard_tree`` with ``specs`` from
    ``build_specs``; the files memory-mapped) on the mesh's device,
    where the reference gives ``jax.device_put`` its shardings."""
    mmap = mmap or isinstance(placement, tuple)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for key, meta in manifest["leaves"].items():
        t = torch.from_numpy(np.load(os.path.join(d, meta["file"]),
                                     mmap_mode="c" if mmap else None))
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        leaves[key] = t
    tree = _unflatten(manifest["skeleton"], leaves)
    if template is not None:
        tree = tree_map(lambda x, t: x if getattr(t, "dtype", None) is None
                        else x.to(_torch_dtype(t.dtype)), tree, template)
    if isinstance(placement, tuple):
        from repro_torch.parallel.sharding import shard_tree
        mesh, specs = placement
        tree = shard_tree(tree, specs, mesh, device=mesh.device)
    elif placement is not None:
        tree = tree_map(lambda x: x.to(placement), tree)
    return tree, manifest["step"], manifest.get("extra", {})


__all__ = ["AsyncCheckpointer", "latest_step", "list_steps", "restore",
           "save"]
