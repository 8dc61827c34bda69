"""A model's training state over a (data, model) mesh: which slice of
each parameter this rank holds, and the plans its layers run
(counterpart of ``Trainer.state_shardings`` in ``repro.train.trainer``).

:class:`TrainPlan` cuts each leaf of the reference's tree (the unrolled
layout) by ``build_specs`` under the trainer's rules, as the reference
places its weights and both AdamW moments: ``heads`` / ``kv_heads`` /
``mlp`` / ``vocab`` / ``experts`` over ``model`` where they divide it,
and with ``fsdp`` the ``embed`` dim over ``data``.  Two leaves stay whole
over ``model`` because the layers' plans hold them whole, as the mesh
engine does: a MoE layer's f32 router, and an MLA layer's ``kv_b`` where
the heads do not divide the axis.

Over ``model`` the layers run the tensor-parallel plans of
``shard_model`` (``models.model.attach_tp``), whose collectives are
differentiable.  A leaf cut over ``data`` is an FSDP shard: the block
that uses it gathers it whole (``layers.Shards``), and its gradient
comes back reduce-scattered and divided by the ``data`` extent.  With
the ``act_embed`` rule the remat stash keeps this rank's ``model`` slice
of each block input (``Stack.act_mesh``).

The modules hold this rank's slices (``Model.train_params`` returns
them, keyed by the reference's paths).  They get them from whole leaves
one at a time: :meth:`TrainPlan.init` draws each module's whole tensors
from the generator in the unsharded order and keeps the slices, so the
sharded init equals the unsharded one and no whole tree is ever on the
device; :meth:`TrainPlan.place` cuts given whole leaves (a whole model's
tensors, a checkpoint read through memory maps).  The model may start
on the meta device (``models.module.abstract_model``).
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves_with_path, tree_map


class TrainPlan:
    """``model`` planned for training on ``mesh`` under ``rules``: per
    leaf (the unrolled tree's order) its path, module slot, spec, mesh
    axes it is cut over (``cut_axes``) and whole shape and dtype
    (``template``, meta tensors)."""

    def __init__(self, model, mesh, rules):
        from repro_torch.models.layers import Shards
        from repro_torch.models.model import (_model_axis_only, _params_tree,
                                              _whole_leaves, attach_tp)
        from repro_torch.models.module import logical_axes
        from repro_torch.parallel.sharding import (_get, _pad, build_specs,
                                                   spec_for)
        cfg = model.cfg
        if model.train_plan is not None or model.mesh is not None:
            raise ValueError("TrainPlan: the model is already cut over a "
                             "mesh; plan a whole or meta-device model")
        full = _params_tree(model, scan=False)
        leaves = list(leaves_with_path(full))
        if not all(isinstance(t, torch.Tensor) for _, t in leaves):
            raise ValueError(f"{cfg.name} holds quantized (PlaneBundle) "
                             "weights: only dense models train, as in the "
                             "reference")
        self.model, self.mesh, self.rules = model, mesh, rules
        self.device = torch.device(mesh.device)
        specs = build_specs(full, logical_axes(cfg.replace(
            scan_layers=False)), mesh, rules)
        _whole_leaves(cfg, specs, mesh)
        if mesh.size("model") > 1:
            attach_tp(model, full, _model_axis_only(specs), mesh, rules)
        model.mesh = mesh
        slot_of = {id(t): (mod, name) for mod in model.modules()
                   for name, t in vars(mod).items()
                   if isinstance(t, torch.Tensor)}
        self.paths, self.slots, self.specs, self.cut_axes = [], [], [], []
        data_dims = []
        for path, t in leaves:
            spec = tuple(_get(specs, path) or ())
            entries = _pad(spec, t.dim())
            names = [e for e in entries if e is not None]
            if any(not isinstance(e, str) for e in names):
                raise NotImplementedError(
                    f"{'/'.join(map(str, path))}: spec {spec} cuts one dim "
                    "over several mesh axes; the trainer's rules map each "
                    "logical axis onto one")
            self.paths.append(path)
            self.slots.append(slot_of[id(t)])
            self.specs.append(spec)
            self.cut_axes.append(tuple(sorted(
                a for a in names if mesh.size(a) > 1)))
            data_dims.append(entries.index("data")
                             if "data" in self.cut_axes[-1] else None)
        self.template = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            full)
        self._meta = [t for _, t in leaves_with_path(self.template)]
        # FSDP leaves: a block's gathered where it runs, the rest (the
        # embeddings, the final norms) for the whole forward
        block_of = {}
        stacks = [model.stack] + ([model.encoder.stack]
                                  if model.encoder is not None else [])
        for stack in stacks:
            for block in stack.layers:
                for m in block.modules():
                    block_of[id(m)] = block
        per_block, top = {}, []
        for (mod, name), dim in zip(self.slots, data_dims):
            if dim is None:
                continue
            block = block_of.get(id(mod))
            (per_block.setdefault(id(block), (block, []))[1]
             if block is not None else top).append((mod, name, dim))
        for block, fsdp in per_block.values():
            block.shards = Shards(mesh, fsdp)
        model.shards = Shards(mesh, top) if top else None
        act = spec_for((1, 1, cfg.d_model), ("batch", None, "act_embed"),
                       mesh, rules)
        if mesh.size("model") > 1 and len(act) == 3 and act[2] == "model":
            for stack in stacks:
                stack.act_mesh = mesh
        model.device = self.device
        model.train_plan = self
        self.placed = False

    # ------------------------------------------------------------------
    @property
    def sharded(self) -> bool:
        """Whether any leaf is cut (else every rank holds the whole
        state, as plain data parallelism)."""
        return any(self.cut_axes)

    def local(self, whole, i: int, dtype=None) -> torch.Tensor:
        """This rank's slice of leaf ``i`` from its whole value (a tensor
        anywhere, a numpy array or memory map: only the slice is read),
        on the mesh's device in ``dtype`` (default the leaf's)."""
        from repro_torch.models.model import _to_tensor
        from repro_torch.parallel.sharding import local_shard
        want = tuple(self._meta[i].shape)
        if tuple(whole.shape) != want:
            raise ValueError(f"{'/'.join(map(str, self.paths[i]))}: a whole "
                             f"leaf of shape {want} was expected, got "
                             f"{tuple(whole.shape)} (a rank's slice? place a "
                             "whole state: restore a checkpoint)")
        part = local_shard(whole, self.specs[i], self.mesh)
        out = _to_tensor(part, self.device).to(dtype or self._meta[i].dtype)
        if isinstance(whole, torch.Tensor) and \
                out.untyped_storage().data_ptr() == \
                whole.untyped_storage().data_ptr():
            out = out.clone()     # not a view that holds the whole alive
        return out

    def place(self, wholes) -> None:
        """Give every module slot this rank's slice of the matching whole
        leaf (``wholes`` in the unrolled tree's leaf order)."""
        wholes = list(wholes)
        if len(wholes) != len(self.slots):
            raise ValueError(f"place: {len(wholes)} leaves for "
                             f"{len(self.slots)}")
        for i, ((mod, name), w) in enumerate(zip(self.slots, wholes)):
            setattr(mod, name, self.local(w, i))
        self.placed = True

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Fresh weights from ``generator``, drawn as ``Model.init_params``
        draws them (module by module, in the same order, on the mesh's
        device), each module's whole tensors held only until its slices
        are kept."""
        model = self.model
        index = {}
        for i, (mod, name) in enumerate(self.slots):
            index.setdefault(id(mod), []).append((i, name))
        done = 0
        for mod in model.modules():
            if mod is model or not hasattr(mod, "init_params"):
                continue
            mine = index.get(id(mod), [])
            for i, name in mine:
                meta = self._meta[i]
                setattr(mod, name, torch.empty(meta.shape, dtype=meta.dtype,
                                               device=self.device))
            mod.init_params(generator)
            for i, name in mine:
                setattr(mod, name, self.local(getattr(mod, name), i))
            done += len(mine)
        if done != len(self.slots):
            raise ValueError(f"init: {len(self.slots) - done} parameters "
                             "have no module init")
        self.placed = True

    def cut(self, wholes, dtype=None) -> list:
        """This rank's slices of a whole tree's leaves (moments: f32)."""
        return [self.local(w, i, dtype) for i, w in enumerate(wholes)]

    def whole(self, slices) -> list:
        """The whole leaves from every rank's slices (``slices`` in the
        unrolled tree's leaf order; every rank calls it): each slice
        all-gathered over the axes it is cut over."""
        from repro_torch.parallel.sharding import _pad
        out = []
        for t, spec in zip(slices, self.specs):
            for dim, entry in enumerate(_pad(spec, t.dim())):
                if entry is not None and self.mesh.size(entry) > 1:
                    t = self.mesh.all_gather(t.contiguous(), entry, dim=dim)
            out.append(t)
        return out

    # ------------------------------------------------------------------
    def nbytes(self, whole: bool = False, dtype=None) -> int:
        """Bytes of this rank's slices of every leaf (or of the whole
        leaves), in the leaves' dtype or ``dtype``."""
        from repro_torch.parallel.sharding import dim_slice
        total = 0
        for meta, spec in zip(self._meta, self.specs):
            n = 1
            for size, entry in zip(meta.shape,
                                   list(spec) + [None] * meta.dim()):
                cut = None if whole else dim_slice(size, entry, self.mesh)
                n *= size if cut is None else cut[1] - cut[0]
            item = (torch.empty((), dtype=dtype) if dtype is not None
                    else meta).element_size()
            total += n * item
        return total

    def region(self, i: int):
        """(whether this rank writes leaf ``i`` of a checkpoint, the index
        of its slice in the whole leaf).  Of the ranks holding one slice
        (those that differ only along axes the leaf is not cut over) the
        one at index 0 on those axes writes it."""
        from repro_torch.parallel.sharding import _pad, dim_slice
        writes = all(self.mesh.index(a) == 0 for a in self.mesh.axis_names
                     if a not in self.cut_axes[i])
        index = []
        for size, entry in zip(self._meta[i].shape,
                               _pad(self.specs[i], self._meta[i].dim())):
            cut = dim_slice(size, entry, self.mesh)
            index.append(slice(None) if cut is None else slice(*cut))
        return writes, tuple(index)



__all__ = ["TrainPlan"]
