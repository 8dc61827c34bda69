"""Serving meshes over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  The reference's mesh is a grid of
devices that GSPMD partitions a program over; here a mesh is SPMD: one
process per rank, each running the same program, and one
``torch.distributed`` group per axis, over which the layers issue their
collectives explicitly.  Ranks lie on the grid row-major (the last axis
fastest), as ``jax.make_mesh`` lays out devices, so the ``model`` ranks
of one ``data`` replica are consecutive.

The count of devices is the world size: the ``WORLD_SIZE`` that
``torchrun`` (or :func:`spawn`) sets, 1 outside them.  The process group
is created from the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) with an explicit ``tcp://`` address.
Its backend is chosen, and printed, by :func:`choose_backend`: ``nccl``
where every rank has a card of its own, ``gloo`` where ranks share one
card (NCCL refuses two ranks on one device) or run on the CPU.  A gloo
collective on CUDA tensors is staged through host memory, which costs a
host wait; the mesh counts those (``host_syncs``), the seconds spent
in collectives (``comm_s``) and the bytes they moved, per kind
(``coll_bytes``: ``all-reduce`` / ``all-gather`` / ``reduce-scatter``,
the result bytes on this rank, the convention ``roofline/analysis.py``
reads).  A second, gloo group spans the world for host-side agreement
(``broadcast_float``, ``same_on_all``), since NCCL carries only device
tensors.

The mesh's own collectives are outside autograd.  Training runs through
the differentiable ones below it, Megatron's pairs:

  * :func:`sum_partials`: forward the all-reduce of a partial result (a
    row-parallel product, a vocab-parallel lookup, the MoE combine),
    backward the gradient as it is;
  * :func:`enter_parallel`: forward the replicated activation as it is,
    backward the all-reduce of the ranks' gradients (the input of a
    column-parallel linear, of the local experts, of the vocab-parallel
    head: without it each rank's gradient of every earlier layer would
    be its own part);
  * :func:`gather_replicated`: forward the all-gather of the ranks'
    slices, backward the rank's own slice of the gradient (every rank
    computes the same loss from the gathered tensor);
  * :func:`split_replicated`: forward the rank's slice of a replicated
    tensor, backward the all-gather (the sharded remat stash);
  * :func:`gather_shards`: forward the all-gather of a weight's shards
    (FSDP), backward the reduce-scatter of its gradient divided by the
    axis extent: the data-parallel mean of the shard.

Each runs its plain collective (or nothing) where no gradient is
tracked, so serving, which runs under ``torch.no_grad()``, takes the
same path as before.
"""
from __future__ import annotations

import math
import os
import socket
import subprocess
import threading
import time
from typing import Optional

import torch


def world_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))


def choose_backend(device_type: str) -> tuple:
    """(backend, reason): ``nccl`` when every local rank has a card of
    its own, else ``gloo``."""
    if device_type != "cuda":
        return "gloo", "ranks run on the CPU"
    cards, ranks = torch.cuda.device_count(), local_world_size()
    if cards >= ranks:
        return "nccl", f"{ranks} ranks on {cards} cards, one card each"
    return "gloo", (f"{ranks} ranks share {cards} card(s): NCCL refuses "
                    "two ranks on one device")


def rank_device(device_type: str):
    """This rank's device: its own card where there are enough, else the
    cards shared round-robin."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def init_distributed(device_type: str = "cuda", *, verbose: bool = True):
    """Create the default process group from the environment (once).
    Returns (backend, device)."""
    import torch.distributed as dist
    device = rank_device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return dist.get_backend(), device
    backend, why = choose_backend(device.type)
    rank, n = int(os.environ.get("RANK", "0")), world_size()
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT") or str(free_port())
    if addr in ("127.0.0.1", "localhost"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=n)
    if verbose and rank == 0:
        print(f"[mesh] {n} ranks, backend {backend} ({why})", flush=True)
    return backend, device


class Mesh:
    """A (data, model)-style grid of ranks: ``axis_names``, ``shape``,
    this rank's ``coords`` and one process group per axis (the ranks
    that differ from this one only along that axis).  Collectives take
    an axis name; on an axis of extent 1 they return their input."""

    def __init__(self, shape, axis_names, *, rank: int, groups: dict,
                 backend: str, device, host_group=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.coords = _coords(rank, self.shape)
        self.groups = groups
        self.backend = backend
        self.device = device
        self.host_group = host_group
        self.host_syncs = 0          # gloo collectives staged through host
        self.collectives = 0
        self.comm_s = 0.0            # host seconds inside collectives
        # result bytes of this rank's collectives, per kind: an
        # all-reduce's output is its input's shape, an all-gather's the
        # concatenation of every rank's part
        self.coll_bytes = {"all-reduce": 0, "all-gather": 0,
                           "reduce-scatter": 0}
        # with ``timing``, CUDA events around each collective on a card:
        # NCCL returns to the host before the device is done, so only the
        # device's clock sees an NCCL collective's time (``device_comm_s``)
        self.timing = False
        self._events = []

    @property
    def size_total(self) -> int:
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def index(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, rank "
                f"{self.rank} at {self.coords}, {self.backend})")

    # ------------------------------------------------------------------
    def _begin(self, t):
        """(host clock, start event or None) of a collective on ``t``."""
        ev = None
        if self.timing and t.is_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return time.perf_counter(), ev

    def _end(self, began, kind: str, out) -> None:
        t0, ev = began
        if ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((ev, end))
        self.collectives += 1
        self.coll_bytes[kind] += out.numel() * out.element_size()
        self.comm_s += time.perf_counter() - t0

    def device_comm_s(self) -> float:
        """Device seconds between the events around this rank's
        collectives since the counters were reset (``timing`` on): the
        collective and its wait for the other ranks, on the current
        stream.  Synchronizes the card."""
        if not self._events:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events) / 1e3

    def _staged(self, t):
        """(tensor the backend takes, whether it was staged to host)."""
        if self.backend == "gloo" and t.device.type == "cuda":
            self.host_syncs += 1
            return t.cpu(), True
        return t.contiguous(), False

    def all_reduce(self, t, axis: str, op: str = "sum"):
        """Sum (or with ``op="max"`` the maximum) of ``t`` over ``axis``
        (a new tensor on t's device)."""
        if self.size(axis) == 1:
            return t
        import torch.distributed as dist
        began = self._begin(t)
        buf, staged = self._staged(t.clone())
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self.groups[axis])
        out = buf.to(t.device) if staged else buf
        self._end(began, "all-reduce", out)
        return out

    def all_gather(self, t, axis: str, dim: int = -1):
        """``t`` of every rank along ``axis``, concatenated in rank order
        along ``dim``."""
        n = self.size(axis)
        if n == 1:
            return t
        import torch.distributed as dist
        began = self._begin(t)
        buf, staged = self._staged(t)
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=self.groups[axis])
        out = torch.cat(parts, dim=dim)
        if staged:
            out = out.to(t.device)
        self._end(began, "all-gather", out)
        return out

    def reduce_scatter(self, t, axis: str, dim: int = 0):
        """This rank's slice along ``dim`` of the sum of ``t`` over
        ``axis`` (the ranks' slices in rank order, equal in size).  NCCL
        runs it as one reduce-scatter; gloo, which stages through host
        memory anyway, as an all-reduce cut to the slice."""
        n = self.size(axis)
        if n == 1:
            return t
        import torch.distributed as dist
        dim = dim % t.dim()
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                             f"does not divide over {axis} ({n})")
        began = self._begin(t)
        part = t.shape[dim] // n
        if self.backend == "nccl":
            src = t.movedim(dim, 0).contiguous()
            buf = torch.empty((part, *src.shape[1:]), dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(buf, src, group=self.groups[axis])
            out = buf.movedim(0, dim)
        else:
            buf, staged = self._staged(t.clone())
            dist.all_reduce(buf, group=self.groups[axis])
            out = buf.narrow(dim, self.index(axis) * part, part).contiguous()
            if staged:
                out = out.to(t.device)
        self._end(began, "reduce-scatter", out)
        return out

    def broadcast_float(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (host state: a clock)."""
        if self.size_total == 1:
            return value
        import torch.distributed as dist
        t = torch.tensor([value], dtype=torch.float64)
        dist.broadcast(t, src=0, group=self.host_group)
        return float(t[0])

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj`` (picklable), by rank, on every rank."""
        if self.size_total == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.size_total
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def same_on_all(self, obj) -> bool:
        """Whether every rank holds an equal ``obj`` (picklable)."""
        out = self.gather_objects(obj)
        return all(o == out[0] for o in out)

    def same_within(self, obj, axis: str) -> bool:
        """Whether the ranks of each ``axis`` group (the ranks that differ
        only along ``axis``) hold an equal ``obj``; the same answer on
        every rank."""
        i = self.axis_names.index(axis)
        first = {}
        for r, o in enumerate(self.gather_objects(obj)):
            key = tuple(c for j, c in enumerate(_coords(r, self.shape))
                        if j != i)
            if first.setdefault(key, o) != o:
                return False
        return True

    def reset_counters(self) -> None:
        self.host_syncs = self.collectives = 0
        self.comm_s = 0.0
        self.coll_bytes = {"all-reduce": 0, "all-gather": 0,
                           "reduce-scatter": 0}
        self._events = []


# ---------------------------------------------------------------------------
# differentiable collectives (training)
# ---------------------------------------------------------------------------


def _tracked(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _own(t, mesh, axis: str, dim: int):
    """This rank's slice along ``dim`` of ``t`` (every rank's slice one
    width, in rank order)."""
    n = t.shape[dim] // mesh.size(axis)
    return t.narrow(dim, mesh.index(axis) * n, n)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(t, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (_own(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None,
                None, None)


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own(t, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g.contiguous(), ctx.axis, dim=ctx.dim),
                None, None, None)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(t, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        # summed in f32 whatever the weight's dtype, then the mean
        n = ctx.mesh.size(ctx.axis)
        out = ctx.mesh.reduce_scatter(g.float(), ctx.axis, dim=ctx.dim)
        return out.div_(n).to(g.dtype), None, None, None


def sum_partials(t, mesh, axis: str = "model"):
    """The sum over ``axis`` of each rank's partial ``t``; its gradient
    passes unchanged to every rank."""
    if mesh.size(axis) == 1:
        return t
    if not _tracked(t):
        return mesh.all_reduce(t, axis)
    return _SumPartials.apply(t, mesh, axis)


def enter_parallel(t, mesh, axis: str = "model"):
    """``t``, replicated over ``axis``, as the input of work that differs
    from rank to rank: its gradient is the sum of the ranks'.  A tensor
    this returned is returned as it is, so a caller that enters one
    input of several such consumers (the q, k and v of one activation)
    all-reduces its gradient once."""
    if mesh.size(axis) == 1 or not _tracked(t):
        return t
    if getattr(t, "_parallel", None) == (mesh, axis):
        return t
    out = _EnterParallel.apply(t, mesh, axis)
    out._parallel = (mesh, axis)
    return out


def gather_replicated(t, mesh, axis: str = "model", dim: int = -1):
    """Every rank's slice of ``t`` along ``dim``, concatenated in rank
    order, for work that is the same on every rank; the gradient of the
    rank's slice is its slice of the (equal) gradient."""
    if mesh.size(axis) == 1:
        return t
    if not _tracked(t):
        return mesh.all_gather(t, axis, dim=dim)
    return _GatherReplicated.apply(t, mesh, axis, dim % t.dim())


def split_replicated(t, mesh, axis: str = "model", dim: int = -1):
    """This rank's slice along ``dim`` of ``t``, replicated over
    ``axis``; the gradient of ``t`` is every rank's slice gathered."""
    if mesh.size(axis) == 1:
        return t
    if not _tracked(t):
        return _own(t, mesh, axis, dim % t.dim()).contiguous()
    return _SplitReplicated.apply(t, mesh, axis, dim % t.dim())


def gather_shards(t, mesh, axis: str = "data", dim: int = 0):
    """A weight whose ``dim`` is cut over ``axis`` (FSDP), gathered whole
    along it; the shard's gradient is the reduce-scatter of the whole
    one's, divided by the extent of ``axis``: the data-parallel mean."""
    if mesh.size(axis) == 1:
        return t
    if not _tracked(t):
        return mesh.all_gather(t, axis, dim=dim)
    return _GatherShards.apply(t, mesh, axis, dim % t.dim())


def _coords(rank: int, shape) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_mesh(shape, axes, *, device_type: Optional[str] = None) -> Mesh:
    """The mesh of ``shape`` over the world's ranks, creating the
    process group from the environment if there is none.  Every rank
    must call it, with the same arguments."""
    import torch.distributed as dist
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "rank")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend, device = init_distributed(device_type)
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the world has {n}")
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in the same order
    for i, axis in enumerate(axes):
        for r in range(n):
            c = _coords(r, shape)
            if c[i] != 0:
                continue
            members = []
            for j in range(shape[i]):
                cc = list(c)
                cc[i] = j
                members.append(_rank_of(cc, shape))
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    host = (dist.new_group(list(range(n)), backend="gloo")
            if backend != "gloo" else dist.group.WORLD)
    return Mesh(shape, axes, rank=rank, groups=groups, backend=backend,
                device=device, host_group=host)


def _rank_of(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def make_production_mesh(*, multi_pod: bool = False, **kw) -> Mesh:
    """16x16 (single pod, 256 ranks) or 2x16x16 (two pods, 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = world_size()
    if n != math.prod(shape):
        raise ValueError(f"the production mesh needs {math.prod(shape)} "
                         f"ranks ({'x'.join(map(str, shape))}), the world "
                         f"has {n}")
    return make_mesh(shape, axes, **kw)


def mesh_shape_for(n_devices: int, model_parallel: int = 0) -> tuple:
    """The (data, model) shape :func:`make_mesh_for` builds."""
    if model_parallel <= 0:
        model_parallel = min(16, n_devices)
    while n_devices % model_parallel:
        model_parallel //= 2
    return n_devices // model_parallel, model_parallel


def make_mesh_for(n_devices: int, model_parallel: int = 0, **kw) -> Mesh:
    """Best (data, model) mesh for ``n_devices`` ranks."""
    return make_mesh(mesh_shape_for(n_devices, model_parallel),
                     ("data", "model"), **kw)


def parse_mesh_shape(spec: str, tp: int = 0) -> tuple:
    """The (data, model) shape of a ``--mesh`` flag, with the
    reference's refusals (ValueError); builds nothing."""
    if spec == "auto":
        n = world_size()
        if tp and n % tp:
            raise ValueError(f"--tp {tp} does not divide the {n} visible "
                             f"devices")
        return mesh_shape_for(n, tp)
    try:
        data, model = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh expects 'auto' or 'DxM' (e.g. 2x4), "
                         f"got {spec!r}")
    if tp and tp != model:
        raise ValueError(f"--tp {tp} contradicts --mesh {spec} "
                         f"(model axis {model})")
    n = world_size()
    if data * model != n:
        raise ValueError(f"--mesh {spec} needs {data * model} devices, "
                         f"found {n} (hint: torchrun --nproc-per-node "
                         f"{data * model})")
    return data, model


def parse_mesh(spec: str, tp: int = 0, **kw) -> Mesh:
    """A serving mesh from a CLI flag: ``"auto"`` (the largest (data,
    model) divisor mesh over the world, ``tp`` pinning the model axis) or
    an explicit ``"DxM"`` (must multiply to the world size)."""
    return make_mesh(parse_mesh_shape(spec, tp), ("data", "model"), **kw)


# ---------------------------------------------------------------------------
# local launcher
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv, nprocs: int, *, env: Optional[dict] = None,
          timeout: float = 600.0, cwd=None) -> list:
    """Run ``argv`` (a command list) as ``nprocs`` ranks on this host,
    with the environment ``torchrun`` would give them, and wait for all.
    Returns [(returncode, stdout, stderr)] by rank.  If one rank fails
    or the time runs out, the others are killed: no process outlives
    the call."""
    port = free_port()
    procs = []
    base = {**os.environ, **(env or {})}
    for r in range(nprocs):
        e = {**base, "RANK": str(r), "LOCAL_RANK": str(r),
             "WORLD_SIZE": str(nprocs), "LOCAL_WORLD_SIZE": str(nprocs),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            argv, env=e, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    outs = [None] * nprocs

    def reader(i, p):
        outs[i] = p.communicate()

    threads = [threading.Thread(target=reader, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    try:
        while any(t.is_alive() for t in threads):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in threads:
            t.join(timeout=30)
    return [(p.returncode, *(outs[i] or ("", "")))
            for i, p in enumerate(procs)]


__all__ = ["Mesh", "choose_backend", "enter_parallel", "free_port",
           "gather_replicated", "gather_shards", "init_distributed",
           "make_mesh", "make_mesh_for", "make_production_mesh",
           "mesh_shape_for", "parse_mesh", "parse_mesh_shape", "spawn",
           "split_replicated", "sum_partials", "world_size"]
