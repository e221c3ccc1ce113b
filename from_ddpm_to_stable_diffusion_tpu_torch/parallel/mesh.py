"""Device meshes and their collectives (port of ``parallel/mesh.py``).

A :class:`Mesh` names its axes and their sizes, as ``jax.sharding.Mesh``
does. The parallel functions (ring and Ulysses attention, the Switch-MoE
experts, the pipeline schedules) are written once against the collectives of
one mesh axis, :class:`AxisComm`, over the shards *this process* holds. A
mesh has one of two forms:

(a) One process holds every shard: ``build_mesh(shape, devices)`` over a
    list of ``torch.device`` whose length is the product of the sizes, and
    shard *i* of an axis lives on its device. The same device may repeat:
    ``[torch.device("cuda")] * 4`` runs a 4-way ring on one card, as XLA's
    virtual host devices run the JAX package's meshes on one CPU. A sharded
    tensor is the whole tensor; ``ppermute`` hands a shard to its
    neighbour's device (list indexing on one device, no copy), ``all_to_all``
    re-chunks and ``psum`` sums. Autograd differentiates all three.
(b) One shard per rank of a ``torch.distributed`` process group
    (:func:`init_multihost`, then ``build_mesh(shape, group=...)``; gloo on
    the CPU, NCCL on cards). A sharded tensor is the rank's own shard;
    ``ppermute`` is ``batch_isend_irecv``, ``all_to_all``
    ``all_to_all_single`` and ``psum`` ``all_reduce``, each an autograd
    function whose backward runs the transposed collective.

Gradients in form (b). A tensor computed alike on every rank of an axis
(replicated) carries the same gradient on every rank of it: ``scatter``
(the rank's slice) sums the slices' gradients over the axis, ``gather``
(all_gather) keeps the gradient's local slice. On a batch axis each rank's
loss is its own shard's and the gradients are averaged afterwards:
``gather_batch`` sums the gradient over the ranks and keeps the local slice,
``slice_batch`` pads it with zeros. In form (a) all four are the identity.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def visible_devices(kind: str = "cuda") -> List[torch.device]:
    """Every visible device of ``kind``, as ``jax.devices()``: each CUDA
    device, or the one host device for "cpu"."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   backend: Optional[str] = None, store=None) -> int:
    """Join this process to a ``torch.distributed`` group, the counterpart of
    ``jax.distributed.initialize``. ``coordinator`` is "host:port" (or any
    init URL); without one the environment (``MASTER_ADDR`` ...) or
    ``store`` (e.g. a ``FileStore``) gives the rendezvous. ``backend``:
    NCCL where CUDA is available, else gloo. Returns the number of ranks,
    each one shard of a form-(b) mesh."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(world_size=-1 if num_processes is None else num_processes,
              rank=-1 if process_id is None else process_id)
    if store is not None:
        kw["store"] = store
    elif coordinator is not None:
        kw["init_method"] = (coordinator if "://" in coordinator
                             else f"tcp://{coordinator}")
    dist.init_process_group(backend, **kw)
    return dist.get_world_size()


# --------------------------------------------------------------------------
# form (b): collectives as autograd functions
# --------------------------------------------------------------------------
def _p2p(x, perm, comm):
    me = comm.index[0]
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out = x.clone()
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x, comm.ranks[d], comm.group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, comm.ranks[s], comm.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, comm):
        ctx.perm, ctx.comm = perm, comm
        return _p2p(x, perm, comm)

    @staticmethod
    def backward(ctx, g):
        return _p2p(g, tuple((d, s) for s, d in ctx.perm), ctx.comm), None, \
            None


def _a2a(x, split_dim, concat_dim, comm):
    inp = torch.stack([c.contiguous() for c in x.chunk(comm.n, split_dim)])
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=comm.group)
    return torch.cat(list(out.unbind(0)), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, comm):
        ctx.dims, ctx.comm = (split_dim, concat_dim), comm
        return _a2a(x, split_dim, concat_dim, comm)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, concat_dim, split_dim, ctx.comm), None, None, None


def _all_reduce(x, comm):
    x = x.clone()
    dist.all_reduce(x, group=comm.group)
    return x


def _all_gather(x, dim, comm):
    parts = [torch.empty_like(x) for _ in range(comm.n)]
    dist.all_gather(parts, x.contiguous(), group=comm.group)
    return torch.cat(parts, dim)


def _local(x, dim, comm):
    return x.chunk(comm.n, dim)[comm.index[0]].contiguous()


def _pad_local(g, dim, comm, n_full):
    full = torch.zeros((*g.shape[:dim], n_full, *g.shape[dim + 1:]),
                       dtype=g.dtype, device=g.device)
    full.narrow(dim, comm.index[0] * g.shape[dim], g.shape[dim]).copy_(g)
    return full


class _AllReduce(torch.autograd.Function):
    """psum of a value the ranks then use alike: the backward passes the
    gradient through."""

    @staticmethod
    def forward(ctx, x, comm):
        return _all_reduce(x, comm)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """A replicated tensor entering a column-parallel layer (Megatron's
    ``f``): identity forward; the backward sums the shards' gradients, each
    of which saw only its own columns."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.comm), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm):
        ctx.dim, ctx.comm, ctx.n_full = dim, comm, x.shape[dim]
        return _local(x, dim, comm)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(_pad_local(g, ctx.dim, ctx.comm, ctx.n_full),
                           ctx.comm), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm):
        ctx.dim, ctx.comm = dim, comm
        return _all_gather(x, dim, comm)

    @staticmethod
    def backward(ctx, g):
        return _local(g, ctx.dim, ctx.comm), None, None


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm):
        ctx.dim, ctx.comm = dim, comm
        return _all_gather(x, dim, comm)

    @staticmethod
    def backward(ctx, g):
        return _local(_all_reduce(g, ctx.comm), ctx.dim, ctx.comm), None, None


class _SliceBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm):
        ctx.dim, ctx.comm, ctx.n_full = dim, comm, x.shape[dim]
        return _local(x, dim, comm)

    @staticmethod
    def backward(ctx, g):
        return _pad_local(g, ctx.dim, ctx.comm, ctx.n_full), None, None


def _relayout(x, dim, perm, comm):
    full = _all_gather(x, dim, comm)
    return _local(full.index_select(dim, perm.to(x.device)), dim, comm)


class _Relayout(torch.autograd.Function):
    """The local shard of a sharded tensor re-ordered by a global
    permutation of its sharded dim; the backward applies the inverse."""

    @staticmethod
    def forward(ctx, x, dim, perm, inv, comm):
        ctx.args = dim, inv, comm
        return _relayout(x, dim, perm, comm)

    @staticmethod
    def backward(ctx, g):
        return _relayout(g, *ctx.args), None, None, None, None


# --------------------------------------------------------------------------
# one mesh axis
# --------------------------------------------------------------------------
class AxisComm:
    """The collectives of one mesh axis over the shards this process holds
    (each a list: every shard in form (a), the rank's own in form (b)).
    ``index``: the axis positions of those shards; ``devices``: theirs."""

    def __init__(self, name: str, n: int, index: Sequence[int],
                 devices: Sequence[torch.device], group=None,
                 ranks: Optional[Sequence[int]] = None):
        self.name, self.n = name, n
        self.index, self.devices = list(index), list(devices)
        self.group, self.ranks = group, ranks

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def __repr__(self):
        form = "ranks" if self.distributed else "devices"
        return f"AxisComm({self.name!r}, n={self.n}, {form})"

    # sharded <-> the shards held
    def shards(self, x, dim: int) -> list:
        """The shards this process holds of ``x``, sharded on ``dim``: in
        form (a) ``x`` is the whole tensor, chunked and each chunk on its
        device (no copy where it already lies there); in form (b) ``x`` is
        the rank's shard."""
        if self.distributed:
            return [x]
        if x.shape[dim] % self.n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"over the {self.name!r} axis of {self.n}")
        return [c.to(d) for c, d in zip(x.chunk(self.n, dim), self.devices)]

    def unshard(self, xs: list, dim: int):
        """Inverse of :meth:`shards`: the chunks joined on the first shard's
        device (form (a)), the rank's shard (form (b))."""
        if self.distributed:
            return xs[0]
        dev = xs[0].device
        return torch.cat([x.to(dev) for x in xs], dim)

    def local_shards(self, x, dim: int) -> list:
        """The shards this process holds of a tensor that every shard holds
        whole (replicated): :meth:`shards` of :meth:`scatter`."""
        return self.shards(self.scatter(x, dim), dim)

    def global_len(self, x, dim: int) -> int:
        """Length of the sharded ``dim`` over the whole axis."""
        return x.shape[dim] * (self.n if self.distributed else 1)

    # replicated <-> sharded
    def scatter(self, x, dim: int):
        """A tensor replicated over the axis, as this process's sharded form
        of it (form (b): the rank's slice; its gradient sums over ranks)."""
        return _Scatter.apply(x, dim, self) if self.distributed else x

    def gather(self, x, dim: int):
        """Inverse of :meth:`scatter` (form (b): all_gather; its gradient is
        the local slice)."""
        return _Gather.apply(x, dim, self) if self.distributed else x

    def gather_batch(self, x, dim: int = 0):
        """The whole batch from each rank's shard, where each rank's loss is
        its own shard's (form (b): all_gather; its gradient is summed over
        the ranks and sliced)."""
        return _GatherBatch.apply(x, dim, self) if self.distributed else x

    def slice_batch(self, x, dim: int = 0):
        """Inverse of :meth:`gather_batch` (its gradient zero-padded)."""
        return _SliceBatch.apply(x, dim, self) if self.distributed else x

    def permute(self, x, dim: int, perm, inv):
        """``x`` (sharded on ``dim``) re-ordered by the global permutation
        ``perm`` of that dim, ``inv`` its inverse."""
        if self.distributed:
            return _Relayout.apply(x, dim, perm, inv, self)
        return x.index_select(dim, perm.to(x.device))

    def copy_to(self, x):
        """A replicated tensor as the input of this axis's shards
        (column-parallel layers): form (b) all-reduces its gradient, form
        (a) leaves it as it is."""
        return _CopyTo.apply(x, self) if self.distributed else x

    # collectives
    def pmax(self, xs: list) -> list:
        """The elementwise maximum over the axis, on every shard (no
        gradient: W8A8's per-token abs-max)."""
        if self.distributed:
            x = xs[0].clone()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
            return [x]
        top = xs[0]
        for x in xs[1:]:
            top = torch.maximum(top, x.to(top.device))
        return [top.to(d) for d in self.devices]

    def ppermute(self, xs: list, perm) -> list:
        """``jax.lax.ppermute``: ``perm`` holds (source, destination) pairs
        of axis positions; a shard that no pair sends to gets zeros."""
        perm = tuple((int(s), int(d)) for s, d in perm)
        if self.distributed:
            return [_PPermute.apply(xs[0], perm, self)]
        src = {d: s for s, d in perm}
        return [xs[src[j]].to(self.devices[j]) if j in src
                else torch.zeros_like(xs[j]) for j in range(self.n)]

    def shift(self, xs: list, k: int = 1) -> list:
        """Every shard to the position ``k`` after it, around the ring."""
        return self.ppermute(xs, [(j, (j + k) % self.n)
                                  for j in range(self.n)])

    def all_to_all(self, xs: list, split_dim: int, concat_dim: int) -> list:
        """``jax.lax.all_to_all(tiled=True)``: each shard split into n
        chunks on ``split_dim``, chunk j to shard j, which concatenates what
        it receives, in source order, on ``concat_dim``."""
        if self.distributed:
            return [_AllToAll.apply(xs[0], split_dim, concat_dim, self)]
        parts = [x.chunk(self.n, split_dim) for x in xs]
        return [torch.cat([parts[i][j].to(self.devices[j])
                           for i in range(self.n)], concat_dim)
                for j in range(self.n)]

    def psum(self, xs: list) -> list:
        """The sum over the axis, on every shard."""
        if self.distributed:
            return [_AllReduce.apply(xs[0], self)]
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return [total.to(d) for d in self.devices]


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------
class Mesh:
    """Named axes with sizes over devices (form (a)) or over the ranks of a
    process group (form (b)). ``shape``: axis name -> size, in order."""

    def __init__(self, shape: Mapping[str, int], devices=None, group=None,
                 device: Optional[torch.device] = None):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names = tuple(self.shape)
        sizes = tuple(self.shape.values())
        self.devices = devices      # object array shaped by the sizes
        self.group = group
        self._comms: Dict[str, AxisComm] = {}
        if group is None:
            return
        self.rank = dist.get_rank(group)
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             sizes))
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend(group) == "nccl"
                      else torch.device("cpu"))
        self.device = torch.device(device)
        world = dist.get_process_group_ranks(group)
        grid = np.asarray(world).reshape(sizes)
        for a, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, a, -1).reshape(-1, sizes[a])
            mine = None
            for line in lines:
                line = [int(r) for r in line]
                g = (group if len(line) == len(world)
                     else dist.new_group(line))
                if dist.get_rank() in line:
                    mine = (g, line)
            self._comms[name] = AxisComm(name, sizes[a], [self.coords[a]],
                                         [self.device], group=mine[0],
                                         ranks=mine[1])

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def comm(self, axis: str) -> AxisComm:
        """The collectives of ``axis``. In form (a) an axis's shards must lie
        on the same devices at every position of the other axes (true of
        any mesh over one device repeated)."""
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        if axis not in self._comms:
            a = self.axis_names.index(axis)
            lines = np.moveaxis(self.devices, a, -1).reshape(
                -1, self.shape[axis])
            if any(list(line) != list(lines[0]) for line in lines[1:]):
                raise NotImplementedError(
                    f"axis {axis!r} of {self.shape} lies on different devices "
                    "at different positions of the other axes: one process "
                    "drives such a mesh only with one device repeated; on "
                    "several cards run a process group, one rank per card "
                    "(build_mesh(shape, group=...))")
            self._comms[axis] = AxisComm(axis, self.shape[axis],
                                         range(self.shape[axis]),
                                         list(lines[0]))
        return self._comms[axis]

    def __repr__(self):
        where = (f"rank {self.rank} of a process group" if self.distributed
                 else f"devices {sorted({str(d) for d in self.devices.flat})}")
        return f"Mesh({self.shape}, {where})"


def _indexed(device: torch.device) -> torch.device:
    """"cuda" as the current CUDA device's index, so that a shard already on
    it is not copied."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def build_mesh(shape: Optional[Mapping[str, int]] = None, devices=None, *,
               group=None, device: Optional[torch.device] = None) -> Mesh:
    """A named mesh. ``shape`` maps axis name -> size, e.g. {"data": 4,
    "seq": 2}; None puts every device on the data axis; -1 infers one axis.
    The sizes must multiply to the device count.

    Form (a): ``devices``, a list of ``torch.device`` (repeats allowed);
    None is every visible CUDA device. Form (b): ``group``, a process group
    (one shard per rank; ``device`` is this rank's), also taken when
    ``devices`` is None and ``torch.distributed`` is initialised."""
    if group is None and devices is None and dist.is_available() \
            and dist.is_initialized():
        group = dist.group.WORLD
    if group is not None:
        n = dist.get_world_size(group)
    else:
        devices = visible_devices() if devices is None else [
            _indexed(torch.device(d)) for d in devices]
        n = len(devices)
    if not shape:
        shape = {DATA_AXIS: n}
    names, sizes = list(shape.keys()), list(shape.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} != {n} "
                         "devices")
    if group is not None:
        return Mesh(dict(zip(names, sizes)), group=group, device=device)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(dict(zip(names, sizes)), devices=grid.reshape(sizes))


def local_mesh(n: Optional[int] = None, axis: str = DATA_AXIS,
               kind: str = "cuda") -> Mesh:
    """1-D mesh over the first ``n`` visible devices of ``kind`` (all)."""
    devs = visible_devices(kind)
    if n is not None:
        devs = devs[:n]
    return build_mesh({axis: len(devs)}, devs)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def mesh_device(mesh: Mesh) -> torch.device:
    """Where a form-(a) mesh keeps what is not sharded (its first device),
    or a form-(b) rank's device."""
    return mesh.device if mesh.distributed else mesh.devices.flat[0]


def shard_batch(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """Host arrays (numpy or tensors; a tree of them) on the mesh, batch dim
    sharded over ``axis``: in form (b) each rank's slice of the batch on its
    device. In form (a) every shard of ``axis`` is one device, so the batch
    stays one tensor there: the mean over equal shards is the whole-batch
    mean, as JAX's ``jnp.mean`` over a sharded array is."""
    comm = mesh.comm(axis) if axis in mesh.shape else None
    if comm is not None and not comm.distributed \
            and len(set(comm.devices)) > 1:
        raise NotImplementedError(
            f"a {axis!r} axis over distinct devices in one process: one "
            "process holds a batch shard per device only with one device "
            "repeated; on several cards run a process group, one rank per "
            "card (init_multihost, then build_mesh(shape, group=...))")
    dev = mesh_device(mesh)

    def put(x):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if x.dim() and comm is not None:
            if x.shape[0] % comm.n:
                raise ValueError(f"batch {x.shape[0]} does not divide over "
                                 f"the {axis!r} axis of {comm.n}")
            x = _local(x, 0, comm) if comm.distributed else x
        return x.to(dev)

    return _map(put, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` whole on the mesh: on its first device (form
    (a)), or on each rank, broadcast from the group's first rank (form
    (b))."""
    dev = mesh_device(mesh)

    def put(x):
        x = torch.as_tensor(x).to(dev)
        if mesh.distributed:
            x = x.clone()
            dist.broadcast(x, dist.get_process_group_ranks(mesh.group)[0],
                           group=mesh.group)
        return x

    return _map(put, tree)
