"""The mesh on ``torch.distributed``, and the launcher of its ranks.

The reference builds a jax Mesh over the devices of one process — a
``("data",)`` calibration mesh, a ``("data", "model")`` serve mesh — and
runs its steps under ``shard_map``.  Here one process is one rank:
:class:`Mesh` is that rank's view of the same mesh — the world size, its
rank, the shape and axis names (row-major over the ranks, as the
reference's mesh places its devices), the process group of its ``model``
axis (the ``tp`` consecutive ranks that hold one model's shards), of its
data-parallel axes (the ranks with the same ``model`` index) and of each
named axis on its own (:meth:`Mesh.group_of`), and the device it runs
on.  ``shard_map``'s per-shard body becomes the rank's own step on its
local shard; ``psum`` / ``all_gather`` over an axis become collectives
over that axis's group.

:func:`make_mesh` and :func:`make_data_mesh` build the reference's general
and calibration meshes (``engine="sharded"``), :func:`serve_mesh` the serve
mesh (``--tp``); :func:`batch_rows` says which rows of a leading batch dim
a rank owns (the reference's ``batch_spec``).  A mesh of one rank needs no
process group: every exchange over it is the identity, so the sharded
engine runs in a plain process, as the reference's 1-device mesh does.

A mesh need not span the whole process group: it holds its members'
global ranks (``Mesh.ranks``, row-major over its shape; every rank of the
group by default), so every group it makes and every ``broadcast(src=)``
over it names global ranks.  :func:`pod_submeshes` carves a ``("pod",
"data", "model")`` mesh into one ``("data", "model")`` submesh a pod, over
that pod's ranks, and :func:`reshard_between_pods` moves a tensor tree from
one pod's ranks to another's: the seam of the pod-pipelined block walk
(``core.pipeline``).  :func:`make_production_mesh` is the reference's
16 x 16 (or 2 x 16 x 16) chip grid as a rank's view; its rank layout is the
pure :func:`production_layout`.

The backend of the process group is always the caller's choice
(:func:`run_ranks`): NCCL needs one card per rank; gloo runs on the CPU and
on ranks that share a card (it stages a CUDA collective through the host).
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device

AXES = ("data", "model")
DP_AXES = ("pod", "data")
BACKENDS = ("nccl", "gloo")


def _axis_groups(shape, axis_names, axes, ranks=None) -> np.ndarray:
    """Every group of the mesh along ``axes``: (groups, members) global
    ranks, each row one group, its members row-major over ``axes``.
    ``ranks``: the mesh's global ranks, row-major (default ``0..n-1``)."""
    grid = np.asarray(range(math.prod(shape)) if ranks is None
                      else ranks).reshape(shape)
    along = [axis_names.index(a) for a in axes]
    rest = [d for d in range(len(shape)) if d not in along]
    size = math.prod(shape[d] for d in along)
    return grid.transpose(rest + along).reshape(-1, size)


def _group_of(shape, axis_names, axes, rank, ranks=None) -> Tuple[int, ...]:
    rows = _axis_groups(shape, axis_names, axes, ranks)
    hit = rows[(rows == rank).any(axis=1)]
    if not len(hit):
        raise ValueError(f"rank {rank} is not a member of the mesh over "
                         f"ranks {tuple(ranks)}")
    return tuple(int(r) for r in hit[0])


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh: ``shape`` over ``axis_names``, the
    ranks laid out row-major over it.

    ``group`` is the process group of the rank's ``model`` axis (the
    consecutive ranks that hold one model's shards; every collective of
    the serve steps and the TP gathers of the sharded engine run over it),
    ``data_group`` that of its data-parallel axes (``pod`` and ``data``:
    the ranks with the same ``model`` index, over which the sharded
    engine exchanges its gradient).  ``axis_groups`` maps each axis name
    to the process group of the rank's line along that axis alone (the
    collectives of ``pmax`` / ``psum`` over one named axis, e.g.
    ``optim.compression.compressed_psum``'s ``pod``), and ``mesh_group``
    is that of every rank of the mesh: None where the mesh is the whole
    process group (the default group).  All are None on a mesh of one rank
    without a process group.  ``device`` is the ``torch.device`` the rank
    runs on.

    ``world`` is the mesh's number of ranks and ``ranks`` their global
    ranks, row-major over ``shape`` (default ``0..world-1``: the whole
    process group).  ``rank`` is the rank's own global rank; a view of a
    mesh the rank is not a member of (another pod's submesh) has no
    groups, and only its shape and ranks may be read.  ``cache_layouts``
    records the shardings of the caches allocated on the mesh
    (``launch.sharding.mesh_cache_model``)."""
    world: int
    rank: int
    shape: Tuple[int, ...]
    group: Any = dataclasses.field(repr=False)
    device: torch.device
    axis_names: Tuple[str, ...] = AXES
    data_group: Any = dataclasses.field(default=None, repr=False)
    axis_groups: Any = dataclasses.field(default=None, repr=False,
                                         compare=False)
    ranks: Optional[Tuple[int, ...]] = None
    mesh_group: Any = dataclasses.field(default=None, repr=False,
                                        compare=False)
    cache_layouts: dict = dataclasses.field(default_factory=dict, repr=False,
                                            compare=False)

    def __post_init__(self):
        ranks = (tuple(range(self.world)) if self.ranks is None
                 else tuple(int(r) for r in self.ranks))
        if len(ranks) != self.world or len(set(ranks)) != self.world:
            raise ValueError(f"a mesh of {self.world} ranks needs as many "
                             f"distinct global ranks, got {ranks}")
        object.__setattr__(self, "ranks", ranks)

    @property
    def member(self) -> bool:
        """Whether the rank is one of the mesh's."""
        return self.rank in self.ranks

    @property
    def model_ranks(self) -> Tuple[int, ...]:
        """Global ranks of the rank's ``model`` group, in axis order."""
        return self.ranks_of(("model",) if tp_axis(self) else ())

    @property
    def data_ranks(self) -> Tuple[int, ...]:
        """Global ranks of the rank's data-parallel group, row-major over
        the DP axes."""
        return self.ranks_of(dp_axes(self))

    @property
    def model_rank(self) -> int:
        """The rank's position on the ``model`` axis (its shard index)."""
        return self.model_ranks.index(self.rank)

    @property
    def data_rank(self) -> int:
        """The rank's position over the data-parallel axes (its replica
        index, the reference's linearized ``_dp_rank``)."""
        return self.data_ranks.index(self.rank)

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        bad = [a for a in axes if a not in self.axis_names]
        if bad:
            raise ValueError(f"axes {bad} are not on the mesh's "
                             f"{self.axis_names}")
        return axes

    def size_of(self, axes) -> int:
        """The extent of one axis, or the product over a tuple of axes."""
        return math.prod(int(self.shape[self.axis_names.index(a)])
                         for a in self._axes(axes))

    def ranks_of(self, axes) -> Tuple[int, ...]:
        """Global ranks of the rank's line along ``axes`` (a name or a
        tuple; none: the rank alone), row-major over them: the order in
        which a dim split over ``axes`` concatenates."""
        axes = self._axes(axes)
        if not axes:
            return (self.rank,)
        return _group_of(self.shape, self.axis_names, axes, self.rank,
                         self.ranks)

    def index_of(self, axes) -> int:
        """The rank's position along ``axes`` (row-major over a tuple)."""
        return self.ranks_of(axes).index(self.rank)

    def group_of(self, axes):
        """The process group of the rank's line along ``axes``: one named
        axis, the data-parallel axes together, or every axis of the mesh
        (``mesh_group``: None, the default group, where the mesh is the
        whole process group).  None too on a line of one rank, where no
        collective runs."""
        axes = self._axes(axes)
        if self.size_of(axes) == 1:
            return None
        if set(axes) == set(self.axis_names):
            return self.mesh_group
        if axes == ("model",):
            return self.group
        if len(axes) == 1:
            return self.axis_groups[axes[0]]
        if set(axes) == set(dp_axes(self)):
            return self.data_group
        raise ValueError(f"no process group over {axes} on a mesh of "
                         f"{self.axis_names}")


def check_backend(backend: str, world: int, device) -> None:
    """Refuse a process group that cannot run: an unknown backend, NCCL
    where ranks would share a card (NCCL refuses a duplicate GPU in one
    communicator) or run on the CPU, or the ``"fake"`` backend (torch's
    test group, whose collectives move nothing) anywhere but on a dry mesh
    of ``device="meta"``, which computes nothing."""
    dev = torch.device(device)
    if backend == "fake":
        if dev.type != "meta":
            raise ValueError("backend 'fake' moves no bytes: it runs only a "
                             "dry mesh (device='meta'), never a path that "
                             f"computes (device {dev})")
        return
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend != "nccl":
        return
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if world > cards:
        raise ValueError(
            f"backend 'nccl' needs one CUDA device per rank: {world} ranks "
            f"on {cards} CUDA device(s) ({dev.type}); use backend 'gloo' "
            f"for ranks that share a card or run on the CPU")


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:{rank % device_count}``,
    or the CPU (or ``"meta"``, a dry mesh) when ``device`` says so."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _new_group(members):
    """``dist.new_group`` over ``members`` (global ranks), called by every
    rank of the process group; the group on a member, None elsewhere."""
    g = dist.new_group([int(m) for m in members])
    return g if dist.get_rank() in members else None


def _groups(shape, axis_names, rank, ranks):
    """The rank's (model group, data group, {axis: group}, mesh group),
    made by every rank of the process group (each ``dist.new_group`` is a
    collective of all ranks, called in the same order on every rank, the
    mesh's members or not).  A set of axes already made (the data axes of
    a ``("data",)`` mesh are its one axis) is not made twice; the mesh
    group is made only where the mesh is not the whole process group."""
    made = {}

    def group(axes):
        if not axes:
            return None
        if axes not in made:
            made[axes] = None
            for members in _axis_groups(shape, axis_names, axes, ranks):
                g = _new_group(members)
                if rank in members:
                    made[axes] = g
        return made[axes]

    model = group(("model",) if "model" in axis_names else ())
    data = group(tuple(a for a in axis_names if a in DP_AXES))
    axis = {a: group((a,)) for a in axis_names}
    whole = (None if len(ranks) == 1
             or set(ranks) == set(range(dist.get_world_size()))
             else _new_group(ranks))
    return model, data, axis, whole


def _build(shape, axis_names, device, who: str, ranks=None) -> Mesh:
    """The rank's view of a ``shape`` mesh over ``axis_names`` and the
    global ``ranks`` (row-major; default every rank of the process group).
    A mesh of one rank without a process group has no groups."""
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"{who}: shape {shape} does not fit axes "
                         f"{axis_names}")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1 or ranks not in (None, (0,), [0]):
            raise RuntimeError(
                f"{who}: a mesh of {n} ranks needs an initialized process "
                "group (launch.mesh.run_ranks starts one per rank)")
        return Mesh(world=1, rank=0, shape=shape, group=None,
                    device=resolve_device(device), axis_names=axis_names)
    world = dist.get_world_size()
    if ranks is None:
        if n != world:
            raise ValueError(f"{who}: a mesh of {n} ranks {shape}, but the "
                             f"process group has {world} ranks (pass "
                             "ranks= for a mesh over some of them)")
        ranks = range(n)
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != n or len(set(ranks)) != n \
            or not all(0 <= r < world for r in ranks):
        raise ValueError(f"{who}: a mesh of {n} ranks {shape} needs as many "
                         f"distinct ranks of the process group's {world}, "
                         f"got {ranks}")
    rank = dist.get_rank()
    dev = rank_device(rank, device)
    check_backend(dist.get_backend(), world, dev)
    group, data_group, axis_groups, whole = _groups(shape, axis_names, rank,
                                                    ranks)
    return Mesh(world=n, rank=rank, shape=shape, group=group, device=dev,
                axis_names=axis_names, data_group=data_group,
                axis_groups=axis_groups, ranks=ranks, mesh_group=whole)


def make_mesh(shape, axes=None, *, device="cuda", ranks=None) -> Mesh:
    """The rank's view of an arbitrary mesh (e.g. ``(2, 2)``), with the
    reference's default axis names: ``("pod", "data", "model")`` for three
    dims, else ``("data", "model")[:len(shape)]``.  ``ranks``: the global
    ranks it spans, row-major over ``shape`` (default: every rank of the
    process group, whose size must then be the mesh's).  Called by every
    rank of the process group, members or not (the groups are collectives
    of all ranks), or, for a mesh of one rank, by a plain process.

    ``device="meta"`` makes a dry mesh: one rank's view over a ``"fake"``
    process group of the mesh's size (``launch.dryrun``), whose steps run
    on fake tensors and are counted, not computed."""
    if axes is None:
        axes = (("pod", "data", "model") if len(shape) == 3
                else ("data", "model")[:len(shape)])
    return _build(shape, axes, device, "make_mesh", ranks)


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def production_layout(multi_pod: bool = False) -> dict:
    """The rank layout of :func:`make_production_mesh`, without a process
    group: its ``shape`` and ``axes``, ``ranks`` (the global ranks as a
    grid, row-major), and for each axis the lines of ranks along it
    (``lines[axis]``: (groups, members)); with ``multi_pod`` also each
    pod's ranks as its ``("data", "model")`` grid (``pods``)."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    grid = np.arange(math.prod(shape)).reshape(shape)
    out = {"shape": shape, "axes": axes, "ranks": grid,
           "lines": {a: _axis_groups(shape, axes, (a,)) for a in axes}}
    if multi_pod:
        out["pods"] = [grid[p] for p in range(shape[0])]
    return out


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production mesh as the rank's view: 16 x 16
    ``("data", "model")`` (one pod of 256 ranks) or 2 x 16 x 16 ``("pod",
    "data", "model")`` (512).  The ``pod`` axis is pure data parallelism:
    the pipelined block walk runs one block a pod.  Needs a process group
    of exactly that many ranks, all of which call it; ``device="meta"``
    over a ``"fake"`` group of that size is the dry-run's view."""
    lay = production_layout(multi_pod)
    return _build(lay["shape"], lay["axes"], device, "make_production_mesh")


_DATA_MESH_CACHE: dict = {}


def make_data_mesh(n=None, *, device="cuda") -> Mesh:
    """The 1-D pure data-parallel mesh over ``n`` ranks (default: every
    rank of the process group, or one rank without one): the default mesh
    of ``engine="sharded"``.  Memoized, as the reference's is, so the
    engines of a walk keyed by it are found again (and the groups are made
    once)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n is None else int(n)
    key = (n, str(device),
           id(dist.group.WORLD) if dist.is_initialized() else None)
    if key not in _DATA_MESH_CACHE:
        _DATA_MESH_CACHE[key] = _build((n,), ("data",), device,
                                       "make_data_mesh")
    return _DATA_MESH_CACHE[key]


def serve_mesh(tp: int = 1, world: Optional[int] = None, *,
               device="cuda") -> Mesh:
    """THE serve-mesh constructor (``--tp N`` on the serve CLI): a
    ``("data", "model")`` mesh whose ``model`` axis carries the TP degree,
    the remaining ranks on ``data``.  Needs an initialized process group
    of ``world`` ranks (default: its size) and is called by every rank of
    it, since each ``dist.new_group`` is."""
    if not dist.is_initialized():
        raise RuntimeError("serve_mesh needs an initialized process group "
                           "(launch.mesh.run_ranks starts one per rank)")
    n = dist.get_world_size() if world is None else int(world)
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"serve_mesh: tp must be >= 1, got {tp}")
    if n % tp:
        raise ValueError(f"serve_mesh: tp={tp} does not divide the "
                         f"{n} ranks")
    if n != dist.get_world_size():
        raise ValueError(f"serve_mesh: world={n} but the process group "
                         f"has {dist.get_world_size()} ranks")
    return _build((n // tp, tp), AXES, device, "serve_mesh")


def batch_rows(mesh, n: int) -> slice:
    """The rows of a leading batch dim of ``n`` that the rank owns when it
    is split over the mesh's data-parallel axes (the reference's
    ``batch_spec``): ``[r * n / D, (r + 1) * n / D)`` for DP rank ``r`` of
    ``D``."""
    D = dp_size(mesh)
    if n % D:
        raise ValueError(f"batch_rows: {n} rows do not split over the "
                         f"mesh's data-parallel degree {D}")
    r = mesh.data_rank
    return slice(r * n // D, (r + 1) * n // D)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in DP_AXES)


def _extent(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.axis_names.index(axis)])


def dp_size(mesh, axes=None) -> int:
    """Total data-parallel degree (product of the DP axis extents)."""
    n = 1
    for a in (dp_axes(mesh) if axes is None else axes):
        n *= _extent(mesh, a)
    return n


def tp_axis(mesh):
    """Name of the tensor-parallel axis, or None without a ``model``
    axis (reported even at extent 1: branch on :func:`tp_size`)."""
    return "model" if "model" in mesh.axis_names else None


def tp_size(mesh) -> int:
    """Tensor-parallel degree; 1 for ``None`` or a mesh without
    ``model``."""
    if mesh is None:
        return 1
    ax = tp_axis(mesh)
    return _extent(mesh, ax) if ax is not None else 1


def pod_axis(mesh):
    """Name of the cross-pod axis, or None (a serve mesh has none)."""
    return "pod" if mesh is not None and "pod" in mesh.axis_names else None


def pod_count(mesh) -> int:
    ax = pod_axis(mesh)
    return _extent(mesh, ax) if ax is not None else 1


_POD_SUBMESH_CACHE: dict = {}
# (source pod's ranks, destination pod's ranks) -> the group of the
# source's first rank and the destination's ranks (None off it)
_POD_LINKS: dict = {}


def pod_layout(mesh) -> list:
    """The global ranks of each pod of ``mesh``, each as its ``("data",
    "model")`` grid (the reference's ``np.moveaxis(devices, pod_dim,
    0)[p]``); the whole mesh as one pod where it has no ``pod`` axis."""
    grid = np.asarray(mesh.ranks).reshape(mesh.shape)
    ax = pod_axis(mesh)
    if ax is None:
        return [grid]
    return list(np.moveaxis(grid, mesh.axis_names.index(ax), 0))


def pod_submeshes(mesh) -> list:
    """One ``("data", "model")``-shaped submesh per pod of a ``("pod",
    "data", "model")`` mesh, over that pod's ranks (``[mesh]`` without a
    ``pod`` axis).  The pipelined block walk reconstructs block k on pod
    ``k % n_pods``.  A rank is a member of its own pod's submesh; the
    others are views without groups (their shape and ranks).

    Memoized per mesh, as the reference's is: the engine cache is keyed by
    the mesh, so a pod's submesh must be the same object on every call.
    On first use every rank of the process group makes every pod's groups
    and, for each ordered pair of pods, the group of the source pod's
    first rank and the destination's ranks (:func:`reshard_between_pods`),
    in the same order."""
    if pod_axis(mesh) is None:
        return [mesh]
    key = (mesh.ranks, mesh.shape, mesh.axis_names, mesh.rank,
           str(mesh.device),
           id(dist.group.WORLD) if dist.is_initialized() else None)
    if key not in _POD_SUBMESH_CACHE:
        rest = tuple(a for a in mesh.axis_names if a != "pod")
        subs = [_build(grid.shape, rest, mesh.device, "pod_submeshes",
                       tuple(int(r) for r in grid.flat))
                if dist.is_initialized() else
                Mesh(world=grid.size, rank=mesh.rank, shape=grid.shape,
                     group=None, device=mesh.device, axis_names=rest,
                     ranks=tuple(int(r) for r in grid.flat))
                for grid in pod_layout(mesh)]
        if dist.is_initialized():
            for src in subs:
                for dst in subs:
                    if src is not dst:
                        _POD_LINKS[(src.ranks, dst.ranks)] = _new_group(
                            (src.ranks[0],) + dst.ranks)
        _POD_SUBMESH_CACHE[key] = subs
    return _POD_SUBMESH_CACHE[key]


class _Leaf:
    """A tensor's place in a tree sent by :func:`broadcast_tree`."""

    def __init__(self, dtype, shape):
        self.dtype, self.shape = dtype, tuple(shape)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def _map_tree(fn, tree):
    """``fn`` on every leaf of a tree of dicts, lists and tuples (not named
    tuples), in order."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


_ALIGN = 16         # every tensor starts 16-byte aligned in the buffer


def broadcast_tree(tree, src: int, group, device):
    """``tree`` (dicts, lists and tuples of tensors and picklable values)
    from global rank ``src`` to every rank of ``group`` (None: the default
    group), each of which calls this (``tree`` is read on ``src`` only).
    Its structure with the tensors' dtypes and shapes goes first, pickled;
    then every tensor's bytes in one flat buffer on ``device``: the exact
    bytes.  On the other ranks the tensors are views of that buffer;
    ``src`` gets ``tree`` itself back."""
    me = dist.get_rank()
    tensors: list = []

    def skel(leaf):
        if not torch.is_tensor(leaf):
            return leaf
        tensors.append(leaf)
        return _Leaf(leaf.dtype, leaf.shape)
    head = [_map_tree(skel, tree) if me == src else None]
    dist.broadcast_object_list(head, src, group=group)
    slots: list = []
    _map_tree(lambda v: slots.append(v) if isinstance(v, _Leaf) else None,
              head[0])
    spans = [s.nbytes + (-s.nbytes % _ALIGN) for s in slots]
    if me == src:
        pieces = []
        for t, s, n in zip(tensors, slots, spans):
            pieces.append(t.detach().to(device).contiguous().reshape(-1)
                          .view(torch.uint8))
            pieces.append(torch.zeros(n - s.nbytes, dtype=torch.uint8,
                                      device=device))
        buf = (torch.cat(pieces) if pieces
               else torch.empty(0, dtype=torch.uint8, device=device))
    else:
        buf = torch.empty(sum(spans), dtype=torch.uint8, device=device)
    if buf.numel():
        dist.broadcast(buf, src, group=group)
    if me == src:
        return tree
    offs = iter(np.cumsum([0] + spans[:-1]).tolist())

    def fill(v):
        if not isinstance(v, _Leaf):
            return v
        o = next(offs)
        return buf[o:o + v.nbytes].view(v.dtype).view(v.shape)
    return _map_tree(fill, head[0])


def reshard_between_pods(x, dst_mesh, spec=None, *, src_mesh):
    """Move a tensor or a tree of them from the ranks of pod ``src_mesh``
    to the ranks of pod ``dst_mesh`` (two submeshes of one
    :func:`pod_submeshes`): the cross-pod seam of the pipelined block
    walk.  Every rank of the process group calls it in lockstep; ``x`` is
    read on the source pod's first rank only.  That rank broadcasts over
    the group of itself and the destination's ranks: gloo runs
    ``broadcast`` on CUDA tensors (staged through the host), where its
    ``send`` / ``recv`` would hand the transport a device pointer, and
    NCCL runs it card to card.  The bytes are exact.

    Returns, on the destination's ranks, the tree on ``dst_mesh.device``:
    whole with ``spec`` None (the port keeps a pod's streams replicated on
    its ranks, where the reference's default batch-shards them), else the
    rank's slice under ``spec`` (a ``sharding.PartitionSpec`` for every
    tensor, or a tree of specs mirroring ``x``); None on every other rank.
    With ``src_mesh is dst_mesh`` it returns ``x``."""
    if src_mesh is dst_mesh:
        return x
    link = (src_mesh.ranks, dst_mesh.ranks)
    if link not in _POD_LINKS:
        raise ValueError("reshard_between_pods: the two meshes are not pods "
                         "of one pod_submeshes")
    me = dist.get_rank()
    if me != src_mesh.ranks[0] and me not in dst_mesh.ranks:
        return None
    out = broadcast_tree(x, src_mesh.ranks[0], _POD_LINKS[link],
                         dst_mesh.device)
    if me not in dst_mesh.ranks:
        return None
    if spec is None:
        return out
    from repro_torch.launch import sharding
    if isinstance(spec, sharding.PartitionSpec):
        return _map_tree(lambda t: sharding.shard_leaf(t, spec, dst_mesh)
                         if torch.is_tensor(t) else t, out)
    return sharding.shard_tree(out, spec, dst_mesh)


def validate_single_pod(mesh, what: str) -> None:
    """Serving paths are single-mesh: fail loudly on a multi-pod mesh."""
    if mesh is not None and pod_count(mesh) > 1:
        raise ValueError(
            f"{what} runs on a single-pod mesh, but was handed a mesh with "
            f"axes {mesh.axis_names} (pod extent {pod_count(mesh)})")


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _rank_main(rank, fn, world, backend, device, init, args, results):
    """One spawned rank: join the process group, run ``fn(*args)``, report
    its result (or its traceback) on ``results``, leave the group."""
    try:
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
        # no rank runs (and may finish and leave) before every rank has
        # joined: a rank that leaves early closes the connections a slower
        # rank's gloo handshake still needs
        dist.barrier()
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:   # the process boundary: report, exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn, world: int, *, backend: str, device, args=(),
              timeout: Optional[float] = None) -> list:
    """Run ``fn(*args)`` in ``world`` spawned processes, ranks 0..world-1
    of one ``torch.distributed`` group on ``backend`` ("nccl" or "gloo",
    never chosen for the caller), and return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and return
    something picklable (host data, not CUDA tensors).  ``args`` reach
    every rank; tensors among them are shared, not copied (CPU tensors
    through shared memory, CUDA tensors through CUDA IPC: this process
    keeps them alive until the ranks are done).  Each rank runs on
    :func:`rank_device` of ``device``.  The rendezvous is a file in a
    temporary directory.  A rank that fails raises here with its
    traceback, and every rank still running is terminated; ``timeout``
    (seconds) bounds the whole run."""
    if world < 1:
        raise ValueError(f"run_ranks: world must be >= 1, got {world}")
    if backend not in BACKENDS:
        raise ValueError(f"run_ranks: backend {backend!r}; its ranks compute, "
                         f"so it takes one of {BACKENDS}")
    check_backend(backend, world, resolve_device(device))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="run_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, fn, world, backend, str(device), init,
                                   tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out = {}
        try:
            while len(out) < world:     # drain before joining
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [(i, p.exitcode) for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and i not in out]
                    if dead:
                        raise RuntimeError(
                            f"run_ranks: rank {dead[0][0]} exited with code "
                            f"{dead[0][1]} before reporting") from None
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(
                            f"run_ranks: {world - len(out)} of {world} "
                            f"ranks still running after {timeout} s") \
                            from None
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n"
                                       f"{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            results.close()
    return [out[r] for r in range(world)]
