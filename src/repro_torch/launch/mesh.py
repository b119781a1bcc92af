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

The backend of the process group is always the caller's choice
(:func:`run_ranks`): NCCL needs one card per rank; gloo runs on the CPU and
on ranks that share a card (it stages a CUDA collective through the host).

Not here yet (ROADMAP queue 1, "Parallelism on torch.distributed"): the
reference's ``make_production_mesh`` and the pod walk's helpers
(``pod_submeshes``, ``reshard_between_pods``, item 9.4), which raise.
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
_POD_WALK = ("ROADMAP queue 1, 'Parallelism on torch.distributed': the "
             "pod-pipelined walk")


def _axis_groups(shape, axis_names, axes) -> np.ndarray:
    """Every group of the mesh along ``axes``: (groups, members) global
    ranks, each row one group, its members row-major over ``axes``."""
    grid = np.arange(math.prod(shape)).reshape(shape)
    along = [axis_names.index(a) for a in axes]
    rest = [d for d in range(len(shape)) if d not in along]
    size = math.prod(shape[d] for d in along)
    return grid.transpose(rest + along).reshape(-1, size)


def _group_of(shape, axis_names, axes, rank) -> Tuple[int, ...]:
    rows = _axis_groups(shape, axis_names, axes)
    return tuple(int(r) for r in rows[(rows == rank).any(axis=1)][0])


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
    ``optim.compression.compressed_psum``'s ``pod``).  All are None on a
    mesh of one rank without a process group.  ``device`` is the
    ``torch.device`` the rank runs on."""
    world: int
    rank: int
    shape: Tuple[int, ...]
    group: Any = dataclasses.field(repr=False)
    device: torch.device
    axis_names: Tuple[str, ...] = AXES
    data_group: Any = dataclasses.field(default=None, repr=False)
    axis_groups: Any = dataclasses.field(default=None, repr=False,
                                         compare=False)

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
        return _group_of(self.shape, self.axis_names, axes, self.rank)

    def index_of(self, axes) -> int:
        """The rank's position along ``axes`` (row-major over a tuple)."""
        return self.ranks_of(axes).index(self.rank)

    def group_of(self, axes):
        """The process group of the rank's line along ``axes``: one named
        axis, the data-parallel axes together, or every axis of the mesh
        (the default group, None).  None too on a line of one rank, where
        no collective runs."""
        axes = self._axes(axes)
        if self.size_of(axes) == 1:
            return None
        if set(axes) == set(self.axis_names):
            return None
        if axes == ("model",):
            return self.group
        if len(axes) == 1:
            return self.axis_groups[axes[0]]
        if set(axes) == set(dp_axes(self)):
            return self.data_group
        raise ValueError(f"no process group over {axes} on a mesh of "
                         f"{self.axis_names}")


def check_backend(backend: str, world: int, device) -> None:
    """Refuse a process group that cannot run: an unknown backend, or NCCL
    where ranks would share a card (NCCL refuses a duplicate GPU in one
    communicator) or run on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend != "nccl":
        return
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if world > cards:
        raise ValueError(
            f"backend 'nccl' needs one CUDA device per rank: {world} ranks "
            f"on {cards} CUDA device(s) ({dev.type}); use backend 'gloo' "
            f"for ranks that share a card or run on the CPU")


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:{rank % device_count}``,
    or the CPU when ``device`` says so."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _groups(shape, axis_names, rank):
    """The rank's (model group, data group, {axis: group}), made by every
    rank of the process group (each ``dist.new_group`` is a collective of
    all ranks, called in the same order on every rank).  A set of axes
    already made (the data axes of a ``("data",)`` mesh are its one axis)
    is not made twice."""
    made = {}

    def group(axes):
        if not axes:
            return None
        if axes not in made:
            made[axes] = None
            for members in _axis_groups(shape, axis_names, axes):
                g = dist.new_group([int(m) for m in members])
                if rank in members:
                    made[axes] = g
        return made[axes]

    model = group(("model",) if "model" in axis_names else ())
    data = group(tuple(a for a in axis_names if a in DP_AXES))
    return model, data, {a: group((a,)) for a in axis_names}


def _build(shape, axis_names, device, who: str) -> Mesh:
    """The rank's view of a ``shape`` mesh over ``axis_names``.  A mesh of
    one rank without a process group has no groups; otherwise the process
    group must hold exactly the mesh's ranks."""
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"{who}: shape {shape} does not fit axes "
                         f"{axis_names}")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"{who}: a mesh of {n} ranks needs an initialized process "
                "group (launch.mesh.run_ranks starts one per rank)")
        return Mesh(world=1, rank=0, shape=shape, group=None,
                    device=resolve_device(device), axis_names=axis_names)
    if n != dist.get_world_size():
        raise ValueError(f"{who}: a mesh of {n} ranks {shape}, but the "
                         f"process group has {dist.get_world_size()} ranks")
    rank = dist.get_rank()
    dev = rank_device(rank, device)
    check_backend(dist.get_backend(), n, dev)
    group, data_group, axis_groups = _groups(shape, axis_names, rank)
    return Mesh(world=n, rank=rank, shape=shape, group=group, device=dev,
                axis_names=axis_names, data_group=data_group,
                axis_groups=axis_groups)


def make_mesh(shape, axes=None, *, device="cuda") -> Mesh:
    """The rank's view of an arbitrary mesh (e.g. ``(2, 2)``), with the
    reference's default axis names: ``("pod", "data", "model")`` for three
    dims, else ``("data", "model")[:len(shape)]``.  Called by every rank of
    the process group (its size is the mesh's), or, for a mesh of one
    rank, by a plain process."""
    if axes is None:
        axes = (("pod", "data", "model") if len(shape) == 3
                else ("data", "model")[:len(shape)])
    return _build(shape, axes, device, "make_mesh")


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


def pod_submeshes(mesh) -> list:
    """The reference's per-pod submeshes of the pipelined block walk."""
    raise NotImplementedError(f"pod_submeshes is not ported yet ({_POD_WALK}"
                              ", item 9.4)")


def reshard_between_pods(x, dst_mesh, spec=None):
    """The reference's cross-pod transfer of the pipelined block walk."""
    raise NotImplementedError(
        f"reshard_between_pods is not ported yet ({_POD_WALK}, item 9.4)")


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
