"""The serve mesh on ``torch.distributed``, and the launcher of its ranks.

The reference builds a ``("data", "model")`` jax Mesh over the devices of
one process and runs each serve step under ``shard_map``.  Here one process
is one rank: :class:`ServeMesh` is that rank's view of the same mesh — the
world size, its rank, the shape ``(world // tp, tp)`` and the process group
of its ``model`` axis (consecutive ranks, as the reference's row-major mesh
places them) — and the device it runs on.  ``shard_map``'s per-shard body
becomes the rank's own forward on its local shard, and ``psum`` over
``model`` an all-reduce over that group.

The backend of the process group is always the caller's choice
(:func:`run_ranks`): NCCL needs one card per rank; gloo runs on the CPU and
on ranks that share a card (it stages a CUDA all-reduce through the host).

Not here yet (ROADMAP queue 1, "Parallelism on torch.distributed"): the
reference's ``make_mesh`` / ``make_data_mesh`` / ``make_production_mesh``
and ``batch_spec`` wait for the sharded recon engine; the pod helpers raise.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device

AXES = ("data", "model")
BACKENDS = ("nccl", "gloo")
_POD_WALK = ("ROADMAP queue 1, 'Parallelism on torch.distributed': the "
             "pod-pipelined walk")


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """One rank's view of the ``("data", "model")`` serve mesh.

    ``shape`` is ``(world // tp, tp)``; the rank sits at ``(rank // tp,
    rank % tp)``.  ``group`` is the process group of the rank's ``model``
    axis (the ``tp`` consecutive ranks that hold one model's shards; every
    collective of the serve steps runs over it).  ``device`` is the
    ``torch.device`` the rank runs on."""
    world: int
    rank: int
    shape: Tuple[int, int]
    group: Any = dataclasses.field(repr=False)
    device: torch.device
    axis_names: Tuple[str, ...] = AXES

    @property
    def model_rank(self) -> int:
        """The rank's position on the ``model`` axis (its shard index)."""
        return self.rank % self.shape[1]

    @property
    def data_rank(self) -> int:
        """The rank's position on the ``data`` axis (its replica index)."""
        return self.rank // self.shape[1]


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


def serve_mesh(tp: int = 1, world: Optional[int] = None, *,
               device="cuda") -> ServeMesh:
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
    rank = dist.get_rank()
    dev = rank_device(rank, device)
    check_backend(dist.get_backend(), n, dev)
    group = None
    for first in range(0, n, tp):         # every rank creates every group
        g = dist.new_group(list(range(first, first + tp)))
        if first <= rank < first + tp:
            group = g
    return ServeMesh(world=n, rank=rank, shape=(n // tp, tp), group=group,
                     device=dev)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


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
    raise NotImplementedError(f"pod_submeshes is not ported yet ({_POD_WALK})")


def reshard_between_pods(x, dst_mesh, spec=None):
    """The reference's cross-pod transfer of the pipelined block walk."""
    raise NotImplementedError(
        f"reshard_between_pods is not ported yet ({_POD_WALK})")


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
