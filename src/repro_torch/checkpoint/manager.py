"""Fault-tolerant checkpointing (the reference's ``checkpoint/manager.py``).

Contracts, as in the reference:
  * atomic: a step is written to ``step_N.tmp``, its manifest last, then
    moved into place with ``os.replace``, so a crash mid-write never
    corrupts the latest checkpoint;
  * self-describing: a structure string and a leaf manifest beside
    ``leaves.npz``; ``QTensor``-aware;
  * retention: the newest ``keep`` COMPLETE steps are kept; torn dirs (no
    ``MANIFEST.json``) never count toward ``keep``, and are swept only when
    older than the newest complete step;
  * ``latest_step`` sees complete checkpoints only (resume after a crash).

Leaves are flattened in the reference's order — dict keys sorted, tuple and
NamedTuple fields in order (``AdamState(step, m, v)``), a ``QTensor`` as
``packed, scale, zero[, act_scale]``, ``None`` as no leaf — and stored under
the reference's names (``leaf_<i>``) with bf16 staged through f32, so each
package restores the other's checkpoints.  A restored leaf takes the device
and dtype of the ``like`` leaf it replaces.

Elastic re-scale, as in the reference: a run on a mesh saves whole leaves
(``save(..., shardings=...)`` gathers the ranks' slices, rank 0 writes,
every rank waits on a barrier), so the on-disk format does not depend on
the mesh, and ``restore(..., shardings=...)`` cuts each whole leaf to the
rank's slice of another mesh's shardings, or of none.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.qtensor import QTensor
from repro_torch.launch.sharding import shard_leaf, unshard_tree

_NUMPY_DTYPES = (torch.float32, torch.float64, torch.float16, torch.int8,
                 torch.int16, torch.int32, torch.int64, torch.uint8,
                 torch.bool)


def _children(node):
    """(children in the reference's order, rebuild(children) -> node) of
    one container node, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        # rebuilt in the node's own key order
        def rebuild(ch):
            got = dict(zip(keys, ch))
            return {k: got[k] for k in node}
        return [node[k] for k in keys], rebuild
    if isinstance(node, QTensor):
        has_act = node.act_scale is not None
        ch = [node.packed, node.scale, node.zero] + (
            [node.act_scale] if has_act else [])
        return ch, lambda c: QTensor(c[0], c[1], c[2], node.bits,
                                     node.group_size, node.shape,
                                     c[3] if has_act else None)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node), lambda ch: type(node)(*ch)
    if isinstance(node, (tuple, list)):
        return list(node), lambda ch: type(node)(ch)
    return None


def flatten(tree) -> list:
    """The leaves of ``tree`` in the reference's ``tree_flatten`` order."""
    if tree is None:
        return []
    got = _children(tree)
    if got is None:
        return [tree]
    return [leaf for c in got[0] for leaf in flatten(c)]


def unflatten(like, leaves: list):
    """``like``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        got = _children(node)
        if got is None:
            return next(it)
        return got[1]([build(c) for c in got[0]])
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def treedef(tree) -> str:
    """A readable structure string for the manifest (``*`` per leaf)."""
    if tree is None:
        return "None"
    got = _children(tree)
    if got is None:
        return "*"
    inner = ", ".join(treedef(c) for c in got[0])
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {treedef(tree[k])}" for k in sorted(tree))
        return "{" + inner + "}"
    return f"{type(tree).__name__}({inner})"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype not in _NUMPY_DTYPES:
            t = t.to(torch.float32)        # bf16: stage through f32, lossless
        return t.numpy()
    return np.asarray(leaf)


def _restore_leaf(arr: np.ndarray, ref):
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=ref.device,
                                                  dtype=ref.dtype)
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- paths --------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _complete(self) -> list:
        return sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.dir, n, "MANIFEST.json")))

    def latest_step(self) -> Optional[int]:
        steps = self._complete()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             shardings: Any = None):
        """Write ``tree`` as step ``step``.  On a mesh, ``tree`` holds the
        rank's slices and ``shardings`` (the tree of
        ``launch.sharding.NamedSharding`` they were cut by) says how:
        every rank calls ``save``, the whole leaves are gathered, rank 0
        writes them and the others wait for it on a barrier."""
        if shardings is not None:
            whole = unshard_tree(tree, shardings)
            if dist.is_initialized() and dist.get_world_size() > 1:
                if dist.get_rank() == 0:
                    self.save(step, whole, extra)
                dist.barrier()
                return
            tree = whole
        leaves = flatten(tree)
        tmp = self._step_dir(step) + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(),
                    "treedef": treedef(tree), "n_leaves": len(leaves),
                    "extra": extra or {}}
        arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
        np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
        # the manifest is written LAST inside tmp, then the atomic rename
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        """Keep the newest ``keep`` COMPLETE checkpoints.  Torn dirs (a
        step_N without MANIFEST.json) never count toward ``keep``; those
        older than the newest complete step are swept, newer ones are left
        alone (another writer may be mid-flight) — ``latest_step`` ignores
        them either way."""
        complete = self._complete()
        for s in complete[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        if complete:
            newest = complete[-1]
            for n in os.listdir(self.dir):
                if not n.startswith("step_") or n.endswith(".tmp"):
                    continue
                full = os.path.join(self.dir, n)
                if not os.path.exists(os.path.join(full, "MANIFEST.json")) \
                        and int(n.split("_")[1]) < newest:
                    shutil.rmtree(full, ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Restore step ``step`` into the structure of ``like``, each leaf
        on the device and in the dtype of ``like``'s leaf.  ``shardings``
        (a tree of ``launch.sharding.NamedSharding`` mirroring ``like``,
        on any mesh): each whole leaf is cut to the rank's slice — the
        elastic path, whatever mesh the checkpoint was saved from."""
        with np.load(os.path.join(self._step_dir(step), "leaves.npz")) as data:
            arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
        like_leaves = flatten(like)
        if len(arrays) != len(like_leaves):
            raise ValueError(f"checkpoint/model mismatch: step {step} holds "
                             f"{len(arrays)} leaves, the structure "
                             f"{len(like_leaves)}")
        if shardings is not None:
            specs = flatten(shardings)
            if len(specs) != len(arrays):
                raise ValueError(f"restore: {len(specs)} shardings for "
                                 f"{len(arrays)} leaves")
            arrays = [shard_leaf(torch.from_numpy(np.array(a)), sh).numpy()
                      for a, sh in zip(arrays, specs)]
        return unflatten(like, [_restore_leaf(a, r)
                                for a, r in zip(arrays, like_leaves)])

    def restore_latest(self, like: Any, shardings: Any = None):
        s = self.latest_step()
        if s is None:
            return None, None
        return s, self.restore(s, like, shardings)
