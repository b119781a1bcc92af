"""AdamW over nested dicts of tensors, with the reference's arithmetic.

Ported by hand from the reference's ``optim/adam.py`` (not
``torch.optim.AdamW``, whose arithmetic differs): eps is added outside the
square root, weight decay is added to the update (not applied to the
parameter first), and the bias corrections use ``b ** step`` in float32
with the step counter kept on the parameters' device, so an update never
reads the host.  Used for pretraining (``launch/steps.make_train_harness``,
with ``clip_by_global_norm`` and ``cosine_schedule``) and for TesseraQ's
Soften-phase steps (paper: Adam, lr 1e-3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist


class AdamState(NamedTuple):
    step: torch.Tensor          # int32 scalar on the params' device
    m: Any
    v: Any


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: torch.dtype = torch.float32

    def init(self, params) -> AdamState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else "cpu"
        z = lambda p: torch.zeros(p.shape, dtype=self.state_dtype,
                                  device=p.device)
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         tree_map(z, params), tree_map(z, params))

    def state_specs(self, param_specs) -> AdamState:
        """The state's split dims given a spec tree of the params' (as
        ``launch.sharding.ParamSpec`` gives them): the moments follow
        their parameter's shard, the step counter is replicated (None).
        The update is elementwise with no clipping, so updating a slice
        gives the bits that slicing the whole update gives."""
        return AdamState(None, param_specs, param_specs)

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads, state: AdamState, params):
        """Returns (new params, new state); nothing is updated in place."""
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        lr = self._lr(step)
        stepf = step.to(torch.float32)
        # b ** step with both in f32; ``torch.full`` fills on the device
        # (a ``torch.tensor`` from a Python float would be a host copy)
        c1 = 1.0 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                        device=stepf.device), stepf)
        c2 = 1.0 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                        device=stepf.device), stepf)

        def upd(g, m, v, p):
            gf = g.to(self.state_dtype)
            m2 = b1 * m + (1 - b1) * gf
            v2 = b2 * v + (1 - b2) * gf * gf
            mh = m2 / c1
            vh = v2 / c2
            delta = mh / (torch.sqrt(vh) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(self.state_dtype)
            return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

        out = tree_map(upd, grads, state.m, state.v, params)
        pick = lambda i: _pick(out, i)
        return pick(0), AdamState(step, pick(1), pick(2))


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def _leaves_sorted(tree) -> list:
    """Leaves with dict keys in sorted order: the reference's (jax's) leaf
    order, whatever order the dicts were built in."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_sorted(tree[k])]
    return [tree]


def clip_by_global_norm(grads, max_norm: float, replicas=None, mesh=None):
    """Scale every gradient by ``min(1, max_norm / max(gn, 1e-12))``, where
    ``gn`` is the f32 global L2 norm over all leaves, summed leaf by leaf in
    the reference's leaf order (so a tree's key order, e.g. after a
    checkpoint restore, cannot change it).  Returns (clipped grads, gn);
    nothing is read to the host.

    On a ``mesh`` (a ``launch.mesh.Mesh``) ``grads`` are the rank's slices
    and ``replicas`` mirrors them with the number of the mesh's ranks that
    hold each slice (``launch.sharding.replicas``): every rank weighs its
    squares by one over that, so each distinct slice counts once, and the
    sums are all-reduced over the mesh's ranks (its own group: a mesh need
    not be the whole process group)."""
    leaves = _leaves_sorted(grads)
    weights = ([1] * len(leaves) if replicas is None
               else _leaves_sorted(replicas))

    def sq(g, n):
        s = torch.sum(torch.square(g.to(torch.float32)))
        return s if n == 1 else s / n
    total = sum(sq(g, n) for g, n in zip(leaves, weights))
    if mesh is not None and mesh.world > 1:
        dist.all_reduce(total, group=mesh.group_of(mesh.axis_names))
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    # the product in f32, rounded once to the leaf's dtype, as the reference
    # promotes a bf16 leaf times an f32 scale
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then cosine decay
    to ``min_frac * base_lr`` at ``total``.  The returned function takes the
    step as a device tensor (``AdamW._lr`` passes the int32 counter) and
    returns the lr as an f32 device tensor, so computing it costs no host
    sync."""
    def lr(step):
        s = step.to(torch.float32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr
