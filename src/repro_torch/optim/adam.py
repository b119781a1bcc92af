"""AdamW over nested dicts of tensors, with the reference's arithmetic.

Ported by hand from the reference's ``optim/adam.py`` (not
``torch.optim.AdamW``, whose arithmetic differs): eps is added outside the
square root, weight decay is added to the update (not applied to the
parameter first), and the bias corrections use ``b ** step`` in float32
with the step counter kept on the parameters' device, so an update never
reads the host.  Used for TesseraQ's Soften-phase steps (paper: Adam, lr
1e-3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


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

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads, state: AdamState, params):
        """Returns (new params, new state); nothing is updated in place."""
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        lr = self._lr(step)
        stepf = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=stepf.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
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
