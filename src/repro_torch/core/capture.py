"""Eager capture of per-linear input activations inside a block, plus the
activation-stream utilities the ``quantize_model`` walk uses.

AWQ and GPTQ need, for every linear W in a block, statistics of that
linear's own input X (mean |X| per channel, a token subsample for the
layer objective and, for GPTQ, the Hessian X^T X).
``capture_block_inputs`` runs the block with
``repro_torch.models.layers.matmul`` and ``layers.expert_matmul``
temporarily wrapped to record them, keyed by the weight tensor's identity,
which maps back to a param path.  The statistics stay on the activations'
device; the Hessian is accumulated there in float32, one X^T X per
minibatch summed in minibatch order, as the reference sums its numpy
products.

MoE expert weights see their own capacity-gathered (E, C, d) inputs,
recorded as (E*C, d) rows with the zero-padded slots included, as the
reference records them (the padding dilutes ``mean_abs`` by a uniform
factor that cancels under AWQ's relative scale search); every expert's
rows go into the stack's one Hessian, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import get_path, quant_leaf_paths
from repro_torch.models import layers as L

MAX_ROWS = 1024          # token subsample kept per linear for objectives
CAPTURE_MINIBATCH = 4    # the reference's single-device capture minibatch


def stage_calibration(X, Y) -> Tuple:
    """A block's calibration streams, staged once on X's device.

    The reconstruction loop gathers its minibatches out of these tensors on
    the device; Y is promoted to float32, the dtype of the reconstruction
    loss."""
    return X, Y.to(device=X.device, dtype=torch.float32)


def split_minibatches(x: torch.Tensor, mb: int = CAPTURE_MINIBATCH) -> list:
    """Split a (N, ...) stream into minibatches of ``mb`` rows (the last one
    may be short); the parts are views."""
    return [x[j:j + mb] for j in range(0, x.shape[0], mb)]


class LinearStats:
    """Running mean |x| per input channel, a row subsample (at most
    ``MAX_ROWS`` rows, ``linspace``-spaced within each update) and, when
    asked for, the Hessian X^T X (float32, (in, in))."""

    def __init__(self):
        self.abs_sum = None
        self.count = 0
        self.rows = []
        self.row_count = 0
        self.hessian = None

    def update(self, x: torch.Tensor, want_hessian: bool = False):
        x2d = x.detach().reshape(-1, x.shape[-1]).to(torch.float32)
        a = x2d.abs().sum(0)
        self.abs_sum = a if self.abs_sum is None else self.abs_sum + a
        self.count += x2d.shape[0]
        if self.row_count < MAX_ROWS:
            take = min(MAX_ROWS - self.row_count, x2d.shape[0])
            idx = np.linspace(0, max(x2d.shape[0] - 1, 0), take).astype(int)
            self.rows.append(x2d[torch.as_tensor(idx, device=x2d.device)])
            self.row_count += take
        if want_hessian:
            h = x2d.T @ x2d
            self.hessian = h if self.hessian is None else self.hessian + h

    @property
    def mean_abs(self) -> torch.Tensor:
        return self.abs_sum / max(self.count, 1)

    @property
    def sample(self) -> torch.Tensor:
        if not self.rows:
            return torch.zeros((0, 1))
        return torch.cat(self.rows, 0)


def capture_block_inputs(apply: Callable, bp, xs, *,
                         want_hessian: bool = False
                         ) -> Dict[tuple, LinearStats]:
    """Run ``apply(bp, x)`` over the minibatches ``xs``, recording the input
    of every quantizable linear of ``bp`` (with its Hessian when
    ``want_hessian``)."""
    paths = quant_leaf_paths(bp)
    by_id = {id(get_path(bp, p)): p for p in paths}
    stats = {p: LinearStats() for p in paths}
    orig_mm, orig_emm = L.matmul, L.expert_matmul

    def rec(w, x):
        p = by_id.get(id(w))
        if p is not None:
            stats[p].update(x, want_hessian)

    def patched_mm(x, w, backend=None):
        rec(w, x)
        return orig_mm(x, w, backend)

    def patched_emm(a, w, backend=None, rows=None):
        rec(w, a)
        return orig_emm(a, w, backend, rows)

    L.matmul, L.expert_matmul = patched_mm, patched_emm
    try:
        with torch.no_grad():
            for x in xs:
                apply(bp, x)
    finally:
        L.matmul, L.expert_matmul = orig_mm, orig_emm
    return stats
