"""Perplexity + synthetic downstream evaluation (paper Sec. 4.1 metrics).

``backend`` overrides the QTensor matmul dispatch ("xla"/"pallas") when
evaluating a PACKED model: under "pallas" every projection of a batch of
more than 32 token rows goes through the quant-matmul kernel (its plain
version on a CPU tensor).  It is inert for plain or fake-quant params.
Batches may hold numpy arrays or tensors; they are moved to the params'
device.

Under a mesh ctx (``make_ctx(cfg, mesh=...)``) ``perplexity`` takes the
rank's slices of the params and the shardings they were cut by
(``launch.sharding.param_shardings``): it gathers them as the mesh train
step does (the MoE experts stay split over the ``model`` axis), runs the
rank's rows of each batch and averages the losses over the data group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import batch_rows, dp_size
from repro_torch.launch.sharding import unshard_tree
from repro_torch.launch.steps import entry_shardings
from repro_torch.models import get_model
from repro_torch.models.common import DEFAULT_CTX


def _with_backend(ctx, backend: Optional[str]):
    return ctx if backend is None else dataclasses.replace(
        ctx, kernel_backend=backend)


def _device(params) -> torch.device:
    return params["embed"].device


def perplexity(cfg, params, batches: List[Dict], ctx=DEFAULT_CTX,
               backend: Optional[str] = None, shardings=None) -> float:
    """exp(mean NLL) over token batches (the WikiText2-style metric); the
    per-batch losses stay on the device until one read at the end.  On a
    mesh ctx ``params`` are the rank's slices under ``shardings``."""
    ctx = _with_backend(ctx, backend)
    model = get_model(cfg)
    dev = _device(params)
    mesh, rows = ctx.mesh, (lambda b: b)
    if mesh is not None:
        if shardings is None:
            raise ValueError("perplexity on a mesh needs the shardings the "
                             "params were cut by")
        params = unshard_tree(params, entry_shardings(shardings, cfg))

        def rows(b):
            r = batch_rows(mesh, next(iter(b.values())).shape[0])
            return {k: v[r] for k, v in b.items()}
    losses = []
    with torch.no_grad():
        for b in batches:
            b = rows({k: torch.as_tensor(v, device=dev)
                      for k, v in b.items()})
            losses.append(model.loss_fn(params, b, ctx).to(torch.float64))
    if mesh is not None and losses and dp_size(mesh) > 1:
        total = torch.stack(losses)
        dist.all_reduce(total, group=mesh.data_group)
        losses = list(total / dp_size(mesh))
    if not losses:
        return 1.0
    tot = float(torch.stack(losses).sum())
    return float(np.exp(tot / len(losses)))


def choice_accuracy(cfg, params, tasks: List[Dict], ctx=DEFAULT_CTX,
                    backend: Optional[str] = None) -> float:
    """Synthetic zero-shot multiple-choice: score each candidate continuation
    by sequence log-likelihood, count argmax hits (PIQA/ARC-style protocol)."""
    ctx = _with_backend(ctx, backend)
    model = get_model(cfg)
    dev = _device(params)
    hits = 0
    with torch.no_grad():
        for t in tasks:
            scores = [float(-model.loss_fn(
                params, {"tokens": torch.as_tensor(c[None], device=dev)},
                ctx)) for c in t["choices"]]
            hits += int(int(np.argmax(scores)) == t["answer"])
    return hits / max(len(tasks), 1)


def make_choice_tasks(corpus, n_tasks: int, seq: int, n_choices: int = 4,
                      seed: int = 7) -> List[Dict]:
    """Build tasks from the synthetic corpus: the true continuation of a
    prefix vs corrupted continuations (harder models score higher)."""
    rng = np.random.default_rng(seed)
    tasks = []
    for i in range(n_tasks):
        b = corpus.batch(90_000 + i)
        row = b["tokens"][0][:seq]
        cut = seq // 2
        true = row.copy()
        choices = [true]
        for _ in range(n_choices - 1):
            fake = row.copy()
            alt = corpus.batch(91_000 + int(rng.integers(1 << 16)))
            fake[cut:] = alt["tokens"][0][:seq][cut:]
            choices.append(fake)
        order = rng.permutation(n_choices)
        tasks.append({"choices": [choices[j] for j in order],
                      "answer": int(np.argwhere(order == 0)[0][0])})
    return tasks
