"""How far rounding alone moves a reduced train step of the mesh tests
(``test_torch_train_mesh.py``) on the CPU, and what the reference does at
the params where the port's split step and the reference's part by more
than the tests' bound.

    PYTHONPATH=src:tests python tests/_torch_train_noise.py
        [--family hybrid] [--dtype float32] [--steps 3] [--atol 1e-4]
        [--leaves]

From the tests' params (the reference's ``PRNGKey(0)`` ones, bridged) and
batch (``_torch_train_ranks.batch``) it runs the port's step without a
mesh and these variants of it, each against the plain one:

* ``chunk``: attention over KV chunks of 8 (the same function);
* ``embed``: ``embed`` scaled by ``1 + 1e-7``;
* ``two microbatches``: the same mean, each half's gradients rounded to
  the params' dtype before their sum;
* ``out_proj halves`` (the hybrid): Mamba's ``out_proj`` product summed
  from its two halves over the inner width ``di``, each rounded to the
  params' dtype first, as the two ranks of a ``(1, 2)`` split hold it
  before the exchange sums it;
* ``(1, 2)`` and ``(1, 2) seq``: two gloo ranks of a ``(1, 2)`` mesh, the
  work split over ``model`` (``launch.steps.train_plan``), the second
  with ``seq_parallel``.

For each it prints the first step's gradients' distance (the worst leaf's
max abs difference over its largest |g|), the losses' and grad norms'
largest relative distance, and after ``--steps`` AdamW steps the params'
largest abs distance and how many elements are over ``--atol``; with
``--leaves``, each leaf's step-1 gradient distance (the norm of the
difference over the leaf's norm) under every variant.  It then
runs the reference's ``jit_train_step`` (two forced host devices) in the
same dtype without a mesh, on ``(1, 2)`` and on ``(1, 2)`` with
``seq_parallel``, and prints how far each split run's losses and grad
norms lie from its no-mesh run's.  In f32 it also prints, for each element
where the port's split run and the reference's run on the same mesh part
by more than ``--atol``, the first step's gradient of every run there, the
leaf's largest |g|, and the reference's own distance there between its
split and no-mesh runs; and how many elements the reference's split runs
put over ``--atol`` from its no-mesh run.  The ranks import nothing of
jax; the reference runs in this process after them.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import os
from unittest import mock

import numpy as np
import torch

import _torch_train_ranks as R
from repro_torch.checkpoint.manager import flatten, unflatten
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.launch.sharding import (NamedSharding, PartitionSpec,
                                         shard_tree, unshard_tree)
from repro_torch.models import get_model, layers, ssm

SPLITS = {"(1, 2)": False, "(1, 2) seq": True}


class _OutProjHalves:
    """``layers`` as ``ssm`` reads it in the ``out_proj halves`` variant:
    the product with the ``di``-row ``out_proj`` summed from two halves."""

    def __init__(self, di):
        self.di = di

    def __getattr__(self, name):
        return getattr(layers, name)

    def matmul(self, x, w, backend=None):
        if w.shape[0] != self.di:
            return layers.matmul(x, w, backend)
        n = self.di // 2
        return (layers.matmul(x[..., :n], w[:n], backend)
                + layers.matmul(x[..., n:], w[n:], backend))


def leaf_names(tree, path=""):
    """``tree``'s leaf paths in ``flatten``'s order (sorted keys)."""
    if not isinstance(tree, dict):
        return [path]
    return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                        f"{path}/{k}")]


def _split_part(pspec, plan, name=None):
    """What the step's gradients keep split: the ``model`` entry of each
    leaf of ``plan``, nothing of the rest (gathered whole before the
    backward)."""
    if isinstance(pspec, dict):
        return {k: _split_part(v, plan, k) for k, v in pspec.items()}
    keep = name in plan
    return NamedSharding(pspec.mesh, PartitionSpec(*(
        e if keep and e == "model" else None for e in pspec.spec)))


def run(family, dtype, steps, leaves, variant):
    """(metrics, step-1 gradient leaves, final params) of one variant of
    the port's step, as numpy, the gradients and params whole."""
    torch.set_num_threads(1)
    cfg = R.config(family).replace(dtype=dtype)
    like = get_model(cfg).init_params(0, "cpu")
    params = unflatten(like, [torch.as_tensor(x).to(t.dtype)
                              for x, t in zip(leaves, flatten(like))])
    if variant == "embed":
        params = dict(params, embed=params["embed"] * (1 + 1e-7))
    mesh = make_mesh((1, 2), device="cpu") if variant in SPLITS else None
    h = S.make_train_harness(cfg, mesh, lr=R.LR,
                             attn_chunk=8 if variant == "chunk" else 512,
                             microbatches=2 if "micro" in variant else 1,
                             seq_parallel=SPLITS.get(variant, False))
    grads = []
    real = S._value_and_grad, S._reduce_rows

    def record(*a):
        loss, g = real[0](*a)
        grads.append(g)
        return loss, g

    def rows(split, g):
        # the first step's gradients once the norms' row parts are summed
        g = real[1](split, g)
        if len(grads) == 1:
            grads[0] = g
        return g
    S._value_and_grad, S._reduce_rows = record, rows
    halves = (mock.patch.object(ssm, "L", _OutProjHalves(ssm._dims(cfg)[0]))
              if variant == "out_proj halves" else contextlib.nullcontext())
    try:
        with halves:
            p = params if mesh is None else shard_tree(params,
                                                       h.param_sharding)
            o = h.init_opt(p)
            metrics = []
            for _ in range(steps):
                p, o, m = h.step_fn(p, o, R.batch(cfg))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        S._value_and_grad, S._reduce_rows = real
    # the first step's gradient (two microbatches: the mean of its halves')
    g = grads[0] if "micro" not in variant else _mean(grads[:2])
    if mesh is not None:
        p = unshard_tree(p, h.param_sharding)
        g = unshard_tree(g, _split_part(h.param_sharding, h.plan))
    return (metrics, [t.detach().float().numpy() for t in flatten(g)],
            [t.detach().float().numpy() for t in flatten(p)])


def _mean(trees):
    return unflatten(trees[0], [sum(ts) / len(trees) for ts in
                                zip(*(flatten(t) for t in trees))])


def _ranks(*args):
    return run(*args)


REF_RUNS = {"plain": (None, False), "(1, 2)": ((1, 2), False),
            "(1, 2) seq": ((1, 2), True)}


@functools.lru_cache(maxsize=None)
def _ref_programs(family, dtype, tag):
    """One of the reference's ``REF_RUNS`` in ``dtype``, built once: (its
    params and AdamW state placed, its jitted step and value-and-grad, the
    batch)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced_config
    from repro.launch.mesh import make_mesh as jmesh
    from repro.launch.steps import jit_train_step, make_ctx, \
        make_train_harness
    from repro.models import get_model as jget_model
    cfg = get_reduced_config(R.ARCHS[family]).replace(dtype=dtype)
    model = jget_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in R.batch(cfg).items()}
    shape, seq = REF_RUNS[tag]
    mesh = None if shape is None else jmesh(shape)
    h = make_train_harness(cfg, mesh, lr=R.LR, seq_parallel=seq)
    ctx = make_ctx(cfg, mesh, attn_chunk=512, shard_overrides=(
        {"res_seq": ("model",)} if seq else None))

    def vg(p, b):
        return jax.value_and_grad(model.loss_fn)(p, b, ctx)
    if mesh is None:
        return (params, h.init_opt(params), jax.jit(h.step_fn), jax.jit(vg),
                batch)
    step, (ps, osp, bs) = jit_train_step(h, mesh, jax.eval_shape(
        lambda: params), jax.eval_shape(lambda: batch))
    return (jax.device_put(params, ps),
            jax.device_put(h.init_opt(params), osp), step,
            jax.jit(vg, in_shardings=(ps, bs)), batch)


def reference(family, steps, dtype):
    """The reference's ``REF_RUNS`` in ``dtype``: {tag: (metrics, step-1
    gradients, params)}."""
    import jax
    out = {}
    for tag in REF_RUNS:
        p, o, step, grad, batch = _ref_programs(family, dtype, tag)
        g = grad(p, batch)[1]
        metrics = []
        for _ in range(steps):
            p, o, m = step(p, o, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[tag] = (metrics,
                    [np.asarray(x) for x in jax.tree_util.tree_leaves(g)],
                    [np.asarray(x) for x in jax.tree_util.tree_leaves(p)])
    return out


def _dist(m, base):
    return [tuple(float(f"{abs(u - v) / abs(v):.3g}") for u, v in zip(x, y))
            for x, y in zip(m, base)]


def _over(a, b, atol):
    return sum(int((np.abs(x - y) > atol).sum()) for x, y in zip(a, b))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="hybrid", choices=sorted(R.ARCHS))
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--steps", type=int, default=R.STEPS)
    ap.add_argument("--atol", type=float, default=1e-4)
    ap.add_argument("--leaves", action="store_true",
                    help="print each leaf's step-1 gradient distance")
    a = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    from repro.configs import get_reduced_config
    from repro.models import get_model as jget_model
    import jax
    jcfg = get_reduced_config(R.ARCHS[a.family]).replace(dtype="float32")
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jget_model(jcfg).init_params(jax.random.PRNGKey(0)))]
    args = (a.family, a.dtype, a.steps, leaves)
    port = {"plain": run(*args, "plain")}
    print(f"{R.ARCHS[a.family]} (reduced, {a.dtype}), {a.steps} steps at lr "
          f"{R.LR}, batch {R.BATCH}; against the port's plain step:")
    variants = ("chunk", "embed", "two microbatches",
                *(("out_proj halves",) if a.family == "hybrid" else ()),
                *SPLITS)
    for variant in variants:
        if variant in SPLITS:
            port[variant] = run_ranks(_ranks, 2, backend="gloo",
                                      device="cpu", args=(*args, variant),
                                      timeout=600)[0]
        else:
            port[variant] = run(*args, variant)
        (m, g, p), (bm, bg, bp) = port[variant], port["plain"]
        gd = max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
                 for x, y in zip(g, bg))
        md = float(np.max(np.abs(np.asarray(m) - bm) / np.abs(bm)))
        pd = max(float(np.abs(x - y).max()) for x, y in zip(p, bp))
        print(f"  {variant}: step-1 gradients {gd:.2e} of the leaf's "
              f"largest; losses / grad norms {md:.2e} (a step: "
              f"{_dist(m, bm)}); "
              f"params {pd:.2e} ({_over(p, bp, a.atol)} over {a.atol:g})")
    if a.leaves:
        print("step-1 gradient distance a leaf (|g - g_plain| / |g_plain|): "
              + ", ".join(variants))
        names = leaf_names(get_model(R.config(a.family)).init_params(
            0, "cpu"))
        for i, name in enumerate(names):
            y = port["plain"][1][i]
            scale = max(float(np.linalg.norm(y)), 1e-30)
            print(f"  {name}: " + ", ".join(
                f"{np.linalg.norm(port[v][1][i] - y) / scale:.3g}"
                for v in variants))
    ref = reference(a.family, a.steps, a.dtype)
    for tag in SPLITS:
        print(f"the reference's {tag} against its plain run: losses / grad "
              f"norms a step {_dist(ref[tag][0], ref['plain'][0])}")
    if a.dtype != "float32":
        return
    for tag in SPLITS:
        print(f"the reference's {tag} against its plain run: params "
              f"{_over(ref[tag][2], ref['plain'][2], a.atol)} over "
              f"{a.atol:g}; the port's {tag} against the reference's "
              f"{tag}: {_over(port[tag][2], ref[tag][2], a.atol)}")
        for i, (x, y) in enumerate(zip(port[tag][2], ref[tag][2])):
            for j in map(tuple, np.argwhere(np.abs(x - y) > a.atol)):
                grads = {f"{who} {k}": float(src[k][1][i][j])
                         for who, src in (("port", port), ("reference", ref))
                         for k in ("plain", *SPLITS)}
                print(f"  leaf {i} {x.shape} at {j}: port {x[j]:.7g}, "
                      f"reference {y[j]:.7g} ({abs(x[j] - y[j]):.3g}); the "
                      f"reference's {tag} from its plain run "
                      f"{abs(y[j] - ref['plain'][2][i][j]):.3g}; step-1 "
                      f"gradients {grads}; the leaf's largest |g| "
                      f"{float(np.abs(ref['plain'][1][i]).max()):.3g}")


if __name__ == "__main__":
    main()
