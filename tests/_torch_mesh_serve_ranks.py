"""GSPMD-placed serving runs of the port for the mesh serve tests: the same
functions run a case in the test process (no mesh, or a mesh of one rank
without a process group) and inside a spawned rank of
``launch.mesh.run_ranks`` (gloo).  Torch and the port only: a spawned rank
imports this module, never jax.

Every case starts from params the test process hands over (the
reference's, bridged) and serves prompts made here from a numpy seed, so
the reference, the test process and the ranks see the same bytes.
"""
import numpy as np
import torch

from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import get_reduced_config
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import make_mesh, serve_mesh
from repro_torch.launch.scheduler import make_workload, serve_scheduled
from repro_torch.launch.sharding import MeshPlacement, ServeSpec
from repro_torch.launch.steps import make_serve_steps, make_train_harness
from repro_torch.models.common import _get_leaf, _leaf_paths

# family -> reduced arch: llama2's 4 KV heads split over ``model`` up to
# 4; tinyllama's one KV head never does, so its cache splits its sequence
ARCHS = {"dense": "llama2-7b", "gqa": "tinyllama-1.1b"}
B, PLEN, GEN = 4, 8, 4
WORLD_MESHES = {1: ((1, 1),), 2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
SLOTS = 4
WORKLOAD = dict(n_requests=6, seed=0, prompt_lens=(4, 12), budgets=(2, 6))
LR = 1e-2


def config(family):
    return get_reduced_config(ARCHS[family]).replace(dtype="float32")


def prompts(cfg):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, PLEN)).astype(np.int32)


def param_shapes(tree) -> list:
    """The leaves' shapes in the checkpoint's leaf order (QTensor-aware)."""
    return [tuple(t.shape) for t in flatten(tree)]


def cache_shapes(cache) -> dict:
    return {p: tuple(_get_leaf(cache, p).shape) for p in _leaf_paths(cache)}


def serve_f32(cfg, params, mesh):
    """The prefill of :func:`prompts` and ``GEN - 1`` greedy decode steps
    through the GSPMD steps with an f32 cache of ``PLEN + GEN`` positions
    (``mesh`` None: the unmeshed steps).  Returns the logits (GEN, B, V) and
    the shapes the rank keeps (its params and its cache)."""
    model, pstep, dstep = make_serve_steps(cfg, mesh, kernel_backend="xla")
    held = params if mesh is None else MeshPlacement.place(mesh, cfg, params)
    cache = model.init_cache(B, PLEN + GEN, torch.float32, "cpu")
    kept = {"params": param_shapes(held if mesh is None else held.params),
            "cache": cache_shapes(cache)}
    toks = torch.as_tensor(prompts(cfg), dtype=torch.long)
    with torch.no_grad():
        lg, cache = pstep(held, {"tokens": toks}, cache)
        out = [lg]
        tok = torch.argmax(lg, -1)
        pos = torch.full((B,), PLEN, dtype=torch.int32)
        for _ in range(GEN - 1):
            lg, cache = dstep(held, cache, tok, pos)
            out.append(lg)
            tok = torch.argmax(lg, -1)
            pos = pos + 1
    return np.stack([lg.numpy() for lg in out]), kept


def scheduled(cfg, params, mesh, prefill_chunk=0):
    """The seeded workload through the scheduler (``mesh`` None: no mesh);
    returns {rid: tokens}."""
    reqs = make_workload(cfg.vocab_size, **WORKLOAD)
    res = serve_scheduled(cfg, params, reqs, slots=SLOTS, device="cpu",
                          kernel_backend="xla", mesh=mesh,
                          prefill_chunk=prefill_chunk)
    return {r.rid: res.requests[r.rid]["tokens"] for r in reqs}


def train_step(cfg, params, mesh, **kw):
    """One harness step from ``params`` (whole) on ``mesh``; returns the
    new params as numpy, the rank's slices on a mesh."""
    from repro_torch.launch.sharding import shard_tree
    h = make_train_harness(cfg, mesh, lr=LR, **kw)
    p = params if mesh is None else shard_tree(params, h.param_sharding)
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(4, 17)).astype(np.int32)}
    new, _, m = h.step_fn(p, h.init_opt(p), batch)
    return [t.numpy() for t in flatten(new)] + [float(m["loss"])]


def tp_decode_record(cfg, params):
    """A TP = world decode step (``ServeSpec``) counted by
    ``hlo_stats.OpCounter``, after the prefill of :func:`prompts`: its
    collectives by op and its host transfers."""
    spec = ServeSpec.place(serve_mesh(torch.distributed.get_world_size(),
                                      device="cpu"), cfg, params)
    model, pstep, dstep = make_serve_steps(cfg, spec=spec,
                                           kernel_backend="xla")
    cache = model.init_cache(B, PLEN + GEN, torch.float32, "cpu")
    toks = torch.as_tensor(prompts(cfg), dtype=torch.long)
    with torch.no_grad():
        lg, cache = pstep(spec.params, {"tokens": toks}, cache)
        counter = hlo_stats.OpCounter()
        with counter:
            dstep(spec.params, cache, torch.argmax(lg, -1),
                  torch.full((B,), PLEN, dtype=torch.int32))
    return {"collectives": hlo_stats.collective_op_counts(
                counter.collectives),
            "host_transfers": hlo_stats.host_transfer_ops(counter),
            "flops": counter.flops}


def rank_main(params, world):
    """One rank: every case of its world.  Returns {tag: result}."""
    torch.set_num_threads(1)
    out = {}
    for fam in ARCHS:
        cfg = config(fam)
        for shape in WORLD_MESHES[world]:
            mesh = make_mesh(shape, device="cpu")
            out[f"{fam}|{shape}"] = serve_f32(cfg, params[fam], mesh)
            out[f"{fam}|{shape}|sched"] = scheduled(cfg, params[fam], mesh)
    cfg = config("dense")
    if world == 2:
        mesh = make_mesh((2, 1), device="cpu")
        out["sched|chunk"] = scheduled(cfg, params["dense"], mesh, 4)
        out["tp"] = tp_decode_record(cfg, params["dense"])
    mesh = make_mesh(WORLD_MESHES[world][0], device="cpu")
    out["train"] = [train_step(cfg, params["dense"], mesh, **kw)
                    for kw in ({}, {"seq_parallel": True},
                               {"extra_overrides": {"seq": ("data",)}},
                               {"extra_overrides": {"seq": ("model",)}})]
    return out
