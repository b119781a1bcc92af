"""Serve runs of the port for the tensor-parallel tests: the same function
serves one process without a mesh (in the test process) and one rank of a
``launch.mesh.Mesh`` (spawned by ``launch.mesh.run_ranks``).  Torch
and the port only: a spawned rank imports this module, never jax."""
import dataclasses

import numpy as np
import torch

from repro_torch.launch.mesh import serve_mesh
from repro_torch.launch.scheduler import compile_sched_steps, serve_scheduled
from repro_torch.launch.serve import compile_serve_steps
from repro_torch.launch.sharding import ServeSpec, unplace
from repro_torch.models import get_model

MAX_SEQ = 32


def run_family(cfg, params, inputs, *, backend="xla", gen=3):
    """Lock-step prefill + ``gen - 1`` greedy decode steps through the
    serve steps on an f32 cache (the cross-package rule) of ``params``, a
    param tree or a placed ``ServeSpec``; ``inputs`` holds numpy
    ``tokens`` (B, S) and the VLM's ``patches`` or the encoder-decoder's
    ``frames``.  Returns (tokens (B, gen), logits (B, gen, V)) as numpy."""
    model = get_model(cfg)
    params, spec = unplace(params)
    if spec is not None:
        model = spec.cache_model(model)
    pstep, dstep = compile_serve_steps(cfg, kernel_backend=backend,
                                       spec=spec)
    tokens = inputs["tokens"]
    B, S = tokens.shape
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    batch["tokens"] = batch["tokens"].long()
    with torch.no_grad():
        cache = model.init_cache(B, S + gen + extra, torch.float32, "cpu")
        lg, cache = pstep(params, batch, cache)
        tok = torch.argmax(lg, -1)
        pos = torch.full((B,), S + extra, dtype=torch.int32)
        toks, lgs = [tok], [lg]
        for _ in range(gen - 1):
            lg, cache = dstep(params, cache, tok, pos)
            tok = torch.argmax(lg, -1)
            pos = pos + 1
            toks.append(tok)
            lgs.append(lg)
    return (torch.stack(toks, 1).numpy(),
            torch.stack(lgs, 1).float().numpy())


def f32_cache_steps(steps):
    """``steps`` with its model's caches allocated in f32 whatever the
    store asks for."""
    init = steps.model.init_cache
    model = dataclasses.replace(
        steps.model,
        init_cache=lambda b, s, _=None, *a: init(b, s, torch.float32, *a))
    return dataclasses.replace(steps, model=model)


def run_sched(cfg, params, reqs, kw):
    """``serve_scheduled`` of ``params`` (a param tree or a placed
    ``ServeSpec``) over 2 slots at ``MAX_SEQ`` on f32 caches (``kw``:
    store, page_size, prefill_chunk); {rid: (tokens, logits)}."""
    paged = kw.get("store") == "paged"
    steps = f32_cache_steps(compile_sched_steps(
        cfg, max_seq=MAX_SEQ, kernel_backend="xla",
        page_size=kw.get("page_size", 16) if paged else 0,
        spec=unplace(params)[1]))
    res = serve_scheduled(cfg, params, reqs, slots=2, max_seq=MAX_SEQ,
                          collect_logits=True, compiled=steps, device="cpu",
                          **kw)
    return {r.rid: (res.requests[r.rid]["tokens"],
                    res.requests[r.rid]["logits"]) for r in reqs}


def tp_cases(tp, families, scheds):
    """One rank's runs: every ``families`` case ``key -> (cfg, params,
    inputs, backend)`` through ``run_family`` and every ``scheds`` case
    ``key -> (cfg, params, reqs, kw)`` through ``run_sched``, all on the
    rank's shards of a ``tp``-way model axis."""
    torch.set_num_threads(1)
    mesh = serve_mesh(tp, device="cpu")
    out = {"rank": mesh.rank, "model_rank": mesh.model_rank,
           "shape": mesh.shape}
    for key, (cfg, params, inputs, backend) in families.items():
        out[key] = run_family(cfg, ServeSpec.place(mesh, cfg, params),
                              inputs, backend=backend)
    for key, (cfg, params, reqs, kw) in scheds.items():
        out[key] = run_sched(cfg, ServeSpec.place(mesh, cfg, params), reqs,
                             kw)
    return out


def group_sum(tp, value):
    """Each rank all-reduces ``value + rank`` over its model group: (rank,
    model_rank, group ranks' sum, shape) of the mesh."""
    mesh = serve_mesh(tp, device="cpu")
    t = torch.tensor([float(value + mesh.rank)])
    torch.distributed.all_reduce(t, group=mesh.group)
    return mesh.rank, mesh.model_rank, float(t[0]), mesh.shape


def raise_on(rank, message):
    """Fails on ``rank`` only."""
    if torch.distributed.get_rank() == rank:
        raise ValueError(message)
    return np.int64(torch.distributed.get_rank())
