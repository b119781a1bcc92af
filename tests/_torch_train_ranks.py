"""Training runs of the port for the mesh train-step tests: the same
functions run a case in the test process (no mesh, or a mesh of one rank
without a process group) and inside a spawned rank of
``launch.mesh.run_ranks`` (gloo).  Torch and the port only: a spawned rank
imports this module, never jax.

Every case starts from params the test process hands over (the
reference's, bridged) and trains on one batch made here from a numpy seed,
so the reference, the test process and the ranks see the same bytes.  A
run returns its (loss, grad_norm) a step and its final params, gathered
whole, as numpy in the checkpoint's leaf order.
"""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import (param_shardings, shard_tree,
                                         unshard_tree)
from repro_torch.launch.steps import make_train_harness
from repro_torch.optim.compression import compressed_psum

# family -> reduced arch; the MoE's capacity factor drops routed pairs.
# "llama" is a dense config whose heads, KV heads, FFN and vocab divide by
# 4 (tinyllama's one KV head keeps its attention whole on a model axis,
# as PaliGemma's does)
ARCHS = {"moe": "qwen3-moe-30b-a3b", "dense": "tinyllama-1.1b",
         "rwkv": "rwkv6-3b", "llama": "llama2-7b", "vlm": "paligemma-3b",
         "hybrid": "zamba2-1.2b", "encdec": "whisper-small"}
MOE_CF = 0.5
STEPS, LR, BATCH = 3, 1e-3, (8, 33)
ODD_BATCH = (8, 34)         # S = 33 does not split over 2 model ranks
# the families whose (1, 2) seq_parallel run the reference makes too, and
# the one besides llama it runs at ODD_BATCH (whisper's 32 frames split,
# its 33 tokens do not)
REF_SEQ = ("rwkv", "vlm", "hybrid", "encdec")
ODD_FAMILY = "encdec"
WORLD_MESHES = {1: ((1,), (1, 1)), 2: ((2,), (1, 2)), 4: ((4,), (2, 2))}
# the reference's ``--attn-seq-parallel`` remap, and (family, mesh, variant)
# of the runs with it the reference makes too ("q": the remap, "qseq": the
# remap and seq_parallel)
QUERY_SPLIT = {"seq": ("model",)}
QUERY_CASES = tuple(
    ("llama", shape, var) for shape in ((1, 2), (2, 2), (1, 4))
    for var in ("q", "qseq")) + tuple(
        (fam, (1, 2), "q") for fam in ("moe", "vlm", "hybrid"))
ELASTIC = "dense"           # the family saved at (2, 2) and resumed
SAVE_AT = 2


def config(family):
    """The reduced f32 config of ``family`` (the MoE's capacity factor
    cut to ``MOE_CF``)."""
    cfg = get_reduced_config(ARCHS[family]).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=MOE_CF))
    return cfg


def batch(cfg, shape=BATCH):
    """A batch of ``shape`` tokens from ``default_rng(0)``, then from the
    same generator the VLM's patches (B, num_patches, d) or the
    encoder-decoder's frames (B, frontend_len, d)."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=shape).astype(np.int32)}
    lead = {"vlm": ("patches", cfg.num_patches),
            "encdec": ("frames", cfg.frontend_len)}.get(cfg.family)
    if lead is not None:
        out[lead[0]] = rng.normal(size=(shape[0], lead[1], cfg.d_model)
                                  ).astype(np.float32)
    return out


def loss_mask():
    """A (8, 33) loss mask keeping a different number of tokens in each
    half of the batch's rows."""
    rng = np.random.default_rng(1)
    m = (rng.random(BATCH) < 0.7).astype(np.int32)
    m[BATCH[0] // 2:, BATCH[1] // 2:] = 0
    return m


def embeds(cfg, shape=BATCH):
    """``inputs_embeds`` for the forward's ``S - 1`` positions of a batch of
    ``shape`` (tokens' rows, length), from ``default_rng(2)``."""
    rng = np.random.default_rng(2)
    return rng.normal(size=(shape[0], shape[1] - 1, cfg.d_model)).astype(
        np.float32)


def psum_input(n):
    """The inputs of ``tests/test_sharding.py``'s compressed_psum test at
    ``n`` pods: (n * 2, 64) f32, block ``i`` rows ``[2i, 2i + 2)``."""
    rng = np.random.default_rng(0)
    return rng.normal(size=(n * 2, 64)).astype(np.float32) * 3.0


def _numpy(tree):
    return [t.detach().cpu().numpy() for t in flatten(tree)]


def train(family, params, mesh=None, steps=STEPS, microbatches=1,
          ckpt=None, start=None, compression=False, mask=False,
          seq_parallel=False, odd=False, inputs=False, queries=False):
    """``steps`` steps of the harness on ``mesh`` (None: one device) from
    ``params`` (whole), or from ``start = (step, like)`` restored out of
    ``ckpt`` at the harness's shardings.  With ``ckpt`` and no ``start``
    the run saves at step ``SAVE_AT``.  ``compression``: int8 gradient
    compression with error feedback; ``mask``: the batch carries
    :func:`loss_mask`; ``odd``: the batch is ``ODD_BATCH``; ``inputs``:
    the batch carries :func:`embeds` as ``inputs_embeds``; ``queries``:
    the harness takes :data:`QUERY_SPLIT` (the reference's
    ``--attn-seq-parallel``).  Returns (metrics, whole params)."""
    cfg = config(family)
    h = make_train_harness(cfg, mesh, lr=LR, microbatches=microbatches,
                           grad_compression=compression,
                           seq_parallel=seq_parallel,
                           extra_overrides=QUERY_SPLIT if queries else None)
    shard = {"params": h.param_sharding, "opt": h.opt_sharding}
    p = params if mesh is None else shard_tree(params, h.param_sharding)
    o = h.init_opt(p)
    if start is not None:
        state = CheckpointManager(ckpt).restore(
            start, {"params": p, "opt": o},
            shardings=None if mesh is None else shard)
        p, o = state["params"], state["opt"]
    b = batch(cfg, ODD_BATCH if odd else BATCH)
    if mask:
        b["loss_mask"] = loss_mask()
    if inputs:
        b["inputs_embeds"] = embeds(cfg, b["tokens"].shape)
    out = []
    for s in range(steps):
        p, o, m = h.step_fn(p, o, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
        if ckpt is not None and start is None and s + 1 == SAVE_AT:
            CheckpointManager(ckpt).save(
                SAVE_AT, {"params": p, "opt": o},
                shardings=None if mesh is None else shard)
    if mesh is not None:
        p = unshard_tree(p, h.param_sharding)
    return out, _numpy(p)


def train_rank(params, ckpt, cases):
    """One rank: every ``(tag, family, shape, kw)`` of ``cases`` trained
    on ``make_mesh(shape)``; ``kw`` passes on to :func:`train` (``ckpt``
    joined in where it names ``"ckpt"``).  Returns {tag: (metrics, params)}
    on rank 0 and {tag: (metrics, None)} elsewhere, each rank's
    coordinates, the harness's plan (the leaves its step keeps split over
    ``model``), and whether ``unshard_tree(shard_tree(params))`` gave the
    params back bit for bit."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    out = {}
    for tag, family, shape, kw in cases:
        kw = dict(kw)
        if kw.pop("ckpt", False):
            kw["ckpt"] = ckpt
        mesh = make_mesh(shape, device="cpu")
        metrics, p = train(family, params[family], mesh, **kw)
        out[tag] = (metrics, p) if rank == 0 else (metrics, None)
        out[tag + "/coords"] = (mesh.data_rank, mesh.model_rank)
        out[tag + "/plan"] = make_train_harness(config(family), mesh).plan
        shard = param_shardings(mesh, params[family], config(family))
        back = unshard_tree(shard_tree(params[family], shard), shard)
        out[tag + "/roundtrip"] = all(
            torch.equal(a, b) for a, b in zip(flatten(back),
                                              flatten(params[family])))
    return out


def psum_rank(shapes):
    """``compressed_psum`` on each ``(shape, axes, axis)``: the rank's
    block of :func:`psum_input` over the axis's extent, and the result."""
    rank = torch.distributed.get_rank()
    out = {}
    for shape, axes, axis in shapes:
        mesh = make_mesh(shape, axes, device="cpu")
        n = mesh.size_of(axis)
        x = psum_input(n).reshape(n, 2, 64)[mesh.index_of(axis)]
        got = compressed_psum(torch.from_numpy(x.copy()), mesh, axis)
        out[(shape, axis)] = (rank, x, got.numpy())
    return out


def probe(family, params, shape, seq_parallel=False, queries=False):
    """One step of ``family`` on ``make_mesh(shape)`` (with ``queries``
    the harness takes :data:`QUERY_SPLIT`) with the work it does
    recorded: the heads and rows of each attention's q (of each
    cross-attention's too), the heads of each RWKV time mix, the columns
    of the logits the loss reads, the rows of each block's residual
    input, the (in, out) of each Mamba product, the rank's experts, the
    leaves split over ``model`` that the step gathers whole, and every
    collective as
    ``(op, axis, shape)`` (the axis its group runs over: ``"model"`` or
    ``"data"``).  Returns that record and the harness's plan."""
    import types
    from repro_torch.models import encdec, layers, moe, rwkv, ssm, \
        transformer
    torch.set_num_threads(1)
    dist = torch.distributed
    cfg = config(family)
    mesh = make_mesh(shape, device="cpu")
    h = make_train_harness(cfg, mesh, lr=LR, seq_parallel=seq_parallel,
                           extra_overrides=QUERY_SPLIT if queries else None)
    p = shard_tree(params[family], h.param_sharding)
    o = h.init_opt(p)
    rec = {"heads": set(), "qrows": set(), "vocab": set(), "rows": set(),
           "experts": set(),
           "time_heads": set(), "cross_heads": set(),
           "mamba_products": set(), "collectives": [], "plan": h.plan,
           "gathered": {n for n, sh in _named(h.param_sharding)
                        if "model" in tuple(sh.spec) and n not in h.plan}}
    axis = {id(mesh.group): "model", id(mesh.data_group): "data"}
    ops = ("broadcast", "all_reduce", "all_gather", "reduce_scatter")
    blocks = ((transformer, "block"), (rwkv, "block"),
              (ssm, "mamba_block"), (encdec, "encoder_block"),
              (encdec, "decoder_block"))
    real = {"attn": layers.flash_attention, "nll": layers.token_nll,
            "held": moe._experts_held, "scan": rwkv.chunked_linear_attention,
            "xattn": encdec._attn, "ssm_L": ssm.L,
            **{op: getattr(dist, op) for op in ops},
            **{(m, n): getattr(m, n) for m, n in blocks}}

    def attn(q, *a, **k):
        rec["heads"].add(q.shape[2])
        rec["qrows"].add(q.shape[1])
        return real["attn"](q, *a, **k)

    def nll(logits, *a, **k):
        rec["vocab"].add(logits.shape[-1])
        return real["nll"](logits, *a, **k)

    def rows(fn):
        def call(bp, x, *a, **k):
            rec["rows"].add(x.shape[1])
            return fn(bp, x, *a, **k)
        return call

    def held(mp):
        rec["experts"].add(real["held"](mp))
        return real["held"](mp)

    def scan(q, *a, **k):
        rec["time_heads"].add(q.shape[2])
        return real["scan"](q, *a, **k)

    def xattn(ap, x, kv_src, c, *a, **k):
        if kv_src is not x:
            rec["cross_heads"].add(ap["wq"].shape[-1] // c.resolved_head_dim)
        return real["xattn"](ap, x, kv_src, c, *a, **k)

    def mamba_matmul(x, w, *a, **k):
        rec["mamba_products"].add((x.shape[-1], w.shape[-1]))
        return layers.matmul(x, w, *a, **k)

    def counted(op):
        def call(t, *a, group=None, **k):
            x = t if isinstance(t, torch.Tensor) else a[0]
            rec["collectives"].append(
                (op, axis.get(id(group), "world"), tuple(x.shape)))
            return real[op](t, *a, group=group, **k)
        return call
    layers.flash_attention, layers.token_nll = attn, nll
    moe._experts_held, rwkv.chunked_linear_attention = held, scan
    encdec._attn = xattn
    ssm.L = types.SimpleNamespace(**{**vars(layers),
                                     "matmul": mamba_matmul})
    for m, n in blocks:
        setattr(m, n, rows(real[(m, n)]))
    for op in ops:
        setattr(dist, op, counted(op))
    try:
        h.step_fn(p, o, batch(cfg))
    finally:
        layers.flash_attention, layers.token_nll = real["attn"], real["nll"]
        moe._experts_held = real["held"]
        rwkv.chunked_linear_attention = real["scan"]
        encdec._attn, ssm.L = real["xattn"], real["ssm_L"]
        for m, n in blocks:
            setattr(m, n, real[(m, n)])
        for op in ops:
            setattr(dist, op, real[op])
    return rec


def _named(tree, name=None):
    """(leaf name, leaf) of every leaf of ``tree``."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, k)]
    return [(name, tree)]


def rank_main(params, ckpt, cases, psum_shapes, probes=()):
    """The spawned body: the training cases, the psum cases, then each
    ``(tag, family, shape, seq_parallel[, queries])`` of ``probes``."""
    out = train_rank(params, ckpt, cases)
    out["psum"] = psum_rank(psum_shapes)
    for tag, family, shape, *kw in probes:
        out[tag] = probe(family, params, shape, *kw)
    out["pid"] = os.getpid()
    return out
