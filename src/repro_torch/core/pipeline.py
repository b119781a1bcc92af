"""End-to-end PTQ pipeline at model scope, on one device or, with
``engine="sharded"``, on every rank of a mesh.

``quantize_model`` walks the architecture's stages block by block:
  1. collect the block's input stream X (paper Algorithm 1: from the FP
     model; or, with ``input_source="quant"``, BRECQ-style from the
     progressively-quantized model) and the FP target block(theta_fp, X);
  2. initialize scale/zero per linear: RTN, AWQ (activation-aware
     scaling + clipping search on the captured inputs) or GPTQ (Hessian-
     guided column walk with error compensation);
  3. optimize with TesseraQ (``method="tesseraq"``), OmniQuant's learnable
     weight clipping (``"omniquant"``) or SignRound (``"signround"``), on
     the engine ``tcfg.engine`` names (``"device"``, the reference's
     host-loop ``"reference"`` and ``"legacy"``, or the mesh-sharded
     ``"sharded"``), or keep the initialization (``method="none"``);
  4. write the fake-quantized block back and advance the streams.
A stage whose ``init_x`` returns None continues the running streams (the
hybrid's one-block stages), and a stage with ``calibrate=False`` only
advances both streams through its block (the hybrid's shared block after
its first site: through the block as already written back, as in the
reference).  A stage's ``make_aux`` gives a per-sample ``aux`` stream that
goes beside x into every forward of its blocks, their captures and their
reconstruction (the encoder-decoder's decoder: ``ln_enc`` of the encoder
stage's final quantized stream, which that stage keeps under its
``save_as`` name).

The streams stay on the params' device; captures and forwards run over
minibatches of ``capture.CAPTURE_MINIBATCH`` samples, as the reference's
single-device walk does.

With ``engine="sharded"`` every rank of the mesh (``tcfg.mesh``, default
the data mesh over every rank of the process group) runs the walk in
lockstep and returns the same tree.  The mesh is resolved once, the batch
size lifted to a multiple of the DP degree (clamped to the pool), and a
pool smaller than the DP degree or a chunk count it does not divide fails
before the first block, as in the reference.  Unlike the reference, which
batch-shards its capture forwards over DP and TP-places the block for
them (so its TP walk matches only within GSPMD's reordered contractions),
the port runs the capture, the AWQ / GPTQ initialization and the target
forwards replicated on every rank over the whole pool, exactly as with no
mesh; only the engine's staged streams split.  The walk is then
bit-identical to ``engine="device"`` at TP too.

In ``input_source="fp"`` block i+1's FP targets are computed before block
i reconstructs, from block i's targets (the reference's prefetch).  On a
mesh with a ``pod`` axis of extent P > 1 that prefetch moves into space,
as in the reference: block i of each stage is initialized and
reconstructed on pod ``i % P``'s ``("data", "model")`` submesh
(``launch.mesh.pod_submeshes``; the DP degree, the batch lift and the
checks are pod 0's), block i's targets hop to pod ``(i + 1) % P`` by
``reshard_between_pods`` before block i reconstructs, and that pod
computes block i+1's targets while pod ``i % P`` reconstructs.  Every
rank runs the loop in lockstep; the block, its ``qmeta`` and its report
entry then reach every rank (``launch.mesh.broadcast_tree``), and every
rank advances the quantized stream, so every rank returns the device
walk's tree.  A sharded walk reports ``report["pipeline"]``, the
reference's keys: ``pods``, ``dp``, ``tp``, per block ``stage``,
``block``, ``pod``, ``recon_secs``, ``capture_wait_secs`` (the pod's wait
on its prefetched targets; None where a block was not prefetched across
pods) and ``fill_secs`` (targets computed in place), and their totals
with ``efficiency`` = recon / (recon + wait).

``pack_model`` then converts the calibrated model into the deployment
form: stacked packed QTensors per linear, with DST folded into the
scales.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import awq as awq_mod
from repro_torch.core import gptq as gptq_mod
from repro_torch.core import omniquant as omni_mod
from repro_torch.core import recon_engine as re_mod
from repro_torch.core import rtn as rtn_mod
from repro_torch.core import signround as sr_mod
from repro_torch.core import tesseraq as tq_mod
from repro_torch.core.blocks import build_stages, get_path, set_path
from repro_torch.core.capture import (capture_block_inputs,
                                      split_minibatches, stage_calibration)
from repro_torch.core.qtensor import QTensor, pack
from repro_torch.core.quantizer import resolve_group
from repro_torch.launch.mesh import (broadcast_tree, dp_size, pod_count,
                                     pod_submeshes, reshard_between_pods,
                                     tp_size)
from repro_torch.models.common import Ctx, DEFAULT_CTX
from repro_torch.models.layers import PsumWeight

METHODS = ("tesseraq", "omniquant", "signround", "none")
INITS = ("awq", "rtn", "gptq")


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _mse(outs, refs) -> float:
    return float(torch.stack(
        [((o.float() - f.float()) ** 2).mean()
         for o, f in zip(outs, refs, strict=True)]).mean())


def quantize_model(cfg: ModelConfig, params: Dict, batches: List[Dict],
                   qcfg: QuantConfig, *, method: str = "tesseraq",
                   init: str = "awq",
                   tcfg: Optional[tq_mod.TesseraQConfig] = None,
                   omni_steps: int = 500,
                   ctx: Ctx = DEFAULT_CTX, input_source: str = "fp"):
    """Returns (params_fq, qmeta, report), as the reference does.

    ``batches``: list of batch dicts ({"tokens": (B, S) int tensor on the
    params' device}), the calibration set.
    method: tesseraq | omniquant | signround | none (initialization only)
    init:   awq | rtn | gptq (OmniQuant starts from the FP block and
        discards it, as in the reference)
    input_source: "fp" (paper Algorithm 1: block inputs from the FP model)
        or "quant" (BRECQ/OmniQuant-style compounding: inputs from the
        progressively-quantized stream, targets from the FP block on them)

    ``tcfg`` carries TesseraQ's schedule and every method's engine and
    batch size; OmniQuant takes ``omni_steps`` steps, SignRound
    ``max(par_iterations * steps_per_iteration, 50)``, as in the reference.

    Every block's report carries ``recon_mse`` (the written-back block
    against the FP targets), ``secs``, ``recon_secs`` (the reconstruction
    alone) and the engine ``log``; with AWQ also each linear's ``awq``
    choices, and with TesseraQ and SignRound the ``flips`` of the codes
    against the initialization's (``tesseraq.flip_stats``); a sharded
    walk adds ``report["pipeline"]`` (see the module docstring).  The
    caller's params are left as they are: the walk quantizes a private
    copy of the block stacks (``blocks``, the hybrid's ``shared_attn``, the
    encoder-decoder's ``encoder`` and ``decoder``).
    """
    if method not in METHODS:
        raise ValueError(f"quantize_model: unknown method {method!r} "
                         f"(expected one of {METHODS})")
    if init not in INITS:
        raise ValueError(f"quantize_model: unknown init {init!r} "
                         f"(expected one of {INITS})")
    if input_source not in ("fp", "quant"):
        raise ValueError(f"quantize_model: unknown input_source "
                         f"{input_source!r} (expected 'fp' or 'quant')")
    tcfg = tcfg or tq_mod.TesseraQConfig()
    mesh, pods, prof = None, [None], None
    if tcfg.engine == "sharded":
        tcfg, mesh, pods = _sharded_tcfg(tcfg, batches)
        prof = {"pods": len(pods), "dp": dp_size(tcfg.mesh),
                "tp": tp_size(tcfg.mesh), "blocks": []}
    P = len(pods)
    me = next(p for p, m in enumerate(pods) if m is None or m.member)
    fp_mode = input_source == "fp"
    stages = build_stages(cfg, ctx)
    params_q = dict(params)
    for key in ("blocks", "shared_attn", "encoder", "decoder"):
        if key in params:
            params_q[key] = _clone_tree(params[key])
    saved: Dict[str, torch.Tensor] = {}
    qmeta_all: Dict = {}
    report = {"blocks": [], "method": method, "init": init, "qcfg": qcfg.tag}

    def run(bp, stream):
        return torch.cat([stage.apply(bp, x, a) for x, a in
                          zip(split_minibatches(stream), aux_parts,
                              strict=True)], 0)

    def hop(x, src, dst):
        """``x`` from pod ``src``'s ranks to pod ``dst``'s (a collective of
        every rank; None off ``dst``)."""
        if src == dst:
            return x
        return reshard_between_pods(x if me == src else None, pods[dst],
                                    src_mesh=pods[src])

    X = X_fp = None
    fp_pod = None        # the pod whose ranks hold X_fp (None: every rank)
    with torch.no_grad():
        for stage in stages:
            parts = [stage.init_x(params_q, b, saved) for b in batches]
            if parts[0] is not None:     # else: continue the running stream
                X = torch.cat(parts, 0)
                X_fp, fp_pod = X, None
            # the stage's aux stream, once, split as the streams are split
            aux = stage.make_aux(params_q, batches, saved)
            aux_parts = (split_minibatches(aux) if aux is not None
                         else [None] * len(split_minibatches(X)))
            # the reconstruction engine is reused for every block of a stage
            recon_cache: Dict = {}
            # fp mode: block i's FP targets (minibatch parts, on pod i % P),
            # prefetched while block i - 1 reconstructed, and their inputs
            fp_out = fp_src = None
            for i in range(stage.n_blocks):
                t0 = time.time()
                b = i % P
                own = me == b
                same_stream = X_fp is X
                # views into the walk's block stack: read them before
                # set_block overwrites block i below
                bp_fp = stage.get_block(params_q, i)
                if not stage.calibrate:
                    # advance both streams through the block as it stands
                    X_next = run(bp_fp, X)
                    if not fp_mode or same_stream:
                        X_fp, fp_pod = X_next, None
                    elif X_fp is not None:      # on the pod that holds it
                        X_fp = run(bp_fp, X_fp)
                    X = X_next
                    continue
                # in fp mode every block after a stage's first was prefetched
                prefetched = fp_mode and i > 0
                if fp_mode and not prefetched and fp_pod not in (None, b):
                    X_fp, fp_pod = hop(X_fp, fp_pod, b), b
                wait_s = fill_s = None
                if own and prefetched:
                    if P > 1:
                        # the pod's residual wait on the targets it
                        # prefetched from the previous pod's hop
                        tw = time.time()
                        _ready(fp_out)
                        wait_s = time.time() - tw
                    # the FP stream: this pod's own targets of block i - 1
                    # on one pod, else the parts that hopped here
                    src_parts = fp_src
                    src = X_fp if P == 1 else torch.cat(src_parts, 0)
                elif own:
                    src = X_fp if fp_mode else X
                    src_parts = split_minibatches(src)
                    # FP targets block(theta_fp, src); in fp mode they are
                    # the next block's FP inputs too
                    tf = time.time()
                    fp_out = [stage.apply(bp_fp, x, a) for x, a in
                              zip(src_parts, aux_parts, strict=True)]
                    if prof is not None:
                        _ready(fp_out)
                        fill_s = time.time() - tf
                # prefetch (fp mode): block i's targets hop to the pod of
                # block i + 1, which computes that block's targets from them
                # while this pod reconstructs block i
                next_out = next_src = None
                if fp_mode and i + 1 < stage.n_blocks:
                    n = (i + 1) % P
                    next_src = hop(fp_out, b, n)
                    if me == n:
                        bp_next = stage.get_block(params_q, i + 1)
                        next_out = [stage.apply(bp_next, x, a) for x, a in
                                    zip(next_src, aux_parts, strict=True)]
                if own:
                    Y = torch.cat(fp_out, 0)
                    bp_q, qmeta, entry = _calibrate_block(
                        stage, i, bp_fp, src, src_parts, Y, aux, aux_parts,
                        qcfg, method, init, omni_steps,
                        tcfg if P == 1 else dataclasses.replace(
                            tcfg, mesh=pods[b]), recon_cache)
                    params_q = stage.set_block(params_q, i, bp_q)
                    bq = stage.get_block(params_q, i)
                    out_q = [stage.apply(bq, x, a) for x, a in
                             zip(src_parts, aux_parts, strict=True)]
                    entry.update({"recon_mse": _mse(out_q, fp_out),
                                  "secs": time.time() - t0})
                    pblock = {"stage": stage.name, "block": i, "pod": b,
                              "recon_secs": entry["recon_secs"],
                              "capture_wait_secs": wait_s,
                              "fill_secs": fill_s}
                if P > 1:
                    # the block, its meta and its report reach every rank
                    bp_q, qmeta, entry, pblock = broadcast_tree(
                        (bp_q, qmeta, entry, pblock) if own else None,
                        pods[b].ranks[0], mesh.group_of(mesh.axis_names),
                        mesh.device)
                    if not own:
                        params_q = stage.set_block(params_q, i, bp_q)
                for p_, m_ in qmeta.items():
                    qmeta_all[stage.pack_target(i) + tuple(p_)] = m_
                report["blocks"].append(entry)
                if prof is not None:
                    prof["blocks"].append(pblock)
                # advance the quantized stream (reusing the mse forward when
                # it ran over that stream) and the FP one
                if own and (not fp_mode or same_stream):
                    X = torch.cat(out_q, 0)
                else:
                    X = run(stage.get_block(params_q, i), X)
                if fp_mode:
                    X_fp = Y if own else None
                    fp_pod = b if P > 1 else None
                    fp_out, fp_src = next_out, next_src
                else:
                    X_fp = X
            if stage.save_as:
                # the quantized stream, as the reference saves it
                saved[stage.save_as] = X
    if prof is not None:
        report["pipeline"] = _pipeline_summary(prof)
    return params_q, qmeta_all, report


def _ready(parts):
    """Wait for the device work behind ``parts`` (the reference's
    ``block_until_ready``)."""
    dev = parts[0].device
    if dev.type == "cuda":
        # reprolint: ok[host-sync] — the reference blocks here to time the walk (report["pipeline"])
        torch.cuda.synchronize(dev)


def _calibrate_block(stage, i, bp_fp, src, src_parts, Y, aux, aux_parts,
                     qcfg, method, init, omni_steps, tcfg, cache):
    """Block ``i``'s initialization and reconstruction against its FP
    targets ``Y`` over ``src``: (bp_q, qmeta, its report entry)."""
    entry = {"stage": stage.name, "block": i}
    if init == "awq":
        caps = capture_block_inputs(stage.apply, bp_fp, src_parts, aux_parts)
        bp_init, qmeta = awq_mod.quantize_block_awq(bp_fp, caps, qcfg)
        entry["awq"] = {".".join(p): {"alpha": m["alpha"], "clip": m["clip"]}
                        for p, m in qmeta.items()}
    elif init == "gptq":
        caps = capture_block_inputs(stage.apply, bp_fp, src_parts, aux_parts,
                                    want_hessian=True)
        bp_init, qmeta = gptq_mod.quantize_block_gptq(bp_fp, caps, qcfg)
        del caps
    else:
        bp_init, qmeta = rtn_mod.quantize_block_rtn(bp_fp, qcfg)

    log: list = []
    init_meta = qmeta
    tr0 = time.time()
    if method == "none":
        bp_q = bp_init
    else:
        Xd, Yd, auxd = stage_calibration(src, Y, aux)
        if method == "tesseraq":
            bp_q, qmeta = tq_mod.reconstruct_block(
                stage.apply, bp_fp, Xd, Yd, auxd, qmeta, qcfg, tcfg, log=log,
                cache=cache)
        elif method == "omniquant":
            bp_q, qmeta = omni_mod.reconstruct_block(
                stage.apply, bp_fp, Xd, Yd, auxd, qcfg, steps=omni_steps,
                batch_size=tcfg.batch_size, log=log, engine=tcfg.engine,
                cache=cache, mesh=tcfg.mesh)
        else:
            bp_q, qmeta = sr_mod.reconstruct_block(
                stage.apply, bp_fp, Xd, Yd, auxd, qmeta, qcfg,
                steps=max(tcfg.par_iterations * tcfg.steps_per_iteration, 50),
                batch_size=tcfg.batch_size, log=log, engine=tcfg.engine,
                cache=cache, mesh=tcfg.mesh)
    entry["recon_secs"] = time.time() - tr0
    entry["log"] = log
    if method in ("tesseraq", "signround"):
        entry["flips"] = {".".join(p): f for p, f in
                          tq_mod.flip_stats(init_meta, qmeta).items()}
    return bp_q, qmeta, entry


def _pipeline_summary(prof):
    """The reference's totals over ``prof["blocks"]``: reconstruction,
    residual prefetch wait and pipeline-fill seconds, and the efficiency
    recon / (recon + wait), defined once a block was prefetched across
    pods (``capture_wait_secs`` None before)."""
    blocks = prof["blocks"]
    recon = float(sum(b["recon_secs"] for b in blocks))
    waits = [b["capture_wait_secs"] for b in blocks
             if b["capture_wait_secs"] is not None]
    wait = float(sum(waits))
    fill = float(sum(b["fill_secs"] or 0.0 for b in blocks))
    eff = (recon / (recon + wait)
           if waits and (recon + wait) > 0 else None)
    return {**prof, "recon_secs": recon,
            "capture_wait_secs": wait if waits else None,
            "fill_secs": fill, "efficiency": eff}


def _sharded_tcfg(tcfg, batches):
    """(tcfg, mesh, pods) for a sharded walk: the mesh resolved once (on
    the batches' device) and, on a mesh with a ``pod`` axis of extent > 1,
    its per-pod submeshes (else ``[mesh]``); ``tcfg.mesh`` pod 0's, with
    ``batch_size`` lifted to a multiple of its DP degree and clamped to the
    largest such size the pool fills (``stage_plan`` clamps to the pool,
    which would undo a bare lift); the pool and chunk checks of the
    reference's walk, on pod 0's submesh."""
    first = next(iter(batches[0].values()))
    mesh = re_mod.resolve_mesh(tcfg.mesh, first.device)
    if not mesh.member:
        raise ValueError(f"quantize_model: rank {mesh.rank} is not one of "
                         f"the mesh's ranks {mesh.ranks}")
    pods = pod_submeshes(mesh) if pod_count(mesh) > 1 else [mesh]
    D = dp_size(pods[0])
    n_pool = sum(next(iter(b.values())).shape[0] for b in batches)
    if n_pool < D:
        raise ValueError(
            f"calibration pool ({n_pool} samples) is smaller than the "
            f"mesh's data-parallel degree ({D}); add calibration data or "
            "shrink the mesh")
    bs = min(tcfg.batch_size + (-tcfg.batch_size % D), n_pool - n_pool % D)
    if re_mod.grad_chunk_count(bs, n_pool) % D:
        raise ValueError(
            f"calibration pool size {n_pool} is incompatible with the "
            f"mesh's data-parallel degree {D}: the canonical gradient chunk "
            f"count gcd(batch={bs}, pool={n_pool}, "
            f"cap={re_mod.CANONICAL_LANE_CHUNKS}) must be a multiple of "
            f"{D} — use a calibration pool whose size is a multiple of the "
            "DP degree, or set recon_engine.CANONICAL_LANE_CHUNKS to a "
            "multiple of the DP degree (required for DP degrees that do not "
            f"divide {re_mod.CANONICAL_LANE_CHUNKS}, e.g. 6-way), or shrink "
            "the mesh")
    return (dataclasses.replace(tcfg, mesh=pods[0], batch_size=bs), mesh,
            pods)


def pack_model(cfg: ModelConfig, params_q: Dict, qmeta_all: Dict,
               qcfg: QuantConfig) -> Dict:
    """Convert calibrated fake-quant params into stacked packed QTensors.
    Codes are packed layer by layer before stacking (the same bytes as
    packing the stack, without a stacked copy of the unpacked codes)."""
    grouped: Dict = {}
    for key, meta in qmeta_all.items():
        pkey, idx, path = key[0], key[1], key[2:]
        grouped.setdefault((pkey, path), {})[idx] = meta

    out = params_q
    for (pkey, path), metas in grouped.items():
        idxs = sorted(metas)
        full_path = (pkey,) + path
        leaf = get_path(out, full_path)                      # (L, in, out)
        first = metas[idxs[0]]
        in_f, out_f = first["codes"].shape[-2:]
        if leaf.shape[0] != len(idxs):
            raise ValueError(f"layer count mismatch at {full_path}")
        packed = torch.stack([pack(metas[i]["codes"].to(torch.uint8),
                                   qcfg.bits, axis=-2) for i in idxs])
        scale = torch.stack([metas[i]["scale"].to(torch.float32)
                             for i in idxs])
        zero = torch.stack([metas[i]["zero"].to(torch.float32) for i in idxs])
        act = (torch.stack([metas[i]["act_scale"].to(torch.float32)
                            for i in idxs])
               if first.get("act_scale") is not None else None)
        qt = QTensor(packed=packed, scale=scale, zero=zero, bits=qcfg.bits,
                     group_size=resolve_group(in_f, qcfg.group_size),
                     shape=(in_f, out_f), act_scale=act)
        out = set_path(out, full_path, qt)
    return out


def _leaves(tree):
    """Every weight of a param tree; a serve-time TP rank's in-split
    weight (``PsumWeight``) counts as the shard it wraps."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, PsumWeight):
        yield tree.w
    else:
        yield tree


def quantized_memory_report(params) -> Dict:
    """Paper Table 8 'WM': weight memory of the deployment artifact."""
    total_q, total_fp = 0, 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            total_q += leaf.memory_bytes()
            n_stack = 1
            for d in leaf.packed.shape[:-2]:
                n_stack *= int(d)
            total_fp += n_stack * leaf.in_features * leaf.out_features * 2
        else:
            total_q += leaf.numel() * 2
            total_fp += leaf.numel() * 2
    return {"quantized_bytes": total_q, "fp16_bytes": total_fp,
            "compression": total_fp / max(total_q, 1)}


__all__ = ["quantize_model", "pack_model", "quantized_memory_report"]
