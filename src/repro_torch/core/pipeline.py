"""End-to-end PTQ pipeline at model scope, single device.

``quantize_model`` walks the architecture's stages block by block:
  1. collect the block's input stream X (paper Algorithm 1: from the FP
     model; or, with ``input_source="quant"``, BRECQ-style from the
     progressively-quantized model) and the FP target block(theta_fp, X);
  2. initialize scale/zero per linear: RTN, AWQ (activation-aware
     scaling + clipping search on the captured inputs) or GPTQ (Hessian-
     guided column walk with error compensation);
  3. optimize with TesseraQ (``method="tesseraq"``), OmniQuant's learnable
     weight clipping (``"omniquant"``) or SignRound (``"signround"``), all
     on the single-device engine, or keep the initialization
     (``method="none"``);
  4. write the fake-quantized block back and advance the streams.

The streams stay on the params' device; captures and forwards run over
minibatches of ``capture.CAPTURE_MINIBATCH`` samples, as the reference's
single-device walk does.  ``pack_model`` then converts the calibrated
model into the deployment form: stacked packed QTensors per linear, with
DST folded into the scales.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import awq as awq_mod
from repro_torch.core import gptq as gptq_mod
from repro_torch.core import omniquant as omni_mod
from repro_torch.core import rtn as rtn_mod
from repro_torch.core import signround as sr_mod
from repro_torch.core import tesseraq as tq_mod
from repro_torch.core.blocks import build_stages, get_path, set_path
from repro_torch.core.capture import (capture_block_inputs,
                                      split_minibatches, stage_calibration)
from repro_torch.core.qtensor import QTensor, pack
from repro_torch.core.quantizer import resolve_group
from repro_torch.models.common import Ctx, DEFAULT_CTX

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
    against the initialization's (``tesseraq.flip_stats``).  The caller's
    params are left as they are: the walk quantizes a private copy of the
    block stack.
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
    stages = build_stages(cfg, ctx)
    params_q = dict(params)
    params_q["blocks"] = _clone_tree(params["blocks"])
    qmeta_all: Dict = {}
    report = {"blocks": [], "method": method, "init": init, "qcfg": qcfg.tag}

    with torch.no_grad():
        for stage in stages:
            X = torch.cat([stage.init_x(params_q, b) for b in batches], 0)
            X_fp = X
            # the reconstruction engine is reused for every block of a stage
            recon_cache: Dict = {}
            for i in range(stage.n_blocks):
                t0 = time.time()
                same_stream = X_fp is X
                # views into the walk's block stack: read them before
                # set_block overwrites block i below
                bp_fp = stage.get_block(params_q, i)
                src = X_fp if input_source == "fp" else X
                src_parts = split_minibatches(src)
                # FP targets block(theta_fp, src); in fp mode they are the
                # next block's FP inputs too
                fp_out = [stage.apply(bp_fp, x) for x in src_parts]
                Y = torch.cat(fp_out, 0)

                entry = {"stage": stage.name, "block": i}
                if init == "awq":
                    caps = capture_block_inputs(stage.apply, bp_fp,
                                                src_parts)
                    bp_init, qmeta = awq_mod.quantize_block_awq(bp_fp, caps,
                                                                qcfg)
                    entry["awq"] = {".".join(p): {"alpha": m["alpha"],
                                                  "clip": m["clip"]}
                                    for p, m in qmeta.items()}
                elif init == "gptq":
                    caps = capture_block_inputs(stage.apply, bp_fp,
                                                src_parts, want_hessian=True)
                    bp_init, qmeta = gptq_mod.quantize_block_gptq(bp_fp, caps,
                                                                  qcfg)
                    del caps
                else:
                    bp_init, qmeta = rtn_mod.quantize_block_rtn(bp_fp, qcfg)

                log: list = []
                init_meta = qmeta
                tr0 = time.time()
                if method == "none":
                    bp_q = bp_init
                else:
                    Xd, Yd = stage_calibration(src, Y)
                    if method == "tesseraq":
                        bp_q, qmeta = tq_mod.reconstruct_block(
                            stage.apply, bp_fp, Xd, Yd, None, qmeta, qcfg,
                            tcfg, log=log, cache=recon_cache)
                    elif method == "omniquant":
                        bp_q, qmeta = omni_mod.reconstruct_block(
                            stage.apply, bp_fp, Xd, Yd, None, qcfg,
                            steps=omni_steps, batch_size=tcfg.batch_size,
                            log=log, engine=tcfg.engine, cache=recon_cache)
                    else:
                        bp_q, qmeta = sr_mod.reconstruct_block(
                            stage.apply, bp_fp, Xd, Yd, None, qmeta, qcfg,
                            steps=max(tcfg.par_iterations
                                      * tcfg.steps_per_iteration, 50),
                            batch_size=tcfg.batch_size, log=log,
                            engine=tcfg.engine, cache=recon_cache)
                recon_s = time.time() - tr0
                params_q = stage.set_block(params_q, i, bp_q)
                for p_, m_ in qmeta.items():
                    qmeta_all[stage.pack_target(i) + tuple(p_)] = m_
                bq = stage.get_block(params_q, i)
                out_q = [stage.apply(bq, x) for x in src_parts]
                if method in ("tesseraq", "signround"):
                    entry["flips"] = {
                        ".".join(p): f for p, f in
                        tq_mod.flip_stats(init_meta, qmeta).items()}
                entry.update({"recon_mse": _mse(out_q, fp_out),
                              "secs": time.time() - t0,
                              "recon_secs": recon_s, "log": log})
                report["blocks"].append(entry)
                # advance the quantized stream (reusing the mse forward when
                # it ran over that stream) and the FP one
                if input_source == "quant" or same_stream:
                    X = torch.cat(out_q, 0)
                else:
                    X = torch.cat([stage.apply(bq, x)
                                   for x in split_minibatches(X)], 0)
                X_fp = Y if input_source == "fp" else X
    return params_q, qmeta_all, report


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
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
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
