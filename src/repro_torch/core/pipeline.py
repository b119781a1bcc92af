"""End-to-end PTQ pipeline at model scope, single device.

``quantize_model`` walks the architecture's stages block by block:
  1. collect the block's input stream X (paper Algorithm 1: from the FP
     model) and the FP target block(theta_fp, X);
  2. initialize scale/zero per linear (this slice: RTN);
  3. optimize the rounding (not ported yet: ``method`` must be "none");
  4. write the fake-quantized block back and advance the streams.

``pack_model`` then converts the calibrated model into the deployment form:
stacked packed QTensors per linear.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import rtn as rtn_mod
from repro_torch.core.blocks import build_stages, get_path, set_path
from repro_torch.core.qtensor import QTensor, pack
from repro_torch.core.quantizer import resolve_group
from repro_torch.models.common import Ctx, DEFAULT_CTX


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def quantize_model(cfg: ModelConfig, params: Dict, batches: List[Dict],
                   qcfg: QuantConfig, *, method: str = "tesseraq",
                   init: str = "awq", ctx: Ctx = DEFAULT_CTX,
                   input_source: str = "fp"):
    """Returns (params_fq, qmeta, report), as the reference does.

    ``batches``: list of batch dicts ({"tokens": (B, S) int tensor on the
    params' device}).  This slice runs the data-free RTN row: ``method=
    "none"``, ``init="rtn"``, ``input_source="fp"``; the walk still runs the
    FP-stream forwards and reports each block's ``recon_mse``.  Every other
    method, init and input source raises.  The caller's params are left as they
    are: the walk quantizes a private copy of the block stack.
    """
    if method != "none":
        raise NotImplementedError(
            f"quantize_model: method {method!r} is not ported yet "
            "(ROADMAP queue 1, 'Calibration: AWQ + TesseraQ')")
    if init != "rtn":
        raise NotImplementedError(
            f"quantize_model: init {init!r} is not ported yet "
            "(ROADMAP queue 1, 'Calibration: AWQ + TesseraQ')")
    if input_source != "fp":
        raise NotImplementedError(
            f"quantize_model: input_source {input_source!r} is not ported "
            "yet (ROADMAP queue 1, 'Calibration: AWQ + TesseraQ')")
    stages = build_stages(cfg, ctx)
    params_q = dict(params)
    params_q["blocks"] = _clone_tree(params["blocks"])
    qmeta_all: Dict = {}
    report = {"blocks": [], "method": method, "init": init, "qcfg": qcfg.tag}

    with torch.no_grad():
        for stage in stages:
            parts = [stage.init_x(params_q, b) for b in batches]
            X_parts = X_fp_parts = parts
            for i in range(stage.n_blocks):
                t0 = time.time()
                same_stream = X_fp_parts is X_parts
                bp_fp = stage.get_block(params_q, i)
                # FP targets over the FP stream; they are the next block's
                # FP inputs too
                fp_out = [stage.apply(bp_fp, x) for x in X_fp_parts]
                bp_q, qmeta = rtn_mod.quantize_block_rtn(bp_fp, qcfg)
                params_q = stage.set_block(params_q, i, bp_q)
                for p_, m_ in qmeta.items():
                    qmeta_all[stage.pack_target(i) + tuple(p_)] = m_
                bq = stage.get_block(params_q, i)
                out_q = [stage.apply(bq, x) for x in X_fp_parts]
                err = float(torch.stack(
                    [((o.float() - f.float()) ** 2).mean()
                     for o, f in zip(out_q, fp_out, strict=True)]).mean())
                report["blocks"].append(
                    {"stage": stage.name, "block": i, "recon_mse": err,
                     "secs": time.time() - t0, "log": []})
                # advance the quantized stream (reusing the mse forward
                # while it still runs over the same stream) and the FP one
                if same_stream:
                    X_parts = out_q
                else:
                    X_parts = [stage.apply(bq, x) for x in X_parts]
                X_fp_parts = fp_out
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
