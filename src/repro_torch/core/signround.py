"""SignRound (Cheng et al., 2023): weight-rounding optimization via *signed*
gradient descent — the rounding-optimization baseline the paper compares
against in Tables 2/11.

A continuous perturbation V in [-0.5, 0.5] is added before rounding:
    W_q = clamp(round_ste(W/s + V) + z, 0, 2^N - 1)
and optimized with sign-SGD (update = -lr * sign(grad)) with linear lr decay
against the block-reconstruction loss.  Unlike TesseraQ there is no
progressive hardening and no dequant-scale tuning; unlike AdaRound there is
no rectified-sigmoid regularizer.

The steps run on the single-device engine of ``core/recon_engine.py`` with
``SignSGD``: ``prepare`` gives every linear's perturbed fake-quant weight,
``lane_loss`` applies the block to it.  The reference's ``"reference"``,
``"legacy"`` and ``"sharded"`` engines raise here, naming their ROADMAP
items (``recon_engine.NOT_PORTED_ENGINES``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import recon_engine as RE
from repro_torch.core.blocks import get_path, quant_leaf_paths, set_path
from repro_torch.core.quantizer import clip, resolve_group, ste_round


def _sr_weight(w, v, scale, zero, qcfg: QuantConfig, act_scale=None):
    """(fake-quant weight (..., in, out) f32, codes in the grouped layout)
    for the perturbation ``v`` (..., ng, g, out); AWQ's ``act_scale``
    multiplies the weight before rounding and divides it after."""
    g = resolve_group(w.shape[-2], qcfg.group_size)
    wf = w.to(torch.float32)
    if act_scale is not None:
        wf = wf * act_scale[..., :, None]
    wg = wf.reshape(tuple(wf.shape[:-2]) + (wf.shape[-2] // g, g,
                                            wf.shape[-1]))
    vc = clip(v, -0.5, 0.5)
    q = clip(ste_round(wg / scale[..., None, :] + vc) + zero[..., None, :],
             0, qcfg.qmax)
    out = ((q - zero[..., None, :]) * scale[..., None, :]).reshape(wf.shape)
    if act_scale is not None:
        out = out / act_scale[..., :, None]
    return out, q


def _make_objective(apply: Callable, qcfg: QuantConfig) -> RE.Objective:
    """``frozen = {"bp": block params, "fixed": {path: scale/zero/act}}``;
    the trainables are ``{path: v}``."""

    def prepare(vs, frozen):
        return {p: _sr_weight(get_path(frozen["bp"], p), vs[p], f["scale"],
                              f["zero"], qcfg, f["act_scale"])[0]
                for p, f in frozen["fixed"].items()}

    return RE.block_mse_objective(apply, prepare)


def reconstruct_block(apply: Callable, bp, X, Y, aux, qmeta: Dict,
                      qcfg: QuantConfig, *, steps: int = 200, lr: float = 5e-3,
                      batch_size: int = 4, seed: int = 0,
                      log: Optional[list] = None, engine: str = "device",
                      cache: Optional[dict] = None):
    """Sign-SGD rounding optimization on one block.  ``qmeta`` supplies the
    (AWQ/RTN/GPTQ) scale/zero/act_scale initialization, exactly as for
    TesseraQ.  X/Y: the block's calibration streams on its device; ``aux``
    must be None (dense and MoE families).  ``cache`` (scoped by the
    caller to one stage) reuses the engine across the stage's blocks.  Log
    entries carry the loss of the last step of every 50.  Returns (bp_fq,
    qmeta')."""
    RE.check_engine(engine, "signround.reconstruct_block")
    if aux is not None:
        raise NotImplementedError(
            "signround.reconstruct_block: per-sample aux streams are not "
            "ported yet (ROADMAP queue 1, 'Remaining families')")
    paths = quant_leaf_paths(bp)
    fixed = {p: {"scale": qmeta[p]["scale"], "zero": qmeta[p]["zero"],
                 "act_scale": qmeta[p].get("act_scale")} for p in paths}
    vs = {}
    for p in paths:
        w = get_path(bp, p)
        g = resolve_group(w.shape[-2], qcfg.group_size)
        vs[p] = torch.zeros(tuple(w.shape[:-2]) + (w.shape[-2] // g, g,
                                                   w.shape[-1]),
                            dtype=torch.float32, device=w.device)

    eng = RE.cached_engine(cache, "signround", lambda: (
        RE.ReconstructionEngine(
            _make_objective(apply, qcfg),
            RE.SignSGD(lr=lr, total_steps=steps, clip=0.5))))
    plan = RE.stage_plan(X, Y, batch_size=batch_size, total_steps=steps,
                         seed=seed)
    vs, _ = RE.run_logged(eng, vs, eng.init(vs), {"bp": bp, "fixed": fixed},
                          plan, steps=steps, chunk=50, log=log)

    new_meta = {}
    with torch.no_grad():
        for p in paths:
            w = get_path(bp, p)
            wq, q = _sr_weight(w, vs[p], fixed[p]["scale"], fixed[p]["zero"],
                               qcfg, fixed[p]["act_scale"])
            bp = set_path(bp, p, wq.to(w.dtype))
            new_meta[p] = {
                "scale": fixed[p]["scale"], "zero": fixed[p]["zero"],
                "act_scale": fixed[p]["act_scale"], "dst": None,
                "codes": q.to(torch.uint8).reshape(w.shape),
            }
    return bp, new_meta


__all__ = ["reconstruct_block"]
