"""OmniQuant-style learnable weight clipping (LWC) with block reconstruction
(Shao et al., 2023) — the paper's strongest baseline and its W2A16 initializer.

Per group we learn gamma = sigmoid(g), beta = sigmoid(b) shrinking the
max/min clipping range; rounding uses the straight-through estimator (the
biased-gradient approach TesseraQ's PAR deliberately avoids — kept here
faithfully as the baseline).

The steps run on the single-device engine of ``core/recon_engine.py`` with
AdamW: ``prepare`` gives every linear's LWC fake-quant weight,
``lane_loss`` applies the block to it.  The reference's ``"reference"``,
``"legacy"`` and ``"sharded"`` engines raise here, naming their ROADMAP
items (``recon_engine.NOT_PORTED_ENGINES``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import recon_engine as RE
from repro_torch.core.blocks import get_path, quant_leaf_paths, set_path
from repro_torch.core.quantizer import (clip, quantize_codes, resolve_group,
                                        ste_round)
from repro_torch.optim.adam import AdamW


def _lwc_weight(w, g, b, qcfg: QuantConfig):
    """(fake-quant weight, scale, zero) of ``w`` (..., in, out) f32 with the
    group range shrunk by sigmoid(g) (max) and sigmoid(b) (min).  Ties of
    the group max/min share their gradient evenly (``amax``/``amin``), as
    ``jnp.max``/``jnp.min`` do."""
    gs = resolve_group(w.shape[-2], qcfg.group_size)
    wg = w.reshape(tuple(w.shape[:-2]) + (w.shape[-2] // gs, gs,
                                          w.shape[-1]))
    wmax = torch.amax(wg, dim=-2) * torch.sigmoid(g)
    wmin = torch.amin(wg, dim=-2) * torch.sigmoid(b)
    rng = wmax - wmin
    scale = torch.maximum(rng, rng.new_full((), 1e-8)) / qcfg.qmax
    zero = ste_round(-wmin / scale)
    q = clip(ste_round(wg / scale[..., None, :]) + zero[..., None, :],
             0, qcfg.qmax)
    wq = (q - zero[..., None, :]) * scale[..., None, :]
    return wq.reshape(w.shape), scale, zero


def _scale_shape(w, qcfg: QuantConfig):
    gs = resolve_group(w.shape[-2], qcfg.group_size)
    return tuple(w.shape[:-2]) + (w.shape[-2] // gs, w.shape[-1])


def _make_objective(apply: Callable, qcfg: QuantConfig) -> RE.Objective:
    """``frozen = {"bp": block params, "ws": {path: f32 weight}}``; the
    trainables are ``{path: {"g", "b"}}``."""

    def prepare(tr, frozen):
        return {p: _lwc_weight(w, tr[p]["g"], tr[p]["b"], qcfg)[0]
                for p, w in frozen["ws"].items()}

    return RE.block_mse_objective(apply, prepare)


def reconstruct_block(apply: Callable, bp, X, Y, aux, qcfg: QuantConfig, *,
                      steps: int = 2000, lr: float = 1e-2, batch_size: int = 4,
                      seed: int = 0, log: Optional[list] = None,
                      engine: str = "device", cache: Optional[dict] = None):
    """LWC block reconstruction from the FP block.  X/Y: the block's
    calibration streams on its device; ``aux`` must be None (dense and MoE
    families).  ``cache`` (scoped by the caller to one stage) reuses the
    engine across the stage's blocks.  Log entries carry the loss of the
    last step of every 100.  Returns (bp_fq, qmeta) with ``zero`` rounded
    and the codes as uint8, as the reference returns them."""
    RE.check_engine(engine, "omniquant.reconstruct_block")
    if aux is not None:
        raise NotImplementedError(
            "omniquant.reconstruct_block: per-sample aux streams are not "
            "ported yet (ROADMAP queue 1, 'Remaining families')")
    paths = quant_leaf_paths(bp)
    # sigmoid^-1(~1.0-): gamma and beta start near 1 (4.0 -> 0.982)
    tr = {}
    for p in paths:
        w = get_path(bp, p)
        tr[p] = {k: torch.full(_scale_shape(w, qcfg), 4.0,
                               dtype=torch.float32, device=w.device)
                 for k in ("g", "b")}
    ws = {p: get_path(bp, p).to(torch.float32) for p in paths}

    eng = RE.cached_engine(cache, "omniquant", lambda: (
        RE.ReconstructionEngine(_make_objective(apply, qcfg), AdamW(lr=lr))))
    plan = RE.stage_plan(X, Y, batch_size=batch_size, total_steps=steps,
                         seed=seed)
    tr, _ = RE.run_logged(eng, tr, eng.init(tr), {"bp": bp, "ws": ws}, plan,
                          steps=steps, chunk=100, log=log)

    qmeta = {}
    with torch.no_grad():
        for p in paths:
            wq, scale, zero = _lwc_weight(ws[p], tr[p]["g"], tr[p]["b"], qcfg)
            codes = quantize_codes(wq, scale, zero, qcfg)
            bp = set_path(bp, p, wq.to(get_path(bp, p).dtype))
            qmeta[p] = {"scale": scale, "zero": torch.round(zero),
                        "act_scale": None, "dst": None,
                        "codes": codes.to(torch.uint8)}
    return bp, qmeta


__all__ = ["reconstruct_block"]
