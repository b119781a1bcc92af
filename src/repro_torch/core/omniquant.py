"""OmniQuant-style learnable weight clipping (LWC) with block reconstruction
(Shao et al., 2023) — the paper's strongest baseline and its W2A16 initializer.

Per group we learn gamma = sigmoid(g), beta = sigmoid(b) shrinking the
max/min clipping range; rounding uses the straight-through estimator (the
biased-gradient approach TesseraQ's PAR deliberately avoids — kept here
faithfully as the baseline).

The steps run on the single-device engine of ``core/recon_engine.py`` with
AdamW (``engine="device"``): ``prepare`` gives every linear's LWC
fake-quant weight, ``lane_loss`` applies the block to it.  With
``engine="reference"`` or ``"legacy"`` they run on the reference's host
loop instead: every step's minibatch gathered on the host and pushed, one
batch-mean gradient (``recon_engine.batch_mean_grad``) and the AdamW
update.  ``engine="sharded"`` runs the device engine on a
``launch.mesh.Mesh``, data-parallel only, as in the reference: on a mesh
with a ``model`` axis the clipping logits replicate.
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
                      engine: str = "device", cache: Optional[dict] = None,
                      mesh=None):
    """LWC block reconstruction from the FP block.  X/Y: the block's
    calibration streams on its device; ``aux`` the per-sample extra
    stream beside x (the encoder-decoder's encoder states) or None.
    ``engine`` is "device", "reference", "legacy" (the two host-loop
    engines run the same loop here, as in the reference) or "sharded" (on
    ``mesh``, default the data mesh over every rank).
    ``cache`` (scoped by the caller to one stage) reuses the engine across
    the stage's blocks.  Log entries carry the loss of the last step of
    every 100 on the device engine, of steps 0, 100, ... on the host loop
    (the reference's two logs).  Returns (bp_fq, qmeta) with ``zero``
    rounded and the codes as uint8, as the reference returns them."""
    RE.check_engine(engine, "omniquant.reconstruct_block")
    paths = quant_leaf_paths(bp)
    # sigmoid^-1(~1.0-): gamma and beta start near 1 (4.0 -> 0.982)
    tr = {}
    for p in paths:
        w = get_path(bp, p)
        tr[p] = {k: torch.full(_scale_shape(w, qcfg), 4.0,
                               dtype=torch.float32, device=w.device)
                 for k in ("g", "b")}
    ws = {p: get_path(bp, p).to(torch.float32) for p in paths}

    frozen = {"bp": bp, "ws": ws}
    if engine in ("device", "sharded"):
        m = RE.resolve_mesh(mesh, X.device) if engine == "sharded" else None
        eng = RE.cached_engine(
            cache, "omniquant" if m is None else ("omniquant", m), lambda: (
                RE.ReconstructionEngine(_make_objective(apply, qcfg),
                                        AdamW(lr=lr), mesh=m)))
        plan = RE.stage_plan(X, Y, aux, batch_size=batch_size,
                             total_steps=steps, seed=seed, mesh=m)
        tr, _ = RE.run_logged(eng, tr, eng.init(tr), frozen, plan,
                              steps=steps, chunk=100, log=log)
    else:
        # the host loop: one objective a stage, as the reference keeps one
        # traced gradient a stage
        obj = RE.cached_engine(cache, "legacy-grad",
                               lambda: _make_objective(apply, qcfg))
        opt = AdamW(lr=lr)
        st = opt.init(tr)
        Xh, Yh, auxh = RE.host_stage(X, Y, aux)
        N = Xh.shape[0]
        plan = RE.draw_index_plan(N, min(batch_size, N), steps, seed)
        for t in range(steps):
            # reprolint: ok[host-sync] — the per-step host gather is the host loop's design (counted)
            xb, yb, ab = RE.host_batch(Xh, Yh, plan[t], X.device, auxh)
            lv, grads = RE.batch_mean_grad(obj, tr, frozen, xb, yb, ab)
            with torch.no_grad():
                tr, st = opt.update(grads, st, tr)
            if log is not None and t % 100 == 0:
                # reprolint: ok[host-sync] — the reference's host-loop log reads the loss (counted)
                log.append({"step": t, "loss": float(RE.host_read(lv))})

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
