"""TesseraQ: Progressive Adaptive Rounding + Dequantization Scale Tuning
(the paper's contribution, Sec. 3.2/3.3, Algorithm 1).

Per block:
  * rounding variables  nu  (one per weight element), sigmoid-reparameterized,
    initialized to reproduce the FP weight exactly:
        nu0 = logit(theta/s - floor(theta/s))
  * DST variables  v  (one per quant group), dequant factor 2*sigmoid(v),
    initialized to 1 (v = 0)
  * K PAR iterations; iteration k HARDENS the still-soft variables with the
    HIGHEST hardness score  HS(nu) = |sigmoid(nu) - 0.5|  (frozen to their
    binary value), then SOFTENS: T Adam steps on the surviving nu and all v
    against  || block(theta_hat, X) - block(theta, X) ||_F^2.

Hardening is tracked with an explicit int8 sign tensor (exactly-zero
gradients for frozen variables); the paper's memory-light alternative (set
nu to +-inf) is ``use_inf_freeze``.

The inner loop runs on the single-device engine of ``core/recon_engine.py``
(``engine="device"``).  θ̂ is materialized once per step per linear: under
``QuantConfig.kernel_backend == "pallas"`` through the soft_round kernels
(forward and backward; their plain versions on a CPU tensor), under
``"xla"`` as plain torch differentiated by autograd, as the reference does
in jnp.  The reference's ``"reference"``, ``"legacy"`` and ``"sharded"``
engines raise here (ROADMAP queue 1 item 1, queue 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import recon_engine as RE
from repro_torch.core.blocks import get_path, quant_leaf_paths, set_path
from repro_torch.core.quantizer import resolve_group
from repro_torch.kernels.soft_round import SoftRound, soft_round_plain
from repro_torch.models.layers import resolve_backend
from repro_torch.optim.adam import AdamW

# handcrafted soft-rate schedule from the paper's Fig. 3 (fractions of
# variables still soft after iteration k); len == K
HANDCRAFTED_SOFT_RATE = (
    0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.22, 0.16, 0.12,
    0.09, 0.06, 0.04, 0.025, 0.015, 0.009, 0.005, 0.002, 0.001, 0.0,
)


def exp_soft_rate(k: int, K: int, t: float) -> float:
    """Rule-based schedule 1/exp(t*x) (paper Sec. 4.3), x in (0, 1]."""
    x = (k + 1) / K
    return float(np.exp(-t * x)) if k + 1 < K else 0.0


@dataclasses.dataclass
class TesseraQConfig:
    par_iterations: int = 20              # K
    steps_per_iteration: int = 250        # T
    lr: float = 1e-3
    v_weight_decay: float = 1e-4          # on DST variables (paper Sec. 4)
    batch_size: int = 4
    soft_rate: Sequence[float] = HANDCRAFTED_SOFT_RATE
    dst: bool = True                      # dequantization scale tuning
    par: bool = True                      # progressive adaptive rounding
    use_inf_freeze: bool = False          # paper's memory-light hardening
    seed: int = 0
    engine: str = "device"     # only "device" is ported
    # keep Adam moments across PAR iterations (the surviving soft variables
    # continue from warm state instead of cold restarts after every harden)
    carry_opt_state: bool = True


def _leaf_state(w, meta, qcfg: QuantConfig):
    """Per-linear PAR/DST state.  Weights are taken in the transformed domain
    when AWQ's act_scale is present (the rounding of W*act_scale is what is
    optimized)."""
    scale = meta["scale"].to(torch.float32).contiguous()
    zero = meta["zero"].to(torch.float32).contiguous()
    act_scale = meta.get("act_scale")
    with torch.no_grad():
        wf = w.to(torch.float32)
        if act_scale is not None:
            wf = wf * act_scale[..., :, None]
        g = resolve_group(wf.shape[-2], qcfg.group_size)
        wg = wf.reshape(tuple(wf.shape[:-2])
                        + (wf.shape[-2] // g, g, wf.shape[-1]))
        ratio = wg / scale[..., None, :]
        base = torch.floor(ratio)
        frac = torch.clamp(ratio - base, 1e-4, 1 - 1e-4)
        nu = torch.log(frac) - torch.log1p(-frac)            # logit
    return {
        "nu": nu.to(torch.float32).contiguous(),             # grouped layout
        "v": torch.zeros_like(scale),
        "hard": torch.zeros(nu.shape, dtype=torch.int8,
                            device=nu.device),               # 0 soft, +-1 frozen
        "base": base.contiguous(),
        "scale": scale,
        "zero": zero,
        "act_scale": act_scale,
    }


def _wshape(nu):
    """Grouped (..., ng, g, out) -> flat (..., ng*g, out) weight shape."""
    return tuple(nu.shape[:-3]) + (nu.shape[-3] * nu.shape[-2], nu.shape[-1])


def soft_weight(st, qcfg: QuantConfig, dst: bool) -> torch.Tensor:
    """Differentiable effective weight theta_hat (Eq. 4 + Eq. 9), (..., in,
    out) f32.  θ̂ in the grouped layout comes from the soft_round kernels
    under ``"pallas"`` (``SoftRound``) and from plain torch under ``"xla"``.
    Leading dims (experts) fold into the group dim, (E*ng, g, out) with
    v/scale/zero (E*ng, out): groups are independent, so one launch covers
    an expert stack.  Under ``"pallas"`` AWQ's act_scale division is folded
    into both launches (the stack's experts share the vector); under
    ``"xla"`` it follows the plain function, as in the reference."""
    g, n = st["nu"].shape[-2:]
    act = st["act_scale"]
    args = [st["base"].reshape(-1, g, n), st["nu"].reshape(-1, g, n),
            st["hard"].reshape(-1, g, n)] + [
        st[k].reshape(-1, n) for k in ("v", "scale", "zero")]
    if resolve_backend(qcfg.kernel_backend) == "pallas":
        return SoftRound.apply(*args, qcfg.qmax, dst,
                               None if act is None else act.reshape(-1)
                               ).reshape(_wshape(st["nu"]))
    w = soft_round_plain(*args, qmax=qcfg.qmax, dst=dst).reshape(
        _wshape(st["nu"]))
    if act is not None:
        w = w / act[..., :, None]
    return w


def hardness_score(nu: torch.Tensor) -> torch.Tensor:
    return torch.abs(torch.sigmoid(nu) - 0.5)          # HS (Eq. 6)


# ---------------------------------------------------------------------------
# inner-loop plumbing
# ---------------------------------------------------------------------------

def _trainables(states, dst: bool):
    t = {p: {"nu": st["nu"]} for p, st in states.items()}
    if dst:
        for p, tp in t.items():
            tp["v"] = states[p]["v"]
    return t


def _merge(states, tr, dst: bool):
    out = {}
    for p, st in states.items():
        st = dict(st)
        st["nu"] = tr[p]["nu"]
        if dst:
            st["v"] = tr[p]["v"]
        out[p] = st
    return out


def _make_loss_fn(apply: Callable, qcfg: QuantConfig,
                  tcfg: TesseraQConfig) -> RE.Objective:
    """The block objective, split for the engine: ``prepare(tr, frozen)``
    materializes every linear's θ̂ (and passes the DST variables through
    for the weight decay) once per step; ``lane_loss`` is one sample's
    ``mean((block(θ̂, x) - y)^2)`` plus the v weight decay, the reference's
    per-lane loss.  ``frozen = {"bp": block_params, "sts": states}`` with
    the trainable entries stripped from ``sts``; ``tr`` entries win."""
    wd = tcfg.v_weight_decay if tcfg.dst else 0.0

    def prepare(tr, frozen):
        inter = {}
        for p, fst in frozen["sts"].items():
            st = {**fst, **tr[p]}
            inter[("w",) + p] = soft_weight(st, qcfg, tcfg.dst)
            if wd:
                inter[("v",) + p] = tr[p]["v"]
        return inter

    def lane_loss(inter, frozen, x1, y1):
        loss = RE.block_mse(apply, frozen["bp"],
                            {p: inter[("w",) + p] for p in frozen["sts"]},
                            x1, y1)
        if wd:
            loss = loss + wd * sum(torch.sum(torch.square(inter[("v",) + p]))
                                   for p in frozen["sts"])
        return loss

    return RE.Objective(prepare, lane_loss)


def _schedule_index(k: int, K: int, n_rates: int) -> int:
    """Stretch the soft-rate schedule over K iterations anchored at BOTH
    ends: the first harden freezes only 1-sr[0] (~10%, paper's gentle start)
    and the last always reaches the schedule's final rate (0.0 soft)."""
    return (int(round(k * (n_rates - 1) / max(K - 1, 1)))
            if K > 1 else n_rates - 1)


def _log_stats(lv, hard):
    """Per-iteration log payload: [last loss, global soft rate] in one
    device tensor, so the host pulls it with ONE blocking read."""
    soft = sum(torch.sum((h == 0).to(torch.float32)) for h in hard.values())
    total = sum(h.numel() for h in hard.values())
    return torch.stack([lv.to(torch.float32), soft / max(total, 1)])


def _run_device(apply, bp, X, Y, qcfg, tcfg: TesseraQConfig, states,
                log: Optional[list], cache: Optional[dict] = None):
    """Device engine: hardening on the device, T steps per PAR iteration
    with no host read, pre-staged batches.  The only blocking host read per
    iteration is the optional log line (loss + realized soft rate in one
    transfer)."""
    K = tcfg.par_iterations if tcfg.par else 1
    T = tcfg.steps_per_iteration
    trainable_keys = ("nu", "v") if tcfg.dst else ("nu",)
    eng = RE.cached_engine(cache, "device", lambda: (
        RE.ReconstructionEngine(_make_loss_fn(apply, qcfg, tcfg),
                                AdamW(lr=tcfg.lr))))
    plan = RE.stage_plan(X, Y, batch_size=tcfg.batch_size,
                         total_steps=K * T, seed=tcfg.seed)

    sr = list(tcfg.soft_rate)
    opt_state = None
    for k in range(K):
        if tcfg.par:
            states = RE.harden_device(
                states, sr[_schedule_index(k, K, len(sr))],
                tcfg.use_inf_freeze)
        tr = _trainables(states, tcfg.dst)
        # strip trainable entries from the side state: tr owns those
        frozen = {p: {kk: vv for kk, vv in st.items()
                      if kk not in trainable_keys}
                  for p, st in states.items()}
        if opt_state is None or not tcfg.carry_opt_state:
            opt_state = eng.init(tr)
        tr, opt_state, lv = eng.run(tr, opt_state, {"bp": bp, "sts": frozen},
                                    plan, start=k * T, steps=T)
        states = _merge(states, tr, tcfg.dst)
        if log is not None and lv is not None:
            hard = {p: st["hard"] for p, st in states.items()}
            stats = RE.host_read(_log_stats(lv, hard))
            log.append({"iter": k, "loss": float(stats[0]),
                        "soft_rate": float(stats[1])})
    return states


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def reconstruct_block(apply: Callable, bp, X: torch.Tensor, Y: torch.Tensor,
                      aux, qmeta: Dict, qcfg: QuantConfig,
                      tcfg: TesseraQConfig, log: Optional[list] = None,
                      cache: Optional[dict] = None):
    """Run TesseraQ on one block.

    X: (N, S, d) inputs; Y: (N, S, d) FP outputs, both on the block's
    device; ``aux`` (the reference's per-sample extra stream) must be None
    for the dense and MoE families.  Returns (bp_fq, qmeta') with
    DST folded into each linear's ``scale`` and the final hardened mask
    under ``hard``.  ``cache`` (a dict the caller scopes to one stage)
    reuses the engine across the stage's blocks."""
    if aux is not None:
        raise NotImplementedError(
            "reconstruct_block: per-sample aux streams are not ported yet "
            "(they arrive with the families that use them, ROADMAP queue 1, "
            "'Remaining families')")
    RE.check_engine(tcfg.engine, "reconstruct_block")
    paths = quant_leaf_paths(bp)
    states = {p: _leaf_state(get_path(bp, p), qmeta[p], qcfg) for p in paths}
    states = _run_device(apply, bp, X, Y, qcfg, tcfg, states, log, cache)

    # ---- finalization: hard-round everything, fold DST into the scale ----
    new_meta = {}
    with torch.no_grad():
        for p in paths:
            st = states[p]
            hard = st["hard"]
            alpha = torch.where(hard != 0, hard > 0,
                                st["nu"] > 0).to(torch.float32)
            zero = st["zero"][..., None, :]
            q = torch.clamp(st["base"] + zero + alpha, 0, qcfg.qmax)
            dst_factor = (2.0 * torch.sigmoid(st["v"])) if tcfg.dst else None
            scale_eff = (st["scale"] * dst_factor if dst_factor is not None
                         else st["scale"])
            w = ((q - zero) * scale_eff[..., None, :]).reshape(
                _wshape(st["nu"]))
            if st["act_scale"] is not None:
                w = w / st["act_scale"][..., :, None]
            orig = get_path(bp, p)
            bp = set_path(bp, p, w.to(orig.dtype))
            new_meta[p] = {
                "scale": scale_eff,                       # DST folded in
                "zero": st["zero"],
                "act_scale": st["act_scale"],
                "dst": dst_factor,
                "codes": q.to(torch.uint8).reshape(_wshape(st["nu"])),
                "hard": hard,                             # grouped layout
            }
    return bp, new_meta


def flip_stats(qmeta_before: Dict, qmeta_after: Dict) -> Dict:
    """Paper Table 7: fraction of rounding decisions that flipped vs the
    initialization's codes."""
    out = {}
    for p in qmeta_after:
        if "codes" not in qmeta_after[p] or "codes" not in qmeta_before[p]:
            continue
        a = qmeta_before[p]["codes"]
        b = qmeta_after[p]["codes"].to(a.device)
        flipped = int((a != b).sum())
        out[p] = {"flipped": flipped, "total": a.numel(),
                  "pct": flipped / max(a.numel(), 1) * 100}
    return out
