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

Three interchangeable inner-loop engines (``TesseraQConfig.engine``), as
in the reference:

  * ``"device"`` (default): the single-device engine of
    ``core/recon_engine.py``: hardening by one device sort, the minibatches
    gathered on the device from a pre-staged index plan, at most one host
    read per PAR iteration (the optional log line).
  * ``"reference"``: the host-loop oracle: NumPy hardening (``harden``),
    every step's minibatch gathered on the host by ``draw_index_plan`` and
    pushed, and the device engine's own step (``canonical_grad`` + AdamW),
    so it gives the device engine's codes, hard masks and folded scales bit
    for bit.
  * ``"legacy"``: the speed baseline: the same host loop with one
    batch-mean gradient (``recon_engine.batch_mean_grad``, not the
    canonical per-sample reduction) and the eager per-leaf AdamW update; it
    tracks the other engines up to f32 rounding (on the CPU codes equal,
    folded scales in the last bits; on a GPU, where the batched and the
    per-sample products round apart, a rare code whose ν ends near 0
    flips).

  * ``"sharded"``: the device engine on a ``launch.mesh.Mesh``
    (``TesseraQConfig.mesh``, default the data mesh over every rank):
    data-parallel over its DP axes and, with a ``model`` axis, ν, v,
    their Adam moments and the frozen state held as the rank's slices by
    the ``launch.sharding.ParamSpec`` contract.  Hardening gathers ν and
    the masks, takes the block's one threshold on every TP peer and keeps
    the rank's slice; the log's soft rate counts each slice's soft
    variables as integers, summed over the model group; the final fold of
    DST into ``qmeta`` reads the gathered whole state.  Masks, codes and
    folded scales equal the device engine's bit for bit on every mesh.

θ̂ is materialized once per step per linear on every engine: under
``QuantConfig.kernel_backend == "pallas"`` through the soft_round kernels
(forward and backward; their plain versions on a CPU tensor), under
``"xla"`` as plain torch differentiated by autograd, as the reference does
in jnp.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import recon_engine as RE
from repro_torch.core.blocks import get_path, quant_leaf_paths, set_path
from repro_torch.core.quantizer import resolve_group
from repro_torch.kernels.soft_round import SoftRound, soft_round_plain
from repro_torch.launch.mesh import tp_size
from repro_torch.launch.sharding import ParamSpec, shard_tree, unshard_tree
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
    engine: str = "device"   # "device" | "reference" | "legacy" | "sharded"
    # keep Adam moments across PAR iterations (the surviving soft variables
    # continue from warm state instead of cold restarts after every harden)
    carry_opt_state: bool = True
    # the launch.mesh.Mesh of engine="sharded" (None: the data mesh over
    # every rank of the process group)
    mesh: Any = None


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


def harden(states: Dict, target_soft_rate: float, use_inf: bool) -> Dict:
    """NumPy hardening (the host-loop engines'): freeze the HIGHEST-HS soft
    variables (those already nearly binary, so rounding them perturbs the
    block least) so that only ``target_soft_rate`` of ALL rounding
    variables of the block stay soft.  The threshold is global across the
    block's leaves (Algorithm 1's joint sort): the k-th largest soft score,
    taken by ``np.partition`` over every leaf's soft scores.  The scores
    are computed where ν lives and read back (counted), so the threshold is
    the one ``recon_engine.harden_device`` takes from its device sort."""
    reads = {}
    for p, st in states.items():
        # reprolint: ok[host-sync] — NumPy hardening reads the scores and masks by design (counted)
        reads[p] = (RE.host_read(hardness_score(st["nu"])),
                    RE.host_read(st["hard"]))
    all_scores = np.concatenate([hs.ravel()[hard.ravel() == 0]
                                 for hs, hard in reads.values()])
    total = sum(hard.size for _, hard in reads.values())
    want_soft = int(total * target_soft_rate)
    n_soft_now = all_scores.size
    n_to_freeze = max(0, n_soft_now - want_soft)
    if n_to_freeze == 0:
        return states
    # k-th largest soft score == ascending-partition index want_soft
    thresh = (np.partition(all_scores, want_soft)[want_soft]
              if n_to_freeze < n_soft_now else -np.inf)

    new = {}
    for p, st in states.items():
        hs, hard = reads[p]
        freeze = (hard == 0) & (hs >= thresh)
        # the sign of ν, read as int8 (a quarter of ν's bytes)
        sign = RE.host_read((st["nu"] > 0).to(torch.int8) * 2 - 1)
        hard = np.where(freeze, sign, hard)
        dev = st["hard"].device
        st = dict(st)
        st["hard"] = RE.host_push(hard, dev)
        if use_inf:
            nu = RE.host_read(st["nu"])
            st["nu"] = RE.host_push(
                np.where(hard != 0, hard * 40.0, nu).astype(np.float32), dev)
        new[p] = st
    return new


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

    def lane_loss(inter, frozen, x1, y1, a1):
        loss = RE.block_mse(apply, frozen["bp"],
                            {p: inter[("w",) + p] for p in frozen["sts"]},
                            x1, y1, a1)
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


def _soft_count(hard, mesh=None, specs=None):
    """(soft variables of the block as an int64 device tensor, their
    total): counted as integers.  With ``specs`` (the TP placement) each
    rank counts its slices, the slices' counts are gathered over the model
    group and summed, and a leaf that replicates counts once."""
    tp = tp_size(mesh) if specs is not None else 1
    split = whole = 0
    total = 0
    for p, h in hard.items():
        n = torch.sum(h == 0)
        if tp > 1 and specs[p]["hard"] is not None:
            split, total = split + n, total + h.numel() * tp
        else:
            whole, total = whole + n, total + h.numel()
    if tp > 1 and torch.is_tensor(split):
        split = unshard_tree(split.reshape(1), 0, mesh).sum()
    return split + whole, total


def _log_stats(lv, soft, total):
    """Per-iteration log payload: [last loss, global soft rate] in one
    device tensor, so the host pulls it with ONE blocking read."""
    return torch.stack([lv.to(torch.float32),
                        (soft / max(total, 1)).to(torch.float32)])


def _nbytes(tree) -> int:
    """Bytes of every tensor of a tree of dicts, tuples and tensors."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) \
        else 0


def _state_bytes(tr, opt_state, frozen) -> dict:
    """The bytes the engine's loop keeps between steps: the trainables (ν
    and v), their Adam moments, the frozen state (masks, bases, scales,
    zeros, act_scale) and the block's weights; on a TP rank its slices."""
    return {"trainable": _nbytes(tr), "moments": _nbytes(opt_state[1:]),
            "frozen": _nbytes(frozen["sts"]), "block": _nbytes(frozen["bp"])}


def _run_device(apply, bp, X, Y, aux, qcfg, tcfg: TesseraQConfig, states,
                log: Optional[list], cache: Optional[dict] = None, *,
                mesh=None):
    """Device engine: hardening on the device, T steps per PAR iteration
    with no host read, pre-staged batches.  The only blocking host read per
    iteration is the optional log line (loss + realized soft rate in one
    transfer; it also carries the bytes the loop keeps, ``state_bytes``).

    With ``mesh`` it is the sharded engine (``engine="sharded"``), keyed in
    ``cache`` by the mesh: an engine built for one mesh never serves
    another.  On a mesh with a ``model`` axis the states and the block's
    weights are cut to the rank's slices (``ParamSpec``) before the first
    PAR iteration and gathered whole after the last."""
    K = tcfg.par_iterations if tcfg.par else 1
    T = tcfg.steps_per_iteration
    trainable_keys = ("nu", "v") if tcfg.dst else ("nu",)
    pspec = ParamSpec.for_mesh(mesh)
    specs = param_specs = None
    if mesh is not None and pspec.active:
        specs = pspec.state_specs(states)
        param_specs = {
            "tr": {p: {k: specs[p][k] for k in trainable_keys}
                   for p in states},
            "frozen": {"bp": pspec.block_specs(bp),
                       "sts": {p: {k: d for k, d in sp.items()
                                   if k not in trainable_keys}
                               for p, sp in specs.items()}}}
    eng = RE.cached_engine(
        cache, "device" if mesh is None else ("sharded", mesh), lambda: (
            RE.ReconstructionEngine(_make_loss_fn(apply, qcfg, tcfg),
                                    AdamW(lr=tcfg.lr), mesh=mesh,
                                    param_specs=param_specs)))
    plan = RE.stage_plan(X, Y, aux, batch_size=tcfg.batch_size,
                         total_steps=K * T, seed=tcfg.seed, mesh=mesh)
    if not eng.tp:
        specs = None
    else:
        states = shard_tree(states, specs, mesh)
        bp = shard_tree(bp, eng.frozen_specs["bp"], mesh)

    sr = list(tcfg.soft_rate)
    opt_state = None
    for k in range(K):
        if tcfg.par:
            states = RE.harden_device(
                states, sr[_schedule_index(k, K, len(sr))],
                tcfg.use_inf_freeze, mesh=mesh, specs=specs)
        tr = _trainables(states, tcfg.dst)
        # strip trainable entries from the side state: tr owns those
        frozen = {"bp": bp,
                  "sts": {p: {kk: vv for kk, vv in st.items()
                              if kk not in trainable_keys}
                          for p, st in states.items()}}
        if opt_state is None or not tcfg.carry_opt_state:
            opt_state = eng.init(tr)
        tr, opt_state, lv = eng.run(tr, opt_state, frozen, plan,
                                    start=k * T, steps=T)
        states = _merge(states, tr, tcfg.dst)
        if log is not None and lv is not None:
            soft, total = _soft_count({p: st["hard"]
                                       for p, st in states.items()},
                                      mesh, specs)
            stats = RE.host_read(_log_stats(lv, soft, total))
            log.append({"iter": k, "loss": float(stats[0]),
                        "soft_rate": float(stats[1]),
                        "state_bytes": _state_bytes(tr, opt_state, frozen)})
    if specs is not None:
        states = unshard_tree(states, specs, mesh)
    return states


def _run_sharded(apply, bp, X, Y, aux, qcfg, tcfg: TesseraQConfig, states,
                 log: Optional[list], cache: Optional[dict] = None):
    """The mesh-sharded engine: the device engine's loop on ``tcfg.mesh``
    (or the data mesh over every rank).  The DP degree must divide the
    canonical chunk count (``recon_engine.check_chunks``)."""
    return _run_device(apply, bp, X, Y, aux, qcfg, tcfg, states, log, cache,
                       mesh=RE.resolve_mesh(tcfg.mesh, X.device))


def _soft_rate_of(states) -> float:
    """Global fraction of rounding variables still soft (the quantity the
    PAR schedule targets), from one counted read of each mask."""
    hard = [RE.host_read(st["hard"]) for st in states.values()]
    soft = sum(int((h == 0).sum()) for h in hard)
    return soft / max(sum(h.size for h in hard), 1)


def _run_host_loop(bp, X, Y, aux, tcfg: TesseraQConfig, states,
                   log: Optional[list], step: Callable):
    """The host loop both host-loop engines share: NumPy hardening, the
    plan drawn on the host, every step's minibatch gathered on the host and
    pushed, ``step(tr, opt_state, frozen, xb, yb, ab) -> (tr, opt_state,
    loss)``, one log line per PAR iteration."""
    K = tcfg.par_iterations if tcfg.par else 1
    T = tcfg.steps_per_iteration
    trainable_keys = ("nu", "v") if tcfg.dst else ("nu",)
    opt = AdamW(lr=tcfg.lr)
    Xh, Yh, auxh = RE.host_stage(X, Y, aux)
    N = Xh.shape[0]
    plan = RE.draw_index_plan(N, min(tcfg.batch_size, N), K * T, tcfg.seed)
    sr = list(tcfg.soft_rate)
    opt_state = None
    for k in range(K):
        if tcfg.par:
            states = harden(states, sr[_schedule_index(k, K, len(sr))],
                            tcfg.use_inf_freeze)
        tr = _trainables(states, tcfg.dst)
        frozen = {p: {kk: vv for kk, vv in st.items()
                      if kk not in trainable_keys}
                  for p, st in states.items()}
        if opt_state is None or not tcfg.carry_opt_state:
            opt_state = opt.init(tr)
        lv = None
        for t in range(T):
            # reprolint: ok[host-sync] — the per-step host gather is the host-loop engines' design (counted)
            xb, yb, ab = RE.host_batch(Xh, Yh, plan[k * T + t], X.device,
                                       auxh)
            tr, opt_state, lv = step(tr, opt_state,
                                     {"bp": bp, "sts": frozen}, xb, yb, ab)
        states = _merge(states, tr, tcfg.dst)
        if log is not None and lv is not None:
            # reprolint: ok[host-sync] — the log line's reads, as the reference's host loop makes them (counted)
            log.append({"iter": k, "loss": float(RE.host_read(lv)),
                        "soft_rate": _soft_rate_of(states)})
    return states


def _run_reference(apply, bp, X, Y, aux, qcfg, tcfg: TesseraQConfig, states,
                   log: Optional[list], cache: Optional[dict] = None):
    """Host-loop oracle: the device engine's step (``canonical_grad`` with
    the same chunk count, then AdamW) on host-gathered minibatches, after
    NumPy hardening.  The minibatches, the threshold and the step's
    arithmetic are the device engine's, so are its results."""
    eng = RE.cached_engine(cache, "reference", lambda: (
        RE.ReconstructionEngine(_make_loss_fn(apply, qcfg, tcfg),
                                AdamW(lr=tcfg.lr))))
    N = X.shape[0]
    chunks = RE.grad_chunk_count(min(tcfg.batch_size, N), N)

    def step(tr, opt_state, frozen, xb, yb, ab):
        return eng.step(tr, opt_state, frozen, xb, yb, chunks, ab)

    return _run_host_loop(bp, X, Y, aux, tcfg, states, log, step)


def _run_legacy(apply, bp, X, Y, aux, qcfg, tcfg: TesseraQConfig, states,
                log: Optional[list], cache: Optional[dict] = None):
    """The pre-engine loop, kept as the speed baseline: one batch-mean
    gradient a step (``recon_engine.batch_mean_grad``), the eager per-leaf
    AdamW update, host-gathered minibatches, NumPy hardening."""
    obj = RE.cached_engine(cache, "legacy",
                           lambda: _make_loss_fn(apply, qcfg, tcfg))
    opt = AdamW(lr=tcfg.lr)

    def step(tr, opt_state, frozen, xb, yb, ab):
        lv, grads = RE.batch_mean_grad(obj, tr, frozen, xb, yb, ab)
        with torch.no_grad():
            tr, opt_state = opt.update(grads, opt_state, tr)
        return tr, opt_state, lv

    return _run_host_loop(bp, X, Y, aux, tcfg, states, log, step)


_RUNNERS = {"device": _run_device, "reference": _run_reference,
            "legacy": _run_legacy, "sharded": _run_sharded}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def reconstruct_block(apply: Callable, bp, X: torch.Tensor, Y: torch.Tensor,
                      aux, qmeta: Dict, qcfg: QuantConfig,
                      tcfg: TesseraQConfig, log: Optional[list] = None,
                      cache: Optional[dict] = None):
    """Run TesseraQ on one block.

    X: (N, S, d) inputs; Y: (N, S, d) FP outputs, both on the block's
    device; ``aux``: a per-sample extra stream (N, ...) passed beside x to
    ``apply`` (the encoder-decoder's encoder states), or None.  Returns
    (bp_fq, qmeta') with DST folded into each linear's ``scale`` and the
    final hardened mask under ``hard``.  The inner loop runs on the engine
    ``tcfg.engine`` names.  ``cache`` (a dict the caller scopes to one
    stage) reuses the engine across the stage's blocks."""
    RE.check_engine(tcfg.engine, "reconstruct_block")
    paths = quant_leaf_paths(bp)
    states = {p: _leaf_state(get_path(bp, p), qmeta[p], qcfg) for p in paths}
    states = _RUNNERS[tcfg.engine](apply, bp, X, Y, aux, qcfg, tcfg, states,
                                   log, cache)

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
