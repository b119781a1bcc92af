"""Block reconstruction engine (single device) for TesseraQ's Soften phase.

The per-block inner loop is the cost center of reconstruction-style PTQ
(paper Sec. 3.2/3.3, Algorithm 1): hundreds of gradient steps per block.
This module keeps the loop on the device and off the host:

  * **Batch pre-staging**: the calibration streams X / Y are staged on the
    device once per block (``capture.stage_calibration``) and the whole
    minibatch index plan for all K*T steps is drawn up front by
    ``draw_index_plan``, the reference's canonical draw (bit-identical
    numpy draws).  Inside the loop a minibatch is an ``index_select`` on the
    device.

  * **Global-threshold hardening on the device**: the block-wide hardness
    quantile (Algorithm 1's joint sort over every rounding variable of the
    block) comes from one device sort in which frozen variables are +inf
    sentinels, which pins the threshold to index ``want_soft`` of the
    ascending sort and reproduces the reference's tie handling.

  * **Host-sync accounting**: the only blocking device->host read per PAR
    iteration is the optional log line, routed through ``host_read`` so
    tests can count syncs.  The T steps of an iteration never read the host.

  * **Canonical chunked batch gradients**: a minibatch's per-sample lanes
    are grouped into ``C = grad_chunk_count(bs, N)`` contiguous chunks; each
    chunk's lanes are summed in lane order, the chunk partials in chunk
    order, and the sum is divided by the batch size, the reference's
    association.

The objective comes in two parts (:class:`Objective`): ``prepare`` maps the
trainables to differentiable intermediates once per step (TesseraQ: every
linear's θ̂ through the soft_round kernel), and ``lane_loss`` is one
sample's loss given them.  The engine takes each lane's gradient with
respect to the intermediates, reduces those in the canonical order, and
pulls the reduced gradient back through ``prepare`` once: the soft_round
backward kernel runs once per linear per step, not once per lane.  The
gradient is linear in the intermediates' cotangent, so this is the
reference's arithmetic with another association.  The reference's
``vmap`` over lanes has no counterpart: the lanes are a Python loop.

The engine serves every reconstruction method of ``core/``: TesseraQ
(AdamW on ν and the DST variables), OmniQuant's LWC (AdamW on the clipping
logits) and SignRound (``SignSGD`` on the rounding perturbation).

The reference's ``"reference"``/``"legacy"`` host-loop engines and its
mesh-sharded engine are not ported yet (ROADMAP queue 1 item 1 and queue 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.blocks import get_path, set_path
from repro_torch.core.capture import stage_calibration
from repro_torch.optim.adam import tree_leaves, tree_map

# The reference's other engines, each with the ROADMAP item that ports it.
NOT_PORTED_ENGINES = {
    "reference": "ROADMAP queue 1, 'Calibration: AWQ + TesseraQ' (the "
                 "host-loop reference engine)",
    "legacy": "ROADMAP queue 1, 'Calibration: AWQ + TesseraQ' (the "
              "pre-engine legacy loop)",
    "sharded": "ROADMAP queue 7, 'Parallelism on torch.distributed'",
}


def check_engine(engine: str, who: str) -> None:
    """Only ``engine="device"`` runs here: the reference's other engines
    raise ``NotImplementedError`` naming their ROADMAP item, anything else
    ``ValueError``."""
    if engine == "device":
        return
    if engine in NOT_PORTED_ENGINES:
        raise NotImplementedError(
            f"{who}: engine {engine!r} is not ported yet "
            f"({NOT_PORTED_ENGINES[engine]})")
    raise ValueError(f"{who}: unknown engine {engine!r} (expected "
                     "'device')")


# ---------------------------------------------------------------------------
# host-sync accounting
# ---------------------------------------------------------------------------

_SYNC_COUNT = 0


def host_read(x: torch.Tensor) -> np.ndarray:
    """Blocking device->host read, counted.  Every code path that pulls a
    value out of the reconstruction loop goes through here, so tests can
    assert the engine's one-sync-per-iteration contract."""
    global _SYNC_COUNT
    _SYNC_COUNT += 1
    return x.detach().cpu().numpy()


def sync_count() -> int:
    return _SYNC_COUNT


def reset_sync_count() -> None:
    global _SYNC_COUNT
    _SYNC_COUNT = 0


# ---------------------------------------------------------------------------
# global-threshold hardening
# ---------------------------------------------------------------------------

def _hardness_score(nu: torch.Tensor) -> torch.Tensor:
    return torch.abs(torch.sigmoid(nu) - 0.5)          # HS (paper Eq. 6)


def harden_device(states, target_soft_rate: float, use_inf: bool):
    """Freeze the HIGHEST-HS soft variables (those already nearly binary, so
    rounding them perturbs the block least) until only
    ``int(total * target_soft_rate)`` variables remain soft across the WHOLE
    block (joint threshold over all leaves).

    Frozen slots score +inf, so in the ascending sort of every score the
    soft ones occupy [0, n_soft_now) and the threshold the reference takes
    (the k-th largest soft score, k = n_soft_now - want_soft) sits at index
    ``want_soft``; every soft variable with ``hs >= thresh`` freezes, so a
    tie freezes its whole tie class.  When nothing needs freezing that
    index holds a +inf sentinel and the mask is empty.  The sort keeps the
    threshold on the device: no host read.  A full sort rather than
    ``torch.kthvalue``: PyTorch's CUDA kthvalue runs its radix select in
    one thread block per slice (``aten/src/ATen/native/cuda/Sorting.cu``),
    and here the slice is a whole block's ~2e8 scores; the sort's int64
    indices cost 8 bytes per variable, transiently."""
    total = sum(st["hard"].numel() for st in states.values())
    want_soft = int(total * target_soft_rate)
    if want_soft >= total:
        return states                                  # nothing to freeze
    scores = torch.cat([
        torch.where(st["hard"] == 0, _hardness_score(st["nu"]),
                    float("inf")).reshape(-1)
        for st in states.values()])
    thresh = torch.sort(scores).values[want_soft]
    del scores

    new = {}
    for p, st in states.items():
        hs = _hardness_score(st["nu"])
        freeze = (st["hard"] == 0) & (hs >= thresh)
        sign = torch.where(st["nu"] > 0, 1, -1).to(torch.int8)
        hard = torch.where(freeze, sign, st["hard"])
        st = dict(st)
        st["hard"] = hard
        if use_inf:
            st["nu"] = torch.where(hard != 0, hard.to(torch.float32) * 40.0,
                                   st["nu"])
        new[p] = st
    return new


# ---------------------------------------------------------------------------
# optimizers beyond AdamW (the same init / update protocol)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SignSGD:
    """Signed gradient descent with linear lr decay and a clip (SignRound's
    optimizer).  The state is the step counter, an int32 scalar on the
    params' device, so an update never reads the host."""
    lr: float = 5e-3
    total_steps: int = 200
    clip: float = 0.5

    def init(self, params) -> torch.Tensor:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else "cpu"
        return torch.zeros((), dtype=torch.int32, device=dev)

    def update(self, grads, state: torch.Tensor, params):
        """Returns (new params, new state); nothing is updated in place."""
        frac = state.to(torch.float32) / max(self.total_steps, 1)
        cur_lr = self.lr * (1.0 - frac)
        new = tree_map(lambda p, g: torch.clamp(p - cur_lr * torch.sign(g),
                                                -self.clip, self.clip),
                       params, grads)
        return new, state + 1


# ---------------------------------------------------------------------------
# canonical (device-count-invariant) chunked batch gradients
# ---------------------------------------------------------------------------

# The canonical gradient association groups a minibatch's per-sample lanes
# into at most this many contiguous chunks (the reference's constant: it
# keeps the association identical to its mesh-sharded engine's).
CANONICAL_LANE_CHUNKS = 8


def grad_chunk_count(batch_size: int, pool: int) -> int:
    """Number of chunks in the canonical gradient association for a
    ``batch_size`` minibatch drawn from a ``pool``-sample calibration pool:
    it divides the batch (equal chunks) and the pool (the index plan draws
    chunk j from pool shard j), capped at ``CANONICAL_LANE_CHUNKS``."""
    return math.gcd(math.gcd(batch_size, CANONICAL_LANE_CHUNKS), pool)


@dataclasses.dataclass(frozen=True)
class Objective:
    """A block objective split for the engine (see the module docstring).

    ``prepare(tr, frozen) -> {key: tensor}``: the differentiable
    intermediates, computed from the trainables once per step.
    ``lane_loss(inter, frozen, x1, y1) -> scalar``: one sample's loss (the
    inputs carry a leading batch dim of 1)."""
    prepare: Callable
    lane_loss: Callable


def block_mse(apply: Callable, bp, weights, x1, y1) -> torch.Tensor:
    """One sample's ``mean((block(x) - y)^2)`` in f32 with each linear at
    ``weights[path]`` (cast to the leaf's dtype): the reconstruction loss
    every method's ``lane_loss`` takes."""
    for p, w in weights.items():
        bp = set_path(bp, p, w.to(get_path(bp, p).dtype))
    out = apply(bp, x1)
    return torch.mean(torch.square(out.to(torch.float32) - y1))


def block_mse_objective(apply: Callable, prepare: Callable) -> Objective:
    """The :class:`Objective` whose ``prepare`` gives every linear's
    weight by path and whose lane loss is :func:`block_mse` of the block
    ``frozen["bp"]`` (OmniQuant's LWC and SignRound)."""

    def lane_loss(inter, frozen, x1, y1):
        return block_mse(apply, frozen["bp"], inter, x1, y1)

    return Objective(prepare, lane_loss)


def canonical_grad(objective: Objective, tr, frozen, xb, yb, chunks: int):
    """(loss, grads) of the minibatch mean loss with the canonical chunked
    per-sample reduction; ``grads`` mirrors ``tr`` (zeros where a trainable
    does not reach the loss)."""
    bs = xb.shape[0]
    width = bs // chunks
    flat_tr = [t.detach().requires_grad_() for t in tree_leaves(tr)]
    tr_req = _unflatten(tr, iter(flat_tr))
    with torch.enable_grad():
        inter = objective.prepare(tr_req, frozen)
        keys = list(inter)
        leaves = {k: inter[k].detach().requires_grad_() for k in keys}
        inputs = [leaves[k] for k in keys]
        total = loss_tot = None
        for j in range(chunks):
            part = loss_part = None
            for lane in range(j * width, (j + 1) * width):
                sl = slice(lane, lane + 1)
                lv = objective.lane_loss(leaves, frozen, xb[sl], yb[sl])
                gs = torch.autograd.grad(lv, inputs, allow_unused=True)
                gs = [torch.zeros_like(x) if g is None else g
                      for g, x in zip(gs, inputs, strict=True)]
                lv = lv.detach()
                if part is None:
                    part, loss_part = gs, lv
                else:
                    for a, g in zip(part, gs, strict=True):
                        a.add_(g)
                    loss_part = loss_part + lv
            if total is None:
                total, loss_tot = part, loss_part
            else:
                for a, g in zip(total, part, strict=True):
                    a.add_(g)
                loss_tot = loss_tot + loss_part
        cot = [g / bs for g in total]
        g_tr = torch.autograd.grad([inter[k] for k in keys], flat_tr,
                                   grad_outputs=cot, allow_unused=True)
    g_tr = [torch.zeros_like(t) if g is None else g
            for g, t in zip(g_tr, flat_tr, strict=True)]
    return loss_tot / bs, _unflatten(tr, iter(g_tr))


def _unflatten(like, it):
    if isinstance(like, dict):
        return {k: _unflatten(v, it) for k, v in like.items()}
    return next(it)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchPlan:
    """Per-block staged calibration data + the full minibatch index plan
    (drawn once by ``draw_index_plan``, staged on the streams' device)."""
    X: Any
    Y: Any
    index_plan: Any        # (total_steps, bs) int64, on the device
    total_steps: int
    chunks: int = 1


def draw_index_plan(N: int, batch_size: int, total_steps: int,
                    seed: int = 0) -> np.ndarray:
    """The canonical minibatch index plan, drawn exactly as the reference
    draws it: STRATIFIED over the canonical chunk grid (chunk j of each
    step's minibatch draws its ``bs/C`` samples without replacement from
    pool shard j), in one fixed ``default_rng(seed)`` sequence, step-major
    then chunk-major."""
    bs = min(batch_size, N)
    if total_steps <= 0:
        return np.empty((0, bs), np.int32)
    C = grad_chunk_count(bs, N)
    c, Ns = bs // C, N // C
    rng = np.random.default_rng(seed)
    plan = np.stack([
        np.concatenate([j * Ns + rng.choice(Ns, c, replace=False)
                        for j in range(C)])
        for _ in range(total_steps)])
    return plan.astype(np.int32)


def stage_plan(X, Y, *, batch_size: int, total_steps: int,
               seed: int = 0) -> BatchPlan:
    Xd, Yd = stage_calibration(X, Y)
    N = Xd.shape[0]
    bs = min(batch_size, N)
    plan = draw_index_plan(N, bs, total_steps, seed)
    return BatchPlan(Xd, Yd,
                     torch.as_tensor(plan, dtype=torch.long,
                                     device=Xd.device),
                     total_steps, grad_chunk_count(bs, N))


class ReconstructionEngine:
    """The Soften-phase loop over a pre-staged :class:`BatchPlan`.

    ``objective`` is the block reconstruction objective (:class:`Objective`);
    ``frozen`` is arbitrary non-trainable side state (TesseraQ: the block
    params and the hardened masks) handed to it unchanged.  ``optimizer``
    is AdamW or anything with the same ``init`` / ``update`` protocol.  The
    engine holds no per-block data, so one engine serves every block of a
    stage."""

    def __init__(self, objective: Objective, optimizer):
        self.objective = objective
        self.opt = optimizer

    def init(self, trainables):
        return self.opt.init(trainables)

    def run(self, trainables, opt_state, frozen, plan: BatchPlan, *,
            start: int = 0, steps: Optional[int] = None):
        """Execute ``steps`` optimization steps (plan rows [start,
        start+steps)).  Returns (trainables, opt_state, last_loss) with the
        loss still on the device: reading it is the caller's (counted)
        choice."""
        steps = plan.total_steps - start if steps is None else steps
        bs = plan.index_plan.shape[1]
        chunks = grad_chunk_count(bs, plan.X.shape[0])
        if chunks != plan.chunks:
            raise ValueError(
                f"plan was staged for {plan.chunks} canonical gradient "
                f"chunks but the engine now derives {chunks}: "
                "CANONICAL_LANE_CHUNKS changed after stage_plan drew the "
                "stratified index plan; re-stage the plan")
        lv = None
        for t in range(start, start + steps):
            idx = plan.index_plan[t]
            xb = plan.X.index_select(0, idx)
            yb = plan.Y.index_select(0, idx)
            lv, grads = canonical_grad(self.objective, trainables, frozen,
                                       xb, yb, chunks)
            with torch.no_grad():
                trainables, opt_state = self.opt.update(grads, opt_state,
                                                        trainables)
        return trainables, opt_state, lv


def cached_engine(cache: Optional[dict], key: str, make: Callable):
    """The engine under ``key`` in ``cache`` (a dict the caller scopes to
    one stage), made by ``make()`` and kept there on first use."""
    eng = cache.get(key) if cache is not None else None
    if eng is None:
        eng = make()
        if cache is not None:
            cache[key] = eng
    return eng


def run_logged(eng: ReconstructionEngine, tr, opt_state, frozen,
               plan: BatchPlan, *, steps: int, chunk: int,
               log: Optional[list]):
    """``steps`` engine steps from plan row 0.  With ``log``, they run in
    pieces of ``chunk`` and each piece appends ``{"step", "loss"}`` of its
    last step (one host read a piece).  Returns (trainables, opt_state)."""
    chunk = chunk if log is not None else steps
    for t0 in range(0, steps, chunk):
        n = min(chunk, steps - t0)
        tr, opt_state, lv = eng.run(tr, opt_state, frozen, plan, start=t0,
                                    steps=n)
        if log is not None:
            log.append({"step": t0 + n - 1, "loss": float(host_read(lv))})
    return tr, opt_state


__all__ = ["NOT_PORTED_ENGINES", "check_engine", "host_read", "sync_count",
           "reset_sync_count", "harden_device", "SignSGD",
           "grad_chunk_count", "CANONICAL_LANE_CHUNKS", "Objective",
           "block_mse", "block_mse_objective", "canonical_grad",
           "BatchPlan", "draw_index_plan", "stage_plan",
           "ReconstructionEngine", "cached_engine", "run_logged"]
