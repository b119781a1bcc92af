"""Block reconstruction engine (single device) for TesseraQ's Soften phase.

The per-block inner loop is the cost center of reconstruction-style PTQ
(paper Sec. 3.2/3.3, Algorithm 1): hundreds of gradient steps per block.
This module keeps the loop on the device and off the host:

  * **Batch pre-staging**: the calibration streams X / Y (and a per-sample
    ``aux`` stream, the encoder-decoder's encoder states, gathered by the
    same rows) are staged on the device once per block
    (``capture.stage_calibration``) and the whole
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

The reference's two host-loop engines run on the same pieces, on purpose
off the device-resident path: ``"reference"`` (the oracle: NumPy
hardening, a host gather of every step's minibatch, and the device
engine's own step, ``ReconstructionEngine.step``) and ``"legacy"`` (the
speed baseline: the same host loop with one batch-mean gradient,
``batch_mean_grad``, and the eager per-leaf optimizer update).  Their
blocking transfers go through ``host_read``, ``host_stage`` and
``host_push``, which count them.

The mesh-sharded engine (``"sharded"``) is this engine on a
``launch.mesh.Mesh``: one process a rank, each running the loop on its
share.  Its DP share is the rows of each step's minibatch whose canonical
chunks it owns (rank r of D takes plan rows ``[r·bs/D, (r+1)·bs/D)``, which
the stratified plan draws from its own pool shard, staged alone by
``stage_plan(mesh=)``); the chunk partials then fold in an ordered chain
over the data group — each rank continues the running sum with its own
partials in chunk order and hands it on, the last sends the total to every
rank — so the reduction is the device engine's ``add_`` fold, bit for bit,
and every rank applies the same pullback and update (replicated trainables
stay equal with no re-synchronization, as in the reference).  Its TP share
(``param_specs``, from ``launch.sharding.ParamSpec``): the slices of the
trainables and of their optimizer moments it keeps between steps; each
step gathers the whole trainables over the model group, runs ``prepare``
and the lanes on them, and keeps its slice of the gradient; the frozen
side state is held as slices and gathered once a ``run``.  Gathers are
broadcasts of each shard (exact bytes, −0.0 included); the chain is
broadcasts over the data group: gloo runs both on CUDA tensors.  A mesh
axis of extent 1 makes no collective, and ``mesh=None`` is the device
engine itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.blocks import get_path, set_path
from repro_torch.core.capture import stage_calibration
from repro_torch.debug.sanitize import allowed_transfer
from repro_torch.launch.mesh import (dp_axes, dp_size, make_data_mesh,
                                     tp_axis, tp_size)
from repro_torch.launch.sharding import shard_tree, unshard_tree
from repro_torch.optim.adam import tree_leaves, tree_map

# The engines a reconstruction method takes (``engine=``), as the
# reference names them.
ENGINES = ("device", "legacy", "reference", "sharded")


def check_engine(engine: str, who: str) -> None:
    """Refuse an engine the reference does not name (``ValueError``)."""
    if engine not in ENGINES:
        raise ValueError(f"{who}: unknown engine {engine!r} (expected one "
                         f"of {list(ENGINES)})")


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
    with allowed_transfer():
        return x.detach().cpu().numpy()


def host_stage(X: torch.Tensor, Y: torch.Tensor, aux=None):
    """A block's calibration streams copied to the host once, for the
    host-loop engines: (X, Y as float32, aux or None), CPU tensors (numpy
    has no bfloat16).  One counted read each."""
    global _SYNC_COUNT
    _SYNC_COUNT += 2 + (aux is not None)
    with allowed_transfer():
        return (X.detach().cpu(), Y.detach().to(torch.float32).cpu(),
                aux.detach().cpu() if aux is not None else None)


def host_push(a, device) -> torch.Tensor:
    """Host array or CPU tensor -> ``device``, counted: a copy from
    pageable memory waits for the stream, so it is a host sync too (on the
    CPU nothing moves, and the count is the same)."""
    global _SYNC_COUNT
    _SYNC_COUNT += 1
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    with allowed_transfer():
        return t.to(device)


def host_batch(Xh: torch.Tensor, Yh: torch.Tensor, idx: np.ndarray, device,
               auxh=None):
    """One step's minibatch (xb, yb, aux rows or None) of the host-loop
    engines: gathered on the host by the plan row ``idx`` and pushed to
    ``device`` (a counted push each)."""
    i = torch.from_numpy(np.asarray(idx, np.int64))
    return (host_push(Xh[i], device), host_push(Yh[i], device),
            host_push(auxh[i], device) if auxh is not None else None)


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


def harden_device(states, target_soft_rate: float, use_inf: bool, *,
                  mesh=None, specs=None):
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
    indices cost 8 bytes per variable, transiently.

    With ``mesh`` and ``specs`` (each leaf's ``{key: split dim}``, the
    sharded engine's TP placement) the states hold the rank's slices:
    ν and the masks are gathered over the model group, every TP peer
    takes the same threshold of the whole block, and keeps its slice of
    the new mask (and of ν under ``use_inf``)."""
    if mesh is not None and specs is not None and tp_size(mesh) > 1:
        keys = ("nu", "hard")
        full = {p: {**st, **{k: unshard_tree(st[k], specs[p][k], mesh)
                             for k in keys}}
                for p, st in states.items()}
        full = harden_device(full, target_soft_rate, use_inf)
        return {p: {**st, **{k: shard_tree(full[p][k], specs[p][k], mesh)
                             for k in keys}}
                for p, st in states.items()}
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
# mesh plumbing for the sharded engine
# ---------------------------------------------------------------------------

def resolve_mesh(mesh=None, device="cuda"):
    """The mesh of ``engine="sharded"``: the caller's, or the 1-D data
    mesh over every rank of the process group (one rank without one) on
    ``device`` (the callers pass their streams' device)."""
    return mesh if mesh is not None else make_data_mesh(device=device)


def _flat_views(flat: torch.Tensor, like):
    """Views of ``flat`` shaped as the tensors of ``like``, and its last
    element (the loss) as a 0-dim view."""
    out, o = [], 0
    for t in like:
        out.append(flat[o:o + t.numel()].view(t.shape))
        o += t.numel()
    return out, flat[o]


def _chain_receive(mesh, like):
    """The running sum of the chunk partials handed on by the previous
    rank of the data group (views shaped as ``like``, and the loss sum),
    or (None, None) on its first rank.  Every rank joins every hop of the
    chain in order: the hops of ranks before the previous one arrive into
    the same buffer and are overwritten."""
    r = mesh.data_rank
    if r == 0:
        return None, None
    buf = torch.empty(sum(t.numel() for t in like) + 1,
                      dtype=like[0].dtype, device=like[0].device)
    for src in mesh.data_ranks[:r]:
        dist.broadcast(buf, src, group=mesh.data_group)
    return _flat_views(buf, like)


def _chain_send(mesh, total, loss):
    """Hand the rank's running sum (``total`` and the loss sum, one flat
    buffer) on to the rest of the data group, then take the later ranks'
    hops; the last rank's is the total, which every rank returns."""
    flat = torch.cat([t.reshape(-1) for t in total] + [loss.reshape(1)])
    for src in mesh.data_ranks[mesh.data_rank:]:
        dist.broadcast(flat, src, group=mesh.data_group)
    return _flat_views(flat, total)


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
    ``lane_loss(inter, frozen, x1, y1, a1) -> scalar``: one sample's loss
    (the inputs carry a leading batch dim of 1; ``a1`` is the sample's aux
    row, or None)."""
    prepare: Callable
    lane_loss: Callable


def block_mse(apply: Callable, bp, weights, x1, y1, a1=None) -> torch.Tensor:
    """One sample's ``mean((block(x, aux) - y)^2)`` in f32 with each linear
    at ``weights[path]`` (cast to the leaf's dtype): the reconstruction
    loss every method's ``lane_loss`` takes."""
    for p, w in weights.items():
        bp = set_path(bp, p, w.to(get_path(bp, p).dtype))
    out = apply(bp, x1, a1)
    return torch.mean(torch.square(out.to(torch.float32) - y1))


def block_mse_objective(apply: Callable, prepare: Callable) -> Objective:
    """The :class:`Objective` whose ``prepare`` gives every linear's
    weight by path and whose lane loss is :func:`block_mse` of the block
    ``frozen["bp"]`` (OmniQuant's LWC and SignRound)."""

    def lane_loss(inter, frozen, x1, y1, a1):
        return block_mse(apply, frozen["bp"], inter, x1, y1, a1)

    return Objective(prepare, lane_loss)


def canonical_grad(objective: Objective, tr, frozen, xb, yb, chunks: int,
                   ab=None, *, mesh=None, batch_size: Optional[int] = None):
    """(loss, grads) of the minibatch mean loss with the canonical chunked
    per-sample reduction; ``grads`` mirrors ``tr`` (zeros where a trainable
    does not reach the loss).  ``ab``: the minibatch's aux rows, or None.

    With ``mesh`` (a data-parallel degree above 1) ``xb`` holds the rank's
    ``chunks`` chunks of a ``batch_size``-row minibatch, and the partials
    fold in the ordered chain over the data group (``_chain_receive`` /
    ``_chain_send``): every rank returns the whole minibatch's loss and
    gradient, the device engine's bits."""
    chain = mesh is not None and dp_size(mesh) > 1
    bs = xb.shape[0] if batch_size is None else batch_size
    width = xb.shape[0] // chunks
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
                lv = objective.lane_loss(leaves, frozen, xb[sl], yb[sl],
                                         ab[sl] if ab is not None else None)
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
            if total is None and chain:
                total, loss_tot = _chain_receive(mesh, part)
            if total is None:
                total, loss_tot = part, loss_part
            else:
                for a, g in zip(total, part, strict=True):
                    a.add_(g)
                loss_tot = loss_tot + loss_part
        if chain:
            total, loss_tot = _chain_send(mesh, total, loss_tot)
        cot = [g / bs for g in total]
        g_tr = torch.autograd.grad([inter[k] for k in keys], flat_tr,
                                   grad_outputs=cot, allow_unused=True)
    g_tr = [torch.zeros_like(t) if g is None else g
            for g, t in zip(g_tr, flat_tr, strict=True)]
    return loss_tot / bs, _unflatten(tr, iter(g_tr))


def batch_mean_grad(objective: Objective, tr, frozen, xb, yb, ab=None):
    """(loss, grads) of the whole minibatch's loss in one backward: the
    objective's ``lane_loss`` over all of ``xb`` at once (``block_mse``
    means over every sample, so this is the batch mean), differentiated
    through ``prepare`` by ``torch.autograd.grad``.  The host-loop
    ``"legacy"`` engine's gradient (and OmniQuant's and SignRound's): the
    reference's plain ``value_and_grad``, with one association of the batch
    sum and not ``canonical_grad``'s, so it tracks the canonical gradient
    only up to f32 rounding."""
    flat_tr = [t.detach().requires_grad_() for t in tree_leaves(tr)]
    tr_req = _unflatten(tr, iter(flat_tr))
    with torch.enable_grad():
        inter = objective.prepare(tr_req, frozen)
        loss = objective.lane_loss(inter, frozen, xb, yb, ab)
        g_tr = torch.autograd.grad(loss, flat_tr, allow_unused=True)
    g_tr = [torch.zeros_like(t) if g is None else g
            for g, t in zip(g_tr, flat_tr, strict=True)]
    return loss.detach(), _unflatten(tr, iter(g_tr))


def _unflatten(like, it):
    if isinstance(like, dict):
        return {k: _unflatten(v, it) for k, v in like.items()}
    return next(it)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchPlan:
    """Per-block staged calibration data (X, Y and the per-sample ``aux``
    stream or None) + the full minibatch index plan (drawn once by
    ``draw_index_plan``, staged on the streams' device).  On a mesh the
    streams are the rank's pool shard and ``pool`` the whole pool's size;
    the plan is the whole one on every rank."""
    X: Any
    Y: Any
    index_plan: Any        # (total_steps, bs) int64, on the device
    total_steps: int
    chunks: int = 1
    aux: Any = None
    pool: Optional[int] = None

    @property
    def pool_size(self) -> int:
        return self.X.shape[0] if self.pool is None else self.pool


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


def check_chunks(chunks: int, dp: int, batch_size: int, pool: int) -> None:
    """The sharded engine's condition on the canonical chunk grid: the DP
    degree must divide the chunk count, so that each rank owns whole
    chunks (the reference's message)."""
    if chunks % dp:
        raise ValueError(
            f"canonical gradient chunk count {chunks} (minibatch "
            f"{batch_size}, pool {pool}, cap {CANONICAL_LANE_CHUNKS}) does "
            f"not divide by the mesh's data-parallel degree {dp}; pick a "
            "batch_size and calibration pool that are multiples of it (or "
            "shrink the mesh).  For a DP degree that does not divide "
            f"{CANONICAL_LANE_CHUNKS} (e.g. 6- or 16-way), set "
            "recon_engine.CANONICAL_LANE_CHUNKS to a multiple of it before "
            "building engines — note this changes the canonical rounding "
            "trajectory for batches wider than the cap")


def stage_plan(X, Y, aux=None, *, batch_size: int, total_steps: int,
               seed: int = 0, mesh=None) -> BatchPlan:
    """Stage a block's streams and draw its whole plan.  With ``mesh``
    only the rank's pool shard is staged (``capture.stage_calibration``);
    the plan stays a pure function of (N, bs, steps, seed), so every rank
    draws the same one."""
    N = X.shape[0]
    bs = min(batch_size, N)
    chunks = grad_chunk_count(bs, N)
    if mesh is not None:
        check_chunks(chunks, dp_size(mesh), bs, N)
    Xd, Yd, auxd = stage_calibration(X, Y, aux, mesh=mesh)
    plan = draw_index_plan(N, bs, total_steps, seed)
    return BatchPlan(Xd, Yd,
                     torch.as_tensor(plan, dtype=torch.long,
                                     device=Xd.device),
                     total_steps, chunks, auxd, N)


class ReconstructionEngine:
    """The Soften-phase loop over a pre-staged :class:`BatchPlan`.

    ``objective`` is the block reconstruction objective (:class:`Objective`);
    ``frozen`` is arbitrary non-trainable side state (TesseraQ: the block
    params and the hardened masks) handed to it unchanged.  ``optimizer``
    is AdamW or anything with the same ``init`` / ``update`` protocol.  The
    engine holds no per-block data, so one engine serves every block of a
    stage.

    With ``mesh`` (a ``launch.mesh.Mesh``) it is the sharded engine (see
    the module docstring): the plan's streams are the rank's pool shard,
    and each step takes the rank's rows of the plan row and folds the
    chunk partials in the chain over the data group.  ``param_specs``
    (``{"tr": spec tree of the trainables, "frozen": spec tree of the
    frozen state}``, split dims from ``launch.sharding.ParamSpec``) turns
    on the TP share on a mesh with a ``model`` axis: trainables, their
    optimizer moments and the frozen state enter and leave as the rank's
    slices (``launch.sharding.shard_tree``)."""

    def __init__(self, objective: Objective, optimizer, mesh=None,
                 param_specs=None):
        self.objective = objective
        self.opt = optimizer
        self.mesh = mesh
        self.dp_degree = 1 if mesh is None else dp_size(mesh)
        if mesh is not None and not dp_axes(mesh):
            raise ValueError(f"mesh {mesh.axis_names} has no "
                             "data-parallel axes ('pod'/'data')")
        tp = (mesh is not None and param_specs is not None
              and tp_axis(mesh) is not None)
        self.tr_specs = param_specs["tr"] if tp else None
        self.frozen_specs = param_specs["frozen"] if tp else None

    @property
    def tp(self) -> bool:
        """Whether the trainables, moments and frozen state are slices."""
        return self.tr_specs is not None

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
        chunks = grad_chunk_count(bs, plan.pool_size)
        if chunks != plan.chunks:
            raise ValueError(
                f"plan was staged for {plan.chunks} canonical gradient "
                f"chunks but the engine now derives {chunks}: "
                "CANONICAL_LANE_CHUNKS changed after stage_plan drew the "
                "stratified index plan; re-stage the plan")
        D = self.dp_degree
        check_chunks(chunks, D, bs, plan.pool_size)
        # the rank's rows of every plan row, rebased to its pool shard
        r = 0 if self.mesh is None else self.mesh.data_rank
        rows = plan.index_plan[start:start + steps,
                               r * bs // D:(r + 1) * bs // D]
        if r:
            rows = rows - r * plan.pool_size // D
        if self.tp:
            frozen = unshard_tree(frozen, self.frozen_specs, self.mesh)
        lv = None
        for idx in rows:
            xb = plan.X.index_select(0, idx)
            yb = plan.Y.index_select(0, idx)
            ab = (plan.aux.index_select(0, idx) if plan.aux is not None
                  else None)
            whole = (unshard_tree(trainables, self.tr_specs, self.mesh)
                     if self.tp else trainables)
            lv, grads = canonical_grad(self.objective, whole, frozen, xb,
                                       yb, chunks // D, ab, mesh=self.mesh,
                                       batch_size=bs)
            del whole
            if self.tp:
                grads = shard_tree(grads, self.tr_specs, self.mesh)
            with torch.no_grad():
                trainables, opt_state = self.opt.update(grads, opt_state,
                                                        trainables)
        return trainables, opt_state, lv

    def step(self, trainables, opt_state, frozen, xb, yb, chunks: int,
             ab=None):
        """One step on the minibatch (xb, yb, aux rows ``ab`` or None): the
        canonical chunked gradient, then the optimizer: a step of ``run``
        without a mesh, on the host-gathered minibatches of the host-loop
        ``"reference"`` engine.  Returns (trainables, opt_state, loss)."""
        lv, grads = canonical_grad(self.objective, trainables, frozen,
                                   xb, yb, chunks, ab)
        with torch.no_grad():
            trainables, opt_state = self.opt.update(grads, opt_state,
                                                    trainables)
        return trainables, opt_state, lv


def cached_engine(cache: Optional[dict], key, make: Callable):
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


__all__ = ["ENGINES", "check_engine", "resolve_mesh",
           "check_chunks", "host_read", "host_stage", "host_push",
           "host_batch",
           "sync_count", "reset_sync_count", "harden_device", "SignSGD",
           "grad_chunk_count", "CANONICAL_LANE_CHUNKS", "Objective",
           "block_mse", "block_mse_objective", "canonical_grad",
           "batch_mean_grad",
           "BatchPlan", "draw_index_plan", "stage_plan",
           "ReconstructionEngine", "cached_engine", "run_logged"]
