"""Token-choice top-k MoE FFN with capacity-based dispatch (the reference's
``models/moe.py``: its single-shard and its inner expert-parallel paths).

Each token picks its top-k experts from an f32 router; every (token,
choice) pair takes the next free row of its expert's capacity buffer in
token-major order, pairs past an expert's capacity are dropped, and the
experts run as one batched (E, C, d) x (E, d, f) product per projection
(``layers.expert_matmul``: the expert-batched kernel under ``"pallas"``).
Dispatch and combine are fixed-shape tensor ops on the device (a one-hot
cumsum, a scatter into ``E*C + 1`` rows whose last row takes the dropped
pairs, a gather back): no boolean indexing or ``nonzero``, so a decode step
never waits on the host.  The dispatch also hands each expert's count of
routed pairs (the cumsum's last row, no extra launch) to the expert
kernel, which clamps it to the capacity, reads no weight of an expert with
no row and writes +0 past each count; the capacity buffer is zero there,
so that is the product the reference computes (for finite weights), and
the combine never reads those rows.  Inactive decode slots route and take capacity
like live ones, as in the reference (determinism, not alone-parity).

Under serve-time tensor parallelism (``ctx.ep_inner``, the reference's
inner expert parallelism) each rank of the model group holds a contiguous
slice of the experts: it routes over the global expert ids as above (the
capacity keeps its single-device value), dispatches only the pairs routed
to its local experts, runs the expert kernel over them, and one all-reduce
over the group sums the ranks' outputs.

On a mesh (``ctx.mesh``: training and evaluation, each rank holding its
own rows of the batch) there are two more paths, each computing what the
reference's mesh computes:

* ``ctx.ep_axis`` set (the MoE family on a ``model`` axis of more than one
  rank): the rank routes its own rows, with the capacity of its data
  shard's tokens (the reference's ``B*S // dp_degree``), computes its
  contiguous ``E / tp`` experts and sums them over the model group
  through ``layers.leave`` (the train step's ``ctx.tp``, whose split
  names the experts wherever ``ep_axis`` is set, or a split of the
  experts alone): an all-reduce, whose gradient is the cotangent itself,
  the inputs' summed over the group (``layers.copy_to_group``), as
  psum's transpose under the reference's ``shard_map`` gives.  In the
  mesh train step the rows come in whole on every rank (with the
  residual rows split, gathered by ``layers.enter``), so the capacity
  and the drops are the same; with the rows split the sum is a
  reduce-scatter onto the rank's rows.
* ``ctx.ep_axis`` None with data parallelism: the reference is one program
  over the global batch, so the capacity comes from the global token
  count and a pair's queue position from a cumsum over the global token
  order.  Each rank's rows are a contiguous block of that order, so the
  rank offsets its positions per expert by the pairs the lower data ranks
  routed there (one all-reduce of E int32 counts a layer over the data
  group) and keeps and drops exactly as the global cumsum does; the
  combine stays local.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import QTensor
from repro_torch.launch.mesh import dp_size
from repro_torch.models import layers as L
from repro_torch.models.common import Ctx


def init_moe_ffn(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                 dtype, device) -> dict:
    """Stacked (L, ...) router (f32) and expert weights (E, in, out)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

    def w(shape, fan_in, dt):
        t = torch.randn((n_layers,) + shape, generator=gen,
                        dtype=torch.float32, device=device)
        return (t * fan_in ** -0.5).to(dt)

    return {
        "router": w((d, e), d, torch.float32),
        "w_gate": w((e, d, f), d, dtype),
        "w_up": w((e, d, f), d, dtype),
        "w_down": w((e, f, d), f, dtype),
    }


def _route(x2d: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Returns (expert_idx (T, k) int64, gate (T, k) f32): the top-k router
    logits in descending order, softmax-normalized over the chosen k."""
    logits = x2d.float() @ router_w.float()
    gate, idx = torch.topk(logits, top_k, dim=-1, sorted=True)
    return idx, torch.softmax(gate, dim=-1)


def _capacity(tokens: int, num_experts: int, top_k: int, cf: float) -> int:
    c = int(math.ceil(tokens * top_k / num_experts * cf))
    return max(8, -(-c // 8) * 8)                     # round up to 8


def _dispatch(idx: torch.Tensor, num_experts: int, capacity: int,
              e_start: int = 0, e_local=None, offset=None):
    """(keep (T*k,) bool, slot (T*k,) int64, rows (E_l,) int32) for the flat
    token-major list of (token, choice) pairs over the local experts
    ``[e_start, e_start + e_local)`` (default: all ``num_experts``): a
    pair takes the next free row of its expert's queue (a cumsum over the
    one-hot expert column), ``slot`` is its row in the ``E_l*C + 1``-row
    buffer, the last row for a pair past its expert's capacity or routed
    to another rank's expert, and ``rows`` each local expert's routed pairs
    (the cumsum's last row, a view; the expert kernel clamps it to the
    capacity, so its kept rows are ``min(rows, capacity)``).

    ``offset`` (E,) int32: pairs that earlier rows of a longer token order
    routed to each expert ahead of these.  A pair is then kept while its
    position in that order, ``offset + pos``, is within the capacity; its
    slot stays ``pos`` in its expert's rows of this buffer, and ``rows``
    counts the kept pairs alone."""
    e_local = num_experts if e_local is None else e_local
    flat_e = idx.reshape(-1)
    if e_start:
        flat_e = flat_e - e_start
    onehot = (flat_e[:, None] == torch.arange(
        e_local, device=idx.device)).to(torch.int32)             # (T*k, E_l)
    count = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    rows = count[-1]
    if e_local == num_experts:
        pos = torch.gather(count, 1, flat_e[:, None])[:, 0] - 1  # (T*k,)
        if offset is None:
            keep = pos < capacity
        else:
            keep = pos + offset[flat_e] < capacity
            rows = torch.minimum(rows, (capacity - offset).clamp(min=0))
    else:
        pos = torch.gather(count, 1, flat_e.clamp(0, e_local - 1)[:, None]
                           )[:, 0] - 1
        keep = (flat_e >= 0) & (flat_e < e_local) & (pos < capacity)
    slot = torch.where(keep, flat_e * capacity + pos, e_local * capacity)
    return keep, slot, rows


def _expert_compute(x2d, idx, gate, w_gate, w_up, w_down, *,
                    num_experts: int, capacity: int, act_bits=None,
                    backend=None, e_start: int = 0, e_local=None,
                    offset=None):
    """Capacity-gather the tokens routed to experts ``[e_start, e_start +
    e_local)`` (default: all), run the batched FFN, and scatter-combine.
    ``act_bits`` fake-quantizes the capacity buffer (its zero padding rows
    included, as in the reference) and the gated activation before
    ``w_down``.

    x2d: (T, d); idx/gate: (T, k); w_*: (E_l, d, f) / (E_l, f, d)."""
    T, d = x2d.shape
    k = idx.shape[1]
    E = num_experts if e_local is None else e_local
    keep, slot, rows = _dispatch(idx, num_experts, capacity, e_start, E,
                                 offset)
    tok_idx = torch.arange(T * k, device=x2d.device) // k
    buf = torch.zeros((E * capacity + 1, d), dtype=x2d.dtype,
                      device=x2d.device)
    # kept pairs own distinct rows; dropped ones all land on the last row
    buf[slot] = x2d[tok_idx]
    h = buf[:-1].reshape(E, capacity, d)
    if act_bits:
        h = L.fake_quant_act(h, act_bits)

    # rows past each expert's count are zero in h, and so in g: +0 from
    # silu(+0) * (+0), and from fake_quant_act and act_scale's division
    g = (torch.nn.functional.silu(L.expert_matmul(h, w_gate, backend, rows))
         * L.expert_matmul(h, w_up, backend, rows))
    if act_bits:
        g = L.fake_quant_act(g, act_bits)
    out = L.expert_matmul(g, w_down, backend, rows)              # (E, C, d)

    out_flat = torch.cat([out.reshape(E * capacity, d),
                          out.new_zeros((1, d))], 0)
    contrib = out_flat[slot] * gate.reshape(-1)[:, None].to(out.dtype)
    contrib = torch.where(keep[:, None], contrib, contrib.new_zeros(()))
    return torch.sum(contrib.reshape(T, k, d), dim=1)


def moe_ffn(mp: dict, x: torch.Tensor, cfg: ModelConfig,
            ctx: Ctx) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): every expert on this device; under
    ``ctx.ep_inner`` (the model group of serve-time TP) this rank's slice
    of them, summed over the group; on a mesh (``ctx.mesh``, ``x`` the
    rank's rows) the two mesh paths of the module docstring."""
    B, S, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cf = cfg.moe.capacity_factor
    x2d = x.reshape(B * S, d)
    idx, gate = _route(x2d, mp["router"], k)
    if ctx.ep_axis is not None:
        y = _moe_expert_parallel(mp, x2d, idx, gate, cfg, ctx).reshape(
            B, S, d)
        # the train step's split names the experts wherever ep_axis is set
        # (launch.steps.model_split); elsewhere they split over ep_axis alone
        tp = ctx.tp if ctx.tp is not None else L.ModelSplit(
            ctx.mesh.group_of(ctx.ep_axis), ctx.mesh.size_of(ctx.ep_axis),
            ctx.mesh.index_of(ctx.ep_axis), frozenset({"experts"}))
        return L.leave(y, tp, "experts")
    if ctx.mesh is not None and dp_size(ctx.mesh) > 1:
        return _moe_global_queue(mp, x2d, idx, gate, cfg, ctx).reshape(
            B, S, d)
    cap = _capacity(B * S, e, k, cf)
    if ctx.ep_inner is None:
        y = _expert_compute(x2d, idx, gate, mp["w_gate"], mp["w_up"],
                            mp["w_down"], num_experts=e, capacity=cap,
                            act_bits=ctx.act_bits, backend=ctx.kernel_backend)
        return y.reshape(B, S, d)
    if not isinstance(ctx.ep_inner, dist.ProcessGroup):
        raise TypeError(f"moe_ffn: ctx.ep_inner must be the model axis's "
                        f"ProcessGroup, got {ctx.ep_inner!r}")
    e_local = _experts_held(mp)
    y = _expert_compute(x2d, idx, gate, mp["w_gate"], mp["w_up"],
                        mp["w_down"], num_experts=e, capacity=cap,
                        act_bits=ctx.act_bits, backend=ctx.kernel_backend,
                        e_start=dist.get_rank(ctx.ep_inner) * e_local,
                        e_local=e_local)
    dist.all_reduce(y, group=ctx.ep_inner)
    return y.reshape(B, S, d)


def _experts_held(mp: dict) -> int:
    wg = mp["w_gate"]
    return int((wg.packed if isinstance(wg, QTensor) else wg).shape[-3])


def _moe_expert_parallel(mp, x2d, idx, gate, cfg, ctx):
    """``ctx.ep_axis``: the rank's rows through its contiguous experts,
    the rank's part of the output, which the caller sums over the model
    group.  Capacity is per data shard: the rank's own tokens."""
    mesh = ctx.mesh
    e = cfg.moe.num_experts
    tp = mesh.size_of(ctx.ep_axis)
    if e % tp:
        raise ValueError(f"moe_ffn: {e} experts do not split over {tp} "
                         f"expert-parallel ranks")
    e_local = e // tp
    if _experts_held(mp) != e_local:
        raise ValueError(f"moe_ffn: expert weights hold "
                         f"{_experts_held(mp)} experts, the rank's share "
                         f"of the '{ctx.ep_axis}' axis is {e_local}")
    group = mesh.group_of(ctx.ep_axis)
    cap = _capacity(x2d.shape[0], e, cfg.moe.top_k,
                    cfg.moe.capacity_factor)
    return _expert_compute(L.copy_to_group(x2d, group), idx,
                           L.copy_to_group(gate, group), mp["w_gate"],
                           mp["w_up"], mp["w_down"], num_experts=e,
                           capacity=cap, act_bits=ctx.act_bits,
                           backend=ctx.kernel_backend,
                           e_start=mesh.index_of(ctx.ep_axis) * e_local,
                           e_local=e_local)


def _moe_global_queue(mp, x2d, idx, gate, cfg, ctx):
    """``ctx.ep_axis`` None on a data-parallel mesh: the capacity of the
    global token count, and each expert's queue continued from the lower
    data ranks' pairs (an all-reduce of the ranks' E counts, each in its
    own row)."""
    mesh = ctx.mesh
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    axes = ctx.dp_axes
    D, r = dp_size(mesh, axes), mesh.index_of(axes)
    cap = _capacity(x2d.shape[0] * D, e, k, cfg.moe.capacity_factor)
    counts = torch.zeros((D, e), dtype=torch.int32, device=x2d.device)
    flat = idx.reshape(-1)
    counts[r].scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    dist.all_reduce(counts, group=mesh.group_of(axes))
    offset = counts[:r].sum(0, dtype=torch.int32)
    y = _expert_compute(x2d, idx, gate, mp["w_gate"], mp["w_up"],
                        mp["w_down"], num_experts=e, capacity=cap,
                        act_bits=ctx.act_bits, backend=ctx.kernel_backend,
                        offset=offset)
    return y
