"""Shared building blocks: matmul dispatch over plain / quantized (QTensor)
weights, per-token activation fake-quant, RMSNorm, LayerNorm, RoPE,
sinusoidal positions and chunked (flash-style) attention, causal or not,
with a recomputing backward.

Functions over tensors and param dicts; weights use ``(in_features,
out_features)`` (experts: ``(E, in, out)``).  QTensor matmuls dispatch per call on ``backend``:
"xla" dequantizes in the activation dtype and runs a dense matmul, "pallas"
runs the hand-written kernels (their plain versions on a CPU tensor).

Across ranks: serve-time tensor parallelism all-reduces an in-split
linear's product (``PsumWeight``); the mesh train step's split over the
``model`` axis (``ModelSplit``) enters and leaves each region of a block
through differentiable collectives (``enter`` / ``leave``) and takes the
embedding and the cross entropy over the rank's vocab slice
(``vocab_lookup``, ``token_nll``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core.qtensor import QTensor, qmatmul

KERNEL_BACKENDS = ("xla", "pallas")


@dataclasses.dataclass
class PsumWeight:
    """An input-channel-split weight of serve-time tensor parallelism.

    The TP contract (``launch.sharding.ServeSpec``) splits in-split linears
    (``wo``/``w_down``/``cv``) over their reduction dim; each rank's
    partial product must be summed over the model ``group`` before anything
    nonlinear consumes it.  Wrapping the weight keeps the family forwards
    free of sharding logic: :func:`matmul` multiplies the local shard and
    all-reduces, the one place the in-channel epilogue lives
    (``common.take_layer`` / ``unstack_layers`` keep the wrapper around
    each layer's slice).  ``group`` None is the default process group."""
    w: Any
    group: Any = None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward: the sum over ``group`` (an all-reduce).  Backward: the
    cotangent as it is: psum's transpose under the reference's
    ``shard_map``, whose output is replicated over the axis, so every rank
    already holds the whole cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: the tensors as they are.  Backward: each one's cotangent
    summed over ``group`` (one all-reduce a dtype over them flattened):
    the transpose of handing one replicated input to every shard of a
    ``shard_map``, each of which takes its own part of the gradient."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *dys):
        out = list(dys)
        by_dtype: dict = {}
        for i, d in enumerate(dys):
            by_dtype.setdefault(d.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([dys[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=ctx.group)
            o = 0
            for i in idx:
                n = dys[i].numel()
                out[i] = flat[o:o + n].view(dys[i].shape)
                o += n
        return (None, *out)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged, entering a computation that each rank of ``group``
    runs on its own part (its local experts): the gradient sums the
    ranks' parts over ``group``."""
    return _CopyToGroup.apply(group, x)[0]


# --------------------------------------------------------------------------
# the train step's split over the ``model`` axis: region entries and exits
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """How a mesh train step splits its work over the ``model`` axis
    (``Ctx.tp``; ``launch.steps.make_train_harness`` makes it).

    ``group`` is the model axis's process group, ``size`` its extent and
    ``rank`` this rank's index in it.  ``splits`` names the regions whose
    weights the rank holds a slice of: ``"attn"`` (its heads of wq / wk /
    wv, the matching rows of wo: every self- and cross-attention),
    ``"ffn"`` (its columns of w_gate / w_up, the rows of w_down; RWKV's
    channel mix: its columns of ck, the rows of cv), ``"experts"`` (the
    MoE's ``E / size`` experts), ``"time"`` (RWKV's time mix: its heads of
    wr / wk / wv / wg and of the decay, bonus and group norm, the rows of
    wo), ``"out_proj"`` (Mamba's: its ``di / size`` rows, against its
    columns of the mixer's whole output) and ``"vocab"`` (its rows of
    embed, its columns of head).  A region not named runs whole on every
    rank.  ``seq`` splits the residual stream's rows (the sequence dim)
    over the group between the regions: the reference's
    ``seq_parallel``.

    ``qrows`` splits the ``"attn"`` region by its query rows instead of
    its heads (the reference's ``{"seq": ("model",)}`` remap): the rank
    computes q, k and v of its block of the rows with every head, against
    the keys and values of every rank's rows (one all-gather of k and v;
    its backward reduce-scatters the partial dk / dv of each rank's
    queries), and its rows of ``o @ wo``.  The region's weights are whole
    inside it (:func:`attn_weights`)."""
    group: Any
    size: int
    rank: int
    splits: frozenset = frozenset()
    seq: bool = False
    qrows: bool = False


def _gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 1)


def _scatter_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    parts = [p.contiguous() for p in x.chunk(size, 1)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _own_rows(x: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    n = x.shape[1] // size
    return x.narrow(1, rank * n, n).contiguous()


class _GatherRowsTo(torch.autograd.Function):
    """Forward: the whole rows (dim 1) from every rank's block of them (an
    all-gather).  Backward: with ``partial`` (each rank's consumer makes
    its own part of the gradient) the sum over the group of the
    cotangents, scattered back to each rank's block (a reduce-scatter);
    without it (every rank's consumer runs alike) the rank's block of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, group, size, rank, partial):
        ctx.args = group, size, rank, partial
        return _gather_rows(x, group, size)

    @staticmethod
    def backward(ctx, dy):
        group, size, rank, partial = ctx.args
        dx = (_scatter_rows(dy, group, size) if partial
              else _own_rows(dy, size, rank))
        return dx, None, None, None, None


class _ScatterRowsFrom(torch.autograd.Function):
    """Forward: the rank's block of the rows (dim 1): with ``partial`` of
    the sum over the group of every rank's part (a reduce-scatter), else
    of the value itself.  Backward: the whole cotangent gathered from the
    ranks' blocks (an all-gather)."""

    @staticmethod
    def forward(ctx, x, group, size, rank, partial):
        ctx.args = group, size
        return (_scatter_rows(x, group, size) if partial
                else _own_rows(x, size, rank))

    @staticmethod
    def backward(ctx, dy):
        return _gather_rows(dy, *ctx.args), None, None, None, None


class _OwnColumns(torch.autograd.Function):
    """Forward: the rank's block of the last dim of a tensor every rank
    holds whole.  Backward: the whole cotangent gathered from the ranks'
    blocks (an all-gather): each rank's consumer reads only its block, so
    the blocks of the cotangent are disjoint."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.args = group, size
        n = x.shape[-1] // size
        return x.narrow(-1, rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, dy):
        group, size = ctx.args
        parts = [torch.empty_like(dy) for _ in range(size)]
        dist.all_gather(parts, dy.contiguous(), group=group)
        return torch.cat(parts, -1), None, None, None


def own_columns(x: torch.Tensor, tp: Optional[ModelSplit],
                region: str) -> torch.Tensor:
    """The rank's ``1 / size`` block of ``x``'s last dim where ``region``
    splits (``x`` whole on every rank, read by the rank's rows of an
    in-split weight); its gradient gathers the ranks' blocks.  Elsewhere
    ``x``."""
    if tp is None or region not in tp.splits:
        return x
    return _OwnColumns.apply(x, tp.group, tp.size, tp.rank)


def _query_split(tp: Optional[ModelSplit], region: str) -> bool:
    return tp is not None and tp.qrows and region == "attn"


def enter(h: torch.Tensor, tp: Optional[ModelSplit],
          region: str) -> torch.Tensor:
    """``h`` entering ``region`` of a block (its input, after the norm).
    A split region computes the rank's part from the whole rows: ``h``
    unchanged and its gradient all-reduced over the group, or, under
    ``tp.seq``, the rows all-gathered and the gradient reduce-scattered.
    A whole region under ``tp.seq`` all-gathers the rows and takes back
    the rank's block of the gradient.  The attention under ``tp.qrows``
    takes the rank's block of the rows: under ``tp.seq`` ``h`` itself,
    else its block of the whole rows, the gradient gathered back from the
    ranks' blocks.  Without ``tp``: ``h``."""
    if tp is None:
        return h
    if _query_split(tp, region):
        return h if tp.seq else _ScatterRowsFrom.apply(
            h, tp.group, tp.size, tp.rank, False)
    split = region in tp.splits
    if tp.seq:
        return _GatherRowsTo.apply(h, tp.group, tp.size, tp.rank, split)
    return _CopyToGroup.apply(tp.group, h)[0] if split else h


def leave(y: torch.Tensor, tp: Optional[ModelSplit],
          region: str) -> torch.Tensor:
    """``y`` leaving ``region`` for the residual stream: a split region's
    partial sums all-reduced over the group (the gradient passes as it
    is), or, under ``tp.seq``, reduce-scattered to the rank's rows (the
    gradient all-gathered).  A whole region under ``tp.seq`` keeps the
    rank's rows.  The attention under ``tp.qrows`` made the whole sum of
    its rows: they stay under ``tp.seq``, else every rank's are gathered
    (the gradient: the rank's block).  Without ``tp``: ``y``."""
    if tp is None:
        return y
    if _query_split(tp, region):
        return y if tp.seq else _GatherRowsTo.apply(
            y, tp.group, tp.size, tp.rank, False)
    split = region in tp.splits
    if tp.seq:
        return _ScatterRowsFrom.apply(y, tp.group, tp.size, tp.rank, split)
    return _ReduceFromGroup.apply(y, tp.group) if split else y


def share(tp: Optional[ModelSplit], region: str, *ts):
    """Tensors every rank holds whole (replicated leaves, or a value every
    rank computed alike), read inside ``region``.  Where it splits, each
    rank's reading makes its own part of their gradient: the parts are
    summed over the group on the way back (the transpose of handing one
    replicated input to every shard).  Elsewhere they pass as they are.
    Returns the one tensor, or a tuple of them."""
    if tp is not None and region in tp.splits:
        ts = _CopyToGroup.apply(tp.group, *ts)
    return ts[0] if len(ts) == 1 else tuple(ts)


class _GatherSlices(torch.autograd.Function):
    """Forward: each tensor whole from every rank's block of its dim
    ``dims[i]`` (one all-gather of them flattened together).  Backward:
    the sum over the group of each whole cotangent, cut to the rank's
    block (one reduce-scatter): every rank's rows make their own part of
    the weights' gradient."""

    @staticmethod
    def forward(ctx, group, size, dims, *ws):
        ctx.args = group, size, dims, [w.shape for w in ws]
        flat = torch.cat([w.reshape(-1) for w in ws])
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat, group=group)
        out, o = [], 0
        for w, d in zip(ws, dims):
            n = w.numel()
            out.append(torch.cat([p[o:o + n].view(w.shape) for p in parts], d))
            o += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *dys):
        group, size, dims, shapes = ctx.args
        send = [torch.cat([dy.chunk(size, d)[r].reshape(-1)
                           for dy, d in zip(dys, dims)]) for r in range(size)]
        mine = torch.empty_like(send[0])
        dist.reduce_scatter(mine, send, group=group)
        out, o = [], 0
        for s in shapes:
            n = math.prod(s)
            out.append(mine[o:o + n].view(s))
            o += n
        return (None, None, None, *out)


def attn_weights(tp: Optional[ModelSplit], wq, wk, wv, wo) -> tuple:
    """The attention's weights as its region reads them.  Under
    ``tp.qrows`` they are whole: where the region's heads split (the
    rank holds its columns of wq / wk / wv and rows of wo) gathered over
    the group, the gradient reduce-scattered back to the rank's heads;
    where they are whole already, their gradient summed over the group.
    Elsewhere as they are."""
    if tp is None or not tp.qrows:
        return wq, wk, wv, wo
    if "attn" in tp.splits:
        return _GatherSlices.apply(tp.group, tp.size, (-1, -1, -1, -2),
                                   wq, wk, wv, wo)
    return _CopyToGroup.apply(tp.group, wq, wk, wv, wo)


def query_block(tp: Optional[ModelSplit], positions: torch.Tensor,
                rows: int) -> tuple:
    """Under ``tp.qrows``, the positions of the rank's block of ``rows``
    rows (``positions`` those of the whole sequence, last dim) and the
    absolute position of its first row; elsewhere ``(positions, 0)``."""
    if tp is None or not tp.qrows:
        return positions, 0
    q0 = tp.rank * rows
    return positions.narrow(-1, q0, rows), q0


def gather_keys(k: torch.Tensor, v: torch.Tensor,
                tp: Optional[ModelSplit]) -> tuple:
    """Under ``tp.qrows``, the keys and values of every rank's rows from
    the rank's block of them (one all-gather of the two joined on the
    head dim); the backward reduce-scatters the partial dk / dv that each
    rank's queries made.  Elsewhere ``(k, v)``."""
    if tp is None or not tp.qrows:
        return k, v
    kv = _GatherRowsTo.apply(torch.cat([k, v], -1), tp.group, tp.size,
                             tp.rank, True)
    return kv.split(k.shape[-1], -1)


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 rank: int) -> torch.Tensor:
    """The rank's part of an embedding lookup over a vocab-split ``table``
    (its rows ``[rank * n, (rank + 1) * n)``): the rows of the tokens it
    holds, zero for the others; :func:`leave` sums the parts."""
    n = table.shape[0]
    t = tokens - rank * n
    mine = (t >= 0) & (t < n)
    e = table[torch.where(mine, t, 0)]
    return torch.where(mine[..., None], e, e.new_zeros(()))


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              tp: Optional[ModelSplit] = None) -> torch.Tensor:
    """Each position's cross entropy ``logsumexp(logits) - logits[target]``
    in the logits' dtype (f32 for the losses).  Under ``tp`` with
    ``"vocab"`` split the logits are the rank's vocab columns: the max is
    all-reduced (no gradient flows through it), the sum of exponentials
    and the gold logit, which only its owner holds, are summed over the
    group."""
    if tp is None or "vocab" not in tp.splits:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return lse - gold
    n = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    lse = m + torch.log(_ReduceFromGroup.apply(sumexp, tp.group))
    t = targets - tp.rank * n
    mine = (t >= 0) & (t < n)
    gold = torch.gather(logits, -1, torch.where(mine, t, 0)[..., None])[..., 0]
    gold = torch.where(mine, gold, gold.new_zeros(()))
    return lse - _ReduceFromGroup.apply(gold, tp.group)


def resolve_backend(backend: Optional[str]) -> str:
    """Resolve the QTensor matmul backend for ONE dispatch; ``None`` falls
    back to the ``REPRO_KERNEL_BACKEND`` env var (read at call time) and
    then to "xla"."""
    if backend is None:
        import os
        backend = os.environ.get("REPRO_KERNEL_BACKEND", "xla")
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"expected one of {KERNEL_BACKENDS}")
    return backend


def matmul(x: torch.Tensor, w, backend: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` for a plain, packed (QTensor) or in-split (PsumWeight)
    weight.  A PsumWeight's local product is summed over its group in the
    activation dtype, as the reference's ``psum``: every rank gets the
    same bytes, and on a one-rank group the sum is the product itself."""
    if isinstance(w, PsumWeight):
        y = matmul(x, w.w, backend).contiguous()
        dist.all_reduce(y, group=w.group)
        return y
    if isinstance(w, QTensor):
        if resolve_backend(backend) == "pallas":
            from repro_torch.kernels.ops import qtensor_matmul
            return qtensor_matmul(x, w)
        return qmatmul(x, w)
    return x @ w


def expert_matmul(a: torch.Tensor, w, backend: Optional[str] = None,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched per-expert matmul: (E, C, d) x (E, d, f) -> (E, C, f).
    ``"pallas"`` runs the expert-batched kernel, which takes ``rows`` (each
    expert's row count, int32 (E,), clamped to C by the kernel): rows past
    them come out +0, as the dispatch's zero rows give.  ``"xla"`` dequantizes in the
    activation dtype, runs one batched product and ignores ``rows``."""
    if isinstance(w, QTensor):
        if resolve_backend(backend) == "pallas":
            from repro_torch.kernels.ops import qtensor_expert_matmul
            return qtensor_expert_matmul(a, w, rows)
        if w.act_scale is not None:
            a = a / w.act_scale.to(a.dtype)
        w = w.dequantize(a.dtype)
    return torch.einsum("ecd,edf->ecf", a, w)


def fake_quant_act(x: torch.Tensor, bits: int,
                   symmetric: bool = True) -> torch.Tensor:
    """Per-token dynamic activation quantization (simulated): quantize over
    the last dim per token in f32, dequantize, cast back to x.dtype.

    Its gradient reaches x only through the scale (round's gradient is 0);
    ``torch.amax``/``amin`` split it evenly among tied extremes, as the
    reference's ``jnp.max``/``jnp.min`` do, so the calibration's backward
    through this function matches the reference's too.  The floor of the
    range is a scalar clamp (no tensor made per call, so no host-to-device
    copy in a decode step); it differs from the reference's
    ``jnp.maximum`` only at a range of exactly 1e-8."""
    qmax = (1 << bits) - 1
    xf = x.float()
    if symmetric:
        amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
        scale = torch.clamp(amax, min=1e-8) / ((qmax - 1) / 2)
        q = torch.clamp(torch.round(xf / scale), -(qmax + 1) // 2, qmax // 2)
        return (q * scale).to(x.dtype)
    lo = torch.amin(xf, dim=-1, keepdim=True)
    hi = torch.amax(xf, dim=-1, keepdim=True)
    scale = torch.clamp(hi - lo, min=1e-8) / qmax
    zero = torch.round(-lo / scale)
    q = torch.clamp(torch.round(xf / scale) + zero, 0, qmax)
    return ((q - zero) * scale).to(x.dtype)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in f32 (the population variance, as
    ``jnp.var``), cast to x's dtype before the affine ``* g + b``, as the
    reference."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D), positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, dtype=torch.bfloat16,
                   device=None) -> torch.Tensor:
    """(seq, d) sinusoidal positions, ``[sin | cos]`` concatenated (not
    interleaved), computed in f32 and cast to ``dtype``, as the
    reference's."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(0, d, 2, dtype=torch.float32,
                                     device=device) / d)
    ang = pos * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------------
# flash attention: online softmax over KV chunks, with a FlashAttention-2
# style backward that recomputes each chunk's scores (the reference's
# ``_flash_core`` custom VJP), so autograd keeps O(Sq x D) per call instead
# of every chunk's (Sq x C) scores and probabilities
# --------------------------------------------------------------------------

def _mask_for(idx, csz, q_pos, valid_len, causal=True, prefix_len=None):
    """The ``valid_len`` mask of KV chunk ``idx``, and with ``causal`` the
    causal mask; with ``prefix_len`` the prefix-LM mask (the VLM's image
    prefix attends bidirectionally): causal OR ``k_pos < prefix_len``."""
    k_pos = idx * csz + torch.arange(csz, dtype=torch.float32,
                                     device=q_pos.device)
    k5 = k_pos[None, None, None, None, :]
    mask = k5 < valid_len[:, None, None, None, None]
    if not causal:
        return mask
    cm = k5 <= q_pos[:, None, None, :, None]
    if prefix_len is not None:
        cm = cm | (k5 < prefix_len)
    return mask & cm


def _flash_fwd(q, k, v, q_pos, valid_len, causal=True, prefix_len=None):
    """The online-softmax loop over KV chunks in plain ops.  q: (B,Hkv,G,Sq,D)
    f32 with the scale applied; k,v: (N,B,Hkv,C,D).  Returns (out f32, lse
    (B,Hkv,G,Sq)).  Differentiable as it stands (autograd then keeps every
    chunk's scores): ``_flash_core`` runs it without a graph."""
    B, Hkv, G, Sq, D = q.shape
    csz = k.shape[3]
    m = torch.full((B, Hkv, G, Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=q.device)
    for idx in range(k.shape[0]):
        s = torch.einsum("bhgqd,bhcd->bhgqc", q, k[idx].float())
        mask = _mask_for(idx, csz, q_pos, valid_len, causal, prefix_len)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqc,bhcd->bhgqd", p, v[idx].float())
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return acc / l[..., None], m + torch.log(l)


class _FlashCore(torch.autograd.Function):
    """``_flash_fwd``'s output with the reference's recomputing backward:
    it keeps only q, k, v, the positions, ``out`` and ``lse``, and per KV
    chunk recomputes ``p = where(mask, exp(s - lse), 0)``, then ``ds = p *
    (dp - delta)`` with ``delta = sum(dout * out)``; dq accumulates over the
    chunks, dk and dv are per chunk (cast to k's and v's dtype)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, valid_len, causal, prefix_len):
        out, lse = _flash_fwd(q, k, v, q_pos, valid_len, causal, prefix_len)
        ctx.save_for_backward(q, k, v, q_pos, valid_len, out, lse)
        ctx.causal, ctx.prefix_len = causal, prefix_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, valid_len, out, lse = ctx.saved_tensors
        csz = k.shape[3]
        delta = torch.sum(dout * out, dim=-1)                  # (B,Hkv,G,Sq)
        dq = torch.zeros_like(q)
        dk, dv = [], []
        for idx in range(k.shape[0]):
            kf, vf = k[idx].float(), v[idx].float()
            s = torch.einsum("bhgqd,bhcd->bhgqc", q, kf)
            mask = _mask_for(idx, csz, q_pos, valid_len, ctx.causal,
                             ctx.prefix_len)
            p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
            dv.append(torch.einsum("bhgqc,bhgqd->bhcd", p, dout).to(v.dtype))
            dp = torch.einsum("bhgqd,bhcd->bhgqc", dout, vf)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhgqc,bhcd->bhgqd", ds, kf)
            dk.append(torch.einsum("bhgqc,bhgqd->bhcd", ds, q).to(k.dtype))
        return (dq, torch.stack(dk), torch.stack(dv), None, None, None,
                None)


def _flash_core(q, k, v, q_pos, valid_len, causal=True, prefix_len=None):
    """q: (B,Hkv,G,Sq,D) f32 with the scale applied; k,v: (N,B,Hkv,C,D).
    The ``valid_len`` mask and, with ``causal``, the causal (or prefix-LM)
    mask, as ``flash_attention``."""
    return _FlashCore.apply(q, k, v, q_pos, valid_len, causal, prefix_len)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset=0, kv_len: Optional[torch.Tensor] = None,
                    chunk: int = 512, scale: Optional[float] = None,
                    backend: Optional[str] = None,
                    active: Optional[torch.Tensor] = None,
                    pages: Optional[tuple] = None,
                    prefix_len: Optional[int] = None) -> torch.Tensor:
    """Chunked attention with GQA support: causal, or with ``causal=False``
    every valid key (the encoder-decoder's encoder and cross-attention).
    ``prefix_len`` (a Python int) makes the causal mask the prefix-LM mask
    of the VLM: positions below it attend bidirectionally, causal OR
    ``k_pos < prefix_len``.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0] (int or (B,)) for causal masks
    during decode.  ``kv_len``: (B,) valid KV length (cache masking).
    ``backend``: for the causal Sq == 1 decode step with ``kv_len``,
    "pallas" runs the slot-aware decode kernel (inactive slots in
    ``active`` come back zero) unless ``prefix_len`` is set, as in the
    reference (decode never sets it; cross-attention is not causal);
    "xla" runs the dense masked softmax.  Sq > 1 always runs the chunked online softmax
    in plain torch ops, with the recomputing backward (``_flash_core``).

    ``pages = (ptab, page_size)`` marks k/v as page POOLS (P, page_size,
    Hkv, D) indexed by the (B, W) page table ``ptab``.  The ``"pallas"``
    decode step walks the table in the paged kernel (no gather); every other
    path gathers the virtual slot-major cache — shaped exactly like the
    dense lane, W * page_size == max_seq — and runs unchanged, which keeps
    paged attention bit-identical to dense.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device

    if (Sq == 1 and causal and kv_len is not None and prefix_len is None
            and resolve_backend(backend) == "pallas"):
        from repro_torch.kernels import decode_attention as kernels
        q4 = q.reshape(B, Hkv, G, D).contiguous()
        kw = dict(kv_len=kv_len, active=active, scale=scale,
                  q_pos=torch.as_tensor(q_offset, dtype=torch.int32,
                                        device=dev).reshape(-1).expand(B))
        out = (kernels.decode_attention(q4, k, v, **kw) if pages is None
               else kernels.paged_decode_attention(q4, k, v, pages[0], **kw))
        return out.reshape(B, Sq, Hq, D)
    if pages is not None:
        from repro_torch.models.common import gather_pages
        k = gather_pages(k, pages[0])
        v = gather_pages(v, pages[0])
    Sk = k.shape[1]

    qf = q.reshape(B, Sq, Hkv, G, D).float() * scale
    qf = qf.permute(0, 2, 3, 1, 4)                             # (B,Hkv,G,Sq,D)

    if Sq == 1:
        valid1 = (kv_len.float() if kv_len is not None
                  else torch.full((B,), float(Sk), device=dev))
        s = torch.einsum("bhgqd,bshd->bhgqs", qf, k.float())
        k_pos = torch.arange(Sk, dtype=torch.float32, device=dev)
        k5 = k_pos[None, None, None, None, :]
        mask = k5 < valid1[:, None, None, None, None]
        if causal:
            # (a non-causal step, the decoder's cross-attention, makes no
            # tensor of q_offset: a Python int would be copied to the card,
            # a host sync in every decode step)
            q_pos1 = torch.as_tensor(q_offset, dtype=torch.float32,
                                     device=dev).reshape(-1)[:, None]
            q_pos1 = q_pos1.expand(B, 1)
            cm = k5 <= q_pos1[:, None, None, :, None]
            if prefix_len is not None:
                cm = cm | (k5 < prefix_len)
            mask = mask & cm
        s = torch.where(mask, s, -1e30)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqs,bshd->bhgqd", p, v.float())
        out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
        return out.to(q.dtype)

    csz = min(chunk, Sk)
    pad = (-Sk) % csz
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    Skp = k.shape[1]
    kc = k.reshape(B, Skp // csz, csz, Hkv, D).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, Skp // csz, csz, Hkv, D).permute(1, 0, 3, 2, 4)

    if isinstance(q_offset, int):
        # no host-to-device copy (and so no stream sync) for a Python int
        q_pos = torch.arange(Sq, dtype=torch.float32, device=dev) + q_offset
    else:
        q_pos = torch.as_tensor(q_offset, dtype=torch.float32, device=dev)[
            ..., None] + torch.arange(Sq, dtype=torch.float32, device=dev)
    if q_pos.ndim == 1:
        q_pos = q_pos[None]
    q_pos = q_pos.expand(B, Sq)
    valid_len = (kv_len.float() if kv_len is not None
                 else torch.full((B,), float(Sk), device=dev))

    out = _flash_core(qf, kc, vc, q_pos, valid_len, causal, prefix_len)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out.to(q.dtype)
