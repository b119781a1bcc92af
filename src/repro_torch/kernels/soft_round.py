"""TesseraQ soft-weight materialization θ̂ and its gradient (the
calibration-time hot loop: every Soften step rebuilds θ̂ for every linear of
the block and pulls the loss gradient back to ν and v).

Replaces the reference's Pallas kernel ``repro/kernels/soft_round.py``
(``soft_round``), which is forward only; the reference differentiates the
same function in plain jnp (``core/tesseraq.py::soft_weight``).  The CUDA
kernels are ``csrc/soft_round.cu`` (``soft_round_fwd``, ``soft_round_bwd``);
their note says what bounds them on the card and how the design answers
that.  :func:`soft_round_plain` and :func:`soft_round_bwd_plain` are the
same functions in plain PyTorch: the wrappers run them for a tensor on the
CPU, and ``chip_smoke.py`` holds the kernels against them on the card.

Layout: base/ν/hard (ng, g, out), v/scale/zero (ng, out); ``hard`` is int8
(0 soft, ±1 frozen), read as it is stored in the TesseraQ state.  An
optional ``act_scale`` (AWQ's per-input-channel divisor, length ``ng_e ·
g``) divides row ``r`` of group ``grp`` by ``act_scale[(grp % ng_e)·g + r]``:
θ̂ after the product, the cotangent before the chain, so every expert of
a folded ``(E·ng_e, g, out)`` stack shares one vector.  Both kernels take it
in the launch; with it absent the function is the TPU kernel's.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

# the C entries take ng, g and out as C ints and launch one block per
# (group, 128-column tile, row split) on a one-dimensional grid
INT_MAX = 2 ** 31 - 1
TILE_COLS = 128


def divide_rows(t: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """``t`` (ng, g, out) with row r of group grp divided by
    ``act_scale[(grp % ng_e)·g + r]``: the division ``soft_weight`` applies
    to the flat (..., in, out) weight, element by element the same IEEE
    operation."""
    ng, g, n = t.shape
    ng_e = act_scale.numel() // g
    return (t.reshape(-1, ng_e, g, n)
            / act_scale.reshape(ng_e, g, 1)).reshape(ng, g, n)


def soft_round_plain(base, nu, hard, v, scale, zero, *, qmax: int,
                     dst: bool = True,
                     act_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """θ̂ = (clip(base + zero + α, 0, qmax) − zero) · scale · [2σ(v)], with
    α = σ(ν) where ``hard == 0`` and the frozen 0/1 elsewhere, then divided
    by ``act_scale`` by rows (:func:`divide_rows`) when it is given.

    The clip is max-then-min, as ``jnp.clip`` is, so autograd through this
    function (the ``"xla"`` path) splits a tie at either bound evenly, as
    ``jax.grad`` does; ``torch.clamp`` would pass the whole gradient."""
    alpha = torch.where(hard == 0, torch.sigmoid(nu),
                        (hard > 0).to(torch.float32))
    z = zero[:, None, :]
    u = base + z + alpha
    q = torch.minimum(torch.maximum(u, u.new_zeros(())),
                      u.new_tensor(float(qmax)))
    s = scale[:, None, :]
    if dst:
        s = s * (2.0 * torch.sigmoid(v))[:, None, :]
    out = (q - z) * s
    return out if act_scale is None else divide_rows(out, act_scale)


def soft_round_bwd_plain(dout, base, nu, hard, v, scale, zero, *, qmax: int,
                         dst: bool = True,
                         act_scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dν, dv) for the cotangent ``dout`` of :func:`soft_round_plain`
    (dv is None without DST): ``dout`` divided by ``act_scale`` by rows
    first when it is given.  The clip passes 1 inside (0, qmax) and 1/2 at
    either bound, as ``jax.grad`` of ``jnp.clip`` does."""
    if act_scale is not None:
        dout = divide_rows(dout, act_scale)
    soft = hard == 0
    sg = torch.sigmoid(nu)
    alpha = torch.where(soft, sg, (hard > 0).to(torch.float32))
    z = zero[:, None, :]
    u = base + z + alpha
    q = torch.clamp(u, 0.0, float(qmax))
    cg = torch.where((u > 0) & (u < qmax), 1.0,
                     torch.where((u == 0) | (u == qmax), 0.5, 0.0))
    se = scale[:, None, :]
    if dst:
        sv = torch.sigmoid(v)
        se = se * (2.0 * sv)[:, None, :]
    dnu = ((dout * se) * cg) * torch.where(soft, sg * (1.0 - sg), 0.0)
    dv = None
    if dst:
        dv = (((dout * (q - z)).sum(dim=1) * scale) * 2.0) * (sv * (1.0 - sv))
    return dnu, dv


def check_grid(name, ng, g, n):
    """The launch's limits: ng, g and out are C ints, and the grid's ng x
    tiles x splits blocks fit its 2^31 − 1 (the rows split only where ng x
    tiles < 4096, so ng x tiles decides)."""
    if max(ng, g, n) > INT_MAX or ng * -(-n // TILE_COLS) > INT_MAX:
        raise ValueError(f"{name}: (ng, g, out) = {(ng, g, n)} exceeds the "
                         f"launch's limits (C ints, 2^31 - 1 blocks)")


def _check_act(name, act_scale, base, ng, g):
    """act_scale: 1-D, base's dtype and device, length ng_e · g with ng_e
    dividing ng.  Returns ng_e."""
    if act_scale.ndim != 1:
        raise ValueError(f"{name}: act_scale must be 1-D, got "
                         f"{tuple(act_scale.shape)}")
    L = act_scale.shape[0]
    if L == 0 or L % g or ng % (L // g):
        raise ValueError(f"{name}: act_scale length {L} is not ng_e * g "
                         f"with ng_e dividing ng (ng={ng}, g={g})")
    if act_scale.dtype != base.dtype:
        raise TypeError(f"{name}: act_scale must be {base.dtype}, got "
                        f"{act_scale.dtype}")
    if act_scale.device != base.device:
        raise ValueError(f"{name}: act_scale is on {act_scale.device}, base "
                         f"on {base.device}")
    return L // g


def _check(name, base, nu, hard, v, scale, zero, dout=None, act_scale=None):
    """Validates shapes (and act_scale's length, dtype and device); on a
    CUDA tensor also types, device, contiguity and the launch's limits.
    Returns (ng, g, n, ng_e), ng_e 0 without act_scale."""
    if base.ndim != 3:
        raise ValueError(f"{name}: base must be (ng, g, out), got "
                         f"{tuple(base.shape)}")
    ng, g, n = base.shape
    for nm, t in (("nu", nu), ("hard", hard)) + ((("dout", dout),)
                                                 if dout is not None else ()):
        if tuple(t.shape) != (ng, g, n):
            raise ValueError(f"{name}: {nm} shape {tuple(t.shape)}, expected "
                             f"{(ng, g, n)}")
    for nm, t in (("v", v), ("scale", scale), ("zero", zero)):
        if tuple(t.shape) != (ng, n):
            raise ValueError(f"{name}: {nm} shape {tuple(t.shape)}, expected "
                             f"{(ng, n)}")
    ng_e = 0 if act_scale is None else _check_act(name, act_scale, base, ng,
                                                  g)
    if base.device.type == "cpu":
        return ng, g, n, ng_e
    if base.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {base.device}")
    if hard.dtype != torch.int8:
        raise TypeError(f"{name}: hard must be int8, got {hard.dtype}")
    named = (("base", base), ("nu", nu), ("v", v), ("scale", scale),
             ("zero", zero)) + ((("dout", dout),) if dout is not None else ()
                                ) + ((("act_scale", act_scale),)
                                     if act_scale is not None else ())
    for nm, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {nm} must be float32, got {t.dtype}")
    for nm, t in named + (("hard", hard),):
        if t.device != base.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, base on "
                             f"{base.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    check_grid(name, ng, g, n)
    return ng, g, n, ng_e


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def soft_round_config(base, nu, hard, out, dout=None) -> dict:
    """The plan the CUDA kernels take for these operands, as their own host
    code chooses it (``soft_round_config`` in ``csrc/soft_round.cu``;
    launches nothing): the forward's with ``dout`` None (``out`` the θ̂
    buffer), else the backward's (``out`` the dν buffer), whose row splits
    form one thread-block cluster.  Every field but ``vec16`` is a function
    of (ng, g, out) and the direction alone.  CUDA tensors only."""
    if base.device.type != "cuda":
        raise ValueError(f"soft_round_config: CUDA tensors only, got "
                         f"{base.device}")
    ng, g, n = base.shape
    cfg = (ctypes.c_int * 8)()
    lib = build.load_library()
    build.check("soft_round_config", lib.soft_round_config(
        _ptr(dout), base.data_ptr(), nu.data_ptr(), hard.data_ptr(),
        out.data_ptr(), ng, g, n, cfg))
    cols, tile, warps, rows, splits, per, tiles, vec = cfg
    return {"tile": f"{tile} columns x {warps} warps, {cols} a thread",
            "rows_in_flight": rows, "splits": splits,
            "rows_per_split": per, "vec16": bool(vec),
            "grid": [ng, tiles, splits]}


def soft_round(base, nu, hard, v, scale, zero, *, qmax: int,
               dst: bool = True,
               act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """θ̂ (ng, g, out) f32, divided by ``act_scale`` by rows when given.  A
    CUDA tensor launches ``soft_round_fwd``; a CPU tensor runs
    :func:`soft_round_plain`."""
    ng, g, n, ng_e = _check("soft_round", base, nu, hard, v, scale, zero,
                            act_scale=act_scale)
    if base.device.type == "cpu":
        return soft_round_plain(base, nu, hard, v, scale, zero, qmax=qmax,
                                dst=dst, act_scale=act_scale)
    out = torch.empty_like(base)
    lib = build.load_library()
    err = lib.soft_round_fwd(
        base.data_ptr(), nu.data_ptr(), hard.data_ptr(), v.data_ptr(),
        scale.data_ptr(), zero.data_ptr(), _ptr(act_scale), out.data_ptr(),
        ng, g, n, ng_e, qmax, int(dst), build.stream_ptr(base.device))
    build.check("soft_round_fwd", err)
    build.LAUNCHES["soft_round_fwd"] += 1
    return out


def soft_round_bwd(dout, base, nu, hard, v, scale, zero, *, qmax: int,
                   dst: bool = True, act_scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dν, dv) for ``dout`` (divided by ``act_scale`` by rows first when
    given).  A CUDA tensor launches ``soft_round_bwd``; a CPU tensor runs
    :func:`soft_round_bwd_plain`."""
    ng, g, n, ng_e = _check("soft_round_bwd", base, nu, hard, v, scale, zero,
                            dout=dout, act_scale=act_scale)
    if base.device.type == "cpu":
        return soft_round_bwd_plain(dout, base, nu, hard, v, scale, zero,
                                    qmax=qmax, dst=dst, act_scale=act_scale)
    dnu = torch.empty_like(base)
    dv = torch.empty_like(v) if dst else None
    lib = build.load_library()
    err = lib.soft_round_bwd(
        dout.data_ptr(), base.data_ptr(), nu.data_ptr(), hard.data_ptr(),
        v.data_ptr(), scale.data_ptr(), zero.data_ptr(), _ptr(act_scale),
        dnu.data_ptr(), _ptr(dv), ng, g, n, ng_e, qmax, int(dst),
        build.stream_ptr(base.device))
    build.check("soft_round_bwd", err)
    build.LAUNCHES["soft_round_bwd"] += 1
    return dnu, dv


class SoftRound(torch.autograd.Function):
    """θ̂ with its gradient to ν and v, one kernel launch each way, with
    ``act_scale`` (optional, last) divided in both launches and given no
    gradient.  Only the inputs are saved; the backward recomputes σ(ν), α
    and the clip."""

    @staticmethod
    def forward(ctx, base, nu, hard, v, scale, zero, qmax: int, dst: bool,
                act_scale=None):
        ctx.save_for_backward(base, nu, hard, v, scale, zero, act_scale)
        ctx.qmax, ctx.dst = qmax, dst
        return soft_round(base, nu, hard, v, scale, zero, qmax=qmax, dst=dst,
                          act_scale=act_scale)

    @staticmethod
    def backward(ctx, dout):
        base, nu, hard, v, scale, zero, act_scale = ctx.saved_tensors
        dnu, dv = soft_round_bwd(dout.contiguous(), base, nu, hard, v, scale,
                                 zero, qmax=ctx.qmax, dst=ctx.dst,
                                 act_scale=act_scale)
        return None, dnu, None, dv, None, None, None, None, None
