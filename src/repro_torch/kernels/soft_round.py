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
(0 soft, ±1 frozen), read as it is stored in the TesseraQ state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build


def soft_round_plain(base, nu, hard, v, scale, zero, *, qmax: int,
                     dst: bool = True) -> torch.Tensor:
    """θ̂ = (clip(base + zero + α, 0, qmax) − zero) · scale · [2σ(v)], with
    α = σ(ν) where ``hard == 0`` and the frozen 0/1 elsewhere.

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
    return (q - z) * s


def soft_round_bwd_plain(dout, base, nu, hard, v, scale, zero, *, qmax: int,
                         dst: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dν, dv) for the cotangent ``dout`` of :func:`soft_round_plain`
    (dv is None without DST).  The clip passes 1 inside (0, qmax) and 1/2
    at either bound, as ``jax.grad`` of ``jnp.clip`` does."""
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


def _check(name, base, nu, hard, v, scale, zero, dout=None):
    """Validates shapes; on a CUDA tensor also types, device, contiguity.
    Returns (ng, g, n)."""
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
    if base.device.type == "cpu":
        return ng, g, n
    if base.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {base.device}")
    if hard.dtype != torch.int8:
        raise TypeError(f"{name}: hard must be int8, got {hard.dtype}")
    named = (("base", base), ("nu", nu), ("v", v), ("scale", scale),
             ("zero", zero)) + ((("dout", dout),) if dout is not None else ())
    for nm, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {nm} must be float32, got {t.dtype}")
    for nm, t in named + (("hard", hard),):
        if t.device != base.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, base on "
                             f"{base.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    if ng > 65535:
        raise ValueError(f"{name}: ng={ng} exceeds the grid's 65535 rows")
    return ng, g, n


def soft_round(base, nu, hard, v, scale, zero, *, qmax: int,
               dst: bool = True) -> torch.Tensor:
    """θ̂ (ng, g, out) f32.  A CUDA tensor launches ``soft_round_fwd``; a
    CPU tensor runs :func:`soft_round_plain`."""
    ng, g, n = _check("soft_round", base, nu, hard, v, scale, zero)
    if base.device.type == "cpu":
        return soft_round_plain(base, nu, hard, v, scale, zero, qmax=qmax,
                                dst=dst)
    out = torch.empty_like(base)
    lib = build.load_library()
    err = lib.soft_round_fwd(
        base.data_ptr(), nu.data_ptr(), hard.data_ptr(), v.data_ptr(),
        scale.data_ptr(), zero.data_ptr(), out.data_ptr(), ng, g, n, qmax,
        int(dst), build.stream_ptr(base.device))
    build.check("soft_round_fwd", err)
    build.LAUNCHES["soft_round_fwd"] += 1
    return out


def soft_round_bwd(dout, base, nu, hard, v, scale, zero, *, qmax: int,
                   dst: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dν, dv) for ``dout``.  A CUDA tensor launches ``soft_round_bwd``; a
    CPU tensor runs :func:`soft_round_bwd_plain`."""
    ng, g, n = _check("soft_round_bwd", base, nu, hard, v, scale, zero,
                      dout=dout)
    if base.device.type == "cpu":
        return soft_round_bwd_plain(dout, base, nu, hard, v, scale, zero,
                                    qmax=qmax, dst=dst)
    dnu = torch.empty_like(base)
    dv = torch.empty_like(v) if dst else None
    lib = build.load_library()
    err = lib.soft_round_bwd(
        dout.data_ptr(), base.data_ptr(), nu.data_ptr(), hard.data_ptr(),
        v.data_ptr(), scale.data_ptr(), zero.data_ptr(), dnu.data_ptr(),
        dv.data_ptr() if dv is not None else None, ng, g, n, qmax, int(dst),
        build.stream_ptr(base.device))
    build.check("soft_round_bwd", err)
    build.LAUNCHES["soft_round_bwd"] += 1
    return dnu, dv


class SoftRound(torch.autograd.Function):
    """θ̂ with its gradient to ν and v, one kernel launch each way.  Only the
    inputs are saved; the backward recomputes σ(ν), α and the clip."""

    @staticmethod
    def forward(ctx, base, nu, hard, v, scale, zero, qmax: int, dst: bool):
        ctx.save_for_backward(base, nu, hard, v, scale, zero)
        ctx.qmax, ctx.dst = qmax, dst
        return soft_round(base, nu, hard, v, scale, zero, qmax=qmax, dst=dst)

    @staticmethod
    def backward(ctx, dout):
        base, nu, hard, v, scale, zero = ctx.saved_tensors
        dnu, dv = soft_round_bwd(dout.contiguous(), base, nu, hard, v, scale,
                                 zero, qmax=ctx.qmax, dst=ctx.dst)
        return None, dnu, None, dv, None, None, None, None
