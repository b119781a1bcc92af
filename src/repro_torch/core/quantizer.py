"""Uniform affine quantization (paper Eq. 1) over per-group / per-channel
weights, plus QTensor construction.

Conventions: weights are (..., in_features, out_features); groups tile the
*input* dimension (the reduction dim).  ``torch.round`` rounds half to even,
as ``jnp.round`` does, so codes match the reference exactly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.qtensor import QTensor, pack


def resolve_group(in_features: int, group_size: Optional[int]) -> int:
    """Per-channel == one group spanning the whole input dim; fall back to it
    when the requested group does not divide (small smoke models)."""
    if group_size is None or in_features % group_size != 0:
        return in_features
    return group_size


def _grouped(w: torch.Tensor, g: int) -> torch.Tensor:
    """(..., in, out) -> (..., n_groups, g, out)."""
    *b, n, o = w.shape
    return w.reshape(*b, n // g, g, o)


def compute_scale_zero(w: torch.Tensor, qcfg: QuantConfig,
                       gamma: Optional[float] = None,
                       beta: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric scale/zero per group (Eq. 1), shape (..., n_groups, out).
    ``gamma``/``beta`` shrink the max/min clipping range."""
    g = resolve_group(w.shape[-2], qcfg.group_size)
    wg = _grouped(w.to(torch.float32), g)
    gamma = qcfg.gamma if gamma is None else gamma
    beta = qcfg.beta if beta is None else beta
    if qcfg.symmetric:
        amax = wg.abs().amax(dim=-2) * gamma
        scale = torch.clamp(amax, min=1e-8) / (qcfg.qmax / 2)
        zero = torch.full_like(scale, (qcfg.qmax + 1) / 2)
        return scale, zero
    wmax = wg.amax(dim=-2) * gamma
    wmin = wg.amin(dim=-2) * beta
    scale = torch.clamp(wmax - wmin, min=1e-8) / qcfg.qmax
    zero = torch.round(-wmin / scale)
    return scale, zero


def quantize_codes(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   qcfg: QuantConfig) -> torch.Tensor:
    """RTN integer codes in [0, qmax] (float), shape of w."""
    g = resolve_group(w.shape[-2], qcfg.group_size)
    wg = _grouped(w.to(torch.float32), g)
    q = torch.clamp(torch.round(wg / scale[..., None, :]) + zero[..., None, :],
                    0, qcfg.qmax)
    return q.reshape(w.shape)


def dequantize_codes(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                     qcfg: QuantConfig, out_dtype=torch.float32) -> torch.Tensor:
    g = resolve_group(q.shape[-2], qcfg.group_size)
    qg = _grouped(q.to(torch.float32), g)
    w = (qg - zero[..., None, :]) * scale[..., None, :]
    return w.reshape(q.shape).to(out_dtype)


def fake_quantize(w: torch.Tensor, qcfg: QuantConfig, gamma=None, beta=None
                  ) -> torch.Tensor:
    """RTN round-trip (the plain baseline and the inner op of search loops)."""
    scale, zero = compute_scale_zero(w, qcfg, gamma, beta)
    q = quantize_codes(w, scale, zero, qcfg)
    return dequantize_codes(q, scale, zero, qcfg, w.dtype)


def make_qtensor(w: torch.Tensor, qcfg: QuantConfig, *,
                 scale: Optional[torch.Tensor] = None,
                 zero: Optional[torch.Tensor] = None,
                 codes: Optional[torch.Tensor] = None,
                 dst_factor: Optional[torch.Tensor] = None,
                 act_scale: Optional[torch.Tensor] = None) -> QTensor:
    """Pack a weight into the deployment QTensor.

    ``dst_factor`` is TesseraQ's dequantization-scale-tuning multiplier
    2*sigmoid(v), folded into the stored scale."""
    g = resolve_group(w.shape[-2], qcfg.group_size)
    if scale is None:
        scale, zero = compute_scale_zero(w, qcfg)
    if codes is None:
        codes = quantize_codes(w, scale, zero, qcfg)
    eff_scale = scale * dst_factor if dst_factor is not None else scale
    return QTensor(
        packed=pack(codes.to(torch.uint8), qcfg.bits, axis=-2),
        scale=eff_scale.to(torch.float32),
        zero=zero.to(torch.float32),
        bits=qcfg.bits,
        group_size=g,
        shape=tuple(w.shape[-2:]),
        act_scale=act_scale,
    )
