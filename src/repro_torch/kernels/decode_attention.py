"""Slot-aware single-token decode attention over the dense slot-major cache.

Replaces the reference's Pallas kernel ``repro/kernels/decode_attention.py``
(``decode_attention``).  The CUDA kernel is ``csrc/decode_attention.cu``;
its note says what bounds it on the card and how the design answers that.
:func:`decode_attention_plain` is the same function in plain PyTorch.

Layouts are the reference's: q (B, Hkv, G, D) with the G query rows of each
KV head together, k/v (B, S, Hkv, D) read in place from the cache.  Slot b
sees positions t < min(kv_len[b], q_pos[b] + 1); an inactive slot, or one
with no visible position, returns exact zeros.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

_NEG_INF = -1e30


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, kv_len: torch.Tensor, q_pos: torch.Tensor,
                           active: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Dense masked softmax in f32 over all S positions; returns q.dtype."""
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    scale = float(D) ** -0.5 if scale is None else scale
    qf = q.float() * scale
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    kpos = torch.arange(S, device=q.device)
    mask = (kpos[None, :] < kv_len[:, None]) & (kpos[None, :] <= q_pos[:, None])
    s = torch.where(mask[:, None, None, :], s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / l
    live = mask.any(dim=-1)
    if active is not None:
        live = live & (active > 0)
    out = torch.where(live[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


def _check(q, k, v, kv_len, q_pos, active):
    if q.ndim != 4:
        raise ValueError(f"decode_attention: q must be (B, Hkv, G, D), got "
                         f"{tuple(q.shape)}")
    B, Hkv, G, D = q.shape
    S = k.shape[1] if k.ndim == 4 else -1
    if tuple(k.shape) != (B, S, Hkv, D) or tuple(v.shape) != (B, S, Hkv, D):
        raise ValueError(f"decode_attention: cache-lane layout mismatch: q "
                         f"{tuple(q.shape)} vs k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)}")
    for nm, t in (("kv_len", kv_len), ("q_pos", q_pos), ("active", active)):
        if t is not None and tuple(t.shape) != (B,):
            raise ValueError(f"decode_attention: {nm} must be ({B},), got "
                             f"{tuple(t.shape)}")
    return B, S, Hkv, G, D


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: torch.Tensor, q_pos: torch.Tensor,
                     active: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hkv, G, D); k/v (B, S, Hkv, D); kv_len/q_pos/active (B,).
    Returns (B, Hkv, G, D) in q.dtype.  A CUDA tensor launches the kernel
    (bf16 q/k/v); a CPU tensor runs :func:`decode_attention_plain`."""
    B, S, Hkv, G, D = _check(q, k, v, kv_len, q_pos, active)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len=kv_len, q_pos=q_pos,
                                      active=active, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention: the CUDA kernel takes bf16 "
                            f"{nm}, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {nm} must be contiguous on "
                             f"{q.device}")
    scale = float(D) ** -0.5 if scale is None else float(scale)
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    q_pos = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
    active = (torch.ones((B,), dtype=torch.int32, device=q.device)
              if active is None
              else active.to(device=q.device, dtype=torch.int32).contiguous())
    out = torch.empty_like(q)
    if B * Hkv * G * D == 0:
        return out
    lib = build.load_library()
    err = lib.launch_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        q_pos.data_ptr(), active.data_ptr(), out.data_ptr(),
        B, S, Hkv, G, D, scale, build.stream_ptr(q.device))
    build.check("decode_attention", err)
    build.LAUNCHES["decode_attention"] += 1
    return out
