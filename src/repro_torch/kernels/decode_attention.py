"""Slot-aware single-token decode attention over the dense slot-major cache
and over a paged KV pool.

Replaces the reference's Pallas kernels ``repro/kernels/decode_attention.py``
(``decode_attention`` and ``paged_decode_attention``).  Both CUDA kernels
are one template in ``csrc/decode_attention.cu``; its note says what bounds
them on the card and how the design answers that.
:func:`decode_attention_plain` and :func:`paged_decode_attention_plain` are
the same functions in plain PyTorch.

Layouts are the reference's: q (B, Hkv, G, D) with the G query rows of each
KV head together, k/v (B, S, Hkv, D) read in place from the cache, or k/v
pools (P, psz, Hkv, D) read through a (B, W) page table.  Slot b sees
positions t < min(kv_len[b], q_pos[b] + 1); an inactive slot, or one with
no visible position, returns exact zeros.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.models.common import gather_pages

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


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, ptab: torch.Tensor, *,
                                 kv_len: torch.Tensor, q_pos: torch.Tensor,
                                 active: Optional[torch.Tensor] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """:func:`decode_attention_plain` on the gathered virtual cache."""
    return decode_attention_plain(q, gather_pages(k_pool, ptab),
                                  gather_pages(v_pool, ptab), kv_len=kv_len,
                                  q_pos=q_pos, active=active, scale=scale)


def _check_cuda(name, q, k, v):
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bf16 {nm}, got "
                            f"{t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous on {q.device}")


def _i32(t, dev):
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _slot_args(B, dev, kv_len, q_pos, active):
    """kv_len, q_pos, active as contiguous int32 on ``dev`` (no-ops when
    they already are)."""
    act = (torch.ones((B,), dtype=torch.int32, device=dev) if active is None
           else _i32(active, dev))
    return _i32(kv_len, dev), _i32(q_pos, dev), act


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
    _check_cuda("decode_attention", q, k, v)
    scale = float(D) ** -0.5 if scale is None else float(scale)
    kv_len, q_pos, active = _slot_args(B, q.device, kv_len, q_pos, active)
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


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, ptab: torch.Tensor, *,
                           kv_len: torch.Tensor, q_pos: torch.Tensor,
                           active: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hkv, G, D); k_pool/v_pool (P, psz, Hkv, D); ptab (B, W) with
    logical page j of slot b in pool page ``ptab[b, j]`` (W * psz is the
    logical width); kv_len/q_pos/active (B,).  Returns (B, Hkv, G, D) in
    q.dtype.  A CUDA tensor launches the kernel (bf16 q/k/v), which reads
    only the table entries of positions each slot can see; a CPU tensor runs
    :func:`paged_decode_attention_plain`."""
    if q.ndim != 4 or k_pool.ndim != 4:
        raise ValueError(f"paged_decode_attention: q must be (B, Hkv, G, D) "
                         f"and the pools (P, psz, Hkv, D), got q "
                         f"{tuple(q.shape)}, k {tuple(k_pool.shape)}")
    B, Hkv, G, D = q.shape
    P, psz = k_pool.shape[0], k_pool.shape[1]
    if (tuple(k_pool.shape) != (P, psz, Hkv, D)
            or tuple(v_pool.shape) != (P, psz, Hkv, D)):
        raise ValueError(f"paged_decode_attention: pool layout mismatch: q "
                         f"{tuple(q.shape)} vs k {tuple(k_pool.shape)} / v "
                         f"{tuple(v_pool.shape)}")
    if ptab.ndim != 2 or ptab.shape[0] != B:
        raise ValueError(f"paged_decode_attention: ptab {tuple(ptab.shape)} "
                         f"is not (B={B}, W)")
    W = ptab.shape[1]
    for nm, t in (("kv_len", kv_len), ("q_pos", q_pos), ("active", active)):
        if t is not None and tuple(t.shape) != (B,):
            raise ValueError(f"paged_decode_attention: {nm} must be ({B},), "
                             f"got {tuple(t.shape)}")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, ptab,
                                            kv_len=kv_len, q_pos=q_pos,
                                            active=active, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    _check_cuda("paged_decode_attention", q, k_pool, v_pool)
    scale = float(D) ** -0.5 if scale is None else float(scale)
    ptab = _i32(ptab, q.device)
    kv_len, q_pos, active = _slot_args(B, q.device, kv_len, q_pos, active)
    out = torch.empty_like(q)
    if B * Hkv * G * D == 0:
        return out
    lib = build.load_library()
    err = lib.launch_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptab.data_ptr(),
        kv_len.data_ptr(), q_pos.data_ptr(), active.data_ptr(),
        out.data_ptr(), B, W, psz, Hkv, G, D, scale,
        build.stream_ptr(q.device))
    build.check("paged_decode_attention", err)
    build.LAUNCHES["paged_decode_attention"] += 1
    return out
