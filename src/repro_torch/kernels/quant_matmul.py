"""Fused packed-weight dequantization + matmul (prefill-shaped).

Replaces the reference's Pallas kernel ``repro/kernels/quant_matmul.py``
(``quant_matmul``).  The CUDA kernel is ``csrc/quant_matmul.cu``; its note
says what bounds it on the card and how the design answers that.
:func:`quant_matmul_plain` is the same function in plain PyTorch: the
wrapper runs it for a tensor on the CPU, and ``chip_smoke.py`` holds the
kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.qtensor import PACK_FACTOR, unpack
from repro_torch.kernels import build


def dequantize_rows(packed: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, *, bits: int, group_size: int,
                    dtype) -> torch.Tensor:
    """(K, N) weight: ``(code - zero) * scale`` in f32, rounded to ``dtype``
    (the kernels' rounding contract)."""
    K = packed.shape[0] * PACK_FACTOR[bits]
    codes = unpack(packed, bits, K, axis=0).to(torch.float32)
    cg = codes.reshape(K // group_size, group_size, -1)
    w = (cg - zero[:, None, :].float()) * scale[:, None, :].float()
    return w.reshape(K, -1).to(dtype)


def quant_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                       group_size: int) -> torch.Tensor:
    """x (M, K) @ dequant(packed (K/ppb, N)) -> (M, N) in x.dtype, with the
    weight rounded to x.dtype before an f32-accumulated product."""
    w = dequantize_rows(packed, scale, zero, bits=bits,
                        group_size=group_size, dtype=x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def check_operands(name: str, x, packed, scale, zero, bits: int,
                   group_size: int):
    """Validates the (x, packed, scale, zero) contract; returns (M, N, K)."""
    if bits not in PACK_FACTOR:
        raise ValueError(f"{name}: unsupported bits {bits}")
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"{name}: expected 2-D x and packed, got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    M, K = x.shape
    N = packed.shape[1]
    ppb = PACK_FACTOR[bits]
    if K % ppb or packed.shape[0] != K // ppb:
        raise ValueError(f"{name}: packed rows {packed.shape[0]} inconsistent "
                         f"with K={K} at {bits} bits (expected {K // ppb})")
    if group_size < 1 or K % group_size:
        raise ValueError(f"{name}: group_size {group_size} does not divide "
                         f"K={K}")
    want = (K // group_size, N)
    if tuple(scale.shape) != want or tuple(zero.shape) != want:
        raise ValueError(f"{name}: scale/zero shapes {tuple(scale.shape)}/"
                         f"{tuple(zero.shape)}, expected {want}")
    return M, N, K


def check_cuda_operands(name: str, x, packed, scale, zero) -> None:
    """What the CUDA kernels take: bf16 x, uint8 codes, f32 scale/zero, all
    contiguous on x's device."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 activations, "
                        f"got {x.dtype}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"{name}: packed must be uint8, got {packed.dtype}")
    for nm, t in (("scale", scale), ("zero", zero)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {nm} must be float32, got {t.dtype}")
    for nm, t in (("x", x), ("packed", packed), ("scale", scale),
                  ("zero", zero)):
        if t.device != x.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")


def quant_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, *, bits: int,
                 group_size: int) -> torch.Tensor:
    """x: (M, K); packed: (K//ppb, N) uint8; scale/zero: (K//g, N) f32.
    Returns (M, N) in x.dtype.  A CUDA tensor launches the kernel (bf16
    only); a CPU tensor runs :func:`quant_matmul_plain`."""
    M, N, K = check_operands("quant_matmul", x, packed, scale, zero, bits,
                             group_size)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, packed, scale, zero, bits=bits,
                                  group_size=group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    check_cuda_operands("quant_matmul", x, packed, scale, zero)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = build.load_library()
    err = lib.launch_quant_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), M, N, K, bits, group_size,
        build.stream_ptr(x.device))
    build.check("quant_matmul", err)
    build.LAUNCHES["quant_matmul"] += 1
    return out
