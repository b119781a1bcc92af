"""Decode-shaped fused dequantization + GEMV (M <= 32 rows).

Replaces the reference's Pallas kernel ``repro/kernels/quant_gemv.py``
(``quant_gemv``).  The CUDA kernel is ``csrc/quant_gemv.cu``; its note says
what bounds it on the card and how the design answers that.  It computes
the same function as ``quant_matmul`` — only the shape regime differs — so
:func:`quant_gemv_plain` is the same plain PyTorch computation.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import (check_cuda_operands,
                                              check_operands,
                                              quant_matmul_plain)

# the kernel serves 1..32 rows as 1..4 tiles of 8 (rows past M are zeros
# in registers, never loaded)
MAX_ROWS = 32


def quant_gemv_plain(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                     group_size: int) -> torch.Tensor:
    """Plain version: x (M, K) @ dequant(packed) -> (M, N) in x.dtype."""
    return quant_matmul_plain(x, packed, scale, zero, bits=bits,
                              group_size=group_size)


def gemv_config(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                zero: torch.Tensor, *, bits: int, group_size: int) -> dict:
    """The configuration the CUDA kernel takes for these operands at any
    row count, as its own host code chooses it (``quant_gemv_config`` in
    ``csrc/quant_gemv.cu``; launches nothing): the column tile, the K splits
    (one thread-block cluster per column tile), the ring depth, the group
    path, the 2-bit table, and which operands come by 16-byte ``cp.async``.
    CUDA tensors only."""
    if x.device.type != "cuda":
        raise ValueError(f"gemv_config: CUDA tensors only, got {x.device}")
    K = x.shape[-1]
    N = packed.shape[-1]
    cfg = (ctypes.c_int * 12)()
    lib = build.load_library()
    build.check("quant_gemv_config", lib.quant_gemv_config(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        N, K, bits, group_size, cfg))
    (bn, splits, per, stages, mode, rows, spg, lut, w_vec, x_vec, ks,
     warps) = cfg
    return {"tile": f"{bn}n x {ks}k, {warps} warps",
            "splits": splits, "stages_per_split": per, "ring": stages,
            "groups": ("per stage", "per 16-deep chunk",
                       "per element")[mode],
            "group_rows": rows, "stages_per_group": spg, "lut": bool(lut),
            "w_async": bool(w_vec), "x_async": bool(x_vec),
            "grid": [-(-N // bn), splits]}


def quant_gemv(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
               zero: torch.Tensor, *, bits: int,
               group_size: int) -> torch.Tensor:
    """x: (M <= 32, K); packed: (K//ppb, N) uint8; scale/zero: (K//g, N) f32.
    Returns (M, N) in x.dtype.  A CUDA tensor launches the kernel (bf16
    only); a CPU tensor runs :func:`quant_gemv_plain`."""
    M, N, K = check_operands("quant_gemv", x, packed, scale, zero, bits,
                             group_size)
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"quant_gemv: M={M} rows, expected 1..{MAX_ROWS}")
    if x.device.type == "cpu":
        return quant_gemv_plain(x, packed, scale, zero, bits=bits,
                                group_size=group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quant_gemv: unsupported device {x.device}")
    check_cuda_operands("quant_gemv", x, packed, scale, zero)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = build.load_library()
    err = lib.launch_quant_gemv(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), M, N, K, bits, group_size,
        build.stream_ptr(x.device))
    build.check("quant_gemv", err)
    build.LAUNCHES["quant_gemv"] += 1
    return out
