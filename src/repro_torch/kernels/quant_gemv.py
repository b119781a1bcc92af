"""Decode-shaped fused dequantization + GEMV (M <= 32 rows, never padded).

Replaces the reference's Pallas kernel ``repro/kernels/quant_gemv.py``
(``quant_gemv``).  The CUDA kernel is ``csrc/quant_gemv.cu``; its note says
what bounds it on the card and how the design answers that.  It computes
the same function as ``quant_matmul`` — only the shape regime differs — so
:func:`quant_gemv_plain` is the same plain PyTorch computation.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import (check_cuda_operands,
                                              check_operands,
                                              quant_matmul_plain)

# the kernel's accumulator rows are a template parameter up to this count
MAX_ROWS = 32


def quant_gemv_plain(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                     group_size: int) -> torch.Tensor:
    """Plain version: x (M, K) @ dequant(packed) -> (M, N) in x.dtype."""
    return quant_matmul_plain(x, packed, scale, zero, bits=bits,
                              group_size=group_size)


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
    lib = build.load_library()
    err = lib.launch_quant_gemv(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), M, N, K, bits, group_size,
        build.stream_ptr(x.device))
    build.check("quant_gemv", err)
    build.LAUNCHES["quant_gemv"] += 1
    return out
