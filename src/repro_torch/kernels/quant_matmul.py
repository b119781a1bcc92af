"""Fused packed-weight dequantization + matmul (prefill-shaped), alone or
batched over the experts of an MoE layer.

Replaces the reference's Pallas kernels ``repro/kernels/quant_matmul.py``
(``quant_matmul`` and ``quant_matmul_experts``).  Both CUDA entry points
are in ``csrc/quant_matmul.cu``; its note says what bounds them on the card
and how the design answers that.  :func:`quant_matmul_plain` and
:func:`quant_matmul_experts_plain` are the same functions in plain
PyTorch: the wrappers run them for a tensor on the CPU, and
``chip_smoke.py`` holds the kernels against them on the card.

The expert functions take ``rows``, each expert's count of kept capacity
rows (an int32 ``(E,)`` tensor on x's device, as the MoE dispatch makes
it): ``out[e, m] = x[e, m] @ W[e]`` for ``m < rows[e]`` and +0 past it, so
the kernel reads no weight of an expert with no row.  The reference's
``quant_matmul_experts`` has no ``rows``; the two agree wherever x is zero
past ``rows[e]`` and the dequantized weights are finite, which is what the
dispatch's zero-filled capacity buffer gives.  ``rows=None`` keeps every
row.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.qtensor import PACK_FACTOR, unpack
from repro_torch.kernels import build


def dequantize_rows(packed: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, *, bits: int, group_size: int,
                    dtype) -> torch.Tensor:
    """(..., K, N) weight: ``(code - zero) * scale`` in f32, rounded to
    ``dtype`` (the kernels' rounding contract); leading dims (experts) are
    elementwise."""
    K = packed.shape[-2] * PACK_FACTOR[bits]
    N = packed.shape[-1]
    lead = tuple(packed.shape[:-2])
    codes = unpack(packed, bits, K, axis=-2).to(torch.float32)
    cg = codes.reshape(lead + (K // group_size, group_size, N))
    w = (cg - zero[..., :, None, :].float()) * scale[..., :, None, :].float()
    return w.reshape(lead + (K, N)).to(dtype)


def quant_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor, zero: torch.Tensor, *, bits: int,
                       group_size: int) -> torch.Tensor:
    """x (M, K) @ dequant(packed (K/ppb, N)) -> (M, N) in x.dtype, with the
    weight rounded to x.dtype before an f32-accumulated product."""
    w = dequantize_rows(packed, scale, zero, bits=bits,
                        group_size=group_size, dtype=x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def kernel_config(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                  zero: torch.Tensor, *, bits: int, group_size: int) -> dict:
    """The configuration the CUDA kernel takes for these operands, as its
    own host code chooses it (``quant_matmul_config`` in
    ``csrc/quant_matmul.cu``; launches nothing): the tile (``bm`` rows, a
    function of the shape: 8, 32, 64 or 128), the ring depth, the
    group path, the 2-bit table, which operands come by TMA, and the
    grid.  2-D
    operands name a :func:`quant_matmul` launch, 3-D ones (a leading
    expert dim) a :func:`quant_matmul_experts` launch.  CUDA tensors only."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel_config: CUDA tensors only, got {x.device}")
    E = x.shape[0] if x.ndim == 3 else 1
    M, K = x.shape[-2:]
    N = packed.shape[-1]
    cfg = (ctypes.c_int * 9)()
    lib = build.load_library()
    build.check("quant_matmul_config", lib.quant_matmul_config(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        E, M, N, K, bits, group_size, cfg))
    bn, bm, bk, stages, staged, rows, lut, x_tma, w_tma = cfg
    return {"tile": f"{bn}n x {bm}m x {bk}k", "bm": bm, "stages": stages,
            "groups": f"staged, {rows} row(s) a stage" if staged
            else "per-element", "lut": bool(lut), "x_tma": bool(x_tma),
            "w_tma": bool(w_tma), "grid": [-(-N // bn), -(-M // bm), E]}


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


def mask_rows(out: torch.Tensor, rows) -> torch.Tensor:
    """``out`` (E, M, N) with rows ``m >= rows[e]`` set to +0 (``rows=None``:
    unchanged).  Device ops only, so no host sync."""
    if rows is None:
        return out
    keep = torch.arange(out.shape[1], device=out.device) < rows[:, None]
    return torch.where(keep[..., None], out, out.new_zeros(()))


def quant_matmul_experts_plain(x: torch.Tensor, packed: torch.Tensor,
                               scale: torch.Tensor, zero: torch.Tensor, *,
                               bits: int, group_size: int,
                               rows=None) -> torch.Tensor:
    """x (E, M, K) @ dequant(packed (E, K/ppb, N)) -> (E, M, N) in x.dtype:
    :func:`quant_matmul_plain`'s arithmetic, one expert's product at a time
    (so it equals E separate plain products bit for bit), then rows past
    ``rows[e]`` masked to +0."""
    w = dequantize_rows(packed, scale, zero, bits=bits,
                        group_size=group_size, dtype=x.dtype)
    return mask_rows(torch.stack([(x[e].float() @ w[e].float()).to(x.dtype)
                                  for e in range(x.shape[0])]), rows)


def check_expert_operands(name: str, x, packed, scale, zero, bits: int,
                          group_size: int, rows=None):
    """Validates the expert-stacked contract: x (E, M, K), packed
    (E, K/ppb, N), scale/zero (E, K/g, N), and ``rows`` (None, or a
    contiguous int32 (E,) tensor on x's device; its values are not read,
    which would be a host sync).  Returns (E, M, N, K)."""
    if x.ndim != 3 or packed.ndim != 3:
        raise ValueError(f"{name}: expected expert-stacked (E, M, K) x and "
                         f"(E, K/ppb, N) packed, got {tuple(x.shape)} and "
                         f"{tuple(packed.shape)}")
    E = x.shape[0]
    if E < 1 or packed.shape[0] != E or scale.ndim != 3 or zero.ndim != 3 \
            or scale.shape[0] != E or zero.shape[0] != E:
        raise ValueError(f"{name}: expert counts differ or are zero: x "
                         f"{tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}, zero "
                         f"{tuple(zero.shape)}")
    M, N, K = check_operands(name, x[0], packed[0], scale[0], zero[0], bits,
                             group_size)
    if rows is not None:
        if rows.dtype != torch.int32:
            raise TypeError(f"{name}: rows must be int32, got {rows.dtype}")
        if tuple(rows.shape) != (E,):
            raise ValueError(f"{name}: rows of shape {tuple(rows.shape)}, "
                             f"expected ({E},)")
        if rows.device != x.device:
            raise ValueError(f"{name}: rows is on {rows.device}, x on "
                             f"{x.device}")
        if not rows.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous")
    return E, M, N, K


def quant_matmul_experts(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor, zero: torch.Tensor, *,
                         bits: int, group_size: int,
                         rows=None) -> torch.Tensor:
    """x: (E, M, K); packed: (E, K//ppb, N) uint8; scale/zero: (E, K//g, N)
    f32; rows: None or int32 (E,) kept-row counts (the kernel clamps each
    to [0, M]).  Returns (E, M, N) in x.dtype, rows past each count +0,
    every expert in ONE launch.  A CUDA tensor launches the kernel (bf16
    only); a CPU tensor runs :func:`quant_matmul_experts_plain`."""
    E, M, N, K = check_expert_operands("quant_matmul_experts", x, packed,
                                       scale, zero, bits, group_size, rows)
    if x.device.type == "cpu":
        return quant_matmul_experts_plain(x, packed, scale, zero, bits=bits,
                                          group_size=group_size, rows=rows)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul_experts: unsupported device "
                         f"{x.device}")
    check_cuda_operands("quant_matmul_experts", x, packed, scale, zero)
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = build.load_library()
    err = lib.launch_quant_matmul_experts(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(), E, M, N,
        K, bits, group_size, build.stream_ptr(x.device))
    build.check("quant_matmul_experts", err)
    build.LAUNCHES["quant_matmul_experts"] += 1
    return out


def quant_matmul_experts_unrolled(x: torch.Tensor, packed: torch.Tensor,
                                  scale: torch.Tensor, zero: torch.Tensor, *,
                                  bits: int, group_size: int,
                                  rows=None) -> torch.Tensor:
    """One :func:`quant_matmul` launch per expert, then rows past ``rows``
    masked to +0: the bit-parity oracle of :func:`quant_matmul_experts`
    (the reference's fused-vs-unrolled contract).  Takes the same
    expert-stacked operands."""
    check_expert_operands("quant_matmul_experts_unrolled", x, packed, scale,
                          zero, bits, group_size, rows)
    return mask_rows(torch.stack([
        quant_matmul(x[e], packed[e], scale[e], zero[e], bits=bits,
                     group_size=group_size)
        for e in range(x.shape[0])]), rows)
