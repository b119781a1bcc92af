"""Integer matmul with per-token and per-channel scales (weight-activation
quantization, paper Sec. 4.2): ``out = (x_q @ w_q) * x_scale * w_scale``.

Replaces the reference's Pallas kernel ``repro/kernels/int8_matmul.py``
(``int8_matmul``).  The CUDA kernel is ``csrc/int8_matmul.cu``; its note
says what bounds it on the card and how the design answers that.
:func:`int8_matmul_plain` is the same function in plain PyTorch: the
wrapper runs it for a tensor on the CPU, and ``chip_smoke.py`` holds the
kernel against it on the card.

The accumulator is exact on both sides (int32 in the kernel; float64 of
the int8 operands in the plain version, exact because |acc| <= K * 2^14 <
2^53) and the f32 epilogue ``(acc * x_scale) * w_scale`` runs in the
reference's order, so the kernel's output is bit-identical to the plain
version's.  Unlike the reference, which asserts that M, N and K divide its
blocks, the kernel masks ragged edges itself, and ``x_q`` may be a column
slice of a wider matrix (a row stride ``lda`` >= K), so ``ops.w4a8_matmul``
passes its per-group slices without a copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

OUT_DTYPES = (torch.bfloat16, torch.float32)

# |acc| <= K * 128 * 128 must fit the kernel's int32 accumulator
MAX_K = (2 ** 31 - 1) // (128 * 128)


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor, *,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: exact integer accumulator (float64 of the int8
    operands, so it runs on the card too), then ``(acc.float() * x_scale) *
    w_scale`` in f32, cast to ``out_dtype``."""
    acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    out = (acc.to(torch.float32) * x_scale.float()) * w_scale.float()
    return out.to(out_dtype)


def check_operands(name: str, x_q, w_q, x_scale, w_scale, out_dtype):
    """Validates the (x_q, w_q, x_scale, w_scale) contract; returns
    (M, N, K, lda)."""
    if x_q.ndim != 2 or w_q.ndim != 2:
        raise ValueError(f"{name}: expected 2-D x_q and w_q, got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    M, K = x_q.shape
    N = w_q.shape[1]
    if w_q.shape[0] != K:
        raise ValueError(f"{name}: x_q is {tuple(x_q.shape)} but w_q is "
                         f"{tuple(w_q.shape)}")
    if K > MAX_K:
        raise ValueError(f"{name}: K={K} could overflow the int32 "
                         f"accumulator (at most {MAX_K})")
    for nm, t in (("x_q", x_q), ("w_q", w_q)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: {nm} must be int8, got {t.dtype}")
    if tuple(x_scale.shape) != (M, 1) or tuple(w_scale.shape) != (1, N):
        raise ValueError(f"{name}: x_scale {tuple(x_scale.shape)} / w_scale "
                         f"{tuple(w_scale.shape)}, expected ({M}, 1) / "
                         f"(1, {N})")
    for nm, t in (("x_scale", x_scale), ("w_scale", w_scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {nm} must be float32, got {t.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype must be one of {OUT_DTYPES}, "
                        f"got {out_dtype}")
    dev = x_q.get_device()  # an int: cheaper than comparing torch.device
    for nm, t in (("w_q", w_q), ("x_scale", x_scale), ("w_scale", w_scale)):
        if t.get_device() != dev:
            raise ValueError(f"{name}: {nm} is on {t.device}, x_q on "
                             f"{x_q.device}")
    lda = x_q.stride(0) if M > 1 else K
    if x_q.stride(1) != 1 or lda < K:
        raise ValueError(f"{name}: x_q rows must be unit-stride with a row "
                         f"stride >= K, got strides {x_q.stride()}")
    for nm, t in (("w_q", w_q), ("x_scale", x_scale), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    return M, N, K, lda


def int8_matmul_config(x_q: torch.Tensor, w_q: torch.Tensor) -> dict:
    """The plan the CUDA kernel takes for these operands, as its own host
    code chooses it (``int8_matmul_config`` in ``csrc/int8_matmul.cu``;
    launches nothing): the m tile (16 at M <= 16: the decode plan; else the
    main plan), the n tile, the K bytes a stage and the ring's stages, the
    split of K (blocks per thread-block cluster) and the K stages, the
    output tiles, whether x and w come by TMA (else by plain loads), and
    the SM count the split is sized for (the H100 SXM's 132, whatever the
    card).  A function of (M, N, K, lda) and of the bases' alignment.  CUDA
    tensors only."""
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul_config: CUDA tensors only, got "
                         f"{x_q.device}")
    M, K = x_q.shape
    N = w_q.shape[1]
    lda = x_q.stride(0) if M > 1 else K
    cfg = (ctypes.c_int * 11)()
    lib = build.load_library()
    build.check("int8_matmul_config", lib.int8_matmul_config(
        x_q.data_ptr(), w_q.data_ptr(), M, N, K, lda, cfg))
    bm, bn, bk, stages, splits, kt, mt, nt, x_tma, w_tma, sms = cfg
    return {"plan": "decode" if bm == 16 else "main", "bm": bm, "bn": bn,
            "bk": bk, "stages": stages, "splits": splits, "k_stages": kt,
            "blocks": splits * mt * nt, "x_tma": bool(x_tma),
            "w_tma": bool(w_tma), "split_for_sms": sms}


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x_q: (M, K) int8 with unit column stride (row stride ``lda`` >= K);
    w_q: (K, N) int8; x_scale: (M, 1) f32 per token; w_scale: (1, N) f32
    per channel.  Returns (M, N) ``out_dtype`` (bf16 or f32).  A CUDA
    tensor launches the kernel; a CPU tensor runs
    :func:`int8_matmul_plain`."""
    M, N, K, lda = check_operands("int8_matmul", x_q, w_q, x_scale, w_scale,
                                  out_dtype)
    dev = x_q.device
    if dev.type == "cpu":
        return int8_matmul_plain(x_q, w_q, x_scale, w_scale,
                                 out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {dev}")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return out
    lib = build.load_library()
    err = lib.launch_int8_matmul(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), M, N, K, lda,
        int(out_dtype == torch.float32), build.stream_ptr(dev))
    build.check("int8_matmul", err)
    build.LAUNCHES["int8_matmul"] += 1
    return out
