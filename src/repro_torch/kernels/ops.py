"""Dispatch glue between the model code and the quantized-matmul kernels.

``qtensor_matmul`` is the QTensor consumer of the ``"pallas"`` backend:
decode-sized batches (at most ``DECODE_GEMV_MAX_ROWS`` flattened rows, one
token per live slot) go to the GEMV kernel, prefill-sized ones to the tiled
quant-matmul kernel.  ``qtensor_expert_matmul`` is the MoE consumer: the
(E, C, K) capacity buffers against an expert-stacked QTensor, every expert
in one expert-batched launch, at decode too (no GEMV dispatch, as in the
reference).  ``w4a8_matmul`` is the weight-activation entry point:
per-token activation quantization, then the integer kernel against a
QTensor's codes.  The kernels mask ragged edges themselves, so none of the
reference's padding glue is needed here.
"""
from __future__ import annotations

import torch

from repro_torch.core.qtensor import QTensor, unpack
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.quant_gemv import quant_gemv
from repro_torch.kernels.quant_matmul import (
    quant_matmul, quant_matmul_experts, quant_matmul_experts_unrolled)

# decode batches (M = live slots) at or below this row count dispatch to the
# decode-shaped GEMV kernel instead of the prefill-tiled matmul
DECODE_GEMV_MAX_ROWS = 32


def qtensor_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x: (..., K) x QTensor -> (..., N) through the kernels.  ``act_scale``
    is divided out of x here, outside the kernel."""
    if w.act_scale is not None:
        x = x / w.act_scale.to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    scale = w.scale.to(torch.float32).contiguous()
    zero = w.zero.to(torch.float32).contiguous()
    fn = quant_gemv if x2.shape[0] <= DECODE_GEMV_MAX_ROWS else quant_matmul
    out = fn(x2, w.packed.contiguous(), scale, zero, bits=w.bits,
             group_size=w.group_size)
    return out.reshape(*lead, w.out_features)


def _expert_operands(a: torch.Tensor, w: QTensor):
    if w.act_scale is not None:
        a = a / w.act_scale.to(a.dtype)
    return (a.contiguous(), w.packed.contiguous(),
            w.scale.to(torch.float32).contiguous(),
            w.zero.to(torch.float32).contiguous())


def qtensor_expert_matmul(a: torch.Tensor, w: QTensor,
                          rows=None) -> torch.Tensor:
    """(E, C, K) x expert-stacked QTensor -> (E, C, N) in ONE expert-batched
    kernel launch; ``rows`` (int32 (E,), or None) are the dispatch's row
    counts, clamped to C: rows past them come out +0 and an expert with
    none reads no weight."""
    x, packed, scale, zero = _expert_operands(a, w)
    return quant_matmul_experts(x, packed, scale, zero, bits=w.bits,
                                group_size=w.group_size, rows=rows)


def qtensor_expert_matmul_unrolled(a: torch.Tensor, w: QTensor,
                                   rows=None) -> torch.Tensor:
    """One ``quant_matmul`` launch per expert, then rows past ``rows``
    masked: the bit-parity oracle of :func:`qtensor_expert_matmul` (the
    reference's ``ops.py`` counterpart)."""
    x, packed, scale, zero = _expert_operands(a, w)
    return quant_matmul_experts_unrolled(x, packed, scale, zero, bits=w.bits,
                                         group_size=w.group_size, rows=rows)


def quantize_per_token(x: torch.Tensor, bits: int = 8):
    """Symmetric per-token activation quantization -> (int8 codes (..., K),
    f32 scales (..., 1)): the reference's ``ref.quantize_per_token_ref``.
    It quantizes exactly as the symmetric ``layers.fake_quant_act`` at the
    same ``bits`` does."""
    qmax = (1 << (bits - 1)) - 1
    amax = torch.amax(torch.abs(x.float()), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale


# the reference's name for the integer-matmul entry point
int8_matmul_op = int8_matmul


def centered_codes(w: QTensor) -> torch.Tensor:
    """A QTensor's codes unpacked and recentred by 128 into int8 (K, N),
    exactly: code - 128 as int8 is the code's byte with its top bit
    flipped."""
    codes = unpack(w.packed, w.bits, w.in_features, axis=-2)   # uint8
    return torch.bitwise_xor(codes, 128).view(torch.int8)


def w4a8_matmul(x: torch.Tensor, w: QTensor, act_bits: int = 8
                ) -> torch.Tensor:
    """Dynamic per-token activation quant + integer matmul against a QTensor
    (the reference's ``ops.w4a8_matmul``, step for step).

    Codes are recentred by 128 into int8 (exact); the zero point comes back
    through the rank-1 correction ``rowsum(x_q) * x_scale * (128 - zero) *
    scale`` in the f32 epilogue.  Per-channel weights (group_size == K) take
    one ``int8_matmul`` launch; grouped weights one launch plus one
    correction per group (the scale changes along K), each on a column slice
    of the codes, accumulated as ``out = out + part + corr``.

    Raises ``ValueError`` on a stacked QTensor (as the reference does) and
    on one with an AWQ ``act_scale``: the reference's ``w4a8_matmul`` never
    reads ``act_scale`` and so computes ``x @ (s * W)`` where
    ``qtensor_matmul`` computes ``(x / s) @ (s * W)``; the port neither
    repeats that product nor silently corrects it."""
    if w.packed.ndim != 2:
        raise ValueError("w4a8_matmul expects a single (non-stacked) QTensor, "
                         f"got packed.ndim={w.packed.ndim}")
    if w.act_scale is not None:
        raise ValueError(
            "w4a8_matmul: the QTensor carries an AWQ act_scale, which the "
            "reference's w4a8_matmul ignores (it would compute x @ (s*W), "
            "not (x/s) @ (s*W)); refusing rather than repeating or silently "
            "fixing that fault")
    K, N, g = w.in_features, w.out_features, w.group_size
    x_q, x_scale = quantize_per_token(x.reshape(-1, x.shape[-1]), act_bits)
    w_centered = centered_codes(w)
    scale = w.scale.to(torch.float32).contiguous()            # (K // g, N)
    zero = w.zero.to(torch.float32)
    x_q_f = x_q.to(torch.float32)
    out = torch.zeros((x_q.shape[0], N), dtype=torch.float32,
                      device=x.device)
    for gi in range(K // g):
        sl = slice(gi * g, (gi + 1) * g)
        part = int8_matmul(x_q[:, sl], w_centered[sl], x_scale,
                           scale[gi:gi + 1], out_dtype=torch.float32)
        rowsum = torch.sum(x_q_f[:, sl], dim=-1, keepdim=True)
        corr = (rowsum * x_scale) * ((128.0 - zero[gi:gi + 1])
                                     * scale[gi:gi + 1])
        out = out + part + corr
    return out.to(x.dtype).reshape(*x.shape[:-1], N)
