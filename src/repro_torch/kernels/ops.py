"""Dispatch glue between the model code and the quantized-matmul kernels.

``qtensor_matmul`` is the QTensor consumer of the ``"pallas"`` backend:
decode-sized batches (at most ``DECODE_GEMV_MAX_ROWS`` flattened rows, one
token per live slot) go to the GEMV kernel, prefill-sized ones to the tiled
quant-matmul kernel.  ``qtensor_expert_matmul`` is the MoE consumer: the
(E, C, K) capacity buffers against an expert-stacked QTensor, every expert
in one expert-batched launch, at decode too (no GEMV dispatch, as in the
reference).  The kernels mask ragged edges themselves, so none of the
reference's padding glue is needed here.
"""
from __future__ import annotations

import torch

from repro_torch.core.qtensor import QTensor
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


def qtensor_expert_matmul(a: torch.Tensor, w: QTensor) -> torch.Tensor:
    """(E, C, K) x expert-stacked QTensor -> (E, C, N) in ONE expert-batched
    kernel launch."""
    x, packed, scale, zero = _expert_operands(a, w)
    return quant_matmul_experts(x, packed, scale, zero, bits=w.bits,
                                group_size=w.group_size)


def qtensor_expert_matmul_unrolled(a: torch.Tensor,
                                   w: QTensor) -> torch.Tensor:
    """One ``quant_matmul`` launch per expert: the bit-parity oracle of
    :func:`qtensor_expert_matmul` (the reference's ``ops.py``
    counterpart)."""
    x, packed, scale, zero = _expert_operands(a, w)
    return quant_matmul_experts_unrolled(x, packed, scale, zero, bits=w.bits,
                                         group_size=w.group_size)
