"""QTensor: a packed, uniformly-quantized weight that drops into any matmul.

The deployment artifact of the pipeline (paper Table 8): weights live in
device memory as packed low-bit integers and are dequantized next to the
matmul (the CUDA kernels in ``repro_torch.kernels``, or the unpack path
below).  The byte layout is the reference package's, byte for byte: codes
pack along the input dim (axis -2), packed row ``r`` field ``f`` holds input
row ``k = r * ppb + f``, and 3-bit codes sit in 4-bit fields.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# values packed per uint8 container byte (3-bit codes use 4-bit fields)
PACK_FACTOR = {2: 4, 3: 2, 4: 2, 8: 1}


@dataclasses.dataclass
class QTensor:
    """Packed weight with logical shape ``shape`` — always the 2-D
    ``(in_features, out_features)`` of one weight matrix.  Leading stacked
    dims (layers) live on the tensors, never in ``shape``.

    ``packed``  uint8 (..., in_features // pack, out_features)
    ``scale``   float (..., n_groups, out_features)
    ``zero``    float (..., n_groups, out_features)   (zero point, stored float)
    ``act_scale`` optional (..., in_features) AWQ input-channel scale, applied
    as ``x / act_scale`` before the product.
    """
    packed: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    group_size: int              # == in_features for per-channel
    shape: Tuple[int, ...]
    act_scale: Optional[torch.Tensor] = None

    @property
    def in_features(self) -> int:
        return self.shape[-2]

    @property
    def out_features(self) -> int:
        return self.shape[-1]

    def layer(self, i: int) -> "QTensor":
        """Slice layer ``i`` out of a layer-stacked QTensor (views)."""
        return QTensor(self.packed[i], self.scale[i], self.zero[i], self.bits,
                       self.group_size, self.shape,
                       None if self.act_scale is None else self.act_scale[i])

    def to(self, device) -> "QTensor":
        return QTensor(self.packed.to(device), self.scale.to(device),
                       self.zero.to(device), self.bits, self.group_size,
                       self.shape,
                       None if self.act_scale is None
                       else self.act_scale.to(device))

    def memory_bytes(self) -> int:
        """Deployed weight memory: container bytes plus scale/zero at the
        dtype actually stored (f32 here), leading stacked dims included."""
        meta = (self.scale.numel() * self.scale.element_size()
                + self.zero.numel() * self.zero.element_size())
        return self.packed.numel() + meta

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Returns (*batch_dims, in_features, out_features).

        The arithmetic runs in the target dtype, as the reference does:
        scale and zero round to ``dtype`` first."""
        w_int = unpack(self.packed, self.bits, self.in_features, axis=-2)
        g = self.group_size
        ng = self.in_features // g
        bshape = tuple(self.packed.shape[:-2])
        w_int = w_int.reshape(bshape + (ng, g, self.out_features))
        scale = self.scale[..., :, None, :].to(dtype)
        zero = self.zero[..., :, None, :].to(dtype)
        w = (w_int.to(dtype) - zero) * scale
        return w.reshape(bshape + tuple(self.shape[-2:]))


def _shifts(ppb: int, fbits: int, device) -> torch.Tensor:
    return torch.arange(ppb, dtype=torch.uint8, device=device) * fbits


def pack(w_int: torch.Tensor, bits: int, axis: int = -2) -> torch.Tensor:
    """Pack integer codes (values in [0, 2^bits)) into uint8 along ``axis``."""
    ppb = PACK_FACTOR[bits]
    fbits = 8 // ppb
    axis = axis % w_int.ndim
    n = w_int.shape[axis]
    if n % ppb:
        raise ValueError(f"dim {n} not divisible by pack factor {ppb}")
    w = torch.movedim(w_int.to(torch.uint8), axis, -1)
    w = w.reshape(tuple(w.shape[:-1]) + (n // ppb, ppb))
    packed = torch.zeros(w.shape[:-1], dtype=torch.uint8, device=w.device)
    for f in range(ppb):
        packed |= w[..., f] << (f * fbits)
    return torch.movedim(packed, -1, axis).contiguous()


def unpack(packed: torch.Tensor, bits: int, n: int,
           axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack`; returns uint8 codes of size ``n`` along
    ``axis``."""
    ppb = PACK_FACTOR[bits]
    fbits = 8 // ppb
    mask = (1 << fbits) - 1
    axis = axis % packed.ndim
    shifts = _shifts(ppb, fbits, packed.device)
    if axis == packed.ndim - 2:
        p = packed[..., :, None, :]                   # (..., n/ppb, 1, N)
        vals = (p >> shifts[:, None]) & mask          # (..., n/ppb, ppb, N)
        return vals.reshape(tuple(packed.shape[:-2]) + (n, packed.shape[-1]))
    p = torch.movedim(packed, axis, -1)
    vals = (p[..., None] >> shifts) & mask            # (..., n/ppb, ppb)
    vals = vals.reshape(tuple(p.shape[:-1]) + (n,))
    return torch.movedim(vals, -1, axis)


def qmatmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x @ dequant(w): the ``"xla"`` backend's path (dequantize in the
    activation dtype, then a dense matmul)."""
    if w.act_scale is not None:
        x = x / w.act_scale.to(x.dtype)
    return x @ w.dequantize(x.dtype)
