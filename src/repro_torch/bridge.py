"""Turns the reference package's parameters into the port's tensors.

The reference's params arrive as a nested dict whose array leaves are numpy
arrays (or anything ``np.asarray`` accepts) and whose QTensor leaves are any
object with ``packed``/``scale``/``zero``/``bits``/``group_size``/``shape``/
``act_scale``.  bf16 arrays (``ml_dtypes.bfloat16``) go through float32,
which loses nothing, and come out as ``torch.bfloat16``.  This module does
not import jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor

_QT_FIELDS = ("packed", "scale", "zero", "bits", "group_size", "shape",
              "act_scale")


def to_torch(a, device="cpu") -> torch.Tensor:
    """One array -> tensor on ``device``, bf16 kept as bf16."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _is_qtensor_like(x) -> bool:
    return all(hasattr(x, f) for f in _QT_FIELDS)


def params_to_torch(tree, device="cpu"):
    """Nested dict of reference params -> the port's params on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    if _is_qtensor_like(tree):
        return QTensor(
            packed=to_torch(tree.packed, device),
            scale=to_torch(tree.scale, device),
            zero=to_torch(tree.zero, device),
            bits=int(tree.bits), group_size=int(tree.group_size),
            shape=tuple(int(d) for d in tree.shape),
            act_scale=(None if tree.act_scale is None
                       else to_torch(tree.act_scale, device)))
    return to_torch(tree, device)


def params_to(tree, device):
    """Move the port's own params (dicts of tensors / QTensors)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)
