"""Gradient compression with error feedback (the reference's
``optim/compression.py``).

``compress_decompress`` quantizes each gradient leaf to int8 with one
per-tensor scale and dequantizes it again, carrying the quantization
residual into the next step in an f32 error buffer (Seide et al.'s error
feedback), so training converges as without compression.  On one device it
changes only the values; the bytes it saves are the cross-pod all-reduce's,
which ``compressed_psum`` performs over a mesh and which waits for the
port's parallel modes.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adam import _pick, tree_map


def _quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (codes, f32 scale).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Returns (decompressed grads in each leaf's dtype, new f32 error
    feedback buffers)."""
    def one(g, e):
        gf = g.to(torch.float32) + e
        q, scale = _quantize_int8(gf)
        dq = q.to(torch.float32) * scale
        return dq.to(g.dtype), gf - dq

    out = tree_map(one, grads, error)
    return _pick(out, 0), _pick(out, 1)


def init_error(grads_like: Any) -> Any:
    """Zero f32 error buffers shaped like ``grads_like``, on its devices."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_psum(x, mesh, axis: str = "pod"):
    """The int8-on-the-wire all-reduce over a mesh axis: needs the port's
    parallel modes."""
    raise NotImplementedError(
        "compressed_psum needs a device mesh (ROADMAP queue 1, "
        "'Parallelism on torch.distributed')")
