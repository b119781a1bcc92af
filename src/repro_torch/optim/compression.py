"""Gradient compression with error feedback (the reference's
``optim/compression.py``).

``compress_decompress`` quantizes each gradient leaf to int8 with one
per-tensor scale and dequantizes it again, carrying the quantization
residual into the next step in an f32 error buffer (Seide et al.'s error
feedback), so training converges as without compression.  On a mesh it
takes the rank's slices, and each leaf's amax is MAX-all-reduced so the
scale is the whole leaf's.  ``compressed_psum`` is the int8-on-the-wire
all-reduce over one mesh axis (the reference's cross-pod sync).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adam import _pick, tree_leaves, tree_map


def _quantize_int8(g: torch.Tensor, amax=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (codes, f32 scale).  ``torch.round``
    rounds half to even, as ``jnp.round`` does.  ``amax``: the leaf's, when
    ``g`` is a slice of it."""
    if amax is None:
        amax = torch.amax(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: Any, error: Any,
                        mesh=None) -> Tuple[Any, Any]:
    """Returns (decompressed grads in each leaf's dtype, new f32 error
    feedback buffers).  On a ``mesh`` of several ranks the leaves are the
    rank's slices, and their amaxes are MAX-all-reduced over the mesh's
    ranks (its own group) in one collective (a replica's slice repeats
    another's, so the maximum is the whole leaf's)."""
    gfs = tree_map(lambda g, e: g.to(torch.float32) + e, grads, error)
    amax = None
    if mesh is not None and mesh.world > 1:
        flat = tree_leaves(gfs)
        maxes = torch.stack([torch.amax(torch.abs(g)) for g in flat])
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX,
                        group=mesh.group_of(mesh.axis_names))
        it = iter(maxes.unbind(0))
        amax = tree_map(lambda _: next(it), gfs)

    def one(g, gf, a=None):
        q, scale = _quantize_int8(gf, a)
        dq = q.to(torch.float32) * scale
        return dq.to(g.dtype), gf - dq

    out = (tree_map(one, grads, gfs) if amax is None
           else tree_map(one, grads, gfs, amax))
    return _pick(out, 0), _pick(out, 1)


def init_error(grads_like: Any) -> Any:
    """Zero f32 error buffers shaped like ``grads_like``, on its devices."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_psum(x: torch.Tensor, mesh, axis: str = "pod") -> torch.Tensor:
    """int8-on-the-wire psum over ``axis`` of ``mesh`` (a
    ``launch.mesh.Mesh``): ``x`` is the rank's block; it is quantized, the
    per-tensor scale MAX-all-reduced (one scalar), the block re-quantized
    to that shared scale, the int8 codes summed in int32 over the axis's
    ranks (no overflow: log2(127 * n) bits) and dequantized.  Returns the
    sum, as the reference's ``shard_map`` body does on each shard."""
    group = mesh.group_of(axis)
    n = mesh.size_of(axis)
    _, scale = _quantize_int8(x)
    smax = scale.clone()
    if n > 1:
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    # renormalize to the shared scale so the integer sum is exact
    q = torch.clamp(torch.round(x / smax), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    if n > 1:
        dist.all_reduce(total, group=group)
    return total.to(torch.float32) * smax
