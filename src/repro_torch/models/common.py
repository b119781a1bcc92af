"""Shared forward context and cache plumbing for the model code.

The decode cache is a dict of leaves stacked ``(layers, slots, max_seq,
kv_heads, head_dim)`` — the reference's dense slot-major layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.qtensor import QTensor


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call forward context.

    ``kernel_backend`` is the per-call QTensor dispatch: "xla" (dequantize
    + dense matmul; dense masked-softmax decode attention) or "pallas" (the
    hand-written kernels; their plain versions on a CPU tensor).  ``None``
    falls back to ``resolve_backend``'s default.  ``attn_chunk`` is the KV
    chunk of the prefill online softmax.
    """
    kernel_backend: Optional[str] = None
    attn_chunk: int = 512


DEFAULT_CTX = Ctx()

_CTX_FIELDS = {f.name for f in dataclasses.fields(Ctx)}


def make_ctx(**fields) -> Ctx:
    """THE :class:`Ctx` constructor for every serving call site: validates
    the fields and rejects unknown names (the reference's per-token
    activation quantization, int8 KV cache and page size are not ported
    yet, so they are unknown here)."""
    unknown = set(fields) - _CTX_FIELDS
    if unknown:
        raise TypeError(f"make_ctx: unknown Ctx field(s) {sorted(unknown)}; "
                        f"valid fields: {sorted(_CTX_FIELDS)}")
    backend = fields.get("kernel_backend")
    if backend is not None and backend not in ("xla", "pallas"):
        raise ValueError(f"make_ctx: unknown kernel_backend {backend!r} "
                         f"(expected 'xla', 'pallas' or None)")
    if fields.get("attn_chunk", 512) < 1:
        raise ValueError(f"make_ctx: attn_chunk must be >= 1, got "
                         f"{fields['attn_chunk']}")
    return Ctx(**fields)


def take_layer(params, i):
    """Slice layer ``i`` out of stacked (L, ...) block params (views)."""
    if isinstance(params, dict):
        return {k: take_layer(v, i) for k, v in params.items()}
    if isinstance(params, QTensor):
        return params.layer(i)
    return params[i]


def update_cache(cache_k, cache_v, k, v, pos):
    """Insert k, v (B, S_new, H, D) into caches (B, S_max, H, D) at ``pos``.

    ``pos`` is (B,) per-request write offsets.  The write is IN PLACE: the
    cache tensors (often views into the layer-stacked cache) are updated and
    returned, where the reference builds new arrays."""
    B, S_new = k.shape[0], k.shape[1]
    b = torch.arange(B, device=k.device)[:, None]
    idx = pos[:, None] + torch.arange(S_new, device=k.device)[None, :]
    cache_k[b, idx] = k.to(cache_k.dtype)
    cache_v[b, idx] = v.to(cache_v.dtype)
    return cache_k, cache_v
