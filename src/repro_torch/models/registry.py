"""Uniform model API: ``get_model(cfg)`` returns a ``Model`` with
    init_params(seed, device) -> params
    prefill(params, batch, cache, ctx, start_pos, ptab) -> (logits, cache)
    decode_step(params, cache, tokens, pos, ctx, active, ptab) -> (logits, cache)
    init_cache(batch, max_seq, dtype, device) -> cache
    loss_fn(params, batch, ctx) -> scalar next-token cross entropy
    cache_spec: CacheSpec                          (declared cache layout)
for every family of the reference: ``dense``, ``moe``, ``vlm``, ``rwkv``,
``hybrid`` and ``encdec``.  Batches are dicts: {"tokens", optional
"loss_mask"}, plus "patches" (B, P, d) for the VLM and "frames" (B,
frontend_len, d) for the encoder-decoder.  ``ptab`` is the per-slot page
table a paged ``CacheStore`` threads through prefill and decode; dense runs
pass None and families without token leaves ignore it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, rwkv, transformer, vlm
from repro_torch.models.common import (CacheSpec, DEFAULT_CTX, LEAF_FIXED,
                                       LEAF_STATE, LEAF_TOKEN, LeafSpec)

_TOKEN = LeafSpec(LEAF_TOKEN, token_axis=2)
_STATE = LeafSpec(LEAF_STATE)
_FIXED = LeafSpec(LEAF_FIXED)

# Family cache contracts.  dense: every per-position op is row-independent,
# so prefill can stop and resume at any boundary, and full prompt-prefix
# pages hold KV determined solely by the shared tokens -> both True.  moe:
# expert capacity dispatch couples sequence positions (tokens compete for
# per-expert capacity within one prefill call), so splitting prefill
# changes outputs -> neither.  rwkv / hybrid: the recurrent state (wkv,
# mamba conv + ssm) summarizes the whole past and prefill cannot restart
# mid-sequence -> neither.  encdec: decoder positions are resumable in
# principle, but prefill also builds the cross-attention cache from the
# encoder pass -> kept whole-prefill, never shared.  vlm: the image-patch
# prefix (prefix-LM mask) complicates chunk boundaries, and patch
# embeddings are not captured by prompt-token identity -> neither.
CACHE_SPECS = {
    "dense": CacheSpec("dense", (("k", _TOKEN), ("v", _TOKEN)),
                       chunkable=True, shareable=True),
    "moe": CacheSpec("moe", (("k", _TOKEN), ("v", _TOKEN))),
    "rwkv": CacheSpec("rwkv", (("shift1", _STATE), ("shift2", _STATE),
                               ("wkv", _STATE))),
    "hybrid": CacheSpec("hybrid", (("attn_k", _TOKEN), ("attn_v", _TOKEN),
                                   ("mamba/conv", _STATE),
                                   ("mamba/ssm", _STATE))),
    "encdec": CacheSpec("encdec", (("self_k", _TOKEN), ("self_v", _TOKEN),
                                   ("cross_k", _FIXED), ("cross_v", _FIXED))),
    "vlm": CacheSpec("vlm", (("k", _TOKEN), ("v", _TOKEN))),
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    loss_fn: Callable
    cache_spec: CacheSpec


def get_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam not in CACHE_SPECS:
        raise ValueError(f"unknown family {fam!r}")
    spec = CACHE_SPECS[fam]
    if fam in ("dense", "moe"):
        return Model(
            cfg,
            init_params=lambda seed, device="cuda":
                transformer.init_params(cfg, seed, device),
            prefill=lambda p, b, c, ctx=DEFAULT_CTX, start_pos=0, ptab=None:
                transformer.prefill(p, cfg, b["tokens"], c, ctx,
                                    start_pos=start_pos, ptab=ptab),
            decode_step=lambda p, c, t, pos, ctx=DEFAULT_CTX, active=None,
            ptab=None: transformer.decode_step(p, cfg, c, t, pos, ctx,
                                               active=active, ptab=ptab),
            init_cache=lambda batch, max_seq, dtype=torch.bfloat16,
            device="cuda": transformer.init_cache(cfg, batch, max_seq, dtype,
                                                  device),
            loss_fn=lambda p, b, ctx=DEFAULT_CTX:
                transformer.loss_fn(p, cfg, b, ctx),
            cache_spec=spec,
        )
    if fam == "rwkv":
        return Model(
            cfg,
            init_params=lambda seed, device="cuda":
                rwkv.init_params(cfg, seed, device),
            prefill=lambda p, b, c, ctx=DEFAULT_CTX, start_pos=0, ptab=None:
                rwkv.prefill(p, cfg, b["tokens"], c, ctx),
            decode_step=lambda p, c, t, pos, ctx=DEFAULT_CTX, active=None,
            ptab=None: rwkv.decode_step(p, cfg, c, t, pos, ctx,
                                        active=active),
            init_cache=lambda batch, max_seq, dtype=torch.bfloat16,
            device="cuda": rwkv.init_cache(cfg, batch, max_seq, dtype,
                                           device),
            loss_fn=lambda p, b, ctx=DEFAULT_CTX: rwkv.loss_fn(p, cfg, b, ctx),
            cache_spec=spec,
        )
    if fam == "hybrid":
        return Model(
            cfg,
            init_params=lambda seed, device="cuda":
                hybrid.init_params(cfg, seed, device),
            prefill=lambda p, b, c, ctx=DEFAULT_CTX, start_pos=0, ptab=None:
                hybrid.prefill(p, cfg, b["tokens"], c, ctx, ptab=ptab),
            decode_step=lambda p, c, t, pos, ctx=DEFAULT_CTX, active=None,
            ptab=None: hybrid.decode_step(p, cfg, c, t, pos, ctx,
                                          active=active, ptab=ptab),
            init_cache=lambda batch, max_seq, dtype=torch.bfloat16,
            device="cuda": hybrid.init_cache(cfg, batch, max_seq, dtype,
                                             device),
            loss_fn=lambda p, b, ctx=DEFAULT_CTX:
                hybrid.loss_fn(p, cfg, b, ctx),
            cache_spec=spec,
        )
    if fam == "encdec":
        return Model(
            cfg,
            init_params=lambda seed, device="cuda":
                encdec.init_params(cfg, seed, device),
            prefill=lambda p, b, c, ctx=DEFAULT_CTX, start_pos=0, ptab=None:
                encdec.prefill(p, cfg, encdec.frames_of(b), b["tokens"], c,
                               ctx, ptab=ptab),
            decode_step=lambda p, c, t, pos, ctx=DEFAULT_CTX, active=None,
            ptab=None: encdec.decode_step(p, cfg, c, t, pos, ctx,
                                          active=active, ptab=ptab),
            init_cache=lambda batch, max_seq, dtype=torch.bfloat16,
            device="cuda": encdec.init_cache(cfg, batch, max_seq, dtype,
                                             device),
            loss_fn=lambda p, b, ctx=DEFAULT_CTX:
                encdec.loss_fn(p, cfg, b, ctx),
            cache_spec=spec,
        )
    return Model(                                            # vlm
        cfg,
        init_params=lambda seed, device="cuda":
            vlm.init_params(cfg, seed, device),
        prefill=lambda p, b, c, ctx=DEFAULT_CTX, start_pos=0, ptab=None:
            vlm.prefill(p, cfg, vlm.patches_of(b), b["tokens"], c, ctx,
                        ptab=ptab),
        decode_step=lambda p, c, t, pos, ctx=DEFAULT_CTX, active=None,
        ptab=None: vlm.decode_step(p, cfg, c, t, pos, ctx, active=active,
                                   ptab=ptab),
        init_cache=lambda batch, max_seq, dtype=torch.bfloat16,
        device="cuda": vlm.init_cache(cfg, batch, max_seq, dtype, device),
        loss_fn=lambda p, b, ctx=DEFAULT_CTX: vlm.loss_fn(p, cfg, b, ctx),
        cache_spec=spec,
    )
