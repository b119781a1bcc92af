"""Uniform model API: ``get_model(cfg)`` returns a ``Model`` with
    init_params(seed, device) -> params
    prefill(params, batch, cache, ctx) -> (logits, cache)
    decode_step(params, cache, tokens, pos, ctx, active) -> (logits, cache)
    init_cache(batch, max_seq, dtype, device) -> cache
    loss_fn(params, batch, ctx) -> scalar next-token cross entropy
for family ``dense``.  Batches are dicts: {"tokens", optional
"loss_mask"}.  The other families are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import DEFAULT_CTX


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    loss_fn: Callable


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            "'Remaining families')")
    return Model(
        cfg,
        init_params=lambda seed, device="cuda":
            transformer.init_params(cfg, seed, device),
        prefill=lambda p, b, c, ctx=DEFAULT_CTX, start_pos=0:
            transformer.prefill(p, cfg, b["tokens"], c, ctx,
                                start_pos=start_pos),
        decode_step=lambda p, c, t, pos, ctx=DEFAULT_CTX, active=None:
            transformer.decode_step(p, cfg, c, t, pos, ctx, active=active),
        init_cache=lambda batch, max_seq, dtype=torch.bfloat16, device="cuda":
            transformer.init_cache(cfg, batch, max_seq, dtype, device),
        loss_fn=lambda p, b, ctx=DEFAULT_CTX: transformer.loss_fn(p, cfg, b,
                                                                  ctx),
    )
