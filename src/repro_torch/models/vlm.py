"""PaliGemma-style VLM backbone: the gemma decoder-only transformer over a
stubbed SigLIP patch-embedding prefix (prefix-LM attention: the image
prefix attends bidirectionally, the text suffix causally).

The dense transformer does the work; only the input assembly and the
prefix mask differ.  Decode past the prefix is the dense decode step."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.common import Ctx, DEFAULT_CTX

init_params = transformer.init_params
init_cache = transformer.init_cache
decode_step = transformer.decode_step


def patches_of(batch):
    """A VLM batch's patch embeddings, or a clear error: the serve loop,
    the serve and train CLIs and their calibration data feed only tokens,
    as the reference's do (there the batch lookup fails)."""
    if "patches" not in batch:
        raise ValueError(
            "a vlm batch needs 'patches' (B, num_patches, d_model) beside "
            "'tokens'; this entry point feeds tokens only, as the "
            "reference's does")
    return batch["patches"]


def assemble_inputs(params, cfg: ModelConfig, patches, tokens,
                    ctx: Ctx = DEFAULT_CTX):
    """patches: stub (B, P, d) SigLIP embeddings; tokens: (B, S_text).
    Returns (B, P + S_text, d) in the embedding's dtype, whole on every
    rank under ``ctx.tp``: the ranks' vocab parts of the text summed over
    all its rows (never the rank's block of them, which would split the
    text before the patches join it)."""
    if ctx.tp is not None:
        ctx = dataclasses.replace(ctx, tp=dataclasses.replace(ctx.tp,
                                                              seq=False))
    tok = transformer.embed_tokens(params, cfg, tokens, ctx)  # gemma-scaled
    return torch.cat([patches.to(tok.dtype), tok], dim=1)


def forward(params, cfg: ModelConfig, patches, tokens,
            ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    """Logits (B, P + S_text, V); under ``ctx.tp`` the rank's vocab
    columns where the vocab splits, and with ``ctx.tp.seq`` the residual
    stream holds the rank's block of the joined rows (``transformer.
    forward``'s ``"inputs"`` region takes them)."""
    x = assemble_inputs(params, cfg, patches, tokens, ctx)
    return transformer.forward(params, cfg, None, ctx, inputs_embeds=x,
                               prefix_len=cfg.num_patches)


def loss_fn(params, cfg: ModelConfig, batch, ctx: Ctx = DEFAULT_CTX):
    """Next-token cross entropy in float32 over the text suffix only (over
    the ranks' vocab columns under ``ctx.tp``)."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, patches_of(batch), tokens[:, :-1],
                     ctx).to(torch.float32)
    logits = logits[:, cfg.num_patches:]                   # text positions
    targets = tokens[:, 1:].long()
    return L.token_nll(logits, targets, ctx.tp).mean()


def prefill(params, cfg: ModelConfig, patches, tokens, cache,
            ctx: Ctx = DEFAULT_CTX, *, ptab=None):
    """Prefill the patches and the prompt (positions [0, P + S_text));
    returns (last_logits, cache), the cache updated in place."""
    x = assemble_inputs(params, cfg, patches, tokens)
    return transformer.prefill(params, cfg, None, cache, ctx,
                               inputs_embeds=x, prefix_len=cfg.num_patches,
                               ptab=ptab)
