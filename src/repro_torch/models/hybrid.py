"""Zamba2-style hybrid: a Mamba2 backbone with one SHARED attention + FFN
block applied after every ``cfg.attn_every`` mamba layers.  The shared
block's weights are reused at every application site; each site keeps its
own KV lane (``attn_k``/``attn_v`` lead dim = ``n_attn_sites``).

Cache contract (as ``transformer.prefill``): every leaf is updated IN
PLACE and the cache is returned.  A mamba layer writes its new ``conv`` and
``ssm`` state after the block has returned (its last read of the old
state); the shared block writes its site's KV through ``update_cache`` /
``page_update_cache``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm, transformer
from repro_torch.models.common import (Ctx, DEFAULT_CTX, maybe_remat,
                                       take_layer, unstack_layers)
from repro_torch.models.transformer import _normal, model_dtype


def n_attn_sites(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def _segments(cfg: ModelConfig):
    """[(start, end, has_attn_after)] covering all mamba layers."""
    segs, s = [], 0
    while s < cfg.num_layers:
        e = min(s + cfg.attn_every, cfg.num_layers)
        segs.append((s, e, e - s == cfg.attn_every))
        s = e
    return segs


def shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block's config: the dense transformer block."""
    return cfg.replace(family="dense")


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> dict:
    """Random params from ``seed`` on ``device`` (the numbers differ from
    the reference's jax.random ones)."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = model_dtype(cfg)
    d = cfg.d_model
    return {
        "embed": _normal(gen, (cfg.vocab_size, d), d ** -0.5, dt, device),
        "blocks": ssm.init_mamba_block(cfg, gen, cfg.num_layers, device),
        # one shared transformer block (n_layers=1, taken at layer 0)
        "shared_attn": transformer.init_block_params(shared_cfg(cfg), gen, 1,
                                                     device),
        "ln_f": torch.ones((d,), dtype=dt, device=device),
        "head": _normal(gen, (d, cfg.vocab_size), d ** -0.5, dt, device),
    }


def _shared_block(params, x, cfg, ctx, *, positions, kv_cache=None,
                  cache_pos=None, kv_len=None, active=None, ptab=None):
    return transformer.block(take_layer(params["shared_attn"], 0), x,
                             shared_cfg(cfg), ctx, positions=positions,
                             kv_cache=kv_cache, cache_pos=cache_pos,
                             kv_len=kv_len, active=active, ptab=ptab)


def forward(params, cfg: ModelConfig, tokens,
            ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    """Training forward without cache.  Returns logits (B, S, V); under
    ``ctx.tp`` the rank's vocab columns where the vocab splits, and with
    ``ctx.tp.seq`` the residual stream between the regions holds the
    rank's block of the rows (the mixer and the shared block read them
    whole, gathered as each region enters)."""
    x = transformer.embed_tokens(params, cfg, tokens, ctx)
    positions = torch.arange(tokens.shape[1], device=x.device)

    def step(h, bp):
        return ssm.mamba_block(bp, h, cfg, ctx)[0]

    step = maybe_remat(step, ctx)
    layers = unstack_layers(params["blocks"], cfg.num_layers)
    for (s, e, attn_after) in _segments(cfg):
        for bp in layers[s:e]:
            x = step(x, bp)
        if attn_after:
            x, _ = _shared_block(params, x, cfg, ctx, positions=positions)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return transformer.unembed(params, cfg, x, ctx)


def loss_fn(params, cfg: ModelConfig, batch, ctx: Ctx = DEFAULT_CTX):
    """Next-token cross entropy in float32 (the mean over every position;
    over the ranks' vocab columns under ``ctx.tp``)."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens[:, :-1], ctx).to(torch.float32)
    targets = tokens[:, 1:].long()
    return L.token_nll(logits, targets, ctx.tp).mean()


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda"):
    """The mamba state leaves (always f32) and one KV lane per site in
    ``dtype``."""
    hd = cfg.resolved_head_dim
    shape = (n_attn_sites(cfg), batch, max_seq, cfg.num_kv_heads, hd)
    return {
        "mamba": ssm.init_mamba_cache(cfg, batch, cfg.num_layers, device),
        "attn_k": torch.zeros(shape, dtype=dtype, device=device),
        "attn_v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _run(params, cfg, x, cache, ctx, *, positions, cache_pos, kv_len,
         decode, active=None, ptab=None):
    """The prefill and decode body over the segments; writes the cache in
    place."""
    conv, sst = cache["mamba"]["conv"], cache["mamba"]["ssm"]
    site = 0
    for (s, e, attn_after) in _segments(cfg):
        for i in range(s, e):
            x, nc, ns = ssm.mamba_block(
                take_layer(params["blocks"], i), x, cfg, ctx,
                conv_state=conv[i], ssm_state=sst[i], decode=decode)
            conv[i].copy_(nc)
            sst[i].copy_(ns)
        if attn_after:
            kv = {"k": cache["attn_k"][site], "v": cache["attn_v"][site]}
            x, _ = _shared_block(params, x, cfg, ctx, positions=positions,
                                 kv_cache=kv, cache_pos=cache_pos,
                                 kv_len=kv_len, active=active, ptab=ptab)
            site += 1
    return x


def prefill(params, cfg: ModelConfig, tokens, cache, ctx: Ctx = DEFAULT_CTX,
            *, ptab=None):
    """Run the prompt from position 0; returns (last_logits, cache), the
    cache updated in place."""
    x = params["embed"][tokens]
    B, S = tokens.shape
    dev = x.device
    x = _run(params, cfg, x, cache, ctx,
             positions=torch.arange(S, device=dev),
             cache_pos=torch.zeros((B,), dtype=torch.int32, device=dev),
             kv_len=None, decode=False, ptab=ptab)
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return L.matmul(x, params["head"], ctx.kernel_backend)[:, 0], cache


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                ctx: Ctx = DEFAULT_CTX, *, active=None, ptab=None):
    """One decode step; the shared block's decode attention per site.
    Returns (logits, cache), the cache updated in place."""
    x = params["embed"][tokens][:, None, :]
    x = _run(params, cfg, x, cache, ctx, positions=pos[:, None],
             cache_pos=pos, kv_len=pos + 1, decode=True, active=active,
             ptab=ptab)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.matmul(x, params["head"], ctx.kernel_backend)[:, 0], cache
