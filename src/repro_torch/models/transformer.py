"""Decoder-only transformer: the dense llama family (tinyllama, llama2-7b)
and, with a token-choice MoE FFN in place of the dense one, the MoE family
(qwen3-moe-30b-a3b).

Params are nested dicts of tensors with the block weights stacked along a
leading layer axis, as in the reference; the layer loop is a Python loop
over that axis.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.common import (Ctx, DEFAULT_CTX, page_update_cache,
                                       take_layer, update_cache)
from repro_torch.models.moe import init_moe_ffn, moe_ffn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _normal(gen, shape, scale, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def init_block_params(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                      device) -> dict:
    """Stacked (L, ...) decoder-block params; family ``moe`` holds its FFN
    under ``"moe"`` (router + expert-stacked weights)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            "'Remaining families')")
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    dt = model_dtype(cfg)

    def stack(shape):
        return _normal(gen, (n_layers,) + shape, shape[-2] ** -0.5, dt, device)

    p = {
        "ln1": torch.ones((n_layers, d), dtype=dt, device=device),
        "wq": stack((d, cfg.num_heads * hd)),
        "wk": stack((d, cfg.num_kv_heads * hd)),
        "wv": stack((d, cfg.num_kv_heads * hd)),
        "wo": stack((cfg.num_heads * hd, d)),
        "ln2": torch.ones((n_layers, d), dtype=dt, device=device),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe_ffn(cfg, gen, n_layers, dt, device)
    else:
        p["w_gate"] = stack((d, f))
        p["w_up"] = stack((d, f))
        p["w_down"] = stack((f, d))
    return p


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> dict:
    """Random params from ``seed`` on ``device`` (a torch.Generator on that
    device; the numbers differ from the reference's jax.random ones)."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = model_dtype(cfg)
    params = {
        "embed": _normal(gen, (cfg.vocab_size, cfg.d_model),
                         cfg.d_model ** -0.5, dt, device),
        "blocks": init_block_params(cfg, gen, cfg.num_layers, device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = _normal(gen, (cfg.d_model, cfg.vocab_size),
                                 cfg.d_model ** -0.5, dt, device)
    return params


# --------------------------------------------------------------------------
# one decoder block (also the unit the calibration walk quantizes)
# --------------------------------------------------------------------------

def attention(bp: dict, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx, *,
              positions, kv_cache=None, cache_pos=None, kv_len=None,
              active=None, ptab=None):
    """Self-attention with optional KV cache.  Returns (out, new_kv or None);
    the cache is written in place (see ``update_cache``).

    ``ptab`` (B, W) int32 with ``ctx.page_size > 0`` switches the cache to
    paged mode: the k/v leaves are page POOLS shared across slots, writes
    scatter through the page table, and reads either walk the table in the
    paged decode kernel or gather a virtual slot-major cache shaped like
    the dense lane."""
    Bb, S, d = x.shape
    hd = cfg.resolved_head_dim
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    if ctx.act_bits:
        h = L.fake_quant_act(h, ctx.act_bits)
    kb = ctx.kernel_backend
    q = L.matmul(h, bp["wq"], kb).reshape(Bb, S, cfg.num_heads, hd)
    k = L.matmul(h, bp["wk"], kb).reshape(Bb, S, cfg.num_kv_heads, hd)
    v = L.matmul(h, bp["wv"], kb).reshape(Bb, S, cfg.num_kv_heads, hd)
    if cfg.rope_theta:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)

    new_kv = None
    pages = None
    if kv_cache is not None:
        if ctx.page_size > 0 and ptab is not None:
            ck, cv = page_update_cache(kv_cache["k"], kv_cache["v"], k, v,
                                       cache_pos, ptab, ctx.page_size)
            pages = (ptab, ctx.page_size)
        else:
            ck, cv = update_cache(kv_cache["k"], kv_cache["v"], k, v,
                                  cache_pos)
        new_kv = {"k": ck, "v": cv}
        attn_k, attn_v = ck, cv
        q_offset = cache_pos
        valid = kv_len if kv_len is not None else cache_pos + S
    else:
        attn_k, attn_v = k, v
        q_offset = 0
        valid = None

    o = L.flash_attention(q, attn_k, attn_v, q_offset=q_offset, kv_len=valid,
                          chunk=ctx.attn_chunk, backend=kb, active=active,
                          pages=pages)
    o = o.reshape(Bb, S, cfg.num_heads * hd)
    if ctx.act_bits:
        o = L.fake_quant_act(o, ctx.act_bits)
    return L.matmul(o, bp["wo"], kb), new_kv


def ffn(bp: dict, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx) -> torch.Tensor:
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    if ctx.act_bits:
        h = L.fake_quant_act(h, ctx.act_bits)
    if cfg.family == "moe":
        return moe_ffn(bp["moe"], h, cfg, ctx)
    kb = ctx.kernel_backend
    g = L.matmul(h, bp["w_gate"], kb)
    u = L.matmul(h, bp["w_up"], kb)
    a = torch.nn.functional.silu(g) * u
    if ctx.act_bits:
        a = L.fake_quant_act(a, ctx.act_bits)
    return L.matmul(a, bp["w_down"], kb)


def block(bp: dict, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx = DEFAULT_CTX,
          *, positions, kv_cache=None, cache_pos=None, kv_len=None,
          active=None, ptab=None):
    a, new_kv = attention(bp, x, cfg, ctx, positions=positions,
                          kv_cache=kv_cache, cache_pos=cache_pos,
                          kv_len=kv_len, active=active, ptab=ptab)
    x = x + a
    x = x + ffn(bp, x, cfg, ctx)
    return x, new_kv


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    return params["embed"][tokens]


def unembed(params, cfg: ModelConfig, x, ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return L.matmul(x, params["head"], ctx.kernel_backend)


def forward(params, cfg: ModelConfig, tokens, ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    """Prefill-style forward without cache.  Returns logits (B, S, V)."""
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        x, _ = block(take_layer(params["blocks"], i), x, cfg, ctx,
                     positions=positions)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, cfg, x, ctx)


def loss_fn(params, cfg: ModelConfig, batch, ctx: Ctx = DEFAULT_CTX):
    """Next-token cross entropy in float32.  batch = {tokens, (optional)
    loss_mask}; the forward runs on ``tokens[:, :-1]``."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens[:, :-1], ctx)
    targets = tokens[:, 1:].long()
    lw = batch.get("loss_mask")
    lw = (lw[:, 1:].to(torch.float32) if lw is not None
          else torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device))
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (lse - gold) * lw
    return nll.sum() / torch.clamp(lw.sum(), min=1.0)


# -- serving ----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda"):
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _layer_cache(cache, i):
    return {"k": cache["k"][i], "v": cache["v"][i]}


def prefill(params, cfg: ModelConfig, tokens, cache, ctx: Ctx = DEFAULT_CTX, *,
            start_pos: int = 0, ptab=None):
    """Fill the cache from position ``start_pos``; returns (last_logits,
    cache).  The cache is updated in place and returned.

    ``start_pos > 0`` resumes a chunked prefill: this call's tokens are
    positions [start_pos, start_pos + S) and attend causally over what
    earlier chunks wrote (plus themselves).  ``ptab`` (B, W) names the
    pages of a paged cache."""
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[:2]
    dev = x.device
    positions = start_pos + torch.arange(S, device=dev)
    pos0 = torch.full((B,), start_pos, dtype=torch.int32, device=dev)
    for i in range(cfg.num_layers):
        x, _ = block(take_layer(params["blocks"], i), x, cfg, ctx,
                     positions=positions, kv_cache=_layer_cache(cache, i),
                     cache_pos=pos0, ptab=ptab)
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return unembed(params, cfg, x, ctx)[:, 0], cache


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                ctx: Ctx = DEFAULT_CTX, *, active=None, ptab=None):
    """One decode step. tokens: (B,), pos: (B,) int32 write position.
    ``active``: (B,) slot occupancy (None = all live); ``ptab``: (B, W)
    page table when the cache is a page pool.  Returns (logits, cache); the
    cache is updated in place."""
    x = embed_tokens(params, cfg, tokens)[:, None, :]
    kv_len = pos + 1  # once per step, not once per layer
    for i in range(cfg.num_layers):
        x, _ = block(take_layer(params["blocks"], i), x, cfg, ctx,
                     positions=pos[:, None], kv_cache=_layer_cache(cache, i),
                     cache_pos=pos, kv_len=kv_len, active=active,
                     ptab=ptab)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, cfg, x, ctx)[:, 0], cache
