"""Decoder-only transformer: the dense llama family (tinyllama, llama2-7b,
...), with a token-choice MoE FFN in place of the dense one the MoE family
(qwen3-moe-30b-a3b, moonshot-v1-16b-a3b), and the gemma backbone of the
VLM (paligemma-3b: embeddings scaled by sqrt(d_model), and the prefix-LM
mask over ``inputs_embeds`` from ``models/vlm.py``).

Params are nested dicts of tensors with the block weights stacked along a
leading layer axis, as in the reference; the layer loop is a Python loop
over that axis.  ``loss_fn`` is the training loss (``launch/steps.
make_train_harness``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.common import (Ctx, DEFAULT_CTX, gather_pages,
                                       maybe_remat, page_update_cache,
                                       take_layer,
                                       unstack_layers, update_cache)
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
    under ``"moe"`` (router + expert-stacked weights); ``vlm`` is the dense
    block.  The other families build their own blocks (``rwkv``, ``ssm``,
    ``hybrid``, ``encdec``)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"init_block_params builds dense, moe and vlm blocks, not "
            f"family {cfg.family!r}'s (its model module does)")
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
              prefix_len=None, active=None, ptab=None):
    """Self-attention with optional KV cache.  Returns (out, new_kv or None);
    the cache is written in place (see ``update_cache``).

    ``ptab`` (B, W) int32 with ``ctx.page_size > 0`` switches the cache to
    paged mode: the k/v leaves are page POOLS shared across slots, writes
    scatter through the page table, and reads either walk the table in the
    paged decode kernel or gather a virtual slot-major cache shaped like
    the dense lane.  With ``ctx.kv_bits`` the cache holds k and v quantized
    (``Ctx``), and a paged pool is always gathered.

    Under ``ctx.tp.qrows`` (the mesh train step's query split, no cache)
    ``h`` holds the rank's block of the rows: q, k and v of those rows
    with every head, RoPE at their absolute positions, the keys and values
    of every rank's rows gathered (``layers.gather_keys``), the causal
    mask offset to the block's first row."""
    hd = cfg.resolved_head_dim
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    if ctx.act_bits:
        h = L.fake_quant_act(h, ctx.act_bits)
    h = L.enter(h, ctx.tp, "attn")
    Bb, S = h.shape[:2]
    kb = ctx.kernel_backend
    wq, wk, wv, wo = L.attn_weights(ctx.tp, bp["wq"], bp["wk"], bp["wv"],
                                    bp["wo"])
    q = L.matmul(h, wq, kb).reshape(Bb, S, cfg.num_heads, hd)
    k = L.matmul(h, wk, kb).reshape(Bb, S, cfg.num_kv_heads, hd)
    v = L.matmul(h, wv, kb).reshape(Bb, S, cfg.num_kv_heads, hd)
    positions, q0 = L.query_block(ctx.tp, positions, S)
    if cfg.rope_theta:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    k, v = L.gather_keys(k, v, ctx.tp)

    new_kv = None
    pages = None
    if kv_cache is not None:
        ks, vs = k, v
        if ctx.kv_bits:
            qmax = (1 << (ctx.kv_bits - 1)) - 1
            cdt = kv_cache["k"].dtype
            ks, vs = (torch.clamp(torch.round(a.to(torch.float32)
                                              / ctx.kv_scale),
                                  -qmax - 1, qmax).to(cdt) for a in (k, v))
        paged = ctx.page_size > 0 and ptab is not None
        if paged:
            ck, cv = page_update_cache(kv_cache["k"], kv_cache["v"], ks, vs,
                                       cache_pos, ptab, ctx.page_size)
        else:
            ck, cv = update_cache(kv_cache["k"], kv_cache["v"], ks, vs,
                                  cache_pos)
        new_kv = {"k": ck, "v": cv}
        if ctx.kv_bits:
            # an int8 pool is dequantized after the gather: the paged
            # decode kernel reads bf16 pages only, so paged int8 decode
            # runs the dense kernel over the gathered lane
            if paged:
                ck, cv = gather_pages(ck, ptab), gather_pages(cv, ptab)
            scale = torch.full((), ctx.kv_scale, dtype=x.dtype,
                               device=x.device)
            attn_k, attn_v = ck.to(x.dtype) * scale, cv.to(x.dtype) * scale
        else:
            attn_k, attn_v = ck, cv
            if paged:
                pages = (ptab, ctx.page_size)
        q_offset = cache_pos
        valid = kv_len if kv_len is not None else cache_pos + S
    else:
        attn_k, attn_v = k, v
        q_offset = q0
        valid = None

    o = L.flash_attention(q, attn_k, attn_v, q_offset=q_offset, kv_len=valid,
                          chunk=ctx.attn_chunk, backend=kb, active=active,
                          pages=pages, prefix_len=prefix_len)
    o = o.reshape(Bb, S, cfg.num_heads * hd)
    if ctx.act_bits:
        o = L.fake_quant_act(o, ctx.act_bits)
    return L.leave(L.matmul(o, wo, kb), ctx.tp, "attn"), new_kv


def ffn(bp: dict, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx) -> torch.Tensor:
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    if ctx.act_bits:
        h = L.fake_quant_act(h, ctx.act_bits)
    if cfg.family == "moe":
        # the router runs alike on every rank; the experts' split enters
        # and leaves inside moe_ffn
        return moe_ffn(bp["moe"], L.enter(h, ctx.tp, "router"), cfg, ctx)
    h = L.enter(h, ctx.tp, "ffn")
    kb = ctx.kernel_backend
    g = L.matmul(h, bp["w_gate"], kb)
    u = L.matmul(h, bp["w_up"], kb)
    a = torch.nn.functional.silu(g) * u
    if ctx.act_bits:
        a = L.fake_quant_act(a, ctx.act_bits)
    return L.leave(L.matmul(a, bp["w_down"], kb), ctx.tp, "ffn")


def block(bp: dict, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx = DEFAULT_CTX,
          *, positions, kv_cache=None, cache_pos=None, kv_len=None,
          prefix_len=None, active=None, ptab=None):
    a, new_kv = attention(bp, x, cfg, ctx, positions=positions,
                          kv_cache=kv_cache, cache_pos=cache_pos,
                          kv_len=kv_len, prefix_len=prefix_len,
                          active=active, ptab=ptab)
    x = x + a
    x = x + ffn(bp, x, cfg, ctx)
    return x, new_kv


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens,
                 ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    """The token embeddings; under ``ctx.tp`` the residual stream's
    input: with the vocab split the ranks' parts of the lookup
    (``layers.vocab_lookup``) summed, and with ``ctx.tp.seq`` the rank's
    block of the rows (``layers.leave``)."""
    tp = ctx.tp
    if tp is not None and "vocab" in tp.splits:
        e = L.vocab_lookup(params["embed"], tokens, tp.rank)
    else:
        e = params["embed"][tokens]
    if cfg.family == "vlm":
        # gemma input scaling by sqrt(d_model) rounded to the embedding's
        # dtype, as the reference's; a host scalar, so nothing syncs
        e = e * torch.tensor(cfg.d_model ** 0.5, dtype=e.dtype).item()
    return L.leave(e, tp, "vocab")


def unembed(params, cfg: ModelConfig, x, ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    """Logits; under ``ctx.tp`` with the vocab split, the rank's vocab
    columns of them."""
    x = L.enter(x, ctx.tp, "vocab")
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return L.matmul(x, params["head"], ctx.kernel_backend)


def forward(params, cfg: ModelConfig, tokens, ctx: Ctx = DEFAULT_CTX, *,
            inputs_embeds=None, prefix_len=None) -> torch.Tensor:
    """Training/prefill forward without cache.  Returns logits (B, S, V).
    ``inputs_embeds`` (B, S, d) replaces the token embedding (the VLM's
    patches + text); ``prefix_len`` turns on the prefix-LM mask.

    The layers are taken apart once (``unstack_layers``: one ``unbind`` per
    stacked leaf, so the backward stacks the layers' gradients once) and
    each runs through ``maybe_remat`` (``ctx.remat``).

    Under ``ctx.tp`` (the mesh train step's ``model`` split) the logits
    are the rank's vocab columns where the vocab splits, and with
    ``ctx.tp.seq`` the residual stream between the blocks holds the
    rank's block of the rows (of ``inputs_embeds``, whole on every rank,
    the rank keeps its own); RoPE reads the whole sequence's positions."""
    if inputs_embeds is not None:
        S = inputs_embeds.shape[1]
        x = L.leave(inputs_embeds, ctx.tp, "inputs")
    else:
        S = tokens.shape[1]
        x = embed_tokens(params, cfg, tokens, ctx)
    positions = torch.arange(S, device=x.device)

    def step(h, bp):
        h, _ = block(bp, h, cfg, ctx, positions=positions,
                     prefix_len=prefix_len)
        return h

    step = maybe_remat(step, ctx)
    for bp in unstack_layers(params["blocks"], cfg.num_layers):
        x = step(x, bp)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, cfg, x, ctx)


# the params every family's forward applies to the residual stream's rows
# (its norms: the decoder's and RWKV's ln1 / ln2 / ln_f, Mamba's ln,
# whisper's ln1 / ln_m / ln_x / ln_enc / ln_f): with the rows split over
# the model axis (``ctx.tp.seq``) a rank's gradient of each is its own
# rows' part of the sum
ROW_PARAMS = frozenset({"ln1", "ln2", "ln_f", "ln", "ln_m", "ln_x",
                        "ln_enc"})


def loss_fn(params, cfg: ModelConfig, batch, ctx: Ctx = DEFAULT_CTX):
    """Next-token cross entropy in float32.  batch = {tokens, (optional)
    loss_mask, (optional) inputs_embeds}; the forward runs on
    ``tokens[:, :-1]``.  Under ``ctx.tp`` with the vocab split the
    cross entropy is taken over the ranks' vocab columns
    (``layers.token_nll``)."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens[:, :-1], ctx,
                     inputs_embeds=batch.get("inputs_embeds"))
    targets = tokens[:, 1:].long()
    lw = batch.get("loss_mask")
    lw = (lw[:, 1:].to(torch.float32) if lw is not None
          else torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device))
    nll = L.token_nll(logits.to(torch.float32), targets, ctx.tp) * lw
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
            inputs_embeds=None, prefix_len=None, start_pos: int = 0,
            ptab=None):
    """Fill the cache from position ``start_pos``; returns (last_logits,
    cache).  The cache is updated in place and returned.

    ``start_pos > 0`` resumes a chunked prefill: this call's tokens are
    positions [start_pos, start_pos + S) and attend causally over what
    earlier chunks wrote (plus themselves).  ``ptab`` (B, W) names the
    pages of a paged cache.  ``inputs_embeds`` and ``prefix_len`` as in
    ``forward``."""
    x = (inputs_embeds if inputs_embeds is not None
         else embed_tokens(params, cfg, tokens))
    B, S = x.shape[:2]
    dev = x.device
    positions = start_pos + torch.arange(S, device=dev)
    pos0 = torch.full((B,), start_pos, dtype=torch.int32, device=dev)
    for i in range(cfg.num_layers):
        x, _ = block(take_layer(params["blocks"], i), x, cfg, ctx,
                     positions=positions, kv_cache=_layer_cache(cache, i),
                     cache_pos=pos0, prefix_len=prefix_len, ptab=ptab)
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
