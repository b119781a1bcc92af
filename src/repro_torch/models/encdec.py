"""Whisper-style encoder-decoder backbone.  The conv/mel frontend is a STUB,
as in the reference: a batch carries precomputed frame embeddings
``frames`` (B, frontend_len, d); everything downstream (the non-causal
encoder stack, the causal decoder with self- and cross-attention, the KV
caches) is real.

Cache contract (as ``transformer.prefill``): every leaf is updated IN
PLACE and the cache is returned.  ``self_k`` / ``self_v`` are token leaves
(pageable), ``cross_k`` / ``cross_v`` fixed leaves of ``frontend_len``
positions, written once by prefill from the encoder's output.  Decode's
cross-attention runs the plain Sq == 1 softmax over them (not causal), as
in the reference; self-attention takes the decode kernels under
``"pallas"``.  The cache holds no int8 variant for this family (the
reference's ``encdec._attn`` has no quantize-on-write).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.common import (Ctx, DEFAULT_CTX, maybe_remat,
                                       page_update_cache, take_layer,
                                       unstack_layers, update_cache)
from repro_torch.models.transformer import _normal, model_dtype


def frames_of(batch):
    """An encoder-decoder batch's frame embeddings, or a clear error: the
    serve loop, the serve and train CLIs and their calibration data feed
    only tokens, as the reference's do (there the batch lookup fails)."""
    if "frames" not in batch:
        raise ValueError(
            "an encdec batch needs 'frames' (B, frontend_len, d_model) "
            "beside 'tokens'; this entry point feeds tokens only, as the "
            "reference's does")
    return batch["frames"]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_attn(gen, cfg, n_layers, dt, device) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def w(shape):
        return _normal(gen, (n_layers,) + shape, shape[0] ** -0.5, dt, device)

    return {"wq": w((d, q)), "wk": w((d, kv)), "wv": w((d, kv)),
            "wo": w((q, d))}


def _init_stack(cfg, gen, n_layers: int, cross: bool, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = model_dtype(cfg)
    p = {
        "ln1": torch.ones((n_layers, d), dtype=dt, device=device),
        "attn": _init_attn(gen, cfg, n_layers, dt, device),
        "ln_m": torch.ones((n_layers, d), dtype=dt, device=device),
        "w_up": _normal(gen, (n_layers, d, f), d ** -0.5, dt, device),
        "w_down": _normal(gen, (n_layers, f, d), f ** -0.5, dt, device),
    }
    if cross:
        p["ln_x"] = torch.ones((n_layers, d), dtype=dt, device=device)
        p["xattn"] = _init_attn(gen, cfg, n_layers, dt, device)
    return p


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
        "encoder": _init_stack(cfg, gen, cfg.encoder_layers, False, device),
        "decoder": _init_stack(cfg, gen, cfg.num_layers, True, device),
        "ln_enc": torch.ones((d,), dtype=dt, device=device),
        "ln_f": torch.ones((d,), dtype=dt, device=device),
        "head": _normal(gen, (d, cfg.vocab_size), d ** -0.5, dt, device),
    }


# --------------------------------------------------------------------------
# blocks (also the units the calibration walk quantizes)
# --------------------------------------------------------------------------

def _ln(x, g, eps):
    """The reference's ``layer_norm(x, g, zeros_like(g))``."""
    return L.layer_norm(x, g, torch.zeros_like(g), eps)


def _attn(ap, x, kv_src, cfg, ctx, *, causal, q_offset=0, kv_cache=None,
          cache_pos=None, kv_len=None, precomputed_kv=None, active=None,
          ptab=None):
    """Attention of ``x`` over ``kv_src`` (or over ``precomputed_kv``);
    with ``kv_cache`` the new k, v are written into it first (in place;
    paged when ``ctx.page_size > 0`` and ``ptab`` is given) and attention
    reads the whole cache."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    kb = ctx.kernel_backend
    q = L.matmul(x, ap["wq"], kb).reshape(B, S, cfg.num_heads, hd)
    pages = None
    if precomputed_kv is not None:
        k, v = precomputed_kv
    else:
        Sk = kv_src.shape[1]
        k = L.matmul(kv_src, ap["wk"], kb).reshape(B, Sk, cfg.num_kv_heads,
                                                   hd)
        v = L.matmul(kv_src, ap["wv"], kb).reshape(B, Sk, cfg.num_kv_heads,
                                                   hd)
        if kv_cache is not None:
            if ctx.page_size > 0 and ptab is not None:
                k, v = page_update_cache(kv_cache["k"], kv_cache["v"], k, v,
                                         cache_pos, ptab, ctx.page_size)
                pages = (ptab, ctx.page_size)
            else:
                k, v = update_cache(kv_cache["k"], kv_cache["v"], k, v,
                                    cache_pos)
    o = L.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                          kv_len=kv_len, chunk=ctx.attn_chunk, backend=kb,
                          active=active, pages=pages)
    return L.matmul(o.reshape(B, S, cfg.num_heads * hd), ap["wo"], kb)


def _mlp(bp, x, cfg, ctx):
    h = _ln(x, bp["ln_m"], cfg.norm_eps)
    if ctx.act_bits:
        h = L.fake_quant_act(h, ctx.act_bits)
    h = L.enter(h, ctx.tp, "ffn")
    kb = ctx.kernel_backend
    u = L.matmul(h, bp["w_up"], kb)
    # jax.nn.gelu's default is the tanh approximation
    return L.leave(L.matmul(torch.nn.functional.gelu(u, approximate="tanh"),
                            bp["w_down"], kb), ctx.tp, "ffn")


def _normed(x, g, cfg, ctx):
    """An attention's input: the norm, the activations' fake-quant, and
    the ``"attn"`` region's entry."""
    h = _ln(x, g, cfg.norm_eps)
    if ctx.act_bits:
        h = L.fake_quant_act(h, ctx.act_bits)
    return L.enter(h, ctx.tp, "attn")


def encoder_block(bp, x, cfg: ModelConfig, ctx: Ctx = DEFAULT_CTX):
    h = _normed(x, bp["ln1"], cfg, ctx)
    x = x + L.leave(_attn(bp["attn"], h, h, cfg, ctx, causal=False),
                    ctx.tp, "attn")
    return x + _mlp(bp, x, cfg, ctx)


def decoder_block(bp, x, enc_out, cfg: ModelConfig, ctx: Ctx = DEFAULT_CTX,
                  *, q_offset=0, self_kv=None, cache_pos=None, kv_len=None,
                  cross_kv=None, active=None, ptab=None):
    """Causal self-attention (over ``self_kv`` when given), cross-attention
    over ``enc_out`` (or the precomputed ``cross_kv``), then the MLP.
    Under ``ctx.tp``, ``enc_out`` has entered the ``"attn"`` region
    (:func:`forward`)."""
    h = _normed(x, bp["ln1"], cfg, ctx)
    x = x + L.leave(_attn(bp["attn"], h, h, cfg, ctx, causal=True,
                          q_offset=q_offset, kv_cache=self_kv,
                          cache_pos=cache_pos, kv_len=kv_len, active=active,
                          ptab=ptab), ctx.tp, "attn")
    hx = _normed(x, bp["ln_x"], cfg, ctx)
    x = x + L.leave(_attn(bp["xattn"], hx, enc_out, cfg, ctx, causal=False,
                          precomputed_kv=cross_kv), ctx.tp, "attn")
    return x + _mlp(bp, x, cfg, ctx)


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def embed_frames(params, cfg: ModelConfig, frames,
                 ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    """The encoder's input stream: the stub frame embeddings in the model's
    dtype plus sinusoidal positions, under ``ctx.tp.seq`` the rank's block
    of its rows.  (The reference adds the positions in the frames' own
    dtype; for frames in the model's dtype the two agree.)"""
    f = frames.to(params["embed"].dtype)
    return L.leave(f + L.sinusoidal_pos(f.shape[1], cfg.d_model, f.dtype,
                                        f.device)[None], ctx.tp, "inputs")


def embed_tokens(params, cfg: ModelConfig, tokens,
                 ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    """The decoder's input stream: token embeddings (the ranks' vocab
    parts summed under ``ctx.tp``) plus sinusoidal positions [0, S), each
    at the rank's rows under ``ctx.tp.seq``."""
    x = transformer.embed_tokens(params, cfg, tokens, ctx)
    pe = L.sinusoidal_pos(tokens.shape[1], cfg.d_model, x.dtype, x.device)
    return x + L.leave(pe[None], ctx.tp, "inputs")


def encode(params, cfg: ModelConfig, frames, ctx: Ctx = DEFAULT_CTX):
    """frames: precomputed (B, F, d) frontend embeddings (stub).  Returns
    ``ln_enc`` of the encoder's final stream."""
    x = embed_frames(params, cfg, frames, ctx)

    def step(h, bp):
        return encoder_block(bp, h, cfg, ctx)

    step = maybe_remat(step, ctx)
    for bp in unstack_layers(params["encoder"], cfg.encoder_layers):
        x = step(x, bp)
    return _ln(x, params["ln_enc"], cfg.norm_eps)


def forward(params, cfg: ModelConfig, frames, tokens,
            ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    """Training forward without cache.  Returns logits (B, S, V); under
    ``ctx.tp`` the rank's vocab columns where the vocab splits.  The
    encoder's output enters the cross-attention's region once for every
    layer (its gradient, the layers' parts summed, leaves once); with
    ``ctx.tp.seq`` both streams hold the rank's block of their rows
    between the regions."""
    enc = L.enter(encode(params, cfg, frames, ctx), ctx.tp, "attn")
    x = embed_tokens(params, cfg, tokens, ctx)

    def step(h, bp):
        return decoder_block(bp, h, enc, cfg, ctx)

    step = maybe_remat(step, ctx)
    for bp in unstack_layers(params["decoder"], cfg.num_layers):
        x = step(x, bp)
    x = _ln(x, params["ln_f"], cfg.norm_eps)
    return transformer.unembed(params, cfg, x, ctx)


def loss_fn(params, cfg: ModelConfig, batch, ctx: Ctx = DEFAULT_CTX):
    """Next-token cross entropy in float32 (the mean over every position;
    over the ranks' vocab columns under ``ctx.tp``).  batch = {tokens,
    frames}."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, frames_of(batch), tokens[:, :-1],
                     ctx).to(torch.float32)
    targets = tokens[:, 1:].long()
    return L.token_nll(logits, targets, ctx.tp).mean()


# -- serving ----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda"):
    hd = cfg.resolved_head_dim
    Ld, H = cfg.num_layers, cfg.num_kv_heads
    z = lambda n: torch.zeros((Ld, batch, n, H, hd), dtype=dtype,
                              device=device)
    # cross-attention K/V computed once from the encoder output at prefill
    return {"self_k": z(max_seq), "self_v": z(max_seq),
            "cross_k": z(cfg.frontend_len), "cross_v": z(cfg.frontend_len)}


def prefill(params, cfg: ModelConfig, frames, tokens, cache,
            ctx: Ctx = DEFAULT_CTX, *, ptab=None):
    """Encode the frames, write each decoder layer's cross K/V (one
    projection of the encoder output a layer) and run the prompt from
    position 0; returns (last_logits, cache), the cache updated in place."""
    enc = encode(params, cfg, frames, ctx)
    if enc.shape[1] != cache["cross_k"].shape[2]:
        raise ValueError(f"prefill: {enc.shape[1]} frames, but the cache "
                         f"holds {cache['cross_k'].shape[2]} "
                         f"(frontend_len {cfg.frontend_len})")
    B = tokens.shape[0]
    hd = cfg.resolved_head_dim
    kb = ctx.kernel_backend
    x = embed_tokens(params, cfg, tokens)
    pos0 = torch.zeros((B,), dtype=torch.int32, device=x.device)
    for i in range(cfg.num_layers):
        bp = take_layer(params["decoder"], i)
        ck = L.matmul(enc, bp["xattn"]["wk"], kb).reshape(
            B, -1, cfg.num_kv_heads, hd)
        cv = L.matmul(enc, bp["xattn"]["wv"], kb).reshape(
            B, -1, cfg.num_kv_heads, hd)
        x = decoder_block(bp, x, enc, cfg, ctx,
                          self_kv={"k": cache["self_k"][i],
                                   "v": cache["self_v"][i]},
                          cache_pos=pos0, cross_kv=(ck, cv), ptab=ptab)
        cache["cross_k"][i].copy_(ck)
        cache["cross_v"][i].copy_(cv)
    x = _ln(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return L.matmul(x, params["head"], kb)[:, 0], cache


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                ctx: Ctx = DEFAULT_CTX, *, active=None, ptab=None):
    """One decode step. tokens: (B,), pos: (B,) int32 write position.
    Returns (logits, cache); the cache is updated in place."""
    x = params["embed"][tokens][:, None, :]
    # the position row of each request.  Under paging the width comes from
    # the page table (the pool's axis 2 is page_size, not the sequence);
    # rows are position-local, so any width covering the positions gives
    # the dense values.  A position past the table (the scheduler's frozen
    # slots write at max_seq) reads the last row, as the reference's
    # clamped gather does.
    if ctx.page_size > 0 and ptab is not None:
        pe_len = ptab.shape[1] * ctx.page_size
    else:
        pe_len = cache["self_k"].shape[2]
    pe = L.sinusoidal_pos(pe_len, cfg.d_model, x.dtype, x.device)
    x = x + pe[pos.long().clamp(max=pe_len - 1)][:, None, :]
    kv_len = pos + 1
    for i in range(cfg.num_layers):
        x = decoder_block(take_layer(params["decoder"], i), x, None, cfg, ctx,
                          q_offset=pos,
                          self_kv={"k": cache["self_k"][i],
                                   "v": cache["self_v"][i]},
                          cache_pos=pos, kv_len=kv_len,
                          cross_kv=(cache["cross_k"][i],
                                    cache["cross_v"][i]),
                          active=active, ptab=ptab)
    x = _ln(x, params["ln_f"], cfg.norm_eps)
    return L.matmul(x, params["head"], ctx.kernel_backend)[:, 0], cache
