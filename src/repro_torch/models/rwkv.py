"""RWKV6 "Finch": an attention-free LM with data-dependent per-channel
decay.

The time mix (wkv6) runs the shared chunked linear-attention engine
(``models/ssm.py``) with *exclusive* taps plus the diag-u bonus; its decay
comes per token and channel from a low-rank (LoRA) head on the shifted
input, RWKV6's defining feature.  The channel mix is the squared-ReLU
two-matrix FFN.  The decay LoRA (``wA``, ``wB``) stays float32 and is not
quantized.

Cache contract (as ``transformer.prefill``): the per-layer state leaves
``shift1``, ``shift2`` (the previous token's normed input, the cache's
dtype) and ``wkv`` (f32) are updated IN PLACE and the cache is returned.
A layer writes each leaf only after its last read of the old value: the
decode token shift reads the cached token as a view.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.common import (Ctx, DEFAULT_CTX, maybe_remat,
                                       take_layer, unstack_layers)
from repro_torch.models.ssm import (chunked_linear_attention,
                                    step_linear_attention)
from repro_torch.models.transformer import _normal, model_dtype

DECAY_LORA = 64


def init_block_params(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                      device) -> dict:
    d, H, Dh = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    dt = model_dtype(cfg)
    f32 = torch.float32
    lora = min(DECAY_LORA, d // 2)

    def w(shape, fan_in):
        return _normal(gen, (n_layers,) + shape, fan_in ** -0.5, dt, device)

    def full(shape, value, dtype):
        return torch.full((n_layers,) + shape, value, dtype=dtype,
                          device=device)

    return {
        "ln1": full((d,), 1.0, dt),
        "ln2": full((d,), 1.0, dt),
        # token-shift mix coefficients for r, k, v, g, w and channel-mix r, k
        "mu": full((7, d), 0.5, dt),
        "wr": w((d, d), d),
        "wk": w((d, d), d),
        "wv": w((d, d), d),
        "wg": w((d, d), d),
        "wo": w((d, d), d),
        # data-dependent decay: w = -exp(w0 + tanh(x A) B)
        "w0": full((d,), -2.0, f32),
        "wA": w((d, lora), d).to(f32),
        "wB": _normal(gen, (n_layers, lora, d), 0.01, f32, device),
        "u": full((H, Dh), 0.0, f32),                    # bonus
        "gn": full((d,), 1.0, dt),                       # per-head norm
        # channel mix
        "ck": w((d, cfg.d_ff), d),
        "cv": w((cfg.d_ff, d), cfg.d_ff),
        "cr": w((d, d), d),
    }


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
        "blocks": init_block_params(cfg, gen, cfg.num_layers, device),
        "ln_f": torch.ones((d,), dtype=dt, device=device),
        "head": _normal(gen, (d, cfg.vocab_size), d ** -0.5, dt, device),
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1}.  ``last`` (B,1,d) is the cached previous token;
    a one-token step returns it as it is (a view of the cache)."""
    if x.shape[1] == 1 and last is not None:
        return last
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last.to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix(bp, x, cfg: ModelConfig, ctx: Ctx, *, shift_state=None,
             wkv_state=None, decode=False):
    """Returns (out, the token to cache as shift1, the new wkv state).

    Under ``ctx.tp`` with ``"time"`` split, ``cfg`` holds the rank's head
    count: the rank computes r / k / v / g, the decay, the wkv scan and
    the group norm of its heads (its slices of ``w0``, ``wB``, ``u`` and
    ``gn``) and its part of the ``wo`` product, which ``layers.leave``
    sums; the leaves it reads whole have their gradients summed over the
    group (``layers.share``)."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    xs = _shift(x, shift_state)
    tp = ctx.tp
    mu, w0, wA, wB, u, gn = L.share(tp, "time", *(
        bp[k] for k in ("mu", "w0", "wA", "wB", "u", "gn")))
    if tp is not None and "time" in tp.splits:
        c = slice(tp.rank * H * Dh, (tp.rank + 1) * H * Dh)
        w0, wB, gn = w0[c], wB[:, c], gn[c]
        u = u[tp.rank * H:(tp.rank + 1) * H]

    def mix(i):
        return x + (xs - x) * mu[i][None, None, :]

    mixed = [mix(i) for i in range(5)]
    if ctx.act_bits:
        mixed = [L.fake_quant_act(m, ctx.act_bits) for m in mixed]
    kb = ctx.kernel_backend
    r = L.matmul(mixed[0], bp["wr"], kb).reshape(B, S, H, Dh)
    k = L.matmul(mixed[1], bp["wk"], kb).reshape(B, S, H, Dh)
    v = L.matmul(mixed[2], bp["wv"], kb).reshape(B, S, H, Dh)
    g = torch.nn.functional.silu(L.matmul(mixed[3], bp["wg"], kb))
    # data-dependent decay (per channel), clamped for stability
    lora = torch.tanh(mixed[4].float() @ wA) @ wB
    log_decay = -torch.exp(torch.clamp(w0[None, None, :] + lora,
                                       -10.0, 4.0))
    log_decay = log_decay.reshape(B, S, H, Dh)

    if decode:
        y1, new_state = step_linear_attention(
            wkv_state, r[:, 0], k[:, 0], v[:, 0], log_decay[:, 0],
            inclusive=False, u=u)
        y = y1[:, None]
    else:
        y, new_state = chunked_linear_attention(
            r, k, v, log_decay, inclusive=False, u=u,
            chunk=cfg.ssm.chunk_size, initial_state=wkv_state)
    # per-head group norm, then the output gate
    yf = y.reshape(B, S, H, Dh).float()
    yf = (yf - yf.mean(-1, keepdim=True)) * torch.rsqrt(
        yf.var(-1, unbiased=False, keepdim=True) + 64e-5)
    yf = yf.reshape(B, S, H * Dh).to(x.dtype) * gn[None, None, :]
    out = L.matmul(yf * g, bp["wo"], kb)
    return out, x[:, -1:], new_state


def channel_mix(bp, x, cfg: ModelConfig, ctx: Ctx, *, shift_state=None):
    """Returns (out, the token to cache as shift2).

    Under ``ctx.tp`` with ``"ffn"`` split the rank holds its columns of
    ``ck`` and rows of ``cv``; ``cr`` is gathered whole on every rank
    (split, its gate would need the summed ``kv`` first: one more
    collective), and the receptance gate multiplies the rank's partial
    ``kv`` before ``layers.leave`` sums it:
    ``sigmoid(xr @ cr) * sum(kv_r) == sum(sigmoid(xr @ cr) * kv_r)``.  The
    gradients of ``mu`` and ``cr`` are summed over the group
    (``layers.share``)."""
    xs = _shift(x, shift_state)
    mu, cr = L.share(ctx.tp, "ffn", bp["mu"], bp["cr"])
    xk = x + (xs - x) * mu[5][None, None, :]
    xr = x + (xs - x) * mu[6][None, None, :]
    if ctx.act_bits:
        xk = L.fake_quant_act(xk, ctx.act_bits)
        xr = L.fake_quant_act(xr, ctx.act_bits)
    kb = ctx.kernel_backend
    k = torch.square(torch.relu(L.matmul(xk, bp["ck"], kb)))
    kv = L.matmul(k, bp["cv"], kb)
    return torch.sigmoid(L.matmul(xr, cr, kb)) * kv, x[:, -1:]


def block(bp, x, cfg: ModelConfig, ctx: Ctx = DEFAULT_CTX, *, cache=None,
          decode=False):
    """One RWKV block.  ``cache`` (one layer's {shift1, shift2, wkv} views)
    is read, then written in place; returns (x, cache)."""
    c = cache or {}
    h = L.enter(L.rms_norm(x, bp["ln1"], cfg.norm_eps), ctx.tp, "time")
    a, s1, wkv = time_mix(bp, h, cfg, ctx, shift_state=c.get("shift1"),
                          wkv_state=c.get("wkv"), decode=decode)
    if cache is not None:            # time_mix is done with the old state
        cache["shift1"].copy_(s1)
        cache["wkv"].copy_(wkv)
    x = x + L.leave(a, ctx.tp, "time")
    h2 = L.enter(L.rms_norm(x, bp["ln2"], cfg.norm_eps), ctx.tp, "ffn")
    m, s2 = channel_mix(bp, h2, cfg, ctx, shift_state=c.get("shift2"))
    if cache is not None:
        cache["shift2"].copy_(s2)
    return x + L.leave(m, ctx.tp, "ffn"), cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int = 0,
               dtype=torch.bfloat16, device="cuda"):
    """The decode state is O(1) in the sequence length: ``max_seq`` is
    accepted for the uniform API and unused."""
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    n, d = cfg.num_layers, cfg.d_model
    return {
        "shift1": torch.zeros((n, batch, 1, d), dtype=dtype, device=device),
        "shift2": torch.zeros((n, batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((n, batch, H, Dh, Dh), dtype=torch.float32,
                           device=device),
    }


def _layer_cache(cache, i):
    return {k: v[i] for k, v in cache.items()}


def forward(params, cfg: ModelConfig, tokens,
            ctx: Ctx = DEFAULT_CTX) -> torch.Tensor:
    """Training forward without cache.  Returns logits (B, S, V); under
    ``ctx.tp`` the rank's vocab columns where the vocab splits, and with
    ``ctx.tp.seq`` the residual stream between the regions holds the
    rank's block of the rows (the token shift and the scan read them
    whole, gathered as each region enters)."""
    x = transformer.embed_tokens(params, cfg, tokens, ctx)

    def step(h, bp):
        return block(bp, h, cfg, ctx)[0]

    step = maybe_remat(step, ctx)
    for bp in unstack_layers(params["blocks"], cfg.num_layers):
        x = step(x, bp)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return transformer.unembed(params, cfg, x, ctx)


def loss_fn(params, cfg: ModelConfig, batch, ctx: Ctx = DEFAULT_CTX):
    """Next-token cross entropy in float32 (the mean over every position;
    over the ranks' vocab columns under ``ctx.tp``)."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens[:, :-1], ctx).to(torch.float32)
    targets = tokens[:, 1:].long()
    return L.token_nll(logits, targets, ctx.tp).mean()


def prefill(params, cfg: ModelConfig, tokens, cache, ctx: Ctx = DEFAULT_CTX):
    """Run the prompt from the cache's state; returns (last_logits, cache),
    the cache updated in place."""
    x = params["embed"][tokens]
    for i in range(cfg.num_layers):
        x, _ = block(take_layer(params["blocks"], i), x, cfg, ctx,
                     cache=_layer_cache(cache, i))
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return L.matmul(x, params["head"], ctx.kernel_backend)[:, 0], cache


def decode_step(params, cfg: ModelConfig, cache, tokens, pos=None,
                ctx: Ctx = DEFAULT_CTX, *, active=None):
    """One recurrent step for every slot.  ``pos`` and ``active`` are
    accepted for the uniform decode API and unused, as in the reference:
    a finished slot's state is dead weight until admission overwrites it
    whole."""
    del pos, active
    x = params["embed"][tokens][:, None, :]
    for i in range(cfg.num_layers):
        x, _ = block(take_layer(params["blocks"], i), x, cfg, ctx,
                     cache=_layer_cache(cache, i), decode=True)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.matmul(x, params["head"], ctx.kernel_backend)[:, 0], cache
