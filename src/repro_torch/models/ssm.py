"""Chunked linear attention: the shared engine of Mamba2 (zamba2's
backbone) and RWKV6, and the Mamba2 block.

Both recurrences have the form
    S_t = diag(lambda_t) S_{t-1} + k_t v_t^T          (state: (Dk, Dv) per head)
with different output taps:
    mamba2:  y_t = q_t . S_t                  (inclusive; q=C, k=B, v=dt*x)
    rwkv6:   y_t = q_t . (S_{t-1} + u k_t v_t^T)   (exclusive + bonus u)

The chunked form processes ``chunk`` tokens at a time: the intra-chunk part
through a decay-masked (Q, Q) score matrix, the inter-chunk part through
the carried state.  All decay algebra runs in float32 on *pairwise
log-space differences* masked to -inf before ``exp`` (exp(a_t - a_s) <= 1
wherever it is kept), which stays finite for any decay; the factored
q*exp(a), k*exp(-a) form overflows and is not used.

The reference writes this engine in plain jnp (no Pallas kernel), and so
does the port in plain torch ops.  Under autograd each chunk's body runs
through ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``):
the backward recomputes a chunk's (B, H, Q, Q, E) temporaries instead of
keeping them for every chunk (at rwkv6-3b's widths one is 671 MB a sample).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import layers as L


def _chunk_step(state, qb, kb, vb, ld, mask, inclusive: bool, u):
    """One chunk.  qb, kb: (B,H,Q,Dk); vb: (B,H,Q,Dv); ld: (B,H,Q,E) f32;
    state (B,H,Dk,Dv) f32; mask (Q, Q) bool.  Returns (state', y)."""
    qb32, kb32, vb32 = qb.float(), kb.float(), vb.float()
    a = torch.cumsum(ld, dim=2)                              # inclusive
    a_q = a if inclusive else a - ld                         # query-side tap
    a_last = a[:, :, -1:, :]                                 # (B,H,1,E)

    # inter-chunk: read the carried state
    y = torch.einsum("bhtk,bhkv->bhtv", qb32 * torch.exp(a_q), state)

    # intra-chunk: pairwise log-space decay, masked before exp
    diff = a_q[:, :, :, None, :] - a[:, :, None, :, :]       # (B,H,Q,Q,E)
    diff = torch.where(mask[None, None, :, :, None], diff, float("-inf"))
    dec = torch.exp(diff)
    if ld.shape[-1] == 1:
        scores = torch.einsum("bhtk,bhsk->bhts", qb32, kb32) * dec[..., 0]
    else:
        scores = torch.einsum("bhtk,bhtsk,bhsk->bhts", qb32, dec, kb32)
    y = y + torch.einsum("bhts,bhsv->bhtv", scores, vb32)

    if u is not None:                                        # rwkv bonus
        uu = u.float()[None, :, None, :]
        y = y + (qb32 * uu * kb32).sum(-1, keepdim=True) * vb32

    # state update: k decayed to the chunk's end (<= 1, safe)
    k_dec = kb32 * torch.exp(a_last - a)
    state = state * torch.exp(a_last[:, :, 0, :, None])
    state = state + torch.einsum("bhsk,bhsv->bhkv", k_dec, vb32)
    return state, y


def chunked_linear_attention(q, k, v, log_decay, *, inclusive: bool,
                             u: Optional[torch.Tensor] = None,
                             chunk: int = 64,
                             initial_state: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B,S,H,Dk); v: (B,S,H,Dv); log_decay: (B,S,H,E) with E in
    {1, Dk} (a per-head scalar decay for mamba2, per key dim for rwkv6);
    u: (H, Dk).  Returns (y (B,S,H,Dv) in v's dtype, final state
    (B,H,Dk,Dv) f32).  The sequence is zero-padded to a multiple of
    ``chunk`` (a padded step has decay 1 and adds nothing)."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    pad = (-S) % chunk
    if pad:
        def zp(a):
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        q, k, v, log_decay = zp(q), zp(k), zp(v), zp(log_decay)
    N = q.shape[1] // chunk

    def to_chunks(a):
        # (B, S, H, D) -> N x (B, H, Q, D)
        return a.reshape(B, N, chunk, H, a.shape[-1]).permute(
            1, 0, 3, 2, 4).unbind(0)

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    ldc = to_chunks(log_decay.float())
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((B, H, Dk, Dv), dtype=torch.float32,
                              device=q.device))
    t = torch.arange(chunk, device=q.device)
    mask = (t[:, None] >= t[None, :]) if inclusive \
        else (t[:, None] > t[None, :])                       # s<=t / s<t

    ys = []
    for qb, kb, vb, ld in zip(qc, kc, vc, ldc):
        if torch.is_grad_enabled():
            state, y = torch.utils.checkpoint.checkpoint(
                _chunk_step, state, qb, kb, vb, ld, mask, inclusive, u,
                use_reentrant=False, preserve_rng_state=False)
        else:
            state, y = _chunk_step(state, qb, kb, vb, ld, mask, inclusive,
                                   u)
        ys.append(y)
    y = torch.stack(ys, 0).permute(1, 0, 3, 2, 4).reshape(
        B, N * chunk, H, Dv)[:, :S]
    return y.to(v.dtype), state


def step_linear_attention(state, q, k, v, log_decay, *, inclusive: bool,
                          u: Optional[torch.Tensor] = None):
    """One recurrent step (decode).  q, k: (B,H,Dk); v: (B,H,Dv);
    log_decay: (B,H,E); state: (B,H,Dk,Dv) f32.  Returns (y (B,H,Dv) in
    v's dtype, new state)."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    ld = log_decay.float()
    kv = torch.einsum("bhk,bhv->bhkv", k32, v32)
    decay = torch.exp(ld)                                    # (B,H,E)
    new_state = state * decay[..., :, None] + kv             # E == 1 broadcasts
    if inclusive:
        y = torch.einsum("bhk,bhkv->bhv", q32, new_state)
    else:
        uu = u.float()[None]
        y = torch.einsum("bhk,bhkv->bhv", q32, state + uu[..., None] * kv)
    return y.to(v.dtype), new_state


# --------------------------------------------------------------------------
# Mamba2 block (zamba2 backbone)
# --------------------------------------------------------------------------

def _dims(cfg):
    di = cfg.d_model * cfg.ssm.expand
    N, P = cfg.ssm.state_size, cfg.ssm.head_dim
    return di, N, P, di // P


def init_mamba_block(cfg, gen: torch.Generator, n_layers: int,
                     device) -> dict:
    """Stacked (L, ...) Mamba2 params: ``in_proj`` and ``out_proj`` in the
    model dtype (quantized linears); the conv, ``A_log``, ``D`` and
    ``dt_bias`` in float32, as the reference's."""
    from repro_torch.models.transformer import _normal, model_dtype
    d = cfg.d_model
    di, N, P, H = _dims(cfg)
    W = cfg.ssm.conv_width
    conv_ch = di + 2 * N
    dt = model_dtype(cfg)
    f32 = torch.float32

    def w(shape, fan_in):
        return _normal(gen, (n_layers,) + shape, fan_in ** -0.5, dt, device)

    def full(shape, value, dtype):
        return torch.full((n_layers,) + shape, value, dtype=dtype,
                          device=device)

    return {
        "ln": full((d,), 1.0, dt),
        "in_proj": w((d, 2 * di + 2 * N + H), d),        # z, x, B, C, dt
        "conv_w": w((W, conv_ch), W).to(f32),
        "conv_b": full((conv_ch,), 0.0, f32),
        "A_log": full((H,), 0.0, f32),                   # A = -exp(A_log)
        "D": full((H,), 1.0, f32),
        "dt_bias": full((H,), 0.0, f32),
        "out_norm": full((di,), 1.0, dt),
        "out_proj": w((di, d), di),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B,S,C), w: (W,C), b: (C,)."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _mamba_inner(bp, x, cfg, *, conv_state=None, ssm_state=None,
                 decode=False, backend=None, tp=None):
    """The mamba2 mixer after the input norm.  x: (B,S,d); decode runs
    S == 1 against the threaded states.  Returns (y, new_conv_state,
    new_ssm_state), the states as new tensors (the caller writes them into
    its cache after this returns).  Under ``tp`` (a ``layers.ModelSplit``)
    with ``"out_proj"`` split, the mixer runs whole on every rank and
    ``out_proj`` (the rank's ``di / size`` rows) multiplies the rank's
    columns of its output (``layers.own_columns``: their gradients
    gathered back), ``out`` the rank's part of the product."""
    di, N, P, H = _dims(cfg)
    Wc = cfg.ssm.conv_width
    B_, S, _ = x.shape

    zxbcdt = L.matmul(x, bp["in_proj"], backend)
    z, xin, Bs, Cs, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xin, Bs, Cs], dim=-1).float()

    if decode:
        full = torch.cat([conv_state.float(), conv_in], dim=1)  # (B, Wc, C)
        conv = (full * bp["conv_w"][None]).sum(dim=1, keepdim=True) \
            + bp["conv_b"][None, None, :]
        new_conv_state = full[:, 1:]
    else:
        conv = _causal_conv(conv_in, bp["conv_w"], bp["conv_b"])
        new_conv_state = conv_in[:, -(Wc - 1):]
    conv = torch.nn.functional.silu(conv)
    xc, Bc, Cc = torch.split(conv, [di, N, N], dim=-1)

    dtf = torch.nn.functional.softplus(dt.float()
                                       + bp["dt_bias"][None, None, :])
    A = -torch.exp(bp["A_log"])                              # (H,) negative
    log_decay = (dtf * A[None, None, :])[..., None]          # (B,S,H,1)

    xh = xc.reshape(B_, S, H, P)
    v = xh * dtf[..., None]                                  # dt-weighted
    q = Cc[:, :, None, :].expand(B_, S, H, N)
    k = Bc[:, :, None, :].expand(B_, S, H, N)

    if decode:
        y1, new_ssm = step_linear_attention(
            ssm_state, q[:, 0], k[:, 0], v[:, 0], log_decay[:, 0],
            inclusive=True)
        y = y1[:, None]
    else:
        y, new_ssm = chunked_linear_attention(
            q, k, v, log_decay, inclusive=True, chunk=cfg.ssm.chunk_size,
            initial_state=ssm_state)
    y = y + xh.to(y.dtype) * bp["D"][None, None, :, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    y = L.rms_norm(y * torch.nn.functional.silu(z).to(x.dtype),
                   bp["out_norm"], cfg.norm_eps).to(x.dtype)
    out = L.matmul(L.own_columns(y, tp, "out_proj"), bp["out_proj"],
                   backend)
    return out, new_conv_state, new_ssm


def mamba_block(bp, x, cfg, ctx, *, conv_state=None, ssm_state=None,
                decode=False):
    """x + mixer(rms_norm(x)); returns (x', new_conv_state, new_ssm).
    Under ``ctx.tp`` the mixer is a whole region (under ``ctx.tp.seq`` its
    rows gathered: the causal conv and the scan read them all) and its
    output leaves through ``out_proj``'s."""
    h = L.rms_norm(x, bp["ln"], cfg.norm_eps)
    if ctx.act_bits:
        h = L.fake_quant_act(h, ctx.act_bits)
    out, ncs, nss = _mamba_inner(bp, L.enter(h, ctx.tp, "mixer"), cfg,
                                 conv_state=conv_state, ssm_state=ssm_state,
                                 decode=decode, backend=ctx.kernel_backend,
                                 tp=ctx.tp)
    return x + L.leave(out, ctx.tp, "out_proj"), ncs, nss


def init_mamba_cache(cfg, batch: int, n_layers: int, device="cuda"):
    """Decode cache, always float32: the causal conv's last ``conv_width -
    1`` inputs and the SSM state (B, H, Dk=N, Dv=P) per layer."""
    di, N, P, H = _dims(cfg)
    conv_ch = di + 2 * N
    f32 = torch.float32
    return {
        "conv": torch.zeros((n_layers, batch, cfg.ssm.conv_width - 1,
                             conv_ch), dtype=f32, device=device),
        "ssm": torch.zeros((n_layers, batch, H, N, P), dtype=f32,
                           device=device),
    }
