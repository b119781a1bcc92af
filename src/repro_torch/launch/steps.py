"""The prefill/decode steps for single-device serving, the scheduler's
masked decode step and the paged store's admission step."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.models.common import (CACHE_SLOT_AXIS, _get_leaf, make_ctx,
                                       page_rows)


def make_serve_steps(cfg: ModelConfig, *, act_bits=None,
                     attn_chunk: int = 512, kernel_backend=None,
                     page_size: int = 0):
    """Returns (model, prefill_step, decode_step).

    ``kernel_backend`` ("xla" | "pallas" | None = env/default) selects the
    QTensor matmul and decode-attention path for both steps; ``act_bits``
    fake-quantizes activations per token in both (W4A8 / W4A4);
    ``attn_chunk`` is the prefill attention's KV chunk.  ``page_size > 0``
    builds paged-cache steps: prefill accepts ``start_pos``/``ptab``
    (chunked prefill over a page table) and decode accepts ``ptab``.
    Meshes and tensor parallelism are not ported yet (ROADMAP queue 1)."""
    model = get_model(cfg)
    ctx = make_ctx(attn_chunk=attn_chunk, kernel_backend=kernel_backend,
                   act_bits=act_bits, page_size=page_size)

    def prefill_step(params, batch, cache, start_pos=0, ptab=None):
        return model.prefill(params, batch, cache, ctx, start_pos=start_pos,
                             ptab=ptab)

    def decode_step(params, cache, tokens, pos, active=None, ptab=None):
        return model.decode_step(params, cache, tokens, pos, ctx,
                                 active=active, ptab=ptab)

    return model, prefill_step, decode_step


def make_paged_install_step(model, *, page_size: int):
    """Admission step for the paged store, whole-prefill path: move a B=1
    request cache (prefilled dense at the full ``max_seq`` width — exactly
    the computation dense admission runs, which is what makes paged
    admission bit-identical) into the slot's pages, in place.

    Token leaves scatter rows ``[0, plen)`` into the pool pages named by
    ``ptab_row`` (W,), on the device; state/fixed leaves take the
    ``write_slot`` path.  ``slot`` and ``plen`` are host ints."""
    spec = model.cache_spec
    token_paths = set(spec.token_paths)

    def install(cache, c1, slot: int, ptab_row, *, plen: int):
        zero = torch.zeros((1,), dtype=torch.int32, device=ptab_row.device)
        for path, _ in spec.leaves:
            src, dst = _get_leaf(c1, path), _get_leaf(cache, path)
            if path in token_paths:
                # pools (lead, P + 1, psz, *tail) <- rows (lead, plen, *tail)
                pidx, off = page_rows(ptab_row[None], zero, plen, page_size,
                                      dst.shape[1] - 1)
                dst[:, pidx[0], off[0]] = src[:, 0, :plen].to(dst.dtype)
            else:
                dst.narrow(CACHE_SLOT_AXIS, slot, 1).copy_(src)
        return cache

    return install


def make_sched_steps(cfg: ModelConfig, *, max_seq: int, act_bits=None,
                     attn_chunk: int = 512, kernel_backend=None,
                     page_size: int = 0):
    """Step pair for the slot scheduler (``repro_torch.launch.scheduler``).

    Returns ``(model, prefill_step, sched_decode_step)``.  The decode step
    wraps the model's ``decode_step`` with occupancy masking, all on the
    device, so every step issues the same launches whatever the occupancy
    and the loop never waits on the host:

      * inactive slots write at position ``max_seq``, past the cache, so
        ``update_cache`` drops the write (paged: past the table, so the
        write lands on the spare page) and a finished slot's KV state stops
        changing the moment it completes;
      * the greedy next token is selected on the device and frozen for
        inactive slots (``where(active, argmax, tok)``), as is ``pos``.

    Active rows see exactly the arguments the plain serve loop passes (same
    pos, same kv_len), which is what makes scheduled decode bit-compatible
    with serving a request alone."""
    model, prefill_step, decode_step = make_serve_steps(
        cfg, act_bits=act_bits, attn_chunk=attn_chunk,
        kernel_backend=kernel_backend, page_size=page_size)

    def sched_decode_step(params, cache, tok, pos, active, ptab=None):
        write_pos = torch.where(active, pos, max_seq)
        logits, cache = decode_step(params, cache, tok, write_pos,
                                    active=active.to(torch.int32), ptab=ptab)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        tok = torch.where(active, nxt, tok)
        pos = torch.where(active, pos + 1, pos)
        return logits, tok, pos, cache

    return model, prefill_step, sched_decode_step
