#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. build: compile ``src/repro_torch/csrc/*.cu`` for sm_90a and load them;
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the LLaMA and the MoE paths' shapes (Qwen3-30B-A3B's attention
   projections at 512, 4 and 8 rows, soft_round over its folded expert
   stacks and attention leaves), with times (kernel, plain version, one
   PyTorch library call as a yardstick) beside the least time the card
   could take (``bound_ms``); the paged decode attention also against the
   dense kernel on the gathered cache, bit for bit, and the expert-batched
   quant-matmul (Qwen3-30B-A3B's 128 experts, both projection shapes, every
   capacity the MoE phases run: 8, 16, 24, 32, 40 and 160) also against
   one ``quant_matmul`` launch per expert, bit for bit, and on the routed
   traffic of those paths (``ROUTED_TOKENS``: tokens routed top-8 by a
   seeded router through the port's dispatch, x zero past each expert's
   kept rows, its counts passed as ``rows``; timed with and without
   them beside a bound over the experts that hold a row) and every edge of
   the counts (``EXPERT_ROWS_PATHS``), every row past a count +0 by bit
   pattern; the int8 kernel
   bit for bit against its plain version at LLaMA-2-7B's per-channel
   linears (M = 512 and 4), a ``w4a8_matmul`` group slice of a wider x_q
   and a ragged shape, timed beside ``torch._int_mm``; the quant-matmul,
   GEMV and soft_round kernels also at phase 12's W4 per-channel shapes
   (one group of K rows: soft_round's backward sums up to 11008 rows);
   the quant-matmul kernel also on every path of its body (``QM_PATHS``:
   admission prefills of 33 and 384 rows, ragged 100x200x300 at 3 bits
   with one 200-row group, 8 bits, an x base off 16-byte alignment,
   groups of 8 rows, groups of 16, 32 and 48 rows by TMA and by plain
   loads), each record naming the tile, ring, group path and TMA use the
   kernel's host code chose (``kernel_config``, which the expert records
   also hold equal to one single-matrix launch's); decode attention also
   at Qwen3's decode shape and the long lane (S = 4096) beside SDPA, on
   every path of its body (``ATTN_PATHS``: G = 1..12, D = 20..1024, slot
   lengths at the edges of the plan's warp and split runs, a causal cut,
   an inactive slot; ``PAGED_PATHS``: pages of 2, 8, 16 and 64 positions,
   each bit for bit against the dense kernel), each record naming the
   plan (``attention_config``), and batch-invariant (each slot alone
   equals its row of a B=8 launch, bit for bit, as do two launches and
   ``active=None`` against every slot active); the soft_round pair also on
   every plan edge (``SR_PATHS``: per-channel leaves whose rows split over
   a cluster, g = 128 without a split, row counts off the split and the
   pass, g = 1 and 8, n = 1, 3, 5, 127, 129, ragged tiles, base off
   16-byte alignment, DST off, AWQ's act_scale on a leaf and on an expert
   fold), each record naming both launches' plan (``soft_round_config``),
   the backward repeated bit for bit, and the act_scale division folded
   into both launches bit for bit against the outside division at every
   timed shape;
3. serve: LLaMA-2-7B at full width and depth (random weights from a seed),
   RTN-quantized to W2A16g128 and packed, served by ``serve_requests`` on
   the ``"pallas"`` backend (4 requests x 128 prompt tokens, 16 generated);
   the launch counts of that run prove every prefill projection, decode
   projection and decode attention went through the kernels, and a
   teacher-forced run of the ``"xla"`` backend holds its logits to
   rounding-level differences; one more prefill under ``torch.profiler``
   prints where its time goes (device busy time, kernel launches, the top
   kernels and host operators);
4. parity: the reduced llama2/tinyllama configs served on the card and,
   from the same params, on the CPU (plain versions);
5. calibrate: LLaMA-2-7B at full width, depth cut to 2 layers (random
   weights from a seed), W2A16g128 on the ``"pallas"`` backend: AWQ
   initialization, then TesseraQ (the paper's 20-rate PAR schedule, T cut
   to 10 steps) on 32 x 512-token calibration samples, ``pack_model`` and
   the perplexity of the packed and the fake-quant params; the launch
   counts of that run prove every θ̂ and its gradient went through the
   soft_round kernels and the packed perplexity through the quant-matmul
   kernel; then where one Soften step's time goes at that width (θ̂'s
   ``prepare`` beside its pullback, the per-sample loop, AdamW);
6. calibration parity: the reduced llama2 config in f32 calibrated
   (AWQ + TesseraQ, K=3, T=15) on the card and, from the same params, on
   the CPU (plain versions): codes and hardened masks must agree;
7. schedule: the serve phase's packed LLaMA-2-7B served by the
   continuous-batching scheduler (``serve_scheduled``, 8 slots, 16 seeded
   requests with prompts of 16..384 tokens and budgets of 4..48) on the
   dense store and on the paged store (16-token pages), on a tight pool,
   with chunked prefill, with copy-on-write prefix sharing, each request
   alone, and the lock-step baseline; dense and paged tokens must be equal,
   launch counts exact, and the decode steps free of host syncs; where
   one decode step's time goes on each store (``torch.profiler``); then
   the reduced llama2 config scheduled on the paged store on the card and
   on the CPU;
8. MoE serve: Qwen3-30B-A3B at full width, depth cut to 16 of 48 layers
   (random weights from a seed), RTN-quantized to W2A16g128 and packed,
   served by ``serve_requests`` on ``"pallas"`` (4 requests x 128 prompt
   tokens, 16 generated); exact launch counts (3 expert-batched launches
   per layer per forward, 4 attention projections per layer through the
   quant-matmul or GEMV kernel by row count, 1 decode attention per layer
   per decode step) and the teacher-forced ``"xla"`` check of phase 3;
9. MoE parity: the reduced qwen3 config served on the card and, from the
   same params, on the CPU;
10. MoE schedule: phase 8's packed model through ``serve_scheduled`` (8
   slots, phase 7's workload at vocab 151936) on the dense and the paged
   store and again on the dense store: tokens equal across the three,
   exact launch counts, no host sync inside a decode step; a request for
   chunked prefill and prefix sharing runs whole prefill, as the MoE cache
   spec says; then where one dense decode step's time goes
   (``torch.profiler``: device busy, and the expert kernel's device ms and
   launches per step);
11. MoE calibrate: Qwen3-30B-A3B at full width, depth 1 block, AWQ +
   TesseraQ (20-rate PAR schedule, T cut to 10) on 8 x 512-token samples,
   ``pack_model`` and perplexity; exact soft_round launches over the
   expert leaves and expert-kernel launches of the packed perplexity; then
   where one Soften step's time goes;
12. weight-activation: (a) LLaMA-2-7B at full width and depth, RTN W4
   per-channel + pack, served with ``act_bits=8`` (phase 3's requests,
   exact launch counts, the teacher-forced ``"xla"`` check at A8); (b)
   ``ops.w4a8_matmul`` at act_bits 8 and 4 on layer 0's seven linears fed
   their own activations from (a)'s prefill and a decode step, bit for bit
   against the plain-version path and close to the fake-quant ``"xla"``
   product, then one g128 linear (K / g launches per call); (c) W4A4
   per-channel AWQ + TesseraQ at phase 5's width, depth and schedule with
   the activations fake-quantized in the walk, pack, perplexity under
   act_bits=4; (d) the reduced qwen3 at W4A8 on the card and on the CPU;
13. methods: the paper's comparison methods at phase 5's width, depth,
   data and W2A16g128: RTN, AWQ, GPTQ (Hessian capture + column walk),
   OmniQuant's learnable weight clipping and SignRound (50 steps a block
   each), every block's recon_mse below its initialization's (GPTQ and
   OmniQuant below RTN's, SignRound below AWQ's); GPTQ, OmniQuant and
   SignRound packed, their perplexity through the quant-matmul kernel
   with exact launches; layer 0's wq Hessian against float64 and its GPTQ
   codes on the card against the CPU walk from the same W and H; QuaRot's
   rotation of the FP model, its logits against the unrotated model's;
14. harness: ``repro_torch.eval.harness.main`` at its defaults
   (TinyLlama-1.1B at full width, W4A16g32: FP / RTN / AWQ / TesseraQ
   rows and the ``"xla"`` vs ``"pallas"`` logits gate) and at the
   reference's CI settings (``--reduced``, ``--smoke``), each with exact
   launch counts; where the free-running gate fails, the greedy tokens of
   both backends and a teacher-forced reading tell bf16 rounding or a
   flipped token from a wrong kernel, and at the CI settings the gate must
   pass with the ``"xla"`` dequantization rounded as the kernels round it;
15. a JSON line listing the ported kernels with their numbers;
16. last line: ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no result.
Without a CUDA device, or without ``src/repro_torch`` beside this script,
it exits non-zero at once.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): the bound_ms denominators
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12

# kernel vs plain version: both accumulate in f32, in different orders, and
# round the result to bf16.  Allowed: 2 bf16 ulps of the larger magnitude,
# plus an f32 reordering allowance of 2^-16 times the sum of |terms|
# (about sqrt(K) f32 roundings at K <= 11008).
ULPS = 2
REORDER = 2.0 ** -16
# ~0.15 ms of device spin before each timed launch of phase 2 (cuda_ms):
# longer than the host path of any wrapper timed there.  The quant-matmul,
# GEMV and decode-attention records also carry the same launches timed
# without it (``*_ms_nospin``), so a time can be set beside one taken by
# events alone.
SPIN_CYCLES = 300_000

MAIN_SHAPES = ((4096, 4096, 4), (4096, 11008, 2), (11008, 4096, 1))  # K, N, per layer
# Qwen3-30B-A3B's attention projections (q, k and v, o): K, N, per layer
MOE_ATTN_SHAPES = ((2048, 4096, 1), (2048, 512, 2), (4096, 2048, 1))


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def bf16_ulp(t):
    a = t.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def within(got, want, slack):
    """Elementwise |got - want| <= ULPS ulps + slack; returns (ok, max err)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    lim = ULPS * bf16_ulp(torch.maximum(got.abs(), want.abs())) + slack
    return bool((diff <= lim).all()), float(diff.max())


def cuda_ms(fn, iters=20, flush=None, spin=SPIN_CYCLES):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after warm-up.  ``flush`` (outside the timed region) evicts L2, and a
    spin of ``spin`` cycles on the device then keeps it busy while the host
    enqueues ``fn``, so a launch shorter than its host-side path is timed
    on the device and not by the host's pace.  ``spin=0`` times by the
    events alone: where the host path of ``fn`` outlasts its device time,
    that reads the host's pace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
            if spin:
                torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(nbytes, flops, peak=BF16_FLOP_PER_S):
    """Least time for moving ``nbytes`` and doing ``flops`` operations at
    ``peak`` operations per second (bf16 unless stated: the int8 kernel's
    rows pass the int8 peak)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def quant_operands(gen, M, K, N, bits, group_size):
    from repro_torch.core.qtensor import pack
    dev = "cuda"
    codes = torch.randint(0, 1 << bits, (K, N), generator=gen, device=dev,
                          dtype=torch.int32)
    packed = pack(codes, bits)
    ng = K // group_size
    scale = (torch.rand((ng, N), generator=gen, device=dev) * 0.015 + 0.005)
    zero = torch.randint(0, 1 << bits, (ng, N), generator=gen, device=dev
                         ).float()
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    return x, packed, scale, zero


def show(name, rec, card):
    print(f"[kernels] {name} " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in rec.items()) + f" card=[{card}]", flush=True)


def check_quant(name, fn, plain, gen, M, K, N, bits, group_size, flush, card,
                main=False, moe=False, wa=False, sched=False, x_offset=0):
    """Kernel vs plain version at one shape, then both timed with the
    library matmul on the pre-dequantized weight; ``main``, ``moe``, ``wa``
    and ``sched`` mark the shapes the LLaMA (W2 g128, M=4), the MoE, the
    weight-activation (W4 per-channel) and the scheduled decode (W2 g128,
    M=8) paths run (summed in the kernels line).  ``x_offset`` > 0 takes x
    as rows ``x_offset:`` of a wider buffer (a base the kernel cannot load
    by TMA or 16-byte copies when 2 * K * x_offset is not a multiple of
    16).  Each record names the configuration the kernel's host code chose
    (``kernel_config`` / ``gemv_config``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.quant_gemv import gemv_config
    from repro_torch.kernels.quant_matmul import (dequantize_rows,
                                                  kernel_config)
    x, packed, scale, zero = quant_operands(gen, M + x_offset, K, N, bits,
                                            group_size)
    x = x[x_offset:]
    kw = dict(bits=bits, group_size=group_size)
    n0 = build.LAUNCHES[name]
    got = fn(x, packed, scale, zero, **kw)
    torch.cuda.synchronize()
    want = plain(x, packed, scale, zero, **kw)
    w = dequantize_rows(packed, scale, zero, dtype=torch.bfloat16, **kw)
    slack = REORDER * (x.float().abs() @ w.float().abs())
    ok, err = within(got, want, slack)
    if not ok:
        fail(f"{name} disagrees with its plain version at M={M} K={K} N={N} "
             f"bits={bits} g={group_size}: max |diff| {err}")
    rec = {"M": M, "K": K, "N": N, "bits": bits, "g": group_size,
           "max_abs_err": err, "main": main, "moe": moe, "wa": wa,
           "sched": sched}
    config = kernel_config if name == "quant_matmul" else gemv_config
    rec["config"] = config(x, packed, scale, zero, **kw)
    rec["kernel_ms"] = cuda_ms(lambda: fn(x, packed, scale, zero, **kw),
                               flush=flush)
    rec["plain_ms"] = cuda_ms(lambda: plain(x, packed, scale, zero, **kw),
                              iters=5, flush=flush)
    rec["library_ms"] = cuda_ms(lambda: torch.matmul(x, w), flush=flush)
    rec["kernel_ms_nospin"] = cuda_ms(
        lambda: fn(x, packed, scale, zero, **kw), flush=flush, spin=0)
    rec["library_ms_nospin"] = cuda_ms(lambda: torch.matmul(x, w),
                                       flush=flush, spin=0)
    ppb = {2: 4, 3: 2, 4: 2, 8: 1}[bits]
    nbytes = M * K * 2 + K * N // ppb + 2 * (K // group_size) * N * 4 \
        + M * N * 2
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * M * K * N)
    rec["launches"] = build.LAUNCHES[name] - n0
    show(name, rec, card)
    return rec


def attention_operands(gen, B, S, Hkv, G, D, kv_len, q_pos, active):
    dev = "cuda"
    q = torch.randn((B, Hkv, G, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    as_i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return q, k, v, as_i32(kv_len), as_i32(q_pos), as_i32(active)


def check_attention(gen, B, S, Hkv, G, D, kv_len, q_pos, active, flush, card,
                    main=False, moe=False, long=False, timed=True):
    """Kernel vs plain version at one shape (inactive slots exact zeros),
    then, if ``timed``, both timed with SDPA over the live positions where
    one call computes the same function.  ``main``, ``moe`` and ``long``
    mark the LLaMA decode shape, the Qwen3 shape and the long lane (summed
    in the kernels line).  Each record names the plan the kernel's host
    code chose (``attention_config``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import (attention_config,
                                                      decode_attention,
                                                      decode_attention_plain)
    q, k, v, kl, qp, act = attention_operands(gen, B, S, Hkv, G, D, kv_len,
                                              q_pos, active)
    kw = dict(kv_len=kl, q_pos=qp, active=act)
    n0 = build.LAUNCHES["decode_attention"]
    got = decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, **kw)
    ok, err = within(got, want, REORDER * float(v.float().abs().max()))
    if not ok:
        fail(f"decode_attention disagrees with its plain version at "
             f"B={B} S={S} Hkv={Hkv} G={G} D={D} kv_len={list(kv_len)}: "
             f"max |diff| {err}")
    for b in range(B):
        if active[b] == 0 and not bool((got[b] == 0).all()):
            fail(f"decode_attention: inactive slot {b} is not exact zeros")
    rec = {"B": B, "S": S, "Hkv": Hkv, "G": G, "D": D,
           "kv_len": list(kv_len), "q_pos": list(q_pos),
           "active": list(active), "max_abs_err": err, "main": main,
           "moe": moe, "long": long,
           "config": attention_config(q, k, v)}
    if timed:
        time_attention(rec, q, k, v, kw, flush)
    rec["launches"] = build.LAUNCHES["decode_attention"] - n0
    show("decode_attention", rec, card)
    return rec


def time_attention(rec, q, k, v, kw, flush):
    """Kernel, plain version and (where one call computes the same
    function) SDPA times of one check_attention record, and its bound."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    B, Hkv, G, D = q.shape
    kv_len, q_pos, active = rec["kv_len"], rec["q_pos"], rec["active"]
    rec["kernel_ms"] = cuda_ms(lambda: decode_attention(q, k, v, **kw),
                               flush=flush)
    rec["kernel_ms_nospin"] = cuda_ms(
        lambda: decode_attention(q, k, v, **kw), flush=flush, spin=0)
    rec["plain_ms"] = cuda_ms(lambda: decode_attention_plain(q, k, v, **kw),
                              flush=flush)
    # SDPA over the live positions, K/V laid out (B, H, n, D) beforehand: one
    # call computes the same function only when every slot is live at one
    # length (causal q_pos = kv_len - 1)
    rec["library_ms"] = rec["library_ms_nospin"] = None
    n = kv_len[0]
    if min(active) == 1 and all(kv_len[b] == n and q_pos[b] == n - 1
                                for b in range(B)):
        qs = q.reshape(B, Hkv * G, 1, D)
        ks = k[:, :n].permute(0, 2, 1, 3).repeat_interleave(G, 1).contiguous()
        vs = v[:, :n].permute(0, 2, 1, 3).repeat_interleave(G, 1).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec["library_ms"] = cuda_ms(lambda: sdpa(qs, ks, vs), flush=flush)
        rec["library_ms_nospin"] = cuda_ms(lambda: sdpa(qs, ks, vs),
                                           flush=flush, spin=0)
        del ks, vs
    live = sum(min(kv_len[b], q_pos[b] + 1) for b in range(B) if active[b])
    nbytes = 2 * live * Hkv * D * 2 + 2 * B * Hkv * G * D * 2 + 3 * B * 4
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * live * Hkv * G * D)


def check_paged_attention(gen, B, W, psz, Hkv, G, D, kv_len, active, flush,
                          card, main=False, timed=True):
    """Paged kernel vs its plain version, and vs the dense kernel on the
    gathered cache (bit for bit, on the same plan), over a permuted page
    table; then, if ``timed``, the times."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import (
        attention_config, decode_attention, paged_decode_attention,
        paged_decode_attention_plain)
    from repro_torch.models.common import gather_pages
    dev = "cuda"
    P = B * W + 5
    q = torch.randn((B, Hkv, G, D), generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn((P, psz, Hkv, D), generator=gen, device=dev
                     ).to(torch.bfloat16)
    vp = torch.randn((P, psz, Hkv, D), generator=gen, device=dev
                     ).to(torch.bfloat16)
    ptab = torch.randperm(P, generator=gen, device=dev)[:B * W].reshape(
        B, W).to(torch.int32)
    q_pos = [n - 1 for n in kv_len]
    as_i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    kw = dict(kv_len=as_i32(kv_len), q_pos=as_i32(q_pos),
              active=as_i32(active))
    n0 = build.LAUNCHES["paged_decode_attention"]
    got = paged_decode_attention(q, kp, vp, ptab, **kw)
    torch.cuda.synchronize()
    want = paged_decode_attention_plain(q, kp, vp, ptab, **kw)
    ok, err = within(got, want, REORDER * float(vp.float().abs().max()))
    if not ok:
        fail(f"paged_decode_attention disagrees with its plain version at "
             f"B={B} W={W} psz={psz} Hkv={Hkv} G={G}: max |diff| {err}")
    kg, vg = gather_pages(kp, ptab), gather_pages(vp, ptab)
    if not torch.equal(got, decode_attention(q, kg, vg, **kw)):
        fail(f"paged_decode_attention is not bit-identical to the dense "
             f"kernel on the gathered cache at psz={psz} G={G}")
    config = attention_config(q, kp, vp, S=W * psz)
    if config != attention_config(q, kg, vg):
        fail(f"paged and dense decode attention take different plans at "
             f"psz={psz}: {config} vs {attention_config(q, kg, vg)}")
    for b in range(B):
        if active[b] == 0 and not bool((got[b] == 0).all()):
            fail(f"paged_decode_attention: inactive slot {b} is not zeros")
    rec = {"B": B, "W": W, "psz": psz, "Hkv": Hkv, "G": G, "D": D,
           "kv_len": list(kv_len), "active": list(active),
           "max_abs_err": err, "bit_identical_to_dense": True, "main": main,
           "config": config}
    if timed:
        rec["kernel_ms"] = cuda_ms(
            lambda: paged_decode_attention(q, kp, vp, ptab, **kw),
            flush=flush)
        rec["kernel_ms_nospin"] = cuda_ms(
            lambda: paged_decode_attention(q, kp, vp, ptab, **kw),
            flush=flush, spin=0)
        rec["plain_ms"] = cuda_ms(
            lambda: paged_decode_attention_plain(q, kp, vp, ptab, **kw),
            flush=flush)
        rec["dense_kernel_ms"] = cuda_ms(
            lambda: decode_attention(q, kg, vg, **kw), flush=flush)
        # yardstick, not the same function: SDPA with a boolean length mask
        # over the gathered cache laid out (B, H, S, D) beforehand (gather
        # and layout outside the timed region); it computes the inactive
        # slot too
        S = W * psz
        qs = q.reshape(B, Hkv * G, 1, D)
        ks = kg.permute(0, 2, 1, 3).repeat_interleave(G, 1).contiguous()
        vs = vg.permute(0, 2, 1, 3).repeat_interleave(G, 1).contiguous()
        mask = (torch.arange(S, device=dev)[None, :]
                < kw["kv_len"][:, None])[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec["library_ms"] = cuda_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask),
                                    flush=flush)
        rec["library_ms_nospin"] = cuda_ms(
            lambda: sdpa(qs, ks, vs, attn_mask=mask), flush=flush, spin=0)
        live = sum(kv_len[b] for b in range(B) if active[b])
        pages = sum(-(-kv_len[b] // psz) for b in range(B) if active[b])
        nbytes = 2 * live * Hkv * D * 2 + 2 * B * Hkv * G * D * 2 \
            + 3 * B * 4 + pages * 4
        rec["bound_ms"], rec["bound_by"] = bound(nbytes,
                                                 4 * live * Hkv * G * D)
    rec["launches"] = build.LAUNCHES["paged_decode_attention"] - n0
    show("paged_decode_attention", rec, card)
    return rec


# decode attention on every path of its body, each at one shape (S, Hkv, G,
# D; the plan each takes is printed with its record): the LLaMA decode
# shape (one split of 8 warps x 18 positions), GQA at G = 4 and 8 (Qwen3: 2
# splits), S = 100 (not a multiple of a split's run), the long lane S = 4096
# (8 splits of 8 warps x 64), S = 368 (the scheduled max_seq, 8 x 46), D
# = 64 (4 rows a warp step), D = 72 (lanes past D masked), D = 20 (not a
# multiple of 8: plain loads) with G = 12 (six blocks of 2 query rows along
# G), D = 512 and 1024 (16 and 32 values a lane per row).  Each shape runs
# one launch whose slots see n_b = 1, one below, at and one past a warp's
# run and a split's run, and S, plus a causal cut (q_pos < kv_len - 1) and
# an inactive slot (``attention_lengths``).
ATTN_PATHS = ((144, 32, 1, 128), (144, 8, 4, 128), (144, 4, 8, 128),
              (100, 32, 1, 128), (4096, 32, 1, 128), (4096, 4, 8, 128),
              (368, 32, 1, 128), (144, 4, 8, 64), (40, 2, 4, 72),
              (33, 2, 12, 20), (64, 2, 2, 512), (48, 1, 3, 1024))
# the paged walk at 8, 16 and 64 positions a page, and 2 (a warp's run spans
# more than 32 pages: the table read per row), each over a permuted table
# and bit for bit against the dense kernel: B, W, psz, Hkv, G, D
PAGED_PATHS = ((8, 46, 8, 32, 1, 128), (8, 23, 16, 4, 8, 128),
               (8, 6, 64, 8, 4, 128), (4, 2048, 2, 8, 1, 128))


def attention_lengths(S, config):
    """kv_len, q_pos, active of a launch that covers the plan's edges at
    sequence width S: n_b = 1, a warp's run and a split's run one below,
    at and one past, and S; then S with a causal cut at S // 2 + 1,
    and an inactive slot."""
    run = config["run"]
    split = config["warps"] * run
    lens = sorted({n for n in (1, run - 1, run, run + 1, split - 1, split,
                               split + 1, S) if 1 <= n <= S})
    kv_len = lens + [S, S]
    q_pos = [n - 1 for n in lens] + [S // 2, S - 1]
    active = [1] * (len(lens) + 1) + [0]
    return kv_len, q_pos, active


def check_attention_path(gen, S, Hkv, G, D, flush, card):
    """check_attention on ``attention_lengths`` of the plan at this shape
    (untimed)."""
    from repro_torch.kernels.decode_attention import attention_config
    probe = torch.empty((1, S, Hkv, D), dtype=torch.bfloat16, device="cuda")
    qp = torch.empty((1, Hkv, G, D), dtype=torch.bfloat16, device="cuda")
    kv_len, q_pos, active = attention_lengths(
        S, attention_config(qp, probe, probe))
    return check_attention(gen, len(kv_len), S, Hkv, G, D, kv_len, q_pos,
                           active, flush, card, timed=False)


# batch invariance of decode attention: S, Hkv, G, D
ATTN_INVARIANCE = ((144, 32, 1, 128), (144, 4, 8, 128), (368, 32, 1, 128))


def check_attention_invariance(gen, S, Hkv, G, D, card):
    """Decode attention's batch invariance and determinism on the card: each
    slot of a B=8 launch (ragged lengths, a causal cut, an inactive slot)
    launched alone (B=1, same S) equals its row bit for bit, two launches
    on the same operands are bit-equal, and ``active=None`` (the kernel's
    null pointer: every slot live) equals an all-ones ``active``."""
    from repro_torch.kernels.decode_attention import decode_attention
    lens = [S, 1, S // 2, 17, S - 1, 40, S, 96][:8]
    kv_len = [min(n, S) for n in lens]
    q_pos = [n - 1 for n in kv_len]
    q_pos[6] = S // 3
    active = [1, 1, 1, 1, 1, 0, 1, 1]
    q, k, v, kl, qp, act = attention_operands(gen, 8, S, Hkv, G, D, kv_len,
                                              q_pos, active)
    same = lambda a, b: torch.equal(a.view(torch.int16), b.view(torch.int16))
    full = decode_attention(q, k, v, kv_len=kl, q_pos=qp, active=act)
    for b in range(8):
        one = decode_attention(q[b:b + 1].contiguous(),
                               k[b:b + 1].contiguous(),
                               v[b:b + 1].contiguous(), kv_len=kl[b:b + 1],
                               q_pos=qp[b:b + 1], active=act[b:b + 1])
        if not same(one, full[b:b + 1]):
            fail(f"decode_attention slot {b} alone differs from its row of "
                 f"the B=8 launch (S={S} Hkv={Hkv} G={G} D={D})")
    if not same(decode_attention(q, k, v, kv_len=kl, q_pos=qp, active=act),
                full):
        fail(f"decode_attention: two launches on the same operands differ "
             f"(S={S} Hkv={Hkv} G={G} D={D})")
    ones = torch.ones_like(act)
    if not same(decode_attention(q, k, v, kv_len=kl, q_pos=qp),
                decode_attention(q, k, v, kv_len=kl, q_pos=qp, active=ones)):
        fail(f"decode_attention: active=None differs from every slot active "
             f"(S={S} Hkv={Hkv} G={G} D={D})")
    torch.cuda.synchronize()
    rec = {"S": S, "Hkv": Hkv, "G": G, "D": D, "kv_len": kv_len,
           "alone_rows_bit_equal": True, "two_launches_bit_equal": True,
           "null_active_bit_equal": True}
    print(f"[kernels] decode_attention invariance {rec} card=[{card}]",
          flush=True)
    return rec


# soft_round at the main path's leaves (g = 128): (ng, out, leaves per layer)
SR_SHAPES = ((32, 4096, 4), (32, 11008, 2), (86, 4096, 1))
# ... and at Qwen3-30B-A3B's: expert stacks fold to (E·ng, g, n) with E = 128
# (gate and up, down), then q, k and v, o
MOE_SR_SHAPES = ((2048, 768, 2), (768, 2048, 1), (16, 4096, 1), (16, 512, 2),
                 (32, 2048, 1))
SR_G = 128
# the folded expert stacks of MOE_SR_SHAPES: experts sharing one act_scale
MOE_SR_EXPERTS = {(2048, 768): 128, (768, 2048): 128}


def f32_ulp(t):
    a = t.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 23)


def sr_operands(gen, ng, g, n, bits, offset=0):
    """A TesseraQ leaf state as the soften loop sees it: about half of
    ``hard`` frozen, with both signs.  ``offset`` > 0 places ``base`` that
    many f32 past the start of its buffer (off 16-byte alignment for 1..3:
    the kernels' scalar edge path)."""
    dev = "cuda"
    qmax = (1 << bits) - 1
    zero = torch.randint(0, qmax + 1, (ng, n), generator=gen,
                         device=dev).float()
    base = (torch.randint(-2, qmax + 2, (ng, g, n), generator=gen,
                          device=dev).float() - zero[:, None, :])
    nu = torch.randn((ng, g, n), generator=gen, device=dev) * 3
    frz = torch.rand((ng, g, n), generator=gen, device=dev) < 0.5
    sgn = torch.where(torch.rand((ng, g, n), generator=gen, device=dev)
                      < 0.5, -1, 1)
    hard = torch.where(frz, sgn, 0).to(torch.int8)
    v = torch.randn((ng, n), generator=gen, device=dev) * 0.3
    scale = torch.rand((ng, n), generator=gen, device=dev) * 0.02 + 0.005
    dout = torch.randn((ng, g, n), generator=gen, device=dev)
    if offset:
        buf = torch.empty(ng * g * n + offset, device=dev)
        base = buf[offset:].view(ng, g, n).copy_(base)
    return (base.contiguous(), nu, hard, v, scale, zero), dout


def sr_act(gen, ng, g, fold):
    """AWQ's act_scale for a leaf of ``ng`` groups folded from ``fold``
    experts that share it: length ng / fold · g, in [0.5, 1.5)."""
    return torch.rand(ng // fold * g, generator=gen, device="cuda") + 0.5


def sr_fused_check(ops, dout, act, fold, kw, timed):
    """act_scale folded into both launches against the unfused reading, as
    ``soft_weight`` computed it before the fold: the kernel, then the
    division of the flat (E, in, out) weight by act[:, None] (forward); that
    division of the cotangent, then the kernel (backward).  Bit for bit;
    ``timed`` adds the four times."""
    from repro_torch.kernels.soft_round import soft_round, soft_round_bwd
    ng, g, n = ops[0].shape
    flat = (fold, ng // fold * g, n)

    def fused_f():
        return soft_round(*ops, **kw, act_scale=act)

    def fused_b():
        return soft_round_bwd(dout, *ops, **kw, act_scale=act)

    def unfused_f():
        return (soft_round(*ops, **kw).reshape(flat)
                / act[:, None]).reshape(ng, g, n)

    def unfused_b():
        return soft_round_bwd((dout.reshape(flat) / act[:, None]).reshape(
            ng, g, n), *ops, **kw)

    (fnu, fv), (unu, uv) = fused_b(), unfused_b()
    if not torch.equal(fused_f(), unfused_f()) or not torch.equal(fnu, unu) \
            or (fv is not None and not torch.equal(fv, uv)):
        fail(f"soft_round with act_scale folded in is not bit-identical to "
             f"the outside division at ng={ng} g={g} n={n} fold={fold}")
    rec = {"act_fold": fold, "act_fused_bit_identical": True}
    if timed:
        rec["fwd_act_ms"] = cuda_ms(fused_f, flush=timed)
        rec["fwd_act_unfused_ms"] = cuda_ms(unfused_f, flush=timed)
        rec["bwd_act_ms"] = cuda_ms(fused_b, flush=timed)
        rec["bwd_act_unfused_ms"] = cuda_ms(unfused_b, flush=timed)
    return rec


def check_soft_round(gen, ng, n, bits, dst, flush, card, main=False,
                     moe=False, wa=False, g=None, fold=None, offset=0,
                     experts=1):
    """soft_round forward and backward kernels vs their plain versions at
    one leaf shape (``g`` rows per group, ``SR_G`` if None; ``wa`` marks
    the per-channel leaves of the W4A4 calibration, ng = 1 and g = K).
    ``fold`` (experts sharing one act_scale) passes AWQ's act_scale to both
    versions; ``offset`` puts ``base`` off 16-byte alignment.
    Tolerances (σ is computed by other code in the two versions): θ̂ within
    4 f32 ulps plus 4 ulps of (qmax + 1) times the effective scale (σ's
    rounding moves u = base + zero + α by an ulp of u; over act_scale's
    row where it divides); dν within 4 ulps plus 4·2^-24·|d·s_eff| (σ'
    carries σ's absolute rounding; d the cotangent after act_scale's
    division); dv the same allowance summed over the group plus 2^-16 times
    the sum of |terms| (reduction order).  Then the backward again, bit for
    bit; with act_scale, or at a timed shape (``main``/``moe``/``wa``: one
    vector shared by ``experts``), the fused launches bit for bit against
    the outside division (:func:`sr_fused_check`).  Each record names the plan of both
    launches (``soft_round_config``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.soft_round import (divide_rows, soft_round,
                                                soft_round_bwd,
                                                soft_round_bwd_plain,
                                                soft_round_config,
                                                soft_round_plain)
    g = g or SR_G
    qmax = (1 << bits) - 1
    ops, dout = sr_operands(gen, ng, g, n, bits, offset)
    timed = main or moe or wa
    act = sr_act(gen, ng, g, fold) if fold else None
    kw = dict(qmax=qmax, dst=dst)
    n0 = (build.LAUNCHES["soft_round_fwd"], build.LAUNCHES["soft_round_bwd"])
    got = soft_round(*ops, **kw, act_scale=act)
    gnu, gv = soft_round_bwd(dout, *ops, **kw, act_scale=act)
    torch.cuda.synchronize()
    want = soft_round_plain(*ops, **kw, act_scale=act)
    wnu, wv = soft_round_bwd_plain(dout, *ops, **kw, act_scale=act)
    base, nu, hard, v, scale, zero = ops
    s_eff = scale * (2.0 * torch.sigmoid(v)) if dst else scale
    s_eff = s_eff[:, None, :]
    d, want0, row = dout, want, 1.0
    if act is not None:
        d = divide_rows(dout, act)
        want0 = soft_round_plain(*ops, **kw)
        row = divide_rows(torch.ones_like(dout), act)
    chain = (d * s_eff).abs()
    lim = 4 * f32_ulp(torch.maximum(got.abs(), want.abs())) \
        + 4 * f32_ulp(torch.tensor(float(qmax + 1))) * s_eff.abs() * row
    err = (got - want).abs()
    if not bool((err <= lim).all()):
        fail(f"soft_round forward disagrees at ng={ng} g={g} n={n} "
             f"bits={bits} dst={dst} fold={fold} offset={offset}: max "
             f"|diff| {float(err.max())}")
    lim_nu = 4 * f32_ulp(torch.maximum(gnu.abs(), wnu.abs())) \
        + 4 * 2.0 ** -24 * chain
    err_nu = (gnu - wnu).abs()
    if not bool((err_nu <= lim_nu).all()):
        fail(f"soft_round backward (dnu) disagrees at ng={ng} g={g} n={n} "
             f"bits={bits} dst={dst} fold={fold} offset={offset}: max "
             f"|diff| {float(err_nu.max())}")
    err_v = 0.0
    if dst:
        q = want0 / s_eff + zero[:, None, :]
        terms = (d * (q - zero[:, None, :]) * s_eff).abs().sum(1)
        lim_v = 4 * f32_ulp(torch.maximum(gv.abs(), wv.abs())) \
            + REORDER * terms \
            + 4 * f32_ulp(torch.tensor(float(qmax + 1))) * chain.sum(1)
        ev = (gv - wv).abs()
        err_v = float(ev.max())
        if not bool((ev <= lim_v).all()):
            fail(f"soft_round backward (dv) disagrees at ng={ng} g={g} n={n} "
                 f"bits={bits} fold={fold} offset={offset}: max |diff| "
                 f"{err_v}")
    elif gv is not None:
        fail("soft_round backward returned dv without DST")
    # determinism: the backward's fixed-order reduction repeats bit for bit
    gnu2, gv2 = soft_round_bwd(dout, *ops, **kw, act_scale=act)
    if not torch.equal(gnu, gnu2) or (dst and not torch.equal(gv, gv2)):
        fail("soft_round backward is not bit-for-bit repeatable")
    rec = {"ng": ng, "g": g, "n": n, "bits": bits, "dst": dst,
           "fold": fold, "offset": offset,
           "max_abs_err": float(err.max()), "max_abs_err_dnu":
           float(err_nu.max()), "max_abs_err_dv": err_v, "main": main,
           "moe": moe, "wa": wa,
           "config": {"fwd": soft_round_config(base, nu, hard, got),
                      "bwd": soft_round_config(base, nu, hard, gnu,
                                               dout=dout)}}
    if act is not None or timed:
        f = fold or experts
        rec.update(sr_fused_check(
            ops, dout, act if act is not None else sr_act(gen, ng, g, f), f,
            kw, flush if timed else None))
    if timed:
        rec["fwd_ms"] = cuda_ms(lambda: soft_round(*ops, **kw), flush=flush)
        rec["fwd_plain_ms"] = cuda_ms(lambda: soft_round_plain(*ops, **kw),
                                      iters=5, flush=flush)
        rec["bwd_ms"] = cuda_ms(lambda: soft_round_bwd(dout, *ops, **kw),
                                flush=flush)
        rec["bwd_plain_ms"] = cuda_ms(
            lambda: soft_round_bwd_plain(dout, *ops, **kw), iters=5,
            flush=flush)
        rec["fwd_ms_nospin"] = cuda_ms(lambda: soft_round(*ops, **kw),
                                       flush=flush, spin=0)
        rec["bwd_ms_nospin"] = cuda_ms(
            lambda: soft_round_bwd(dout, *ops, **kw), flush=flush, spin=0)
        elems, groups = ng * g * n, ng * n
        rec["fwd_bound_ms"], rec["fwd_bound_by"] = bound(
            elems * (4 + 4 + 1 + 4) + groups * 4 * (3 if dst else 2), 0)
        rec["bwd_bound_ms"], rec["bwd_bound_by"] = bound(
            elems * (4 + 4 + 4 + 1 + 4)
            + groups * 4 * (3 + (1 if dst else 0)), 0)
    rec["launches"] = (build.LAUNCHES["soft_round_fwd"] - n0[0],
                       build.LAUNCHES["soft_round_bwd"] - n0[1])
    show("soft_round", rec, card)
    return rec


# every plan edge of the soft_round pair: (ng, g, n, bits, dst, fold,
# offset); fold None runs without act_scale, else with one vector shared
# by ``fold`` experts.  Per-channel leaves (ng = 1) split their rows over
# a cluster (4096 and 11008 rows; 86 tiles split 6 ways); g = 128 at
# LLaMA's widths does not split; g = 1000 / 999 / 130 are no multiple of
# the rows per split or of a pass (the last split shorter); g = 1 and 8 take
# 1 and 2 warps; n = 1, 3, 5, 127, 129, 4098 (n % 4 != 0: the scalar path)
# and a ragged last tile (300, 132); base off 16-byte alignment; DST off;
# act_scale on a leaf and on an expert fold of 4
SR_PATHS = ((1, 4096, 4096, 4, True, 1, 0), (1, 11008, 4096, 4, True, None, 0),
            (1, 4096, 11008, 4, False, None, 0),
            (32, 128, 4096, 2, True, None, 0),
            (2, 1000, 300, 3, True, 2, 0), (1, 999, 132, 2, True, None, 0),
            (3, 130, 4098, 2, True, None, 0), (64, 1, 256, 2, True, 1, 0),
            (16, 8, 384, 3, True, None, 0), (4, 128, 1, 2, True, None, 0),
            (4, 128, 3, 2, True, None, 0), (4, 128, 5, 3, False, None, 0),
            (4, 128, 127, 2, True, 1, 0), (4, 128, 129, 4, True, None, 0),
            (32, 128, 4096, 2, True, None, 1), (8, 128, 256, 2, True, 4, 0),
            (8, 128, 256, 2, False, 4, 0))


# Qwen3-30B-A3B's expert products (E = 128): (K, N, launches per layer),
# and the capacity rows of the MoE serve's prefill (4 x 128 tokens -> 40)
# and decode (4 or 8 slots -> 8)
EXPERTS = 128
EXPERT_SHAPES = ((2048, 768, 2), (768, 2048, 1))
EXPERT_C = (40, 8)
# further capacities the MoE phases run: the schedule's batch-1 admission
# prefills (40..333 tokens: C = 8..32) and the calibrate phase's packed
# perplexity (4 x 512 tokens: C = 160, two 128-row tiles)
MORE_EXPERT_C = (16, 24, 32, 160)
# the routed traffic of those paths: tokens routed top-8 over the 128
# experts by a seeded uniform router through the port's own dispatch
# (``moe._dispatch``, capacity from ``moe._capacity``), x zero past each
# expert's count as the capacity buffer holds it: a decode step at 4 and 8
# slots (C = 8; ~29 and ~52 experts hold a row), the 4 x 128 prefill (C =
# 40, pairs dropped past it) and the packed perplexity's 4 x 512 (C = 160,
# counts on both sides of the 128-row tile's edge)
ROUTED_TOKENS = (4, 8, 512, 2048)
ROUTED_TOP_K = 8
# every edge of the kept-row counts, each held against the plain version
# (which masks) on random x, bit for bit against the unrolled launches,
# rows past a count +0 by bit pattern: all counts 0 (the whole output +0),
# counts = M everywhere, counts ragged inside a tile, counts 128 and 129
# (and 0, 160, 127, 1) at C = 160, the ragged 13x200x300 case with counts
# past both ends (clamped), and per-element groups (g = 8).  E, M, K, N,
# bits, group_size, counts
EXPERT_ROWS_PATHS = ((EXPERTS, 8, 2048, 768, 2, 128, "zero"),
                     (EXPERTS, 40, 2048, 768, 2, 128, "full"),
                     (EXPERTS, 40, 768, 2048, 2, 128, "ragged"),
                     (EXPERTS, 160, 2048, 768, 2, 128, "edge"),
                     (8, 13, 200, 300, 3, 200, "ragged"),
                     (8, 24, 256, 256, 2, 8, "ragged"))


def expert_rows(gen, spec, E, M):
    """int32 (E,) kept-row counts of an ``EXPERT_ROWS_PATHS`` spec."""
    if spec == "zero":
        return torch.zeros(E, dtype=torch.int32, device="cuda")
    if spec == "full":
        return torch.full((E,), M, dtype=torch.int32, device="cuda")
    if spec == "edge":
        return torch.tensor([128, 129, 0, 160, 127, 1] * -(-E // 6),
                            dtype=torch.int32, device="cuda")[:E]
    return torch.randint(-2, M + 3, (E,), generator=gen, device="cuda",
                         dtype=torch.int32)


def routed_operands(gen, tokens, E, Ks, top_k=ROUTED_TOP_K):
    """Seeded uniform top-k routing of ``tokens`` tokens through the port's
    dispatch: (C, rows, {K: x (E, C, K) bf16}), x the capacity buffer of
    random token rows (zero past each count, dropped pairs left out)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import _capacity, _dispatch
    C = _capacity(tokens, E, top_k,
                  get_config(MOE_ARCH).moe.capacity_factor)
    logits = torch.randn((tokens, E), generator=gen, device="cuda")
    idx = torch.topk(logits, top_k, dim=-1, sorted=True).indices
    _, slot, rows = _dispatch(idx, E, C)
    tok = torch.arange(tokens * top_k, device="cuda") // top_k
    xs = {}
    for K in Ks:
        t = torch.randn((tokens, K), generator=gen, device="cuda")
        buf = torch.zeros((E * C + 1, K), dtype=torch.bfloat16,
                          device="cuda")
        buf[slot] = t.to(torch.bfloat16)[tok]
        xs[K] = buf[:-1].reshape(E, C, K)
    return C, rows, xs


def check_experts(gen, E, M, K, N, bits, group_size, flush, card,
                  main=False, x=None, rows=None, routed=None, timed=True):
    """The expert-batched kernel vs its plain version, and vs one
    ``quant_matmul`` launch per expert (bit for bit), then timed with the
    unrolled launches and a ``torch.bmm`` yardstick on the pre-dequantized
    bf16 weights (not the same function: no dequantization).  ``rows``
    (int32 (E,) kept-row counts, or None) goes to all three, and every row
    past a count must be +0 by bit pattern; ``x`` (E, M, K) replaces the
    random x (a routed capacity buffer: ``routed`` is its token count, and
    the record is timed with and without ``rows``, the bound counting the
    bytes of the experts that hold a row).  A main record (random x) is
    also timed with ``rows`` = M everywhere."""
    from repro_torch.core.qtensor import pack
    from repro_torch.kernels import build
    from repro_torch.kernels.quant_matmul import (
        dequantize_rows, kernel_config, quant_matmul_experts,
        quant_matmul_experts_plain, quant_matmul_experts_unrolled)
    dev = "cuda"
    codes = torch.randint(0, 1 << bits, (E, K, N), generator=gen, device=dev,
                          dtype=torch.int32)
    packed = pack(codes, bits)
    del codes
    ng = K // group_size
    scale = torch.rand((E, ng, N), generator=gen, device=dev) * 0.015 + 0.005
    zero = torch.randint(0, 1 << bits, (E, ng, N), generator=gen,
                         device=dev).float()
    if x is None:
        x = torch.randn((E, M, K), generator=gen, device=dev).to(
            torch.bfloat16)
    kw = dict(bits=bits, group_size=group_size)
    where = (f"E={E} M={M} K={K} N={N} bits={bits} g={group_size}"
             + ("" if rows is None else " with rows"))
    n0 = build.LAUNCHES["quant_matmul_experts"]
    got = quant_matmul_experts(x, packed, scale, zero, **kw, rows=rows)
    torch.cuda.synchronize()
    want = quant_matmul_experts_plain(x, packed, scale, zero, **kw,
                                      rows=rows)
    w = dequantize_rows(packed, scale, zero, dtype=torch.bfloat16, **kw)
    slack = REORDER * torch.bmm(x.float().abs(), w.float().abs())
    ok, err = within(got, want, slack)
    if not ok:
        fail(f"quant_matmul_experts disagrees with its plain version at "
             f"{where}: max |diff| {err}")
    unrolled = lambda: quant_matmul_experts_unrolled(x, packed, scale, zero,
                                                     **kw, rows=rows)
    if not torch.equal(got.view(torch.int16), unrolled().view(torch.int16)):
        fail(f"quant_matmul_experts is not bit-identical to {E} quant_matmul "
             f"launches at {where}")
    live = None
    if rows is not None:
        live = rows.clamp(0, M)
        past = torch.arange(M, device=dev)[None, :] >= live[:, None]
        if bool(got.view(torch.int16)[past].any()):
            fail(f"quant_matmul_experts wrote a nonzero (or -0) row past a "
                 f"count at {where}")
    # the choices that set the order of accumulation are those of one
    # single-matrix launch (TMA or plain loads change no arithmetic)
    config = kernel_config(x, packed, scale, zero, **kw)
    single = kernel_config(x[0], packed[0], scale[0], zero[0], **kw)
    order = ("tile", "stages", "groups", "lut")
    if ([config[k] for k in order] != [single[k] for k in order]
            or config["grid"][:2] != single["grid"][:2]):
        fail(f"quant_matmul_experts configuration {config} differs from one "
             f"quant_matmul launch's {single} at M={M} K={K} N={N}")
    rec = {"E": E, "M": M, "K": K, "N": N, "bits": bits, "g": group_size,
           "max_abs_err": err, "bit_identical_to_unrolled": True,
           "main": main, "routed": routed, "config": config}
    if live is not None:
        rec["touched_experts"] = int((live > 0).sum())
        rec["kept_rows"] = int(live.sum())
        rec["rows_past_count_pos_zero"] = True
    if not timed:
        rec["launches"] = build.LAUNCHES["quant_matmul_experts"] - n0
        show("quant_matmul_experts", rec, card)
        return rec
    rec["kernel_ms"] = cuda_ms(
        lambda: quant_matmul_experts(x, packed, scale, zero, **kw,
                                     rows=rows), flush=flush)
    if routed is not None:
        rec["full_ms"] = cuda_ms(
            lambda: quant_matmul_experts(x, packed, scale, zero, **kw),
            flush=flush)
    else:
        rec["unrolled_ms"] = cuda_ms(unrolled, iters=5, flush=flush)
    if main:
        full = torch.full((E,), M, dtype=torch.int32, device=dev)
        rec["kernel_ms_rows_full"] = cuda_ms(
            lambda: quant_matmul_experts(x, packed, scale, zero, **kw,
                                         rows=full), flush=flush)
    rec["plain_ms"] = cuda_ms(
        lambda: quant_matmul_experts_plain(x, packed, scale, zero, **kw,
                                           rows=rows),
        iters=3, flush=flush)
    rec["library_ms"] = cuda_ms(lambda: torch.bmm(x, w), flush=flush)
    ppb = {2: 4, 3: 2, 4: 2, 8: 1}[bits]
    weight = K * N // ppb + 2 * ng * N * 4
    if live is None:
        nbytes = E * (M * K * 2 + weight + M * N * 2)
        flops = 2 * E * M * K * N
    else:
        nbytes = (rec["touched_experts"] * weight + rec["kept_rows"] * K * 2
                  + E * M * N * 2 + E * 4)
        flops = 2 * rec["kept_rows"] * K * N
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
    rec["launches"] = build.LAUNCHES["quant_matmul_experts"] - n0
    show("quant_matmul_experts", rec, card)
    return rec


def check_routed(gen, tokens, flush, card, E=EXPERTS):
    """The routed traffic of ``tokens`` tokens (``routed_operands``) through
    both expert shapes of a layer (W2 g128)."""
    C, rows, xs = routed_operands(gen, tokens, E,
                                  {K for K, _, _ in EXPERT_SHAPES})
    return [check_experts(gen, E, C, K, N, 2, 128, flush, card, x=xs[K],
                          rows=rows, routed=tokens)
            for K, N, _ in EXPERT_SHAPES]


def summarize_experts(records):
    """One MoE layer's expert FFN at W2 g128: the 3 launches (2 x gate/up
    shape, 1 x down shape) at the decode capacity (C = 8), with the
    prefill capacity's (C = 40) times beside, and each routed traffic's
    (``routed``: by token count, the bound over the experts that hold a
    row, ``full_ms`` the same launches without ``rows``)."""
    per_layer = {(K, N): c for K, N, c in EXPERT_SHAPES}

    def layer(pick, keys):
        sel = [r for r in records if pick(r)]
        out = {k: sum(per_layer[(r["K"], r["N"])] * r[key] for r in sel)
               for k, key in keys}
        out["bound_by"] = sel[0]["bound_by"]
        return out

    keys = (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
            ("library_ms", "library_ms"), ("bound_ms", "bound_ms"),
            ("unrolled_ms", "unrolled_ms"),
            ("ms_rows_full", "kernel_ms_rows_full"))
    main = lambda C: lambda r: r["main"] and r["M"] == C
    out = layer(main(EXPERT_C[1]), keys)
    out["max_abs_err"] = max(r["max_abs_err"] for r in records)
    out["prefill"] = layer(main(EXPERT_C[0]), keys)
    out["routed"] = {}
    for T in ROUTED_TOKENS:
        sel = [r for r in records if r["routed"] == T]
        out["routed"][f"{T} tokens"] = {
            **layer(lambda r: r["routed"] == T, (
                ("ms", "kernel_ms"), ("full_ms", "full_ms"),
                ("plain_ms", "plain_ms"), ("library_ms", "library_ms"),
                ("bound_ms", "bound_ms"))),
            "C": sel[0]["M"], "touched_experts": sel[0]["touched_experts"],
            "kept_rows": sel[0]["kept_rows"]}
    out["edges_checked"] = len(EXPERT_ROWS_PATHS)
    return out


# the int8 kernel at LLaMA-2-7B's per-channel linears (MAIN_SHAPES) at the
# prefill's 512 rows and a decode step's 4; one w4a8_matmul group slice (g =
# 128 columns of a 4096-wide x_q, so lda = 4096); a ragged case
INT8_M = (512, 4)
INT8_SLICE = (512, 128, 11008, 4096)      # M, K, N, lda
INT8_RAGGED = (13, 200, 300)
# every plan and edge of the int8 kernel, bit for bit against the plain
# version (untimed): M = 16 / 17 (the boundary between the decode plan and
# the main plan), ragged M > 16 tiles by TMA and by plain loads, lda % 16
# != 0 (plain-loaded x), an x base off 16-byte alignment (plain-loaded x),
# N % 16 != 0 (plain-loaded w), K not a multiple of 32 (by TMA: lda = 256),
# a ragged decode tile.  M, K, N, lda, x offset, f32 out
INT8_PATHS = ((16, 4096, 11008, 4096, 0, False),
              (17, 4096, 4096, 4096, 0, True), (37, 208, 304, 208, 0, True),
              (37, 200, 300, 200, 0, False), (40, 100, 256, 100, 0, True),
              (24, 128, 512, 144, 1, False), (64, 250, 304, 256, 0, True),
              (64, 256, 300, 256, 0, False), (4, 250, 300, 250, 0, True))


def int_mm_ok(M, K, N):
    """``torch._int_mm``'s shape rules (the library yardstick): more than 16
    rows, K and N multiples of 8."""
    return M > 16 and K % 8 == 0 and N % 8 == 0


def check_int8(gen, M, K, N, flush, card, lda=None, out_dtype=torch.float32,
               path=None, x_offset=0, timed=True):
    """The int8 kernel vs its plain version, bit for bit, then timed with
    the plain version and ``torch._int_mm`` (the int32 product alone, where
    its shape rules allow: a yardstick, no epilogue; at M <= 16, which it
    refuses, on x zero-padded to 17 rows, the same weight bytes: a
    yardstick of the decode shape).  ``lda > K`` passes x_q as a column
    slice of a wider matrix, ``x_offset`` > 0 starts it that many bytes
    into a buffer (a base off 16-byte alignment); ``path`` ("main" at
    M=512, "decode" at M=4) marks the rows summed per layer in the kernels
    line.  Each record names the plan the kernel's host code chose
    (``int8_matmul_config``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_config,
                                                 int8_matmul_plain)
    dev = "cuda"
    lda = lda or K
    if x_offset:
        x_q = torch.randint(-128, 128, (M * lda + x_offset,), generator=gen,
                            device=dev, dtype=torch.int8)[x_offset:]
        x_q = x_q.view(M, lda)[:, :K]
    else:
        x_q = torch.randint(-128, 128, (M, lda), generator=gen, device=dev,
                            dtype=torch.int8)[:, :K]
    w_q = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                        dtype=torch.int8)
    x_scale = torch.rand((M, 1), generator=gen, device=dev) * 0.01 + 1e-3
    w_scale = torch.rand((1, N), generator=gen, device=dev) * 0.01 + 1e-3
    args = (x_q, w_q, x_scale, w_scale)
    n0 = build.LAUNCHES["int8_matmul"]
    got = int8_matmul(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = int8_matmul_plain(*args, out_dtype=out_dtype)
    if not torch.equal(got, want):
        fail(f"int8_matmul is not bit-identical to its plain version at M={M} "
             f"K={K} N={N} lda={lda} x_offset={x_offset} {out_dtype}: max "
             f"|diff| {float((got.float() - want.float()).abs().max())}")
    out_b = 4 if out_dtype == torch.float32 else 2
    rec = {"M": M, "K": K, "N": N, "lda": lda, "x_offset": x_offset,
           "out": str(out_dtype).replace("torch.", ""), "max_abs_err": 0.0,
           "bit_identical": True, "main": path == "main",
           "decode": path == "decode",
           "config": int8_matmul_config(x_q, w_q)}
    if not timed:
        rec["launches"] = build.LAUNCHES["int8_matmul"] - n0
        show("int8_matmul", rec, card)
        return rec
    run = lambda: int8_matmul(*args, out_dtype=out_dtype)
    rec["kernel_ms"] = cuda_ms(run, flush=flush)
    rec["kernel_ms_nospin"] = cuda_ms(run, flush=flush, spin=0)
    rec["plain_ms"] = cuda_ms(
        lambda: int8_matmul_plain(*args, out_dtype=out_dtype), iters=5,
        flush=flush)
    # the library's time with w_q row-major (as the kernel takes it) and
    # column-major (cuBLASLt's preferred int8 layout); the faster is the
    # yardstick
    rec["library_ms"] = None
    if int_mm_ok(max(M, 17), K, N):
        xc = x_q.contiguous()
        if M <= 16:
            xc = torch.zeros((17, K), device=dev, dtype=torch.int8)
            xc[:M] = x_q
            rec["library_yardstick"] = f"torch._int_mm on x zero-padded " \
                                       f"from {M} to 17 rows"
        w_col = w_q.t().contiguous().t()
        for reading, spin in (("", SPIN_CYCLES), ("_nospin", 0)):
            row, col = (cuda_ms(lambda: torch._int_mm(xc, w), flush=flush,
                                spin=spin) for w in (w_q, w_col))
            rec[f"library_row_ms{reading}"] = row
            rec[f"library_col_ms{reading}"] = col
            rec[f"library_ms{reading}"] = min(row, col)
    nbytes = M * K + K * N + 4 * (M + N) + M * N * out_b
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * M * K * N,
                                             INT8_OP_PER_S)
    rec["launches"] = build.LAUNCHES["int8_matmul"] - n0
    show("int8_matmul", rec, card)
    return rec


def check_int8_invariance(gen, card, K=4096, N=4096):
    """The int8 kernel's rows do not depend on the plan or the batch: rows
    of launches at M = 1 and 4 (the decode plan) and row 5 alone equal
    their rows of an M = 16 launch, whose rows equal the first 16 of an M =
    17 launch (the main plan; splits differ), and two launches are bit for
    bit equal (the int32 sums are exact in any order)."""
    from repro_torch.kernels.int8_matmul import int8_matmul
    x = torch.randint(-128, 128, (17, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    xs = torch.rand((17, 1), generator=gen, device="cuda") * 0.01 + 1e-3
    ws = torch.rand((1, N), generator=gen, device="cuda") * 0.01 + 1e-3
    run = lambda a, b: int8_matmul(x[a:b], w, xs[a:b], ws,
                                   out_dtype=torch.float32)
    full, main = run(0, 16), run(0, 17)
    checks = {"M=1": torch.equal(run(0, 1), full[:1]),
              "M=4": torch.equal(run(0, 4), full[:4]),
              "row 5 alone": torch.equal(run(5, 6), full[5:6]),
              "M=16 vs M=17": torch.equal(full, main[:16]),
              "two launches": torch.equal(run(0, 16), full)}
    torch.cuda.synchronize()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"int8_matmul rows differ across launches: {bad} (K={K} N={N})")
    rec = {"K": K, "N": N, "bit_equal": list(checks)}
    print(f"[kernels] int8_matmul invariance {rec} card=[{card}]", flush=True)
    return rec


def summarize_int8(records):
    """One LLaMA-2-7B layer's 7 per-channel linears through the int8 kernel
    (f32 out, as ``w4a8_matmul`` calls it) at M=512; ``decode`` the same at
    M=4, where ``torch._int_mm`` refuses M <= 16: its library time is the
    yardstick on x zero-padded to 17 rows.  ``*_nospin``: timed by events
    alone."""
    per_layer = {(K, N): c for K, N, c in MAIN_SHAPES}

    def at(path):
        timed = [r for r in records if r[path]]
        tot = lambda key: sum(per_layer[(r["K"], r["N"])] * r[key]
                              for r in timed)
        return {"ms": tot("kernel_ms"), "ms_nospin": tot("kernel_ms_nospin"),
                "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
                "bound_by": timed[0]["bound_by"],
                "library_ms": tot("library_ms"),
                "library_ms_nospin": tot("library_ms_nospin"),
                "config": timed[0]["config"]}

    out = at("main")
    out["decode"] = at("decode")
    out["max_abs_err"] = max(r["max_abs_err"] for r in records)
    return out


# quant_matmul on every path of its body: the scheduler's admission
# prefills (33 and 384 rows), ragged M/N/K with one 200-row group at 3 bits
# (plain-loaded weights), 8 bits, an x base off 16-byte alignment (a row
# slice of a wider buffer: plain-loaded x), groups shorter than a 16-deep k
# chunk (per-element scale and zero), and groups of 16, 32 and 48 rows
# (several group rows per 64-deep stage, the group constants reloaded per
# 16-deep chunk): by TMA with a 4-row box that runs past the last group
# (g = 32 and K = 48, g = 16), by plain loads (N = 300, g = 48), and g = 16
# at LLaMA-2-7B's width.  M, K, N, bits, group_size, x offset
QM_PATHS = ((33, 4096, 4096, 2, 128, 0), (384, 4096, 4096, 2, 128, 0),
            (100, 200, 300, 3, 200, 0), (512, 4096, 4096, 8, 128, 0),
            (64, 100, 256, 4, 100, 1), (100, 256, 256, 2, 8, 0),
            (100, 256, 256, 2, 32, 0), (64, 192, 300, 3, 48, 0),
            (40, 48, 256, 4, 16, 0), (512, 4096, 4096, 2, 16, 0))


# quant_gemv on every path of its body: each row template (M = 1..32 run as
# 1..4 tiles of 8 rows) at LLaMA-2-7B's widest projection; 8 bits; groups
# of 8 rows (per-element scale/zero); 16 (8 group rows a 128-deep stage,
# constants per 16-deep chunk); 48 with ragged N = 300 (plain-loaded
# weights); 200 at K = 1000 (per-element, K not a multiple of a stage or
# of the split); N = 512 (32-column tiles, 8 splits) at 32 rows;
# per-channel K = 100 with an x base off 16-byte alignment (plain-loaded
# x); per-channel W3 at K = 11008 (8 splits of 11 stages, the last of 9).
# M, K, N, bits, group_size, x offset
GEMV_PATHS = tuple((M, 4096, 11008, 2, 128, 0)
                   for M in (1, 2, 3, 4, 5, 8, 16, 17, 24, 32)) + (
    (4, 4096, 4096, 8, 128, 0), (4, 256, 256, 2, 8, 0),
    (8, 4096, 4096, 2, 16, 0), (4, 192, 300, 3, 48, 0),
    (4, 1000, 512, 4, 200, 0), (32, 2048, 512, 2, 128, 0),
    (4, 100, 256, 4, 100, 1), (8, 11008, 4096, 3, 11008, 0))
# batch invariance and determinism of the GEMV: K, N, bits, group_size
GEMV_INVARIANCE = ((4096, 11008, 2, 128), (2048, 512, 2, 128),
                   (4096, 4096, 4, 4096))


def check_gemv_invariance(gen, K, N, bits, group_size, card):
    """The GEMV's batch invariance and determinism on the card: rows
    0..M-1 of launches at M = 1, 4, 8 and 32 on the same x rows are bit
    for bit equal (each row's order of accumulation is a function of (N,
    K, bits, group_size) only), rows 5, 17 and 31 launched alone equal
    their rows of the 32-row launch, and two launches on the same operands
    (M = 32 and M = 8) are bit for bit equal."""
    from repro_torch.kernels.quant_gemv import quant_gemv
    x, packed, scale, zero = quant_operands(gen, 32, K, N, bits, group_size)
    run = lambda xs: quant_gemv(xs, packed, scale, zero, bits=bits,
                                group_size=group_size)
    full = run(x)
    same = lambda a, b: torch.equal(a.view(torch.int16),
                                    b.view(torch.int16))
    for M in (1, 4, 8):
        if not same(run(x[:M]), full[:M]):
            fail(f"quant_gemv rows at M={M} differ from the M=32 launch "
                 f"(K={K} N={N} bits={bits} g={group_size})")
    for r in (5, 17, 31):
        if not same(run(x[r:r + 1].contiguous()), full[r:r + 1]):
            fail(f"quant_gemv row {r} alone differs from the M=32 launch "
                 f"(K={K} N={N} bits={bits} g={group_size})")
    if not same(run(x), full) or not same(run(x[:8]), run(x[:8])):
        fail(f"quant_gemv: two launches on the same operands differ (K={K} "
             f"N={N} bits={bits} g={group_size})")
    torch.cuda.synchronize()
    rec = {"K": K, "N": N, "bits": bits, "g": group_size,
           "rows_bit_equal_at_M": [1, 4, 8, 32], "alone_rows": [5, 17, 31],
           "two_launches_bit_equal": True}
    print(f"[kernels] quant_gemv invariance {rec} card=[{card}]", flush=True)
    return rec


def check_gemv_empty_k(card, M=4, N=512):
    """K = 0 is an empty sum: the GEMV returns zeros of (M, N) on the card
    without a launch, and its plan (``gemv_config``) still answers."""
    from repro_torch.kernels import build
    from repro_torch.kernels.quant_gemv import gemv_config, quant_gemv
    x = torch.zeros((M, 0), dtype=torch.bfloat16, device="cuda")
    packed = torch.zeros((0, N), dtype=torch.uint8, device="cuda")
    scale = torch.zeros((0, N), device="cuda")
    n0 = build.LAUNCHES["quant_gemv"]
    got = quant_gemv(x, packed, scale, scale, bits=2, group_size=128)
    config = gemv_config(x, packed, scale, scale, bits=2, group_size=128)
    torch.cuda.synchronize()
    if tuple(got.shape) != (M, N) or bool(got.any()):
        fail(f"quant_gemv at K=0 is not zeros of ({M}, {N})")
    if build.LAUNCHES["quant_gemv"] != n0:
        fail("quant_gemv at K=0 launched its kernel")
    print(f"[kernels] quant_gemv K=0 M={M} N={N}: zeros, no launch, "
          f"config={config} card=[{card}]", flush=True)


def kernel_phase(card):
    from repro_torch.kernels.quant_gemv import quant_gemv, quant_gemv_plain
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = l2.zero_
    out = {"quant_matmul": [], "quant_gemv": [], "decode_attention": []}
    for name, fn, plain, M in (("quant_matmul", quant_matmul,
                                quant_matmul_plain, 512),
                               ("quant_gemv", quant_gemv, quant_gemv_plain, 4)):
        for K, N, _ in MAIN_SHAPES:
            for bits in (2, 3, 4):
                out[name].append(check_quant(name, fn, plain, gen, M, K, N,
                                             bits, 128, flush, card,
                                             main=bits == 2))
        out[name].append(check_quant(name, fn, plain, gen, M, 4096, 4096, 2,
                                     4096, flush, card))
        # the weight-activation path: W4 per-channel (one group of K rows)
        for K, N, _ in MAIN_SHAPES:
            out[name].append(check_quant(name, fn, plain, gen, M, K, N, 4, K,
                                         flush, card, wa=True))
        for K, N, _ in MOE_ATTN_SHAPES:
            out[name].append(check_quant(name, fn, plain, gen, M, K, N, 2,
                                         128, flush, card, moe=True))
    # every path of the quant-matmul kernel (QM_PATHS)
    for M, K, N, bits, g, off in QM_PATHS:
        out["quant_matmul"].append(check_quant(
            "quant_matmul", quant_matmul, quant_matmul_plain, gen, M, K, N,
            bits, g, flush, card, x_offset=off))
    # the MoE schedule's decode: 8 slots; the dense schedule's: the 'sched'
    # summary
    for K, N, _ in MOE_ATTN_SHAPES:
        out["quant_gemv"].append(check_quant(
            "quant_gemv", quant_gemv, quant_gemv_plain, gen, 8, K, N, 2, 128,
            flush, card))
    for K, N, _ in MAIN_SHAPES:
        out["quant_gemv"].append(check_quant(
            "quant_gemv", quant_gemv, quant_gemv_plain, gen, 8, K, N, 2, 128,
            flush, card, sched=True))
    # every path of the GEMV body (GEMV_PATHS), then its batch invariance
    for M, K, N, bits, g, off in GEMV_PATHS:
        out["quant_gemv"].append(check_quant(
            "quant_gemv", quant_gemv, quant_gemv_plain, gen, M, K, N, bits, g,
            flush, card, x_offset=off))
    out["gemv_invariance"] = [check_gemv_invariance(gen, *shape, card)
                              for shape in GEMV_INVARIANCE]
    check_gemv_empty_k(card)
    # main-path shape: kv_len 136 is the middle of the decode steps' 129..143
    out["decode_attention"].append(check_attention(
        gen, 4, 144, 32, 1, 128, [136] * 4, [135] * 4, [1] * 4, flush, card,
        main=True))
    out["decode_attention"].append(check_attention(
        gen, 4, 144, 4, 8, 128, [144, 77, 130, 9], [143, 76, 129, 5],
        [1, 0, 1, 1], flush, card))
    # library-timed: Qwen3's decode shape and the long lane, every slot live
    # at one length
    out["decode_attention"].append(check_attention(
        gen, 4, 144, 4, 8, 128, [136] * 4, [135] * 4, [1] * 4, flush, card,
        moe=True))
    out["decode_attention"].append(check_attention(
        gen, 4, 4096, 32, 1, 128, [4096] * 4, [4095] * 4, [1] * 4, flush,
        card, long=True))
    # every path of the attention body (ATTN_PATHS), then its batch
    # invariance
    for shape in ATTN_PATHS:
        out["decode_attention"].append(check_attention_path(gen, *shape,
                                                            flush, card))
    out["attention_invariance"] = [check_attention_invariance(gen, *shape,
                                                              card)
                                   for shape in ATTN_INVARIANCE]
    # the scheduled phase's shapes: 8 slots over 23 pages of 16 (its
    # max_seq is 368), ragged lengths, slot 3 inactive; then GQA (G=8) and
    # a page of 64 positions
    lens = [368, 17, 300, 255, 96, 1, 351, 160]
    act = [1, 1, 1, 0, 1, 1, 1, 1]
    out["paged_decode_attention"] = [
        check_paged_attention(gen, 8, 23, 16, 32, 1, 128, lens, act, flush,
                              card, main=True),
        check_paged_attention(gen, 8, 23, 16, 4, 8, 128, lens, act, flush,
                              card),
        check_paged_attention(gen, 4, 7, 64, 8, 4, 128, [448, 65, 64, 3],
                              [1, 1, 0, 1], flush, card)]
    for B, W, psz, Hkv, G, D in PAGED_PATHS:
        S = W * psz
        lens = [S, 1, psz - 1, psz, psz + 1, S // 2 + 3, S - 1, 40][:B]
        act = [1] * (B - 1) + [0]
        out["paged_decode_attention"].append(check_paged_attention(
            gen, B, W, psz, Hkv, G, D, lens, act, flush, card, timed=False))
    out["quant_matmul_experts"] = []
    for C in EXPERT_C:
        for K, N, _ in EXPERT_SHAPES:
            out["quant_matmul_experts"].append(check_experts(
                gen, EXPERTS, C, K, N, 2, 128, flush, card, main=True))
    # W3/W4 at the gate shape, and ragged M/N/K edges with per-channel groups
    for bits in (3, 4):
        out["quant_matmul_experts"].append(check_experts(
            gen, EXPERTS, EXPERT_C[0], 2048, 768, bits, 128, flush, card))
    out["quant_matmul_experts"].append(check_experts(
        gen, 8, 13, 200, 300, 3, 200, flush, card))
    for C in MORE_EXPERT_C:
        for K, N, _ in EXPERT_SHAPES:
            out["quant_matmul_experts"].append(check_experts(
                gen, EXPERTS, C, K, N, 2, 128, flush, card))
    # the routed traffic, then every edge of the counts (EXPERT_ROWS_PATHS)
    for T in ROUTED_TOKENS:
        out["quant_matmul_experts"] += check_routed(gen, T, flush, card)
    for E, M, K, N, bits, g, spec in EXPERT_ROWS_PATHS:
        out["quant_matmul_experts"].append(check_experts(
            gen, E, M, K, N, bits, g, flush, card,
            rows=expert_rows(gen, spec, E, M), timed=False))
    out["soft_round"] = []
    for ng, n, _ in SR_SHAPES:
        for bits in (2, 3, 4):
            for dst in (True, False):
                out["soft_round"].append(check_soft_round(
                    gen, ng, n, bits, dst, flush, card,
                    main=bits == 2 and dst))
    for ng, n, _ in MOE_SR_SHAPES:
        out["soft_round"].append(check_soft_round(
            gen, ng, n, 2, True, flush, card, moe=True,
            experts=MOE_SR_EXPERTS.get((ng, n), 1)))
    # the W4A4 calibration's per-channel leaves: dv sums all K rows
    for K, N, _ in MAIN_SHAPES:
        out["soft_round"].append(check_soft_round(
            gen, 1, N, 4, True, flush, card, wa=True, g=K))
    # every plan edge of the pair (SR_PATHS); the per-channel leaves split
    # their rows over a cluster, LLaMA's g = 128 leaves do not
    for ng, g, n, bits, dst, fold, off in SR_PATHS:
        rec = check_soft_round(gen, ng, n, bits, dst, flush, card, g=g,
                               fold=fold, offset=off)
        splits = rec["config"]["bwd"]["splits"]
        if (ng, g) in ((1, 4096), (1, 11008), (32, 128)) \
                and (ng == 1) != (splits > 1):
            fail(f"soft_round plan at ng={ng} g={g} n={n}: {splits} splits")
        out["soft_round"].append(rec)
    out["int8_matmul"] = []
    for M, path in zip(INT8_M, ("main", "decode")):
        for K, N, _ in MAIN_SHAPES:
            out["int8_matmul"].append(check_int8(gen, M, K, N, flush, card,
                                                 path=path))
    M, K, N, lda = INT8_SLICE
    out["int8_matmul"].append(check_int8(gen, M, K, N, flush, card, lda=lda))
    for dt in (torch.float32, torch.bfloat16):
        out["int8_matmul"].append(check_int8(gen, *INT8_RAGGED, flush, card,
                                             out_dtype=dt))
    out["int8_matmul"].append(check_int8(gen, 512, 4096, 4096, flush, card,
                                         out_dtype=torch.bfloat16))
    # every plan and edge of the int8 kernel (INT8_PATHS), then its rows'
    # independence of the plan and the batch
    for M, K, N, lda, off, f32 in INT8_PATHS:
        out["int8_matmul"].append(check_int8(
            gen, M, K, N, flush, card, lda=lda, x_offset=off, timed=False,
            out_dtype=torch.float32 if f32 else torch.bfloat16))
    out["int8_invariance"] = check_int8_invariance(gen, card)
    return out


def sr_layer(shapes=SR_SHAPES, g=SR_G):
    """{(ng, g, n): leaves per layer} of ``shapes`` at ``g`` rows a group."""
    return {(ng, g, n): c for ng, n, c in shapes}


def summarize_soft_round(records, direction, path="main", per_layer=None):
    """One layer of the calibration's Soften step: the forward or backward
    kernel over the layer's 7 leaves (DST on), of the LLaMA (``path=
    "main"``, W2 g128), the MoE (``"moe"``, ``MOE_SR_SHAPES``) or the W4A4
    (``"wa"``, per-channel) path; ``per_layer`` as :func:`sr_layer`.
    ``ms_nospin`` is timed without the device spin, ``act_ms`` with AWQ's
    act_scale folded into the launches, ``act_unfused_ms`` the launches
    followed (preceded) by the division."""
    per_layer = per_layer or sr_layer()
    timed = [r for r in records if r[path]]
    tot = lambda key: sum(per_layer[(r["ng"], r["g"], r["n"])] * r[key]
                          for r in timed)
    err = "max_abs_err" if direction == "fwd" else "max_abs_err_dnu"
    out = {"ms": tot(f"{direction}_ms"),
           "plain_ms": tot(f"{direction}_plain_ms"),
           "bound_ms": tot(f"{direction}_bound_ms"),
           "bound_by": timed[0][f"{direction}_bound_by"],
           "library_ms": None,
           "max_abs_err": max(r[err] for r in records),
           "ms_nospin": tot(f"{direction}_ms_nospin"),
           "act_ms": tot(f"{direction}_act_ms"),
           "act_unfused_ms": tot(f"{direction}_act_unfused_ms")}
    if direction == "bwd":
        out["max_abs_err_dv"] = max(r["max_abs_err_dv"] for r in records)
    return out


def summarize(records, name, path="main", shapes=MAIN_SHAPES):
    """One layer of the main path at W2 g128 (or, ``path="moe"``, of the
    MoE path's attention, ``MOE_ATTN_SHAPES``; ``path="wa"``, of the main
    path at W4 per-channel), each shape weighted by how often a layer runs
    it (attention: its one launch).  Records timed without the device spin
    too add ``ms_nospin`` and ``library_ms_nospin``."""
    timed = [r for r in records if r[path]]
    if name.endswith("decode_attention"):
        weights = [1] * len(timed)
    else:
        per_layer = {(K, N): c for K, N, c in shapes}
        weights = [per_layer[(r["K"], r["N"])] for r in timed]
    tot = lambda key: sum(w * r[key] for w, r in zip(weights, timed,
                                                    strict=True))
    out = {"ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
           "library_ms": tot("library_ms"), "bound_ms": tot("bound_ms"),
           "bound_by": timed[0]["bound_by"],
           "max_abs_err": max(r["max_abs_err"] for r in records)}
    if all("kernel_ms_nospin" in r for r in timed):
        out["ms_nospin"] = tot("kernel_ms_nospin")
        out["library_ms_nospin"] = tot("library_ms_nospin")
    return out


# --------------------------------------------------------------------------
# phase 3: full-width LLaMA-2-7B W2A16g128 serve through the kernels
# --------------------------------------------------------------------------

EXPECTED = {"quant_matmul": 224, "quant_gemv": 3360, "decode_attention": 480,
            "soft_round_fwd": 0, "soft_round_bwd": 0,
            "paged_decode_attention": 0, "quant_matmul_experts": 0,
            "int8_matmul": 0}
REL_L2 = 5e-2


def serve_phase(card, quant="W2A16g128", limit=REL_L2, tag="serve"):
    """LLaMA-2-7B at full width and depth from random weights (seed 0), RTN
    to ``quant`` + pack, served 4 x (128 + 16) on ``"pallas"`` with the
    act_bits of ``quant``: exact launch counts (``EXPECTED``: activation
    quantization is fake-quant in the forward, so A8 runs phase 3's
    kernels) and the teacher-forced ``"xla"`` check within ``limit``.
    Returns the counts and what the ``w4a8`` phase reads."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import (pack_model, quantize_model,
                                           quantized_memory_report)
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           calibration_batches)
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant, serve_requests
    from repro_torch.models import get_model

    B, PROMPT, GEN = 4, 128, 16
    cfg = get_config("llama2-7b")
    model = get_model(cfg)
    qcfg = parse_quant(quant, kernel_backend="pallas")
    act = qcfg.act_bits
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(0, "cuda")
    torch.cuda.synchronize()
    print(f"[{tag}] init {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"ff={cfg.d_ff} V={cfg.vocab_size} in "
          f"{time.perf_counter() - t0:.3f}s", flush=True)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=PROMPT,
                          global_batch=B, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(data_cfg, 2, 1)]
    t0 = time.perf_counter()
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="none", init="rtn")
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    torch.cuda.synchronize()
    mse = [b["recon_mse"] for b in report["blocks"]]
    if not all(np.isfinite(mse)):
        fail("non-finite recon_mse in the RTN walk")
    print(f"[{tag}] RTN walk + pack {qcfg.tag} in "
          f"{time.perf_counter() - t0:.3f}s; recon_mse first/last "
          f"{mse[0]:.4g}/{mse[-1]:.4g}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    mem = quantized_memory_report(packed)
    del params, pfq, qmeta
    gc.collect()
    torch.cuda.empty_cache()
    prompts = SyntheticCorpus(data_cfg).batch(0)["tokens"][:, :PROMPT]

    serve_requests(cfg, model, packed, prompts, gen=2, act_bits=act,
                   kernel_backend="pallas", collect_logits=False,
                   device="cuda")                               # warm-up
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = serve_requests(cfg, model, packed, prompts, gen=GEN, act_bits=act,
                         kernel_backend="pallas", device="cuda")
    counts = dict(build.LAUNCHES)
    logits = res.logits
    if counts != EXPECTED:
        fail(f"{tag} launch counts {counts}, expected {EXPECTED}")
    if logits.shape != (B, GEN, cfg.vocab_size) or not np.isfinite(logits).all():
        fail(f"bad logits: shape {logits.shape}, finite "
             f"{bool(np.isfinite(logits).all())}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {B} x ({PROMPT} prompt + {GEN} generated) on pallas, "
          f"act_bits={act}: "
          f"prefill {res.prefill_tok_s:.1f} tok/s ({res.prefill_secs * 1e3:.3f} "
          f"ms), decode {res.decode_tok_s:.1f} tok/s "
          f"({res.decode_secs * 1e3 / (GEN - 1):.3f} ms/step), launches "
          f"{counts}, packed {mem['quantized_bytes']} B (fp16 "
          f"{mem['fp16_bytes']} B), kv cache {res.cache_stats['cache_bytes']} "
          f"B, peak during serve {peak} B; card=[{card}]", flush=True)

    if tag == "serve":
        prefill_profile(tag, cfg, model, packed, prompts, card)
    teacher_forced_check(tag, cfg, model, packed, prompts, res,
                         act_bits=act, limit=limit)
    return counts, packed, cfg, model, prompts


def prefill_profile(tag, cfg, model, packed, prompts, card):
    """Where one prefill of the served batch spends its time: one forward
    under ``torch.profiler`` (after a warm one), printed as the wall time
    (profiler on), the device's busy time, the kernel launches, and the
    kernels and host operators that take the most time.  A reading only:
    it checks nothing, and its launches fall outside every count."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import compile_serve_steps

    B, S = prompts.shape
    pstep, _ = compile_serve_steps(cfg, kernel_backend="pallas")
    toks = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    with torch.no_grad():
        pstep(packed, {"tokens": toks},
              model.init_cache(B, S + 2, device="cuda"))
        cache = model.init_cache(B, S + 2, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pstep(packed, {"tokens": toks}, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = sorted((e for e in events if e.device_type.name == "CUDA"),
                 key=lambda e: -e.self_device_time_total)
    host = sorted((e for e in events if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"[{tag}] prefill profile ({B} x {S} tokens, one forward, "
          f"profiler on): wall {wall * 1e3:.3f} ms, device busy "
          f"{sum(e.self_device_time_total for e in dev) / 1e3:.3f} ms, "
          f"{launches} kernel launches; card=[{card}]", flush=True)
    for kind, top, attr in (("device", dev, "self_device_time_total"),
                            ("host", host, "self_cpu_time_total")):
        print(f"[{tag}] prefill profile, {kind} time by "
              f"{'kernel' if kind == 'device' else 'operator'}: " + "; ".join(
                  f"{e.key[:60]} x{e.count} {getattr(e, attr) / 1e3:.3f} ms"
                  for e in top[:8]), flush=True)


def teacher_forced_check(tag, cfg, model, packed, prompts, res,
                         act_bits=None, limit=REL_L2):
    """Teacher-forced "xla" backend over the tokens of ``res``, prefill and
    every decode step (with the run's ``act_bits``).  The two paths round
    differently (the "xla" path dequantizes in bf16, the kernels in f32
    rounded once), and over many layers that leaves max |diff| above the
    reference's small-model gate (0.10 measured against atol 5e-2 on
    LLaMA-2-7B); a wrong kernel would instead move the logits by O(1) of
    their norm.  Gate: relative L2 difference of all logits below ``limit``
    (rounding-level differences are ~1e-2 or less at A16)."""
    from repro_torch.eval.harness import parity_gate
    from repro_torch.launch.steps import make_serve_steps
    B, GEN = res.tokens.shape
    PROMPT = prompts.shape[1]
    logits = res.logits
    _, xpre, xdec = make_serve_steps(cfg, kernel_backend="xla",
                                     act_bits=act_bits)
    toks = torch.as_tensor(res.tokens, dtype=torch.long, device="cuda")
    with torch.no_grad():
        cache = model.init_cache(B, PROMPT + GEN, device="cuda")
        lg, cache = xpre(packed, {"tokens": torch.as_tensor(
            prompts, dtype=torch.long, device="cuda")}, cache)
        ref = [lg]
        pos = torch.full((B,), PROMPT, dtype=torch.int32, device="cuda")
        for j in range(GEN - 1):
            lg, cache = xdec(packed, cache, toks[:, j], pos)
            pos = pos + 1
            ref.append(lg)
    ref = torch.stack(ref, 1).float().cpu().numpy()
    gate = parity_gate(logits, ref, atol=5e-2, rtol=2e-2)
    rel = float(np.linalg.norm(logits - ref) / np.linalg.norm(ref))
    agree = float((ref.argmax(-1) == res.tokens).mean())
    print(f"[{tag}] teacher-forced xla reference: relative L2 {rel:.6g} "
          f"(gate {limit}); max |logit| {float(np.abs(ref).max()):.4g}; "
          f"parity_gate(5e-2, 2e-2) {gate}; argmax agreement {agree:.4f}",
          flush=True)
    if not rel < limit:
        fail(f"{tag}: full-width logits differ from the xla backend by "
             f"relative L2 {rel}")
    return rel


# --------------------------------------------------------------------------
# phase 4: reduced configs, card vs CPU from the same params
# --------------------------------------------------------------------------

def parity_phase(archs=("llama2-7b", "tinyllama-1.1b"), tag="parity",
                 quant="W2A16g32"):
    """Reduced configs RTN-quantized to ``quant`` and served on the card
    and, from the same params, on the CPU; an ``A<act_bits>`` below 16 in
    ``quant`` serves with that per-token activation fake-quant."""
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.eval.harness import parity_gate
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant, serve_requests
    from repro_torch.models import get_model

    for arch in archs:
        cfg = get_reduced_config(arch)
        model = get_model(cfg)
        qcfg = parse_quant(quant, kernel_backend="pallas")
        params = model.init_params(0, "cpu")
        calib = [{"tokens": torch.randint(
            0, cfg.vocab_size, (2, 16),
            generator=torch.Generator().manual_seed(1))}]
        pfq, qmeta, _ = quantize_model(cfg, params, calib, qcfg,
                                       method="none", init="rtn")
        packed_cpu = pack_model(cfg, pfq, qmeta, qcfg)
        packed_gpu = params_to(packed_cpu, "cuda")
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=12, global_batch=3,
                        seed=1)
        prompts = SyntheticCorpus(dc).batch(0)["tokens"][:, :12]
        kw = dict(gen=6, kernel_backend="pallas", act_bits=qcfg.act_bits)
        build.reset_launch_counts()
        gpu = serve_requests(cfg, model, packed_gpu, prompts, device="cuda",
                             **kw)
        counts = dict(build.LAUNCHES)
        cpu = serve_requests(cfg, model, packed_cpu, prompts, device="cpu",
                             **kw)
        gate = parity_gate(gpu.logits, cpu.logits, atol=5e-2, rtol=2e-2)
        same = bool((gpu.tokens == cpu.tokens).all())
        print(f"[{tag}] {cfg.name} {qcfg.tag}: card vs CPU {gate}; tokens "
              f"equal {same}; card launches {counts}", flush=True)
        kernels = ("quant_matmul", "quant_gemv", "decode_attention") + (
            ("quant_matmul_experts",) if cfg.family == "moe" else ())
        served = min(counts[k] for k in kernels)
        if not gate["ok"] or not same or served == 0:
            fail(f"{cfg.name}: card and CPU disagree")


# --------------------------------------------------------------------------
# phase 5: full-width calibration (AWQ + TesseraQ) through the kernels
# --------------------------------------------------------------------------

CAL_LAYERS = 2          # depth cut from 32 (one hand-off); widths LLaMA-2-7B's
CAL_K, CAL_T = 20, 10   # the paper's 20-rate schedule; T cut from 250
CAL_SAMPLES, CAL_SEQ, CAL_BS = 32, 512, 4
EVAL_BATCHES = 4
PPL_REL = 1e-2


def calibrate_phase(card):
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import (pack_model, quantize_model,
                                           quantized_memory_report)
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import (DataConfig, calibration_batches,
                                           eval_batches)
    from repro_torch.eval.ppl import perplexity
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model

    cfg = get_config("llama2-7b").replace(num_layers=CAL_LAYERS)
    model = get_model(cfg)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    tcfg = TesseraQConfig(par_iterations=CAL_K, steps_per_iteration=CAL_T,
                          batch_size=CAL_BS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=CAL_SEQ,
                          global_batch=CAL_BS, seed=0)
    t0 = time.perf_counter()
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(data_cfg, CAL_SAMPLES // CAL_BS,
                                          CAL_BS)]
    evalb = eval_batches(data_cfg, EVAL_BATCHES, CAL_BS)
    params = model.init_params(0, "cuda")
    torch.cuda.synchronize()
    print(f"[calibrate] {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}; {CAL_SAMPLES} x "
          f"{CAL_SEQ} calibration tokens, {EVAL_BATCHES} x {CAL_BS} x "
          f"{CAL_SEQ} eval; set-up {time.perf_counter() - t0:.3f}s",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="tesseraq", init="awq",
                                        tcfg=tcfg)
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    peak_cal = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ppl_packed = perplexity(cfg, packed, evalb, backend="pallas")
    ppl_fq = perplexity(cfg, pfq, evalb, backend="pallas")
    t_ppl = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    steps = CAL_K * CAL_T
    expected = {"quant_matmul": 7 * CAL_LAYERS * EVAL_BATCHES,
                "quant_gemv": 0, "decode_attention": 0,
                "soft_round_fwd": 7 * steps * CAL_LAYERS,
                "soft_round_bwd": 7 * steps * CAL_LAYERS,
                "paged_decode_attention": 0, "quant_matmul_experts": 0,
                "int8_matmul": 0}
    for b in report["blocks"]:
        losses = [e["loss"] for e in b["log"]]
        flips = sum(f["flipped"] for f in b["flips"].values())
        total = sum(f["total"] for f in b["flips"].values())
        awq = " ".join(f"{k}:{v['alpha']}/{v['clip']}"
                       for k, v in b["awq"].items())
        print(f"[calibrate] block {b['block']}: awq alpha/clip {awq}; "
              f"recon_mse {b['recon_mse']:.6g}; PAR loss first "
              f"{losses[0]:.6g} last {losses[-1]:.6g}; final soft rate "
              f"{b['log'][-1]['soft_rate']}; {b['secs']:.3f}s "
              f"(reconstruction {b['recon_secs']:.3f}s, "
              f"{steps / b['recon_secs']:.3f} steps/s); flipped vs AWQ "
              f"{flips}/{total} ({100 * flips / total:.4f}%)", flush=True)
        if not all(np.isfinite(losses)) or not np.isfinite(b["recon_mse"]):
            fail(f"non-finite loss in block {b['block']}")
        if len(losses) != CAL_K or b["log"][-1]["soft_rate"] != 0.0:
            fail(f"block {b['block']}: {len(losses)} PAR iterations, final "
                 f"soft rate {b['log'][-1]['soft_rate']}")
    mem = quantized_memory_report(packed)
    print(f"[calibrate] walk + pack {t_cal:.3f}s; peak {peak_cal / 1e9:.3f} "
          f"GB; perplexity packed {ppl_packed:.6g} fake-quant {ppl_fq:.6g} "
          f"({t_ppl:.3f}s); packed {mem['quantized_bytes']} B; launches "
          f"{counts}; card=[{card}]", flush=True)
    if counts != expected:
        fail(f"calibrate launch counts {counts}, expected {expected}")
    if not (np.isfinite(ppl_packed) and np.isfinite(ppl_fq)
            and abs(ppl_packed - ppl_fq) <= PPL_REL * ppl_fq):
        fail(f"packed perplexity {ppl_packed} vs fake-quant {ppl_fq}")
    step_profile(cfg, params, calib, qcfg, tcfg, card)
    return counts, {"blocks": report["blocks"], "secs": t_cal,
                    "peak_bytes": peak_cal}


def step_profile(cfg, params, calib, qcfg, tcfg, card):
    """Where one Soften step's time goes on the first block at full width:
    the step (canonical_grad + AdamW) split into θ̂ materialization
    (``prepare``: 7 soft_round forwards, AWQ's act_scale divided in the
    launch), the per-sample block forwards and backwards with their
    gradient sums, the pullback through ``prepare`` (7 soft_round
    backwards: ``pullback_ms``, ``prepare`` and its pullback under a fixed
    cotangent less ``prepare``), AdamW, and one harden (once per T steps).
    CUDA events around each piece, averaged; ``per_sample_ms`` is
    canonical_grad less both."""
    from repro_torch.core import recon_engine as RE
    from repro_torch.core import tesseraq as tq
    from repro_torch.core.awq import quantize_block_awq
    from repro_torch.core.blocks import build_stages, get_path
    from repro_torch.core.capture import (capture_block_inputs,
                                          split_minibatches)
    from repro_torch.optim.adam import AdamW

    stage = build_stages(cfg)[0]
    with torch.no_grad():
        X = torch.cat([stage.init_x(params, b) for b in calib], 0)
        bp = stage.get_block(params, 0)
        parts = split_minibatches(X)
        Y = torch.cat([stage.apply(bp, x) for x in parts], 0).float()
        caps = capture_block_inputs(stage.apply, bp, parts)
        _, meta = quantize_block_awq(bp, caps, qcfg)
    states = {p: tq._leaf_state(get_path(bp, p), meta[p], qcfg)
              for p in meta}
    states = RE.harden_device(states, 0.5, False)
    obj = tq._make_loss_fn(stage.apply, qcfg, tcfg)
    tr = tq._trainables(states, True)
    frozen = {"bp": bp, "sts": {p: {k: v for k, v in st.items()
                                    if k not in ("nu", "v")}
                                for p, st in states.items()}}
    idx = torch.arange(CAL_BS, device="cuda")
    xb, yb = X.index_select(0, idx), Y.index_select(0, idx)
    chunks = RE.grad_chunk_count(CAL_BS, X.shape[0])
    opt = AdamW(lr=tcfg.lr)
    ost = opt.init(tr)

    def prepare(pull=False):
        with torch.enable_grad():
            req = {p: {k: t.detach().requires_grad_() for k, t in d.items()}
                   for p, d in tr.items()}
            inter = obj.prepare(req, frozen)
            if pull:
                ws = [inter[("w",) + p] for p in req]
                torch.autograd.grad(ws, [t for d in req.values()
                                         for t in d.values()],
                                    grad_outputs=[cot[p] for p in req])

    def grad():
        return RE.canonical_grad(obj, tr, frozen, xb, yb, chunks)

    gen = torch.Generator(device="cuda").manual_seed(3)
    cot = {p: torch.randn(tq._wshape(d["nu"]), generator=gen, device="cuda")
           for p, d in tr.items()}
    _, grads = grad()
    t = {"prepare_ms": cuda_ms(prepare, iters=5),
         "pullback_ms": cuda_ms(lambda: prepare(True), iters=5),
         "canonical_grad_ms": cuda_ms(grad, iters=5),
         "adamw_ms": cuda_ms(lambda: opt.update(grads, ost, tr), iters=5),
         "harden_ms": cuda_ms(lambda: RE.harden_device(states, 0.3, False),
                              iters=3)}
    t["pullback_ms"] -= t["prepare_ms"]
    t["per_sample_ms"] = (t["canonical_grad_ms"] - t["prepare_ms"]
                          - t["pullback_ms"])
    t["step_ms"] = t["canonical_grad_ms"] + t["adamw_ms"]
    print("[profile] one Soften step, block 0 at full width, bs "
          f"{CAL_BS} x {CAL_SEQ}: " + " ".join(
              f"{k}={v:.6g}" for k, v in t.items()) + f" card=[{card}]",
          flush=True)
    return t


# --------------------------------------------------------------------------
# phase 6: calibration parity, card vs CPU from the same params
# --------------------------------------------------------------------------

def calibration_parity_phase():
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import DataConfig, calibration_batches
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model

    cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
    qcfg = parse_quant("W2A16g32", kernel_backend="pallas")
    tcfg = TesseraQConfig(par_iterations=3, steps_per_iteration=15)
    params = get_model(cfg).init_params(0, "cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                    seed=0)
    calib = [b["tokens"][:, :-1] for b in calibration_batches(dc, 2, 4)]
    out = {}
    for dev in ("cpu", "cuda"):
        build.reset_launch_counts()
        p = params if dev == "cpu" else params_to(params, dev)
        batches = [{"tokens": torch.as_tensor(c, dtype=torch.long,
                                              device=dev)} for c in calib]
        _, qmeta, rep = quantize_model(cfg, p, batches, qcfg,
                                       method="tesseraq", init="awq",
                                       tcfg=tcfg)
        out[dev] = (qmeta, rep, dict(build.LAUNCHES))
    (qc, rc, _), (qg, rg, counts) = out["cpu"], out["cuda"]
    agree = {"codes": [0, 0], "hard": [0, 0]}
    worst_scale = 0.0
    for key in qc:
        for f in agree:
            a, b = qc[key][f], qg[key][f].cpu()
            agree[f][0] += int((a == b).sum())
            agree[f][1] += a.numel()
        sa, sb = qc[key]["scale"], qg[key]["scale"].cpu()
        worst_scale = max(worst_scale,
                          float(((sa - sb).abs() / sa.abs()).max()))
    same_awq = all(bc["awq"] == bg["awq"] for bc, bg in
                   zip(rc["blocks"], rg["blocks"], strict=True))
    frac = {f: a / t for f, (a, t) in agree.items()}
    print(f"[calibration-parity] {cfg.name} f32 K=3 T=15 card vs CPU: codes "
          f"agree {agree['codes'][0]}/{agree['codes'][1]} "
          f"({frac['codes']:.6f}), hardened masks {agree['hard'][0]}/"
          f"{agree['hard'][1]} ({frac['hard']:.6f}); folded scales max rel "
          f"diff {worst_scale:.3g}; AWQ choices equal {same_awq}; card "
          f"launches {counts}", flush=True)
    if min(frac.values()) < 0.999 or worst_scale > 1e-4:
        fail("calibration on the card and on the CPU disagree")
    if counts["soft_round_fwd"] == 0 or counts["soft_round_bwd"] == 0:
        fail("the card's calibration did not launch the soft_round kernels")


# --------------------------------------------------------------------------
# phase 7: continuous batching over the dense and paged stores
# --------------------------------------------------------------------------

SCHED_SLOTS, SCHED_PSZ, SCHED_CHUNK, SCHED_TIGHT = 8, 16, 128, 96
SCHED_WORKLOAD = dict(n_requests=16, seed=0, prompt_lens=(16, 384),
                      budgets=(4, 48), mean_gap=2.0)
ALONE_RIDS = (0, 5, 10, 15)


def prefill_calls(res, reqs, chunk=0):
    """(rows, tokens) of every prefill call a scheduled run made (batch 1):
    the whole prompt, or its chunks from the first position not served by
    shared pages."""
    calls = []
    for r in reqs:
        plen = len(r.prompt)
        start = res.requests[r.rid]["shared_tokens"]
        calls += ([min(chunk, plen - c) for c in range(start, plen, chunk)]
                  if chunk else [plen])
    return [(n, n) for n in calls]


def expected_launches(cfg, calls, steps, attn, prefill_attn):
    """Launch counts from the dispatch rules: 7 quantized projections per
    layer (MoE: the 4 attention projections, and 3 expert-batched launches
    for the FFN whatever the rows) for every prefill call and every decode
    step, to the GEMV at most ``DECODE_GEMV_MAX_ROWS`` rows
    (``kernels/ops.py``; decode steps have at most 8 slots) and to the
    tiled matmul above; one attention launch per layer and decode step
    (``attn``), and per layer of a prefill call of a single token, which
    takes the decode kernel too (``prefill_attn``: dense on a batch-1 lane,
    paged on the pool).  ``calls`` holds each prefill call's (rows,
    tokens).  The unpacked head is a library matmul."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import DECODE_GEMV_MAX_ROWS
    moe = cfg.family == "moe"
    per = (4 if moe else 7) * cfg.num_layers
    experts = 3 * cfg.num_layers if moe else 0
    e = {k: 0 for k in build.KERNELS}
    for rows, tokens in calls:
        e["quant_gemv" if rows <= DECODE_GEMV_MAX_ROWS
          else "quant_matmul"] += per
        e["quant_matmul_experts"] += experts
        if tokens == 1:
            e[prefill_attn] += cfg.num_layers
    e["quant_gemv"] += per * steps
    e["quant_matmul_experts"] += experts * steps
    e[attn] += cfg.num_layers * steps
    return e


def same_tokens(a, b, reqs):
    return all(np.array_equal(a.requests[r.rid]["tokens"],
                              b.requests[r.rid]["tokens"]) for r in reqs)


def sync_counted(steps, run):
    """``run(steps)`` under ``torch.cuda.set_sync_debug_mode("warn")``:
    returns (result, syncs in the whole run, syncs inside decode steps,
    {"file:line": syncs} of the Python lines that made them)."""
    import collections
    import dataclasses
    import warnings
    inside = [0]
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")

        def syncs(ws):
            return sum("synchroniz" in str(w.message) for w in ws)

        def decode(*a, **k):
            n0 = len(log)
            out = steps.decode(*a, **k)
            inside[0] += syncs(log[n0:])
            return out

        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = run(dataclasses.replace(steps, decode=decode))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        where = collections.Counter(
            f"{os.path.basename(w.filename)}:{w.lineno}" for w in log
            if "synchroniz" in str(w.message))
        return res, syncs(log), inside[0], dict(where)


def schedule_phase(card, packed):
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import (Request, compile_sched_steps,
                                              make_workload, serve_lockstep,
                                              serve_scheduled)
    from repro_torch.launch.serve import compile_serve_steps, serve_requests
    from repro_torch.models import get_model

    cfg = get_config("llama2-7b")
    model = get_model(cfg)
    V = cfg.vocab_size
    reqs = make_workload(V, **SCHED_WORKLOAD)
    width = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    max_seq = width + (-width) % SCHED_PSZ
    kw = dict(slots=SCHED_SLOTS, max_seq=max_seq, kernel_backend="pallas",
              page_size=SCHED_PSZ, device="cuda")
    steps_d = compile_sched_steps(cfg, max_seq=max_seq,
                                  kernel_backend="pallas")
    steps_p = compile_sched_steps(cfg, max_seq=max_seq,
                                  kernel_backend="pallas",
                                  page_size=SCHED_PSZ)
    print(f"[schedule] {len(reqs)} requests, prompts "
          f"{min(len(r.prompt) for r in reqs)}..{max(len(r.prompt) for r in reqs)}"
          f" ({sum(len(r.prompt) for r in reqs)} tokens), budgets "
          f"{min(r.max_new_tokens for r in reqs)}.."
          f"{max(r.max_new_tokens for r in reqs)} "
          f"({sum(r.max_new_tokens for r in reqs)} tokens), last arrival "
          f"{reqs[-1].arrival}; {SCHED_SLOTS} slots, max_seq {max_seq} "
          f"({max_seq // SCHED_PSZ} pages of {SCHED_PSZ})", flush=True)
    warm = [Request(0, reqs[0].prompt[:24], 3), Request(1, reqs[1].prompt[:40],
                                                        2, arrival=1)]
    for steps, store in ((steps_d, "dense"), (steps_p, "paged")):
        serve_scheduled(cfg, packed, warm, store=store, compiled=steps, **kw)

    runs, counts = {}, {}

    def run(name, fn, expect):
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        counts[name] = dict(build.LAUNCHES)
        want = expect(res)
        runs[name] = res
        peak = torch.cuda.max_memory_allocated()
        cs = res.cache_stats
        print(f"[schedule] ({name}) {res.mode} {res.store}: {res.steps} decode "
              f"steps, occupancy {res.occupancy:.4f}, prefill "
              f"{res.prefill_secs:.3f}s ({res.prefill_tok_s:.1f} tok/s), "
              f"decode {res.decode_secs:.3f}s ({res.decode_tok_s:.2f} useful "
              f"tok/s), latency p50/p90 {res.latency_steps['p50']:.0f}/"
              f"{res.latency_steps['p90']:.0f} steps; cache "
              f"{cs.get('cache_bytes')} B {json.dumps({k: v for k, v in cs.items() if k not in ('store', 'cache_bytes')})}"
              f"; peak {peak} B; launches {counts[name]}", flush=True)
        if counts[name] != want:
            fail(f"schedule run {name}: launches {counts[name]}, expected "
                 f"{want}")
        return res

    def sched_expect(attn, chunk=0, rq=reqs):
        # chunks of a paged run write the pool; every other prefill runs on
        # a dense batch-1 lane
        pre = attn if chunk else "decode_attention"
        return lambda res: expected_launches(
            cfg, prefill_calls(res, rq, chunk), res.steps, attn, pre)

    # (a) dense and (b) paged, host syncs counted
    syncs = {}
    for name, steps, store, attn in (
            ("a", steps_d, "dense", "decode_attention"),
            ("b", steps_p, "paged", "paged_decode_attention")):
        def fn(steps=steps, store=store, name=name):
            res, n, inside, where = sync_counted(
                steps, lambda st: serve_scheduled(cfg, packed, reqs,
                                                  store=store, compiled=st,
                                                  **kw))
            syncs[name] = (n, inside, where)
            return res
        run(name, fn, sched_expect(attn))
    for name in ("a", "b"):
        n, inside, where = syncs[name]
        res = runs[name]
        print(f"[schedule] ({name}) host syncs: {n} in the run ({len(reqs)} "
              f"admissions, {res.steps} decode steps), {inside} inside decode "
              f"steps; by line {where}", flush=True)
        if inside != 0 or n > 3 * len(reqs) + 4:
            fail(f"run {name}: {n} host syncs ({inside} in decode steps) for "
                 f"{len(reqs)} admissions and {res.steps} steps")
    if not same_tokens(runs["a"], runs["b"], reqs):
        fail("dense and paged scheduled tokens differ")

    # (c) a tight pool: admissions wait for pages
    run("c", lambda: serve_scheduled(cfg, packed, reqs, store="paged",
                                     num_pages=SCHED_TIGHT, compiled=steps_p,
                                     **kw),
        sched_expect("paged_decode_attention"))
    if runs["c"].cache_stats["refused_admissions"] == 0:
        fail("the tight pool refused no admission")
    if not same_tokens(runs["a"], runs["c"], reqs):
        fail("tight-pool tokens differ from the dense run's")

    # (d) chunked prefill on both stores
    for name, steps, store, attn in (
            ("d-dense", steps_d, "dense", "decode_attention"),
            ("d-paged", steps_p, "paged", "paged_decode_attention")):
        run(name, lambda steps=steps, store=store: serve_scheduled(
            cfg, packed, reqs, store=store, prefill_chunk=SCHED_CHUNK,
            compiled=steps, **kw), sched_expect(attn, SCHED_CHUNK))
    if not same_tokens(runs["d-dense"], runs["d-paged"], reqs):
        fail("chunked dense and chunked paged tokens differ")
    agree = np.mean([np.mean(runs["d-dense"].requests[r.rid]["tokens"]
                             == runs["a"].requests[r.rid]["tokens"])
                     for r in reqs])
    print(f"[schedule] chunked vs whole prefill: token agreement {agree:.4f} "
          f"(allclose-level contract, not bit-identity)", flush=True)

    # (e) 8 requests behind one 128-token prefix, paged + chunked
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, V, (128,)).astype(np.int32)
    preqs = [Request(i, np.concatenate(
        [prefix, rng.integers(0, V, (int(rng.integers(8, 65)),))]).astype(
            np.int32), int(rng.integers(4, 25)), arrival=2 * i)
        for i in range(8)]
    pw = max(len(r.prompt) + r.max_new_tokens for r in preqs)
    pkw = dict(kw, max_seq=pw + (-pw) % SCHED_PSZ)
    for name, share in (("e-shared", True), ("e-plain", False)):
        run(name, lambda share=share: serve_scheduled(
            cfg, packed, preqs, store="paged", prefill_chunk=SCHED_CHUNK,
            share_prefix=share, **pkw),
            sched_expect("paged_decode_attention", SCHED_CHUNK, preqs))
    hits = runs["e-shared"].cache_stats["shared_page_hits"]
    if hits == 0 or not same_tokens(runs["e-shared"], runs["e-plain"], preqs):
        fail(f"prefix sharing: {hits} hits, tokens equal "
             f"{same_tokens(runs['e-shared'], runs['e-plain'], preqs)}")

    # (f) alone parity: each request alone at the same slot count must give
    # its scheduled tokens; serving it alone through serve_requests (batch
    # 1, so the unpacked head runs at M=1) is printed beside
    alone = {}
    for rid in ALONE_RIDS:
        r = reqs[rid]
        one = serve_scheduled(cfg, packed, [r], store="dense",
                              compiled=steps_d, **kw)
        lock = serve_requests(cfg, model, packed, r.prompt[None],
                              gen=r.max_new_tokens, max_seq=max_seq,
                              kernel_backend="pallas", collect_logits=False,
                              device="cuda")
        want = runs["a"].requests[rid]["tokens"]
        same_sched = np.array_equal(one.requests[rid]["tokens"], want)
        same_lock = np.array_equal(lock.tokens[0], want)
        diverge = (int(np.argmin(lock.tokens[0] == want))
                   if not same_lock else None)
        alone[rid] = (same_sched, same_lock)
        print(f"[schedule] (f) request {rid} (prompt {len(r.prompt)}, budget "
              f"{r.max_new_tokens}): alone at {SCHED_SLOTS} slots equal "
              f"{same_sched}; serve_requests alone equal {same_lock}"
              f"{'' if same_lock else f' (first difference at token {diverge})'}",
              flush=True)
        if not same_sched:
            fail(f"request {rid} scheduled alone differs from its tokens "
                 f"scheduled with the others")

    # (g) the lock-step baseline on the same workload
    run("g", lambda: serve_lockstep(
        cfg, model, packed, reqs, slots=SCHED_SLOTS, kernel_backend="pallas",
        compiled=compile_serve_steps(cfg, kernel_backend="pallas"),
        device="cuda"), lambda res: lockstep_expect(cfg, reqs))
    print(f"[schedule] useful-token decode rate: scheduler dense "
          f"{runs['a'].decode_tok_s:.2f} tok/s, paged "
          f"{runs['b'].decode_tok_s:.2f} tok/s, lock-step "
          f"{runs['g'].decode_tok_s:.2f} tok/s ({runs['g'].steps} steps, "
          f"{runs['g']['wasted_decode_tokens']} wasted decode tokens); "
          f"card=[{card}]", flush=True)
    profiles = {store: decode_profile(steps, packed, store, max_seq, card)
                for steps, store in ((steps_d, "dense"), (steps_p, "paged"))}
    schedule_parity_phase()
    total = {k: counts["a"][k] + counts["b"][k] for k in counts["a"]}
    return total, {"runs": runs, "syncs": syncs, "alone": alone,
                   "profiles": profiles, "max_seq": max_seq}


def decode_profile(steps, packed, store, max_seq, card, n=8,
                   tag="schedule-profile", distinct=False):
    """Where one scheduled decode step's time goes at full width: all 8
    slots live from position 200, the step run ``n`` times.  Wall time per
    step (host clock around synchronized runs), and the device's busy time
    per step by kernel from ``torch.profiler`` (CUPTI); the difference is
    time the card waits for the host.  For an MoE model also the expert
    kernel's device time and launches per step: at 8 slots every
    projection outside the experts takes the GEMV, so each launch of
    ``quant_matmul_kernel`` in a decode step is an expert-batched one.
    Every slot starts from token 0 on an empty cache unless ``distinct``,
    which gives each slot its own token, so an MoE step's slots route to
    different experts as served requests do (from the same token all 8
    take the same top-8)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.common import DenseCacheStore, PagedCacheStore
    model = steps.model
    if store == "paged":
        cs = PagedCacheStore(model, slots=SCHED_SLOTS, max_seq=max_seq,
                             page_size=SCHED_PSZ,
                             num_pages=SCHED_SLOTS * max_seq // SCHED_PSZ,
                             device="cuda")
        for s in range(SCHED_SLOTS):
            cs.try_admit(s, max_seq)
        ptab = torch.tensor(cs.ptab_h, device="cuda")
    else:
        cs = DenseCacheStore(model, slots=SCHED_SLOTS, max_seq=max_seq,
                             device="cuda")
        ptab = None
    tok = torch.zeros((SCHED_SLOTS,), dtype=torch.int32, device="cuda")
    if distinct:
        tok = torch.arange(1, SCHED_SLOTS + 1, dtype=torch.int32,
                           device="cuda") * 1009 % model.cfg.vocab_size
    state = {"cache": cs.cache, "tok": tok,
             "pos": torch.full((SCHED_SLOTS,), 200, dtype=torch.int32,
                               device="cuda")}
    active = torch.ones((SCHED_SLOTS,), dtype=torch.bool, device="cuda")

    def step():
        _, state["tok"], state["pos"], state["cache"] = steps.decode(
            packed, state["cache"], state["tok"], state["pos"], active, ptab)

    with torch.no_grad():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n
    launches = sum(e.count for e in kern) / n
    attn = sum(e.self_device_time_total for e in kern
               if "decode_attention" in e.key) / 1e3 / n
    qmm = [e for e in kern if "quant_matmul_kernel" in e.key]
    experts = sum(e.self_device_time_total for e in qmm) / 1e3 / n
    expert_launches = sum(e.count for e in qmm) / n

    def top(evs, key):
        evs = sorted(evs, key=lambda e: -getattr(e, key))[:6]
        return "; ".join(f"{e.key[:40]} x{e.count // n} "
                         f"{getattr(e, key) / 1e3 / n:.3f}" for e in evs)

    host = [e for e in events if e.device_type == DeviceType.CPU]
    cfg = model.cfg
    moe = cfg.family == "moe"
    print(f"[{tag}] {store} decode step, 8 live slots at position "
          f"200+{', distinct tokens' if distinct else ''}: wall "
          f"{wall:.3f} ms/step; device busy "
          + (f"{busy:.3f} ms/step ({100 * busy / wall:.1f}% of wall), "
             f"{launches:.1f} kernel launches/step, decode attention "
             f"{attn:.3f} ms/step; "
             + (f"expert kernel {experts:.3f} ms/step ({expert_launches:.1f} "
                f"launches/step, {100 * experts / busy:.1f}% of busy); "
                if moe else "")
             + f"top kernels (launches/step, ms/step): "
             f"{top(kern, 'self_device_time_total')}" if kern
             else "not measured (the profiler saw no device activity)")
          + f"; top host ops (calls/step, self CPU ms/step): "
          f"{top(host, 'self_cpu_time_total')}; card=[{card}]", flush=True)
    if moe and kern and expert_launches != 3 * cfg.num_layers:
        fail(f"{tag}: {expert_launches} quant_matmul_kernel launches a "
             f"decode step, expected the 3 expert launches a layer")
    return {"wall_ms": wall, "busy_ms": busy if kern else None,
            "launches": launches if kern else None,
            "experts_ms": experts if moe and kern else None}


def lockstep_expect(cfg, reqs):
    """serve_lockstep: per group of SCHED_SLOTS, one padded prefill and
    (max budget - 1) lock-step decode steps."""
    order = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    e = None
    for i in range(0, len(order), SCHED_SLOTS):
        group = order[i:i + SCHED_SLOTS]
        plen = max(len(r.prompt) for r in group)
        g = expected_launches(cfg, [(len(group) * plen, plen)],
                              max(r.max_new_tokens for r in group) - 1,
                              "decode_attention", "decode_attention")
        e = g if e is None else {k: e[k] + g[k] for k in e}
    return e


def schedule_parity_phase():
    """Reduced llama2 W2A16g32, scheduled on the paged store with chunked
    prefill on the card (kernels) and on the CPU (plain versions)."""
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.eval.harness import parity_gate
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import make_workload, serve_scheduled
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model

    cfg = get_reduced_config("llama2-7b")
    qcfg = parse_quant("W2A16g32", kernel_backend="pallas")
    params = get_model(cfg).init_params(0, "cpu")
    calib = [{"tokens": torch.randint(
        0, cfg.vocab_size, (2, 16),
        generator=torch.Generator().manual_seed(1))}]
    pfq, qmeta, _ = quantize_model(cfg, params, calib, qcfg, method="none",
                                   init="rtn")
    packed_cpu = pack_model(cfg, pfq, qmeta, qcfg)
    reqs = make_workload(cfg.vocab_size, n_requests=6, seed=2,
                         prompt_lens=(4, 40), budgets=(2, 8))
    kw = dict(slots=3, max_seq=48, kernel_backend="pallas", store="paged",
              page_size=8, prefill_chunk=16, collect_logits=True)
    build.reset_launch_counts()
    gpu = serve_scheduled(cfg, params_to(packed_cpu, "cuda"), reqs,
                          device="cuda", **kw)
    counts = dict(build.LAUNCHES)
    cpu = serve_scheduled(cfg, packed_cpu, reqs, device="cpu", **kw)
    lg = lambda res: np.concatenate([res.requests[r.rid]["logits"]
                                     for r in reqs])
    gate = parity_gate(lg(gpu), lg(cpu), atol=5e-2, rtol=2e-2)
    same = same_tokens(gpu, cpu, reqs)
    print(f"[schedule-parity] {cfg.name} paged + chunked: card vs CPU {gate}; "
          f"tokens equal {same}; card launches {counts}", flush=True)
    if not gate["ok"] or not same or counts["paged_decode_attention"] == 0:
        fail(f"{cfg.name}: scheduled card and CPU runs disagree")


# --------------------------------------------------------------------------
# phases 8-11: the MoE family (Qwen3-30B-A3B) through the expert kernel
# --------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 16         # depth cut from 48 (one card); widths are published
MOE_CAL_SAMPLES = 8


def moe_serve_phase(card):
    """Phase 8: RTN W2A16g128 + pack at full width, depth 16, then
    ``serve_requests`` on ``"pallas"`` with exact launch counts and the
    teacher-forced ``"xla"`` check."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import (pack_model, quantize_model,
                                           quantized_memory_report)
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           calibration_batches)
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant, serve_requests
    from repro_torch.models import get_model

    B, PROMPT, GEN = 4, 128, 16
    full = get_config(MOE_ARCH)
    cfg = full.replace(num_layers=MOE_LAYERS)
    model = get_model(cfg)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(0, "cuda")
    torch.cuda.synchronize()
    print(f"[moe-serve] init {cfg.name} depth cut {full.num_layers} -> "
          f"{cfg.num_layers} layers (widths published: d={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"E={cfg.moe.num_experts} top-{cfg.moe.top_k} ff={cfg.d_ff} "
          f"V={cfg.vocab_size}) in {time.perf_counter() - t0:.3f}s",
          flush=True)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=PROMPT,
                          global_batch=B, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(data_cfg, 2, 1)]
    t0 = time.perf_counter()
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="none", init="rtn")
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    torch.cuda.synchronize()
    mse = [b["recon_mse"] for b in report["blocks"]]
    if not all(np.isfinite(mse)):
        fail("non-finite recon_mse in the MoE RTN walk")
    print(f"[moe-serve] RTN walk + pack {qcfg.tag} in "
          f"{time.perf_counter() - t0:.3f}s; recon_mse first/last "
          f"{mse[0]:.4g}/{mse[-1]:.4g}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    mem = quantized_memory_report(packed)
    del params, pfq, qmeta
    gc.collect()
    torch.cuda.empty_cache()
    prompts = SyntheticCorpus(data_cfg).batch(0)["tokens"][:, :PROMPT]

    serve_requests(cfg, model, packed, prompts, gen=2,          # warm-up
                   kernel_backend="pallas", collect_logits=False,
                   device="cuda")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = serve_requests(cfg, model, packed, prompts, gen=GEN,
                         kernel_backend="pallas", device="cuda")
    counts = dict(build.LAUNCHES)
    want = expected_launches(cfg, [(B * PROMPT, PROMPT)], GEN - 1,
                             "decode_attention", "decode_attention")
    if counts != want:
        fail(f"MoE serve launch counts {counts}, expected {want}")
    logits = res.logits
    if logits.shape != (B, GEN, cfg.vocab_size) or not np.isfinite(logits).all():
        fail(f"bad MoE logits: shape {logits.shape}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[moe-serve] {B} x ({PROMPT} prompt + {GEN} generated) on pallas: "
          f"prefill {res.prefill_tok_s:.1f} tok/s ({res.prefill_secs * 1e3:.3f} "
          f"ms), decode {res.decode_secs * 1e3 / (GEN - 1):.3f} ms/step "
          f"({res.decode_tok_s:.1f} tok/s), launches {counts}, packed "
          f"{mem['quantized_bytes']} B (fp16 {mem['fp16_bytes']} B), peak "
          f"during serve {peak / 1e9:.3f} GB; card=[{card}]", flush=True)
    teacher_forced_check("moe-serve", cfg, model, packed, prompts, res)
    return counts, packed, cfg


def moe_schedule_phase(card, packed, cfg):
    """Phase 10: continuous batching of the packed MoE on both stores."""
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import (Request, compile_sched_steps,
                                              make_workload, serve_scheduled)

    reqs = make_workload(cfg.vocab_size, **SCHED_WORKLOAD)
    width = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    max_seq = width + (-width) % SCHED_PSZ
    kw = dict(slots=SCHED_SLOTS, max_seq=max_seq, kernel_backend="pallas",
              page_size=SCHED_PSZ, device="cuda")
    steps = {store: compile_sched_steps(
        cfg, max_seq=max_seq, kernel_backend="pallas",
        page_size=SCHED_PSZ if store == "paged" else 0)
        for store in ("dense", "paged")}
    print(f"[moe-schedule] {len(reqs)} requests at vocab {cfg.vocab_size}, "
          f"prompts {min(len(r.prompt) for r in reqs)}.."
          f"{max(len(r.prompt) for r in reqs)}, budgets "
          f"{min(r.max_new_tokens for r in reqs)}.."
          f"{max(r.max_new_tokens for r in reqs)}; {SCHED_SLOTS} slots, "
          f"max_seq {max_seq}", flush=True)
    warm = [Request(0, reqs[0].prompt[:24], 3),
            Request(1, reqs[1].prompt[:40], 2, arrival=1)]
    for store, st in steps.items():
        serve_scheduled(cfg, packed, warm, store=store, compiled=st, **kw)

    runs, counts, syncs = {}, {}, {}
    for name, store, attn, extra in (
            ("a", "dense", "decode_attention", {}),
            ("b", "paged", "paged_decode_attention", {}),
            ("a2", "dense", "decode_attention", {}),
            ("c", "paged", "paged_decode_attention",
             dict(prefill_chunk=SCHED_CHUNK, share_prefix=True))):
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res, n, inside, where = sync_counted(
            steps[store], lambda st, store=store, extra=extra:
            serve_scheduled(cfg, packed, reqs, store=store, compiled=st,
                            **extra, **kw))
        counts[name] = dict(build.LAUNCHES)
        runs[name], syncs[name] = res, (n, inside, where)
        # whole prefill in every run: the MoE cache spec is not chunkable
        want = expected_launches(cfg, prefill_calls(res, reqs), res.steps,
                                 attn, "decode_attention")
        print(f"[moe-schedule] ({name}) {res.store}{' ' + json.dumps(extra) if extra else ''}: "
              f"{res.steps} decode steps, occupancy {res.occupancy:.4f}, "
              f"prefill {res.prefill_secs:.3f}s ({res.prefill_tok_s:.1f} "
              f"tok/s), decode {res.decode_secs:.3f}s "
              f"({res.decode_secs * 1e3 / max(res.steps, 1):.3f} ms/step, "
              f"{res.decode_tok_s:.2f} useful tok/s), latency p50/p90 "
              f"{res.latency_steps['p50']:.0f}/{res.latency_steps['p90']:.0f}"
              f" steps; host syncs {n} ({inside} inside decode steps); peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
              f"{counts[name]}; card=[{card}]", flush=True)
        if counts[name] != want:
            fail(f"MoE schedule run {name}: launches {counts[name]}, "
                 f"expected {want}")
        if inside != 0 or n > 3 * len(reqs) + 4:
            fail(f"MoE schedule run {name}: {n} host syncs ({inside} in "
                 f"decode steps) for {len(reqs)} admissions and {res.steps} "
                 f"steps; by line {where}")
    for name, what in (("b", "paged"), ("a2", "a second dense run"),
                       ("c", "the chunk-and-share request")):
        if not same_tokens(runs["a"], runs[name], reqs):
            fail(f"MoE scheduled tokens of {what} differ from the dense run")
    if runs["c"].cache_stats["shared_page_hits"] != 0:
        fail("the MoE store shared prefix pages")
    total = {k: sum(c[k] for c in counts.values()) for k in counts["a"]}
    profile = decode_profile(steps["dense"], packed, "dense", max_seq, card,
                             tag="moe-schedule-profile", distinct=True)
    return total, {"runs": runs, "profile": profile}


def moe_calibrate_phase(card):
    """Phase 11: AWQ + TesseraQ on one full-width MoE block, pack,
    perplexity; exact launch counts; a Soften step's time split."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import (pack_model, quantize_model,
                                           quantized_memory_report)
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import (DataConfig, calibration_batches,
                                           eval_batches)
    from repro_torch.eval.ppl import perplexity
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model

    cfg = get_config(MOE_ARCH).replace(num_layers=1)
    model = get_model(cfg)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    tcfg = TesseraQConfig(par_iterations=CAL_K, steps_per_iteration=CAL_T,
                          batch_size=CAL_BS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=CAL_SEQ,
                          global_batch=CAL_BS, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(
                 data_cfg, MOE_CAL_SAMPLES // CAL_BS, CAL_BS)]
    evalb = eval_batches(data_cfg, EVAL_BATCHES, CAL_BS)
    params = model.init_params(0, "cuda")
    torch.cuda.synchronize()
    print(f"[moe-calibrate] {cfg.name} depth 1 block, full width; "
          f"{MOE_CAL_SAMPLES} x {CAL_SEQ} calibration tokens, K={CAL_K} "
          f"T={CAL_T}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="tesseraq", init="awq",
                                        tcfg=tcfg)
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    peak_cal = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ppl_packed = perplexity(cfg, packed, evalb, backend="pallas")
    ppl_fq = perplexity(cfg, pfq, evalb, backend="pallas")
    t_ppl = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    steps = CAL_K * CAL_T
    expected = {k: 0 for k in build.KERNELS}
    expected.update({"quant_matmul": 4 * EVAL_BATCHES,
                     "quant_matmul_experts": 3 * EVAL_BATCHES,
                     "soft_round_fwd": 7 * steps,
                     "soft_round_bwd": 7 * steps})
    b = report["blocks"][0]
    losses = [e["loss"] for e in b["log"]]
    flips = sum(f["flipped"] for f in b["flips"].values())
    total = sum(f["total"] for f in b["flips"].values())
    mem = quantized_memory_report(packed)
    print(f"[moe-calibrate] awq alpha/clip "
          + " ".join(f"{k}:{v['alpha']}/{v['clip']}"
                     for k, v in b["awq"].items())
          + f"; recon_mse {b['recon_mse']:.6g}; PAR loss first "
          f"{losses[0]:.6g} last {losses[-1]:.6g}; block {b['secs']:.3f}s "
          f"(reconstruction {b['recon_secs']:.3f}s, "
          f"{b['recon_secs'] * 1e3 / steps:.3f} ms per Soften step incl. "
          f"hardens); flipped vs AWQ {flips}/{total} "
          f"({100 * flips / total:.4f}%); walk + pack {t_cal:.3f}s; peak "
          f"{peak_cal / 1e9:.3f} GB; perplexity packed {ppl_packed:.6g} "
          f"fake-quant {ppl_fq:.6g} ({t_ppl:.3f}s); packed "
          f"{mem['quantized_bytes']} B; launches {counts}; card=[{card}]",
          flush=True)
    if not all(np.isfinite(losses)) or not np.isfinite(b["recon_mse"]):
        fail("non-finite loss in the MoE block")
    if len(losses) != CAL_K or b["log"][-1]["soft_rate"] != 0.0:
        fail(f"MoE block: {len(losses)} PAR iterations, final soft rate "
             f"{b['log'][-1]['soft_rate']}")
    if counts != expected:
        fail(f"MoE calibrate launch counts {counts}, expected {expected}")
    if not (np.isfinite(ppl_packed) and np.isfinite(ppl_fq)
            and abs(ppl_packed - ppl_fq) <= PPL_REL * ppl_fq):
        fail(f"MoE packed perplexity {ppl_packed} vs fake-quant {ppl_fq}")
    del pfq, packed, qmeta
    gc.collect()
    torch.cuda.empty_cache()
    prof = step_profile(cfg, params, calib, qcfg, tcfg, card)
    return counts, {"secs": t_cal, "peak_bytes": peak_cal, "profile": prof}


# --------------------------------------------------------------------------
# phase 12: weight-activation quantization (W4A8 / W4A4)
# --------------------------------------------------------------------------

# Teacher-forced "xla" gate at A8.  The per-token fake-quant turns the two
# backends' rounding-level differences into whole quantization steps: an
# activation that one backend puts just below a rounding boundary and the
# other just above moves by amax / 127.  On the CPU (plain versions, LLaMA-2-
# 7B widths, W4 per-channel; tools/act_quant_estimates.py) A8 multiplies
# A16's relative L2 by 3.3 at depth 1 (0.035 vs 0.0105) and at depth 8
# (0.058 vs 0.018); phase 3 reads 0.0195 at A16 and full depth, so ~0.065 is
# expected here and phase 3's 0.05 cannot hold.  The H100 read 0.0658 in
# every run (the inputs are seeded); the limit is 1.5x that.  A wrong kernel
# moves the logits by O(1) of their norm, and phase 2 holds kernels 1 and 2
# to their plain versions at this path's W4 per-channel shapes.
WA_REL_L2 = 0.1
# ops.w4a8_matmul vs layers.matmul(fake_quant_act(x), W, "xla") on the same
# x: both quantize x identically (quantize_per_token at ``bits`` is the
# symmetric fake_quant_act at ``bits``); they differ by bf16 roundings of the
# fake-quant activation, the dequantized weight (scale rounded to bf16
# first) and the "xla" product's output, each <= 2^-9 relative: ~3.5e-3
# relative L2 on the CPU at these widths (tools/act_quant_estimates.py).
# Limit 2e-2.
W4A8_REL_L2 = 2e-2
WA_GROUP = 128


def _layer0_activations(cfg, model, packed, prompts):
    """The inputs of layer 0's four fake-quant sites (attention input, the
    attention output before ``wo``, FFN input, the gated activation before
    ``w_down``), before quantization, from a W4A8 prefill (M = 512 rows)
    and its first decode step (M = 4): ``layers.fake_quant_act`` is wrapped
    for the run and keeps only those calls' inputs."""
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import layers as L
    per_forward = 4 * cfg.num_layers
    keep = {**{i: ("prefill", i) for i in range(4)},
            **{per_forward + i: ("decode", i) for i in range(4)}}
    seen, n = {}, [0]
    orig = L.fake_quant_act

    def rec(x, bits, symmetric=True):
        if n[0] in keep:
            seen[keep[n[0]]] = x
        n[0] += 1
        return orig(x, bits, symmetric)

    L.fake_quant_act = rec
    try:
        serve_requests(cfg, model, packed, prompts, gen=2, act_bits=8,
                       kernel_backend="pallas", collect_logits=False,
                       device="cuda")
    finally:
        L.fake_quant_act = orig
    if n[0] != 2 * per_forward:
        fail(f"{n[0]} fake-quant calls in a prefill and a decode step, "
             f"expected {2 * per_forward}")
    return seen


def _plain_path(fn):
    """``fn()`` with ``ops.w4a8_matmul``'s integer products taken by the
    plain version on the card instead of the kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_matmul import int8_matmul_plain
    orig = ops.int8_matmul
    ops.int8_matmul = int8_matmul_plain
    try:
        return fn()
    finally:
        ops.int8_matmul = orig


def w4a8_phase(card, cfg, model, packed, prompts):
    """(b) the ``w4a8_matmul`` entry point on layer 0's seven packed W4
    per-channel linears, fed their own activations from a W4A8 prefill and
    decode step, at act_bits 8 and 4: bit-identical to the plain-version
    path, and within W4A8_REL_L2 of the fake-quant ``"xla"`` product; then
    one g128 W4 linear (K / g launches per call).  Launch counts of the
    checks are exact; times (per layer: the entry point, the kernel alone,
    the glue between them, and the fake-quant "xla"/"pallas" products) come
    after the counts are read."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.quantizer import make_qtensor
    from repro_torch.kernels import build, ops
    from repro_torch.models import layers as L

    acts = _layer0_activations(cfg, model, packed, prompts)
    sites = {"wq": 0, "wk": 0, "wv": 0, "wo": 1, "w_gate": 2, "w_up": 2,
             "w_down": 3}
    linears = {name: packed["blocks"][name].layer(0) for name in sites}
    gen = torch.Generator(device="cuda").manual_seed(1)
    K = cfg.d_model
    wg = (torch.randn((K, K), generator=gen, device="cuda")
          * K ** -0.5).to(torch.bfloat16)
    grouped = make_qtensor(wg, QuantConfig(bits=4, group_size=WA_GROUP))

    def x_of(stage, site):
        x = acts[(stage, site)]
        return x.reshape(-1, x.shape[-1])

    cases = [(stage, name, x_of(stage, s), linears[name])
             for stage in ("prefill", "decode") for name, s in sites.items()]
    cases += [(stage, f"wq_g{WA_GROUP}", x_of(stage, 0), grouped)
              for stage in ("prefill", "decode")]
    build.reset_launch_counts()
    want_launches, worst = 0, {}
    for stage, name, x, w in cases:
        for bits in (8, 4):
            n0 = build.LAUNCHES["int8_matmul"]
            got = ops.w4a8_matmul(x, w, bits)
            n1 = build.LAUNCHES["int8_matmul"]
            torch.cuda.synchronize()
            plain = _plain_path(lambda: ops.w4a8_matmul(x, w, bits))
            calls = w.in_features // w.group_size
            if n1 - n0 != calls or build.LAUNCHES["int8_matmul"] != n1:
                fail(f"w4a8 {name} {stage}: {n1 - n0} kernel launches, "
                     f"expected {calls}")
            want_launches += calls
            if not torch.equal(got, plain):
                fail(f"w4a8_matmul through the kernel differs from its "
                     f"plain-version path: {name} {stage} act_bits={bits}")
            ref = L.matmul(L.fake_quant_act(x, bits), w, "xla").float()
            rel = float((got.float() - ref).norm() / ref.norm())
            key = (stage, bits, "g" if w is grouped else "pc")
            worst[key] = max(worst.get(key, 0.0), rel)
            if not rel < W4A8_REL_L2:
                fail(f"w4a8_matmul {name} {stage} act_bits={bits}: relative "
                     f"L2 {rel} to the fake-quant xla product")
    counts = dict(build.LAUNCHES)
    expect = {k: 0 for k in build.KERNELS}
    expect["int8_matmul"] = want_launches
    if counts != expect:
        fail(f"w4a8 launch counts {counts}, expected {expect}")
    print(f"[w4a8] layer 0's 7 W4 per-channel linears + one W4 g{WA_GROUP} "
          f"(K={K}) at prefill (M={x_of('prefill', 0).shape[0]}) and decode "
          f"(M={x_of('decode', 0).shape[0]}), act_bits 8 and 4: bit-identical "
          f"to the plain-version path; worst relative L2 to the fake-quant "
          f"xla product "
          + " ".join(f"{s}/A{b}/{k}={v:.4g}" for (s, b, k), v in
                     sorted(worst.items()))
          + f" (limit {W4A8_REL_L2}); launches {counts}", flush=True)

    # times per layer (7 per-channel linears) at act_bits 8
    times = {}
    for stage in ("prefill", "decode"):
        t = {"w4a8_ms": 0.0, "kernel_ms": 0.0, "xla_fq_ms": 0.0,
             "pallas_fq_ms": 0.0}
        for name, s in sites.items():
            x, w = x_of(stage, s), linears[name]
            x_q, x_scale = ops.quantize_per_token(x, 8)
            w_c = ops.centered_codes(w)
            sc = w.scale.float().contiguous()
            t["w4a8_ms"] += cuda_ms(lambda: ops.w4a8_matmul(x, w, 8))
            t["kernel_ms"] += cuda_ms(lambda: ops.int8_matmul(
                x_q, w_c, x_scale, sc, out_dtype=torch.float32))
            t["xla_fq_ms"] += cuda_ms(
                lambda: L.matmul(L.fake_quant_act(x, 8), w, "xla"))
            t["pallas_fq_ms"] += cuda_ms(
                lambda: L.matmul(L.fake_quant_act(x, 8), w, "pallas"))
        t["glue_ms"] = t["w4a8_ms"] - t["kernel_ms"]
        times[stage] = t
        print(f"[w4a8] one layer ({stage}, act_bits=8): " + " ".join(
            f"{k}={v:.6g}" for k, v in t.items()) + f" card=[{card}]",
            flush=True)
    x = x_of("prefill", 0)
    g_ms = cuda_ms(lambda: ops.w4a8_matmul(x, grouped, 8))
    print(f"[w4a8] W4 g{WA_GROUP} {K}x{K} at M={x.shape[0]}: "
          f"{K // WA_GROUP} launches per call, {g_ms:.6g} ms per call; "
          f"card=[{card}]", flush=True)
    times["grouped_ms"] = g_ms
    return counts, {"worst_rel_l2": {"/".join(map(str, k)): v
                                     for k, v in worst.items()},
                    "times": times}


def wa_calibrate_phase(card):
    """(c) the paper's Table 3 setting at phase 5's width, depth and
    schedule: W4A4 per-channel, AWQ + TesseraQ with the activations
    fake-quantized at 4 bits in the walk (captures and Soften steps), then
    ``pack_model`` and perplexity under act_bits=4, packed vs fake-quant."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import (DataConfig, calibration_batches,
                                           eval_batches)
    from repro_torch.eval.ppl import perplexity
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model
    from repro_torch.models.common import make_ctx

    cfg = get_config("llama2-7b").replace(num_layers=CAL_LAYERS)
    model = get_model(cfg)
    qcfg = parse_quant("W4A4", kernel_backend="pallas")
    ctx = make_ctx(act_bits=qcfg.act_bits)
    tcfg = TesseraQConfig(par_iterations=CAL_K, steps_per_iteration=CAL_T,
                          batch_size=CAL_BS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=CAL_SEQ,
                          global_batch=CAL_BS, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(data_cfg, CAL_SAMPLES // CAL_BS,
                                          CAL_BS)]
    evalb = eval_batches(data_cfg, EVAL_BATCHES, CAL_BS)
    params = model.init_params(0, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="tesseraq", init="awq",
                                        tcfg=tcfg, ctx=ctx)
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    peak_cal = torch.cuda.max_memory_allocated()
    ppl_packed = perplexity(cfg, packed, evalb, ctx, backend="pallas")
    ppl_fq = perplexity(cfg, pfq, evalb, ctx, backend="pallas")
    ppl_a16 = perplexity(cfg, packed, evalb, backend="pallas")
    counts = dict(build.LAUNCHES)
    steps = CAL_K * CAL_T
    expected = {k: 0 for k in build.KERNELS}
    expected.update({"quant_matmul": 2 * 7 * CAL_LAYERS * EVAL_BATCHES,
                     "soft_round_fwd": 7 * steps * CAL_LAYERS,
                     "soft_round_bwd": 7 * steps * CAL_LAYERS})
    blocks = report["blocks"]
    for b in blocks:
        losses = [e["loss"] for e in b["log"]]
        if not all(np.isfinite(losses)) or not np.isfinite(b["recon_mse"]):
            fail(f"W4A4 block {b['block']}: non-finite loss")
        if len(losses) != CAL_K or b["log"][-1]["soft_rate"] != 0.0:
            fail(f"W4A4 block {b['block']}: {len(losses)} PAR iterations, "
                 f"final soft rate {b['log'][-1]['soft_rate']}")
    secs = [b["secs"] for b in blocks]
    step_ms = [b["recon_secs"] * 1e3 / steps for b in blocks]
    flips = sum(f["flipped"] for b in blocks for f in b["flips"].values())
    total = sum(f["total"] for b in blocks for f in b["flips"].values())
    print(f"[wa-calibrate] {cfg.name} L={CAL_LAYERS} {qcfg.tag} per-channel, "
          f"AWQ + TesseraQ K={CAL_K} T={CAL_T}, activations fake-quantized "
          f"at {qcfg.act_bits} bits: s per block "
          + "/".join(f"{v:.3f}" for v in secs) + "; ms per Soften step "
          "(hardens included) " + "/".join(f"{v:.3f}" for v in step_ms)
          + f"; recon_mse " + "/".join(f"{b['recon_mse']:.4g}"
                                       for b in blocks)
          + f"; flipped vs AWQ {flips}/{total}; walk + pack {t_cal:.3f}s; "
          f"peak {peak_cal / 1e9:.3f} GB; perplexity at A4 packed "
          f"{ppl_packed:.6g} fake-quant {ppl_fq:.6g} (A16 packed "
          f"{ppl_a16:.6g}); launches {counts}; card=[{card}]", flush=True)
    if counts != expected:
        fail(f"W4A4 calibrate launch counts {counts}, expected {expected}")
    if not (np.isfinite(ppl_packed) and np.isfinite(ppl_fq)
            and abs(ppl_packed - ppl_fq) <= PPL_REL * ppl_fq):
        fail(f"W4A4 packed perplexity {ppl_packed} vs fake-quant {ppl_fq}")
    return counts, {"secs": t_cal, "peak_bytes": peak_cal,
                    "block_secs": secs, "step_ms": step_ms}


# --------------------------------------------------------------------------
# phase 13: the paper's comparison methods at phase 5's width and depth
# --------------------------------------------------------------------------

# (label, quantize_model method, init, the row whose recon_mse it must beat)
METHOD_ROWS = (("rtn", "none", "rtn", None),
               ("awq", "none", "awq", None),
               ("gptq", "none", "gptq", "rtn"),
               ("omniquant", "omniquant", "rtn", "rtn"),
               ("signround", "signround", "awq", "awq"))
# OmniQuant's steps a block (its default 500), and SignRound's through
# TesseraQConfig: the walk takes max(K * T, 50) = 50
METHOD_STEPS = 50
METHOD_K, METHOD_T = 5, 10
# GPTQ of layer 0's wq from one W and one Hessian, on the card and on the
# CPU, over its first GPTQ_COLUMNS output columns (columns are independent
# in the walk): the share of codes that may differ (PERF.md §2; the LAPACK
# and cuSOLVER inverses differ by ~1e-6 relative, which flips a code that
# sits on a rounding boundary, and the compensation carries a flip along
# its column)
GPTQ_COLUMNS = 1024
GPTQ_CODE_SHARE = 1e-2
# the FP model's logits rotated vs unrotated (bf16 weights rounded after
# the f32 rotation): relative L2; ~1.6e-2 on the CPU at depth 2 in bf16
ROT_REL_L2 = 5e-2


def gptq_card_vs_cpu(cfg, params, calib, qcfg, walk_codes):
    """Layer 0's wq: its Hessian as the walk captures it (f32, summed by
    minibatch) against float64 from the same inputs, and its GPTQ codes on
    the card against the port's CPU walk from the same W and H."""
    from repro_torch.core.blocks import build_stages
    from repro_torch.core.capture import (capture_block_inputs,
                                          split_minibatches)
    from repro_torch.core.gptq import _gptq_matrix
    from repro_torch.models import layers as L

    stage = build_stages(cfg)[0]
    with torch.no_grad():
        X = torch.cat([stage.init_x(params, b) for b in calib], 0)
        bp = stage.get_block(params, 0)
        parts = split_minibatches(X)
        H = capture_block_inputs(stage.apply, bp, parts,
                                 want_hessian=True)[("wq",)].hessian
        h64 = torch.zeros(H.shape, dtype=torch.float64, device=H.device)
        for x in parts:
            h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
            h = h.reshape(-1, h.shape[-1]).double()
            h64 += h.T @ h
        h_rel = float((H.double() - h64).norm() / h64.norm())
        W = bp["wq"][:, :GPTQ_COLUMNS].float()
        t0 = time.perf_counter()
        card = _gptq_matrix(W, H, qcfg)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        n = torch.get_num_threads()
        torch.set_num_threads(min(n, 4))
        t0 = time.perf_counter()
        cpu = _gptq_matrix(W.cpu(), H.cpu(), qcfg)
        t_cpu = time.perf_counter() - t0
        torch.set_num_threads(n)
    codes, codes_cpu = card[3].cpu(), cpu[3]
    share = float((codes != codes_cpu).float().mean())
    walk_share = float((walk_codes[:, :GPTQ_COLUMNS].cpu() != codes)
                       .float().mean())
    fq_diff = float((card[0].cpu() - cpu[0]).abs().max())
    print(f"[methods] gptq layer 0 wq: Hessian {tuple(H.shape)} f32 vs "
          f"float64 rel {h_rel:.3g}; codes of its first {GPTQ_COLUMNS} "
          f"columns card vs CPU differ in {share:.6g} (limit "
          f"{GPTQ_CODE_SHARE}), max |fq diff| {fq_diff:.3g}; vs the walk's "
          f"codes {walk_share:.6g}; walk {t_card:.3f}s card, {t_cpu:.3f}s "
          f"CPU", flush=True)
    if not (h_rel < 1e-4 and max(share, walk_share) <= GPTQ_CODE_SHARE):
        fail(f"GPTQ card vs CPU: Hessian rel {h_rel}, codes differ "
             f"{share}, vs the walk {walk_share}")
    return {"hessian_rel": h_rel, "code_share": share}


def methods_phase(card):
    """The paper's comparison methods at phase 5's width, depth, data and
    W2A16g128 on the ``"pallas"`` backend: RTN and AWQ (the rows the others
    must beat), GPTQ, OmniQuant's LWC and SignRound, each block's
    recon_mse below its initialization's; the last three packed and their
    perplexity taken through the quant-matmul kernel with exact launches;
    GPTQ card vs CPU on layer 0's wq; QuaRot's rotation of the FP model."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.core.rotation import rotate_params
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import (DataConfig, calibration_batches,
                                           eval_batches)
    from repro_torch.eval.ppl import perplexity
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model, transformer

    cfg = get_config("llama2-7b").replace(num_layers=CAL_LAYERS)
    model = get_model(cfg)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    tcfg = TesseraQConfig(par_iterations=METHOD_K,
                          steps_per_iteration=METHOD_T, batch_size=CAL_BS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=CAL_SEQ,
                          global_batch=CAL_BS, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(data_cfg, CAL_SAMPLES // CAL_BS,
                                          CAL_BS)]
    evalb = eval_batches(data_cfg, EVAL_BATCHES, CAL_BS)
    params = model.init_params(0, "cuda")
    torch.cuda.synchronize()
    zero = {k: 0 for k in build.KERNELS}
    ppl_expected = dict(zero, quant_matmul=7 * CAL_LAYERS * EVAL_BATCHES)
    total = dict(zero)
    mse, out = {}, {}
    for label, method, init, beat in METHOD_ROWS:
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                            method=method, init=init,
                                            tcfg=tcfg,
                                            omni_steps=METHOD_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        walk_counts = dict(build.LAUNCHES)
        mse[label] = [b["recon_mse"] for b in report["blocks"]]
        line = (f"[methods] {label} ({method} + {init}): walk {secs:.3f}s "
                f"(s per block " + "/".join(
                    f"{b['secs']:.3f}" for b in report["blocks"])
                + "), peak " f"{peak / 1e9:.3f} GB, recon_mse per block "
                + "/".join(f"{v:.6g}" for v in mse[label]))
        if walk_counts != zero:
            fail(f"{label} walk launched kernels: {walk_counts}")
        if not all(np.isfinite(mse[label])):
            fail(f"{label}: non-finite recon_mse {mse[label]}")
        if beat is not None:
            logs = [[e["loss"] for e in b["log"]] for b in report["blocks"]]
            packed = pack_model(cfg, pfq, qmeta, qcfg)
            build.reset_launch_counts()
            t1 = time.perf_counter()
            ppl = perplexity(cfg, packed, evalb, backend="pallas")
            t_ppl = time.perf_counter() - t1
            counts = dict(build.LAUNCHES)
            line += (f" (vs {beat} " + "/".join(
                f"{v:.6g}" for v in mse[beat]) + f"); packed perplexity "
                f"{ppl:.6g} ({t_ppl:.3f}s); log losses {logs}; launches "
                f"{counts}")
            if counts != ppl_expected:
                fail(f"{label} perplexity launch counts {counts}, expected "
                     f"{ppl_expected}")
            if not np.isfinite(ppl):
                fail(f"{label}: packed perplexity {ppl}")
            if not all(a < b for a, b in zip(mse[label], mse[beat],
                                             strict=True)):
                fail(f"{label} recon_mse {mse[label]} not below {beat}'s "
                     f"{mse[beat]}")
            for k, v in counts.items():
                total[k] += v
            out[label] = {"secs": secs, "peak_bytes": peak,
                          "recon_mse": mse[label], "ppl": ppl}
            if label == "gptq":
                out["gptq_check"] = gptq_card_vs_cpu(
                    cfg, params, calib, qcfg,
                    qmeta[("blocks", 0, "wq")]["codes"])
            del packed
        print(line + f"; card=[{card}]", flush=True)
        del pfq, qmeta, report
        gc.collect()
        torch.cuda.empty_cache()

    # (d) QuaRot: the FP model's logits, rotated vs unrotated
    toks = torch.as_tensor(evalb[0]["tokens"], device="cuda")
    t0 = time.perf_counter()
    rparams = rotate_params(params, cfg, seed=0)
    torch.cuda.synchronize()
    t_rot = time.perf_counter() - t0
    with torch.no_grad():
        a = transformer.forward(params, cfg, toks).float()
        b = transformer.forward(rparams, cfg, toks).float()
    rel = float((a - b).norm() / a.norm())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"[methods] rotation (Hadamard d={cfg.d_model}, seed 0) in "
          f"{t_rot:.3f}s: FP logits rotated vs unrotated, "
          f"{tuple(toks.shape)} tokens, relative L2 {rel:.6g} (limit "
          f"{ROT_REL_L2}), argmax agreement {agree:.4f}; card=[{card}]",
          flush=True)
    if not rel < ROT_REL_L2:
        fail(f"rotation moved the FP logits by relative L2 {rel}")
    out["rotation_rel_l2"] = rel
    return total, out


# --------------------------------------------------------------------------
# phase 14: the EVAL harness at its defaults (TinyLlama-1.1B, W4A16g32)
# --------------------------------------------------------------------------

HARNESS_ARGS = ()       # the harness's defaults: full-width TinyLlama-1.1B
# the reference's CI settings (the Makefile's ``eval`` and ``eval-smoke``)
HARNESS_CI = (("--reduced",), ("--smoke",))


def harness_expected(args):
    """Exact launches of one harness run: the TesseraQ row's θ̂ (7 linears
    x K x T steps x L blocks, each direction) and the parity gate's
    ``"pallas"`` run (prefill of B x S rows through kernel 1 when over 32
    rows, else the GEMV; then per decode step 7 GEMV launches a layer and
    one decode attention)."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.kernels import build
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    L = cfg.num_layers
    steps = args.par_iters * args.par_steps
    prefill = "quant_matmul" if args.batch * args.seq_len > 32 \
        else "quant_gemv"
    exp = {k: 0 for k in build.KERNELS}
    exp["soft_round_fwd"] = exp["soft_round_bwd"] = 7 * steps * L
    exp[prefill] += 7 * L
    exp["quant_gemv"] += 7 * L * args.parity_steps
    exp["decode_attention"] = L * args.parity_steps
    return exp


def harness_run(card, extra):
    """One ``repro_torch.eval.harness.main`` run on the card: the four rows
    and exact launch counts.  ``logits_parity`` is wrapped to keep the
    gate's packed model for ``gate_reading``.  Returns (exit code, counts,
    the JSON, seconds, what the gate ran on)."""
    import tempfile

    from repro_torch.eval import harness
    from repro_torch.kernels import build

    kept = {}
    orig = harness.logits_parity

    def keep(cfg, model, packed, prompts, **kw):
        kept.update(cfg=cfg, model=model, packed=packed, prompts=prompts,
                    gen=kw["gen"], atol=kw["atol"], rtol=kw["rtol"])
        return orig(cfg, model, packed, prompts, **kw)

    args = harness.parse_args(list(extra))
    harness.logits_parity = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "EVAL.json")
            build.reset_launch_counts()
            t0 = time.perf_counter()
            rc = harness.main(list(extra) + ["--device", "cuda", "--json",
                                             path])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(build.LAUNCHES)
            with open(path) as f:
                res = json.load(f)
    finally:
        harness.logits_parity = orig
    gate = res["parity"].get(args.parity_method, {})
    rows = " ".join(
        f"{k}: ppl {r['ppl']:.6g} acc {r['choice_acc']:.4g}"
        + (f" packed_xla {r['ppl_packed_xla']:.6g}"
           if "ppl_packed_xla" in r else "") + f" ({r['secs']:.3f}s)"
        for k, r in res["rows"].items())
    print(f"[harness] {' '.join(extra) or '(defaults)'}: {res['arch']} "
          f"{res['qcfg']} on {res['device']}: exit {rc} in {secs:.3f}s; "
          f"{rows}; gate {gate}; launches {counts}; card=[{card}]",
          flush=True)
    if set(res["rows"]) != {"fp", "rtn", "awq", "tesseraq"} or not all(
            np.isfinite(v) for r in res["rows"].values() for v in r.values()):
        fail(f"harness rows {res['rows']}")
    expected = harness_expected(args)
    if counts != expected:
        fail(f"harness launch counts {counts}, expected {expected}")
    return rc, counts, res, secs, kept


def gate_reading(tag, kept):
    """Why a free-running gate failed: the greedy tokens of both backends
    (a flipped token makes every later step incomparable), then the
    ``"xla"`` path teacher-forced over the ``"pallas"`` run's tokens, whose
    logits must agree to rounding (``teacher_forced_check``'s relative L2
    below ``REL_L2``, phase 3's full-width limit); a wrong kernel moves
    them by O(1)."""
    from repro_torch.launch.serve import serve_requests
    runs = {b: serve_requests(kept["cfg"], kept["model"], kept["packed"],
                              kept["prompts"], gen=kept["gen"],
                              kernel_backend=b, device="cuda")
            for b in ("pallas", "xla")}
    same = runs["pallas"].tokens == runs["xla"].tokens
    first = [int(np.argmin(r)) if not r.all() else None for r in same]
    lp, lx = runs["pallas"].logits, runs["xla"].logits
    per_step = [float(np.abs(lp[:, j] - lx[:, j]).max())
                for j in range(lp.shape[1])]
    print(f"[{tag}] gate reading: greedy tokens pallas vs xla equal per "
          f"request {[bool(r.all()) for r in same]}, first differing step "
          f"{first}; free-running max |diff| per step {per_step}",
          flush=True)
    rel = teacher_forced_check(tag, kept["cfg"], kept["model"],
                               kept["packed"], kept["prompts"],
                               runs["pallas"])
    return {"tokens_equal": bool(same.all()), "first_flip": first,
            "per_step_max_diff": per_step, "teacher_forced_rel_l2": rel}


def rounded_once_gate(tag, kept):
    """The harness's gate again (same tolerances), with the ``"xla"``
    path's dequantization rounded as the kernels round it: from f32, once
    (``tools/gate_probe.py``'s ``f32_dequant``).  The reference's ``"xla"``
    path rounds scale, zero and each op to bf16 as the port's does
    (``tests/test_torch_qtensor.py``), so that rounding is the gate's one
    expected difference; what is left is the kernels' summation order, and
    a wrong kernel."""
    from repro_torch.eval.harness import logits_parity
    from tools.gate_probe import variant
    with variant("f32_dequant"):
        gate = logits_parity(kept["cfg"], kept["model"], kept["packed"],
                             kept["prompts"], gen=kept["gen"],
                             atol=kept["atol"], rtol=kept["rtol"],
                             device="cuda")
    print(f"[{tag}] gate with the \"xla\" dequantization rounded once: "
          f"{gate}", flush=True)
    return gate


def harness_phase(card, argv=HARNESS_ARGS, ci=HARNESS_CI):
    """The harness at ``argv`` (its defaults), then at the reference's CI
    settings ``ci``: the four finite rows and exact launch counts in each
    run, and exit 0 or, where the free-running elementwise gate fails
    (exit 1), a ``gate_reading`` that shows rounding and not a wrong
    kernel, and the gate with the ``"xla"`` dequantization rounded as the
    kernels round it (``rounded_once_gate``), which must pass at the CI
    settings.  On the H100 the harness's gate fails at all three settings
    with the port's card-drawn weights (PERF.md §6; ROADMAP queue 3):
    the reference's two rounding schemes differ by ~0.05-0.07 in the
    smoke logits against its atol 5e-2, and at ``--reduced`` a greedy token
    flips; rounded once, both CI settings read 0.0."""
    from repro_torch.kernels import build
    counts = {k: 0 for k in build.KERNELS}
    out = {}
    for extra in (tuple(argv),) + tuple(ci):
        rc, c, res, secs, kept = harness_run(card, extra)
        for k, v in c.items():
            counts[k] += v
        tag = "harness " + (" ".join(extra) or "(defaults)")
        out[tag] = {"exit": rc, "secs": secs, "rows": res["rows"],
                    "parity": res["parity"]}
        if rc != 0:
            out[tag]["reading"] = gate_reading(tag, kept)
            once = rounded_once_gate(tag, kept)
            out[tag]["rounded_once"] = once
            if extra in ci and not once["ok"]:
                fail(f"{tag}: the gate fails with the \"xla\" "
                     f"dequantization rounded as the kernels round it: "
                     f"{once}")
        del kept
        gc.collect()
        torch.cuda.empty_cache()
    return counts, out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    build.load_library(verbose=True)
    n_src = len(set(build.SOURCES.values()))
    print(f"[build] {n_src} sources ({len(build.KERNELS)} kernels) built and "
          f"loaded in {time.perf_counter() - t0:.3f}s", flush=True)

    recs = kernel_phase(card)
    t0 = time.perf_counter()
    serve_counts, packed, *_ = serve_phase(card)
    parity_phase()
    print(f"[time] serve + parity {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    sched_counts, _ = schedule_phase(card, packed)
    del packed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] schedule {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    cal_counts, _ = calibrate_phase(card)
    calibration_parity_phase()
    print(f"[time] calibrate + calibration parity "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_serve_counts, moe_packed, moe_cfg = moe_serve_phase(card)
    parity_phase((MOE_ARCH,), tag="moe-parity")
    moe_sched_counts, _ = moe_schedule_phase(card, moe_packed, moe_cfg)
    del moe_packed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] MoE serve + parity + schedule "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    moe_cal_counts, _ = moe_calibrate_phase(card)
    print(f"[time] MoE calibrate {time.perf_counter() - t0:.1f}s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wa_serve_counts, wa_packed, wa_cfg, wa_model, wa_prompts = serve_phase(
        card, "W4A8", WA_REL_L2, "wa-serve")
    w4a8_counts, _ = w4a8_phase(card, wa_cfg, wa_model, wa_packed,
                                wa_prompts)
    del wa_packed
    gc.collect()
    torch.cuda.empty_cache()
    wa_cal_counts, _ = wa_calibrate_phase(card)
    parity_phase((MOE_ARCH,), tag="wa-moe-parity", quant="W4A8")
    print(f"[time] weight-activation {time.perf_counter() - t0:.1f}s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    methods_counts, _ = methods_phase(card)
    print(f"[time] methods {time.perf_counter() - t0:.1f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    harness_counts, _ = harness_phase(card)
    print(f"[time] harness {time.perf_counter() - t0:.1f}s", flush=True)

    sources = {"quant_matmul": "src/repro/kernels/quant_matmul.py:146",
               "quant_gemv": "src/repro/kernels/quant_gemv.py:120",
               "decode_attention": "src/repro/kernels/decode_attention.py:227",
               "soft_round_fwd": "src/repro/kernels/soft_round.py:42",
               "soft_round_bwd": "src/repro/kernels/soft_round.py:42",
               "paged_decode_attention":
                   "src/repro/kernels/decode_attention.py:185",
               "quant_matmul_experts": "src/repro/kernels/quant_matmul.py:197",
               "int8_matmul": "src/repro/kernels/int8_matmul.py:52"}
    per = {"quant_matmul": "one layer of the prefill: 7 launches, M=512, W2 "
                           "g128; 'moe' one Qwen3 layer's 4 attention "
                           "projections; 'wa' the 7 at W4 per-channel; "
                           "'*_nospin' timed without the device spin",
           "quant_gemv": "one layer of a decode step: 7 launches, M=4, W2 "
                         "g128; 'sched' the same at M=8 (the scheduled "
                         "decode's 8 slots); 'moe' one Qwen3 layer's 4 "
                         "attention projections; 'wa' the 7 at W4 "
                         "per-channel; '*_nospin' the same launches timed "
                         "by events alone, without the device spin",
           "decode_attention": "one layer of a decode step: 1 launch, B=4 "
                               "Hkv=32 G=1 D=128 S=144 kv_len=136; 'moe' "
                               "Qwen3's: B=4 Hkv=4 G=8 D=128 S=144 "
                               "kv_len=136; 'long' the long lane: B=4 "
                               "Hkv=32 G=1 D=128 S=kv_len=4096 (SDPA over "
                               "the live positions in all three); "
                               "'*_nospin' timed without the device spin",
           "soft_round_fwd": "one layer of a Soften step: 7 launches (4 x "
                             "ng=32 out=4096, 2 x ng=32 out=11008, 1 x ng=86 "
                             "out=4096; g=128, W2, DST on); 'moe' one Qwen3 "
                             "layer's 7 (2 x ng=2048 out=768, 1 x ng=768 "
                             "out=2048, ng=16 out=4096, 2 x ng=16 out=512, "
                             "ng=32 out=2048); 'wa' the LLaMA layer's 7 at "
                             "W4 per-channel (ng=1, g=K)",
           "soft_round_bwd": "one layer of a Soften step: 7 launches, the "
                             "shapes of soft_round_fwd; 'ms_nospin' timed "
                             "without the device spin; 'act_ms' with AWQ's "
                             "act_scale divided in the launch, "
                             "'act_unfused_ms' the launch and the division "
                             "outside it (each direction)",
           "paged_decode_attention": "one layer of a scheduled decode step: "
                                     "1 launch, B=8 Hkv=32 G=1 D=128, 23 "
                                     "pages of 16, kv_len up to 368, one "
                                     "slot inactive (SDPA with a length "
                                     "mask on the gathered cache: a "
                                     "yardstick); '*_nospin' timed without "
                                     "the device spin",
           "quant_matmul_experts": "one MoE layer of a decode step: 3 "
                                   "launches (2 x K=2048 N=768, 1 x K=768 "
                                   "N=2048), E=128, C=8, W2 g128, random "
                                   "x, every row live ('ms_rows_full' with "
                                   "rows = C); 'prefill' the same at C=40; "
                                   "'routed' the same launches on routed "
                                   "traffic (4 and 8 decode slots at C=8, "
                                   "512 tokens at C=40, 2048 at C=160; "
                                   "top-8, x zero past each count) with "
                                   "the dispatch's counts as rows, 'full_ms' "
                                   "without them, the bound over the "
                                   "experts that hold a row",
           "int8_matmul": "one LLaMA-2-7B layer's 7 per-channel linears "
                          "(4 x K=4096 N=4096, 2 x K=4096 N=11008, 1 x "
                          "K=11008 N=4096), M=512, f32 out; 'decode' the "
                          "same at M=4; '*_nospin' timed without the device "
                          "spin"}
    kernels = []
    for name in build.KERNELS:
        by_path = {"serve": serve_counts[name], "calibrate": cal_counts[name],
                   "schedule": sched_counts[name],
                   "moe_serve": moe_serve_counts[name],
                   "moe_schedule": moe_sched_counts[name],
                   "moe_calibrate": moe_cal_counts[name],
                   "wa_serve": wa_serve_counts[name],
                   "w4a8": w4a8_counts[name],
                   "wa_calibrate": wa_cal_counts[name],
                   "methods": methods_counts[name],
                   "harness": harness_counts[name]}
        if name.startswith("soft_round"):
            nums = summarize_soft_round(recs["soft_round"], name[-3:])
            nums["moe"] = summarize_soft_round(recs["soft_round"], name[-3:],
                                               "moe", sr_layer(MOE_SR_SHAPES))
            nums["wa"] = summarize_soft_round(
                recs["soft_round"], name[-3:], "wa",
                {(1, K, N): c for K, N, c in MAIN_SHAPES})
            nums["library_note"] = ("no single PyTorch call computes θ̂ or "
                                    "its gradient")
            nums["plans"] = {
                f"{r['ng']}x{r['g']}x{r['n']}": r["config"][name[-3:]]
                for r in recs["soft_round"] if r["main"] or r["moe"]
                or r["wa"]}
            nums["edges_checked"] = len(SR_PATHS)
        elif name == "int8_matmul":
            nums = summarize_int8(recs[name])
            nums["invariance"] = recs["int8_invariance"]
            nums["library_note"] = ("torch._int_mm: the int32 product "
                                    "without the scale epilogue, the "
                                    "faster of row- and column-major w_q; "
                                    "a yardstick; it refuses M <= 16, so "
                                    "'decode' times it on x zero-padded to "
                                    "17 rows")
        elif name == "quant_matmul_experts":
            nums = summarize_experts(recs[name])
            nums["library_note"] = ("torch.bmm on the pre-dequantized bf16 "
                                    "weights: a yardstick, not the same "
                                    "function")
        else:
            nums = summarize(recs[name], name)
            if name in ("quant_matmul", "quant_gemv"):
                nums["moe"] = summarize(recs[name], name, "moe",
                                        MOE_ATTN_SHAPES)
                nums["wa"] = summarize(recs[name], name, "wa")
            if name == "quant_gemv":
                nums["sched"] = summarize(recs[name], name, "sched")
                nums["invariance"] = recs["gemv_invariance"]
            if name == "decode_attention":
                nums["moe"] = summarize(recs[name], name, "moe")
                nums["long"] = summarize(recs[name], name, "long")
                nums["invariance"] = recs["attention_invariance"]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{build.SOURCES[name]}",
                        "replaces": sources[name],
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **nums,
                        "per": per[name], "card": card})
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
