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
   timed shape; the plan-edge lists also carry phase 16's widths (kernels
   1 and 2 at K or N of 14336, 22528, 53248 and 1408; attention at G = 4,
   8 and 16 and at 16 KV heads, paged too; the expert kernel at
   Moonlight's 64 experts, its count edges and its routed top-6 traffic;
   soft_round at Mistral's and Command-R's FFN leaves);
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
7. schedule: LLaMA-2-7B at its widths and ``SCHED_LAYERS`` (4) of 32
   layers, RTN W2A16g128 + pack, served by the
   continuous-batching scheduler (``serve_scheduled``, 8 slots, 16 seeded
   requests with prompts of 16..384 tokens and budgets of 4..48) on the
   dense store and on the paged store (16-token pages), on a tight pool,
   with chunked prefill, with copy-on-write prefix sharing, each request
   alone, and the lock-step baseline; dense and paged tokens must be equal,
   launch counts exact, and the decode steps free of host syncs; where
   one decode step's time goes on each store (``torch.profiler``); then
   the reduced llama2 config scheduled on the paged store on the card and
   on the CPU;
8. MoE serve: Qwen3-30B-A3B at full width, depth cut to 4 of 48 layers
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
15. train ((a)'s children beside (b)-(d)): (a) ``python -m
   repro_torch.launch.train`` at smollm-135m's
   full width and depth (24 steps, batch 8 x 256, checkpoints every 12;
   cut from 40 and 20 for the run's time): the loss falls by
   ``TRAIN_MARGIN``, and a run stopped by SIGTERM after step 6 saves,
   exits 2 and, resumed, reaches the straight run's step-12 checkpoint
   within ``RESUME_ATOL``; (b) TinyLlama-1.1B at full width and depth, 3 steps at
   4 x 2048 tokens with remat on and off (finite losses, ms per step, peak
   GB), and one layer's recomputing attention backward against autograd
   through the plain loop at S = 2048 with both peaks; (c)
   ``examples/quickstart_torch.py`` on the card: fp <= AWQ+TesseraQ < AWQ
   < RTN perplexity, the packed model through ``quant_matmul`` within
   ``PPL_REL`` of the fake-quant model, exact soft_round and quant_matmul
   launches; (d) the reduced qwen3 MoE trained 4 steps on the card and on
   the CPU from the same params; training itself launches no kernel;
16. the rest of the two families, the int8 KV cache and the host-loop
   engines, at W2A16g128 from seeded weights, each model freed before the
   next: (a)-(d) Mistral-7B at 4 of 32 layers, Command-R-35B at 2 of 40,
   LLaMA-3-405B at 2 of 126 and Moonlight-16B-A3B at 2 of 48, each at
   its published widths, RTN-packed and served lock-step 4 x (128 + 16)
   with exact launches and the teacher-forced ``"xla"`` check of phase 3;
   Mistral and Moonlight also scheduled on the dense and the paged store
   (phase 7's workload; equal tokens, exact launches); AWQ + TesseraQ on
   Mistral at depth 2, one block of Command-R and one of Moonlight, packed
   perplexity within ``PPL_REL`` of fake-quant; (e) phase 3's packed
   LLaMA-2-7B through ``make_serve_steps(kv_bits=8)`` and an int8 cache:
   lock-step (half the cache bytes; the reference's own test within
   ``KV_REL`` at 2 layers and ``KV_REL_DEEP`` at 32, the 16 teacher-forced
   steps within ``KV_REL_DEEP`` of the bf16 cache's logits, the kernels
   within ``REL_L2`` of the ``"xla"`` path on the int8 cache) and
   scheduled on int8 dense and paged stores
   (equal tokens; the paged run's decode on the dense decode-attention
   kernel, exact launches); (f) phase 5's block at depth 1, in f32,
   calibrated (K=2, T=1) on the ``"device"``, ``"reference"`` and
   ``"legacy"`` engines (reference
   equal to device bit for bit, legacy codes equal and scales within
   rtol 1e-5; ms per Soften step and host syncs of each), and OmniQuant
   and SignRound on the ``"legacy"`` host loop against ``"device"``;
17. the VLM, RWKV and hybrid families at W2A16g128 RTN + pack, published
   widths (PaliGemma-3B at full depth, RWKV6-3B and Zamba2-1.2B at 8 of
   32 and 38 layers, for the run's time): (a) RWKV6-3B and (b) Zamba2-1.2B
   served
   lock-step 4 x (128 + 16) with exact launches (RWKV: 8 projections a
   layer, no attention; Zamba2: 2 a mamba layer and the shared block's 7
   and one decode attention at each of its 6 sites) and the teacher-forced
   ``"xla"`` check, then phase 7's workload on both stores (equal tokens)
   and a profiled scheduled decode step; (c) PaliGemma-3B scheduled only (8
   slots, 16 requests of 256 seeded patches + 16..128 tokens, 4..32
   generated) on both stores, equal tokens, exact launches, 4 requests
   teacher-forced against ``"xla"``; (d) AWQ + TesseraQ (K=3, T=5), 8 x
   512 positions, on 2 blocks of RWKV6-3B and of PaliGemma-3B and on
   Zamba2-1.2B cut to depth 6 (six mamba stages, then the shared block):
   every block below AWQ's recon_mse, packed perplexity within ``PPL_REL``
   of fake-quant; (e) ``examples/quantize_every_family_torch.py`` in a
   child process beside (a)-(d);
18. the encoder-decoder, whisper-small at W2A16g128 RTN + pack, published
   widths: (a) whole (12 + 12 layers), scheduled on both stores (8 slots,
   16 requests of 1500 seeded frames + 4..32 tokens, 8..48 generated):
   exact launches (an admission's encoder and cross K/V at M = 1500, a
   decode step's 8 GEMVs and one decode attention a decoder layer), no
   host sync inside a decode step, equal tokens, requests alone equal to
   scheduled, 4 requests teacher-forced against ``"xla"``, a profiled
   decode step and admission prefill; (b) AWQ + TesseraQ (K=3, T=5) over
   4 encoder and 4 decoder blocks, 8 x (1500 frames + 128 tokens), the
   encoder's stream handed to the decoder stage: every block below AWQ's
   recon_mse, packed perplexity within ``PPL_REL`` of fake-quant, exact
   launches; (c) the reduced config card vs CPU: served logits
   (teacher-forced) and calibration codes and masks;
19. serve-time tensor parallelism (``launch.sharding.ServeSpec`` on
   ``torch.distributed``, ranks spawned by ``launch.mesh.run_ranks``):
   no-mesh controls of LLaMA-2-7B at full width and depth and Qwen3-30B-A3B
   at ``MOE_LAYERS`` of 48 (RTN W2A16g128, 4 x (128 + 8) on "pallas"),
   their packed trees handed to the ranks in a temporary file; (a) one
   NCCL rank: tokens and logits bit-identical to the control, its
   launches, no sync inside a decode step; (b) two gloo ranks sharing
   the card at LLaMA-2-7B's full width and depth (attention and FFN split:
   16 of 32 heads, 43 of 86 groups of ``w_down``): each rank's launches
   the control's, both ranks' bytes identical, teacher-forced within
   ``REL_L2`` of the control's logits, per-rank packed bytes, the device
   bytes a rank holds (its own tree after placement, its peak below the
   control's), the syncs gloo makes a decode step counted; scheduled on
   the dense and the paged store (``TP_WORKLOAD``): equal tokens, exact
   launches; (c) Qwen3's 128 experts split 64 a rank in the same ranks,
   and layer 0's expert-split FFN within ``MOE_LAYER_REL`` of the
   control's on the same input; (d) ``python -m repro_torch.launch.serve
   --reduced --method none --dtype float32`` with and without ``--tp 2
   --dist-backend gloo``, subprocesses beside (a): the same tokens; phase
   2 holds every kernel at a rank's shard widths
   (``TP_SHAPES``, ``TP_MOE_ATTN_SHAPES`` in ``QM_PATHS``/``GEMV_PATHS``,
   16 and 2 KV heads, 64 experts);
20. the mesh-sharded reconstruction engine (``engine="sharded"`` on
   ``torch.distributed``): LLaMA-2-7B at full width and 2 layers,
   W2A16g128, phase 5's 32 x 512 tokens at bs 4, AWQ + TesseraQ at K=2,
   T=1 on block 0 against the device engine in this process: (a) one NCCL
   rank on the ``(1,)`` and ``(1, 1)`` meshes, (b) two gloo ranks sharing
   the card on ``(2,)``, (c) the same ranks on ``(1, 2)`` (TP = 2): the
   control's hardened masks, codes and folded scales bit for bit, its
   soft_round launches and log, no sync inside a step at (a), the state
   bytes a TP rank keeps below the control's; each mesh's ms a Soften step,
   exchange ms and bytes a step and peak bytes; (d) the same ranks:
   ``quantize_model(engine="sharded")`` over both blocks at DP 2 equal to
   the device walk;
21. training on a mesh (``make_train_harness(cfg, mesh)`` on
   ``torch.distributed``): Qwen3-30B-A3B at full width and 2 of 48 layers,
   bf16 params, f32 Adam, 4 x 129 synthetic tokens, 3 steps at lr 1e-3,
   against the no-mesh harness in this process: (a) one NCCL rank on
   ``(1,)`` and ``(1, 1)``, bit-identical, no sync in a step; (b) two gloo
   ranks sharing the card on ``(1, 2)``, the step's work split over
   ``model`` (heads, 64 experts and the vocab a rank; no leaf broadcast),
   its losses within ``MESH_REL`` and its grad norms within ``MESH_REL``
   or ``MESH_NOISE_X`` times the control's twin's distance at that step,
   and in f32 (one layer) every step within ``MESH_F32_REL`` of an f32
   control, (c) TinyLlama-1.1B at full
   width and 2 of 22 layers on ``(2, 1)`` (DP with FSDP slices) and (c')
   on ``(1, 2)`` with ``seq_parallel`` (heads, FFN, vocab and residual
   rows split: all-gathers and reduce-scatters): losses and grad norms
   within ``MESH_REL``; each run's bytes a rank keeps below the control's,
   its peak and exchange ms and bytes a step; (d) (b)'s trained params RTN-packed at W2A16g128 and sliced by
   ``param_shardings``: the packed perplexity on ``(1, 2)`` through the
   kernels within ``MESH_PPL_REL`` of the no-mesh one, with the exact
   launches of kernel 1 and the expert kernel on each rank; (e) TinyLlama
   saved from ``(2, 1)``, restored without a mesh, one more step against
   the control's; (f) in the same two ranks, PaliGemma-3B (2 of 18 layers,
   256 seeded patches), RWKV6-3B (2 of 32), Zamba2-1.2B (6 of 38: one
   shared site) and whisper-small (2 + 2, 1500 seeded frames) at full
   width on ``(1, 2)`` with ``seq_parallel``, 2 steps each against its
   no-mesh bf16 control: losses within ``MESH_REL``, grad norms within
   ``MESH_REL`` or ``MESH_NOISE_X`` times the farthest of the control's
   twins at that step (RWKV6's: the scan over chunks of 64; Zamba2's:
   that, and Mamba's ``out_proj`` product summed from two halves), and
   Zamba2 in f32 beside an f32 control within ``MESH_F32_REL``; the
   split each plan gives (RWKV6's time mix by heads, Mamba's ``out_proj``,
   whisper's cross-attention; only the leaves gathered by design
   broadcast), its exchange, bytes kept and peak;
22. the reference's GSPMD serve path (``make_serve_steps(cfg, mesh)``, a
   ``MeshPlacement``): LLaMA-2-7B at full width and 2 of 32 layers, RTN
   W2A16g128, 4 x (128 + 8) and a scheduled run against the no-mesh
   control: (a) one NCCL rank on ``(1, 1)``, bit-identical; (b) two gloo
   ranks sharing the card on ``(1, 2)`` and ``(2, 1)``: the control's
   tokens, its logits bit for bit (or within ``parity_gate`` where a
   kernel's plan moves with a rank's rows), exact launches, the bytes a
   rank keeps equal to the shardings' prediction, the params' gather
   timed alone, a decode step's collective bytes; beside them the
   sanitizer (``debug.sanitized``: a guarded scheduled run and PAR
   iteration clean, a planted ``.item()`` raising),
   ``assert_no_recompiles`` and the dry-run CLI in a subprocess;
23. a JSON line listing the ported kernels with their numbers;
24. last line: ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no result.
Without a CUDA device, or without ``src/repro_torch`` beside this script,
it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# The caching allocator grows its segments in place instead of carving new
# ones: over the run's dozens of models the fixed-size segments fragmented
# until a 7.9 GB allocation of Command-R's calibration (phase 16) failed
# with 27 GB reserved and free (PERF.md §6, PR 26).  Read at the first CUDA
# allocation, so it is set before anything touches the card.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


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
# whisper-small's projections (phase 18): (K, N, per encoder layer of an
# admission at M = 1500) and (K, N, per decoder layer of a decode step at
# M = 8: self q, k, v, o and cross q, o, then the MLP); its soft_round
# leaves at g128 (ng, n, per encoder layer)
ENCDEC_ENC_SHAPES = ((768, 768, 4), (768, 3072, 1), (3072, 768, 1))
ENCDEC_DEC_SHAPES = ((768, 768, 6), (768, 3072, 1), (3072, 768, 1))
ENCDEC_SR_SHAPES = ((6, 768, 4), (6, 3072, 1), (24, 768, 1))
# Qwen3-30B-A3B's attention projections (q, k and v, o): K, N, per layer
MOE_ATTN_SHAPES = ((2048, 4096, 1), (2048, 512, 2), (4096, 2048, 1))
# LLaMA-2-7B W2 g128 at tp = 2 (phase 19): each rank's local K, N, per
# layer: wq/wk/wv out-split to 2048 columns, wo in-split to K = 2048 (16
# groups), w_gate/w_up to 5504 columns, w_down to K = 5504 (43 groups, a
# prime count for the GEMV's split of K; 1376 packed rows)
TP_SHAPES = ((4096, 2048, 3), (2048, 4096, 1), (4096, 5504, 2),
             (5504, 4096, 1))
# Qwen3-30B-A3B's attention at tp = 2 (16 of 32 heads, 2 of 4 KV heads):
# wq and wo at 2048 x 2048, wk and wv at 2048 x 256
TP_MOE_ATTN_SHAPES = ((2048, 2048, 2), (2048, 256, 2))


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


def bound(nbytes, flops, peak=None):
    """Least time for moving ``nbytes`` and doing ``flops`` operations at
    ``peak`` operations per second (bf16 unless stated: the int8 kernel's
    rows pass the int8 peak), at the H100 SXM's published dense peaks of
    ``launch/hlo_stats.py`` (the dry-run's roofline reads the same)."""
    from repro_torch.launch.hlo_stats import HBM_BW, PEAK_FLOPS
    t_b = nbytes / HBM_BW * 1e3
    t_f = flops / (PEAK_FLOPS if peak is None else peak) * 1e3
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
                main=False, moe=False, wa=False, sched=False, x_offset=0,
                encdec=False, tp=False):
    """Kernel vs plain version at one shape, then both timed with the
    library matmul on the pre-dequantized weight; ``main``, ``moe``, ``wa``,
    ``sched`` and ``encdec`` mark the shapes the LLaMA (W2 g128, M=4), the
    MoE, the weight-activation (W4 per-channel), the scheduled decode (W2
    g128, M=8), whisper-small's (an admission's encoder at M=1500, a
    decode step at M=8) and the tp = 2 LLaMA's (``tp``: phase 19's local
    shards, ``TP_SHAPES``) paths run (summed in the kernels line).
    ``x_offset`` > 0 takes x as rows ``x_offset:`` of a wider buffer (a
    base the kernel cannot load by TMA or 16-byte copies when 2 * K *
    x_offset is not a multiple of 16).  Each record names the configuration the kernel's host code chose
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
           "sched": sched, "encdec": encdec, "tp": tp}
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
                    main=False, moe=False, long=False, timed=True,
                    encdec=False, tp=False):
    """Kernel vs plain version at one shape (inactive slots exact zeros),
    then, if ``timed``, both timed with SDPA over the live positions where
    one call computes the same function.  ``main``, ``moe``, ``long`` and
    ``encdec`` mark the LLaMA decode shape, the Qwen3 shape, the long lane
    and whisper-small's scheduled decode, ``tp`` the LLaMA decode shape at
    tp = 2 (16 KV heads a rank) (summed in the kernels line).
    Each record names the plan the kernel's host code chose
    (``attention_config``)."""
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
           "moe": moe, "long": long, "encdec": encdec, "tp": tp,
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
                          card, main=False, timed=True, encdec=False,
                          tp=False):
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
           "encdec": encdec, "tp": tp, "config": config}
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
              (33, 2, 12, 20), (64, 2, 2, 512), (48, 1, 3, 1024),
              # phase 16: Mistral's scheduled lane (G = 4), Command-R (G =
              # 8), LLaMA-3-405B (G = 16: 8 blocks of 2 rows along G) at the
              # decode and the scheduled widths, Moonlight (16 KV heads)
              (368, 8, 4, 128), (144, 8, 8, 128), (144, 8, 16, 128),
              (368, 8, 16, 128), (368, 16, 1, 128),
              # phase 17: PaliGemma's MQA (one KV head, G = 8, D = 256: G·D
              # = 2048, past the G·D <= 256 register plan) at its scheduled
              # width (256 patches + 128 + 32 tokens), Zamba2's shared
              # block (32 heads of 64) at the lock-step and scheduled widths
              (416, 1, 8, 256), (144, 1, 8, 256), (144, 32, 1, 64),
              (368, 32, 1, 64),
              # phase 18: whisper-small's decoder self-attention (12 heads
              # of 64, no GQA) at its scheduled width (32 + 48 tokens)
              (80, 12, 1, 64),
              # phase 19: a tp = 2 rank's heads, LLaMA-2-7B (16 KV heads)
              # at the lock-step and scheduled widths, Qwen3-30B-A3B (2 KV
              # heads, G = 8)
              (144, 16, 1, 128), (144, 2, 8, 128))
# the paged walk at 8, 16 and 64 positions a page, and 2 (a warp's run spans
# more than 32 pages: the table read per row), each over a permuted table
# and bit for bit against the dense kernel: B, W, psz, Hkv, G, D
PAGED_PATHS = ((8, 46, 8, 32, 1, 128), (8, 23, 16, 4, 8, 128),
               (8, 6, 64, 8, 4, 128), (4, 2048, 2, 8, 1, 128),
               # phase 16's scheduled pools: Mistral (G = 4), Moonlight
               # (16 KV heads), and G = 16
               (8, 23, 16, 8, 4, 128), (8, 23, 16, 16, 1, 128),
               (8, 23, 16, 8, 16, 128),
               # phase 17's scheduled pools: PaliGemma, Zamba2
               (8, 26, 16, 1, 8, 256), (8, 23, 16, 32, 1, 64),
               # phase 18's: whisper-small
               (8, 5, 16, 12, 1, 64),
               # phase 19's: LLaMA-2-7B at tp = 2 (16 KV heads a rank) on
               # its scheduled pool (9 pages of 16)
               (4, 9, 16, 16, 1, 128))


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
                     experts=1, encdec=False):
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
    bit; with act_scale, or at a timed shape (``main``/``moe``/``wa``/
    ``encdec``, whisper-small's leaves: one
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
    timed = main or moe or wa or encdec
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
           "moe": moe, "wa": wa, "encdec": encdec,
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
SR_PATHS = ((32, 128, 14336, 2, True, None, 0),     # Mistral's w_gate
            (112, 128, 4096, 2, True, None, 0),      # Mistral's w_down
            (64, 128, 22528, 2, True, None, 0),      # Command-R's w_gate
            (176, 128, 8192, 2, True, None, 0),      # Command-R's w_down
            (1, 4096, 4096, 4, True, 1, 0), (1, 11008, 4096, 4, True, None, 0),
            (1, 4096, 11008, 4, False, None, 0),
            (32, 128, 4096, 2, True, None, 0),
            (2, 1000, 300, 3, True, 2, 0), (1, 999, 132, 2, True, None, 0),
            (3, 130, 4098, 2, True, None, 0), (64, 1, 256, 2, True, 1, 0),
            (16, 8, 384, 3, True, None, 0), (4, 128, 1, 2, True, None, 0),
            (4, 128, 3, 2, True, None, 0), (4, 128, 5, 3, False, None, 0),
            (4, 128, 127, 2, True, 1, 0), (4, 128, 129, 4, True, None, 0),
            (32, 128, 4096, 2, True, None, 1), (8, 128, 256, 2, True, 4, 0),
            (8, 128, 256, 2, False, 4, 0),
            # phase 17: Zamba2's in_proj (N = 2·4096 + 2·64 + 64 = 8384) and
            # out_proj, RWKV6's square leaves and cv (70 groups), ck
            (16, 128, 8384, 2, True, None, 0), (32, 128, 2048, 2, True, None, 0),
            (20, 128, 2560, 2, True, None, 0), (70, 128, 2560, 2, True, None, 0),
            (20, 128, 8960, 2, True, None, 0))


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
                     (8, 24, 256, 256, 2, 8, "ragged"),
                     # Moonlight's 64 experts (K/N 2048/1408, 1408 = 11
                     # groups of 128): decode, prefill and its count edges
                     (64, 8, 2048, 1408, 2, 128, "ragged"),
                     (64, 32, 1408, 2048, 2, 128, "full"),
                     (64, 160, 2048, 1408, 2, 128, "edge"),
                     # Qwen3-30B-A3B at tp = 2: a rank's 64 experts
                     (64, 8, 2048, 768, 2, 128, "ragged"),
                     (64, 40, 768, 2048, 2, 128, "ragged"))
# Moonlight's routed traffic (64 experts, top-6) through the same dispatch:
# a decode step at 8 slots and the 4 x 128 prefill.  E, top-k, tokens, and
# the expert products (K, N)
MOON_ROUTED = ((64, 6, 8), (64, 6, 512))
MOON_EXPERT_SHAPES = ((2048, 1408), (1408, 2048))


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
                  main=False, x=None, rows=None, routed=None, timed=True,
                  tp=False):
    """The expert-batched kernel vs its plain version, and vs one
    ``quant_matmul`` launch per expert (bit for bit), then timed with the
    unrolled launches and a ``torch.bmm`` yardstick on the pre-dequantized
    bf16 weights (not the same function: no dequantization).  ``rows``
    (int32 (E,) kept-row counts, or None) goes to all three, and every row
    past a count must be +0 by bit pattern; ``x`` (E, M, K) replaces the
    random x (a routed capacity buffer: ``routed`` is its token count, and
    the record is timed with and without ``rows``, the bound counting the
    bytes of the experts that hold a row).  A main record (random x) is
    also timed with ``rows`` = M everywhere; ``tp`` marks the records of
    Qwen3-30B-A3B's 64 experts a rank at tp = 2 (phase 19)."""
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
           "main": main, "routed": routed, "tp": tp, "config": config}
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


def check_routed(gen, tokens, flush, card, E=EXPERTS, top_k=ROUTED_TOP_K,
                 shapes=tuple((K, N) for K, N, _ in EXPERT_SHAPES)):
    """The routed traffic of ``tokens`` tokens (``routed_operands``, top
    ``top_k`` of ``E`` experts) through both expert shapes of a layer
    (``shapes``, W2 g128)."""
    C, rows, xs = routed_operands(gen, tokens, E, {K for K, _ in shapes},
                                  top_k=top_k)
    return [check_experts(gen, E, C, K, N, 2, 128, flush, card, x=xs[K],
                          rows=rows, routed=tokens)
            for K, N in shapes]


def summarize_experts(records):
    """One MoE layer's expert FFN at W2 g128: the 3 launches (2 x gate/up
    shape, 1 x down shape) at the decode capacity (C = 8), with the
    prefill capacity's (C = 40) times beside, and each routed traffic's
    (``routed``: by token count, the bound over the experts that hold a
    row, ``full_ms`` the same launches without ``rows``)."""
    per_layer = {(K, N): c for K, N, c in EXPERT_SHAPES}
    per_layer.update({(K, N): 2 if K < N else 1
                      for K, N in MOON_EXPERT_SHAPES})
    moon = [r for r in records if r["E"] != EXPERTS and r["routed"]]
    tp = [r for r in records if r["tp"]]
    records = [r for r in records if r["E"] == EXPERTS]

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
    # a tp = 2 rank's 64 experts: one layer's 3 launches at C = 8 and 40
    out["tp"] = {}
    for C in EXPERT_C:
        sel = [r for r in tp if r["M"] == C]
        out["tp"][f"C={C}"] = {
            **{key: sum(per_layer[(r["K"], r["N"])] * r[src] for r in sel)
               for key, src in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                                ("library_ms", "library_ms"),
                                ("bound_ms", "bound_ms"),
                                ("unrolled_ms", "unrolled_ms"))},
            "bound_by": sel[0]["bound_by"], "E": sel[0]["E"]}
    # Moonlight's routed traffic: E = 64, top-6, one layer's 3 launches
    out["moonlight_routed"] = {}
    for E, k, T in MOON_ROUTED:
        sel = [r for r in moon if r["routed"] == T and r["E"] == E]
        out["moonlight_routed"][f"{T} tokens"] = {
            **{key: sum(per_layer[(r["K"], r["N"])] * r[src] for r in sel)
               for key, src in (("ms", "kernel_ms"), ("full_ms", "full_ms"),
                                ("plain_ms", "plain_ms"),
                                ("library_ms", "library_ms"),
                                ("bound_ms", "bound_ms"))},
            "bound_by": sel[0]["bound_by"], "E": E, "top_k": k,
            "C": sel[0]["M"], "touched_experts": sel[0]["touched_experts"],
            "kept_rows": sel[0]["kept_rows"]}
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
    from repro_torch.launch.hlo_stats import INT8_PEAK_OPS
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * M * K * N,
                                             INT8_PEAK_OPS)
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
            (40, 48, 256, 4, 16, 0), (512, 4096, 4096, 2, 16, 0)) + tuple(
    # phase 16's FFN widths: Mistral-7B (14336), Command-R-35B (22528),
    # LLaMA-3-405B (53248 by 16384) and a Moonlight expert (1408: 11 groups
    # of 128) at the prefill's 512 rows, each as K and as N
    (512, K, N, 2, 128, 0) for K, N in (
        (4096, 14336), (14336, 4096), (8192, 22528), (22528, 8192),
        (16384, 53248), (53248, 16384), (2048, 1408), (1408, 2048),
        # phase 17: Zamba2's in_proj (8384 = 65.5 tiles of 128) and
        # out_proj, RWKV6's square leaves, ck and cv, PaliGemma's FFN
        (2048, 8384), (4096, 2048), (2560, 2560), (2560, 8960),
        (8960, 2560), (2048, 16384), (16384, 2048))) + tuple(
    # phase 18: whisper-small's projections at the packed perplexity's 4 x
    # 128 decoder rows (its admission's 1500 frames and its decode step
    # are timed under ENCDEC_SHAPES)
    (512, K, N, 2, 128, 0) for K, N in ((768, 768), (768, 3072),
                                        (3072, 768))) + tuple(
    # phase 19: Qwen3-30B-A3B's attention on a tp = 2 rank (LLaMA-2-7B's
    # shards are timed under TP_SHAPES)
    (512, K, N, 2, 128, 0) for K, N, _ in TP_MOE_ATTN_SHAPES)


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
    (4, 100, 256, 4, 100, 1), (8, 11008, 4096, 3, 11008, 0)) + tuple(
    # phase 16's FFN widths at a decode step's 4 rows, as K and as N
    (4, K, N, 2, 128, 0) for K, N in (
        (4096, 14336), (14336, 4096), (8192, 22528), (22528, 8192),
        (16384, 53248), (53248, 16384), (2048, 1408), (1408, 2048),
        # phase 17's widths, as in QM_PATHS
        (2048, 8384), (4096, 2048), (2560, 2560), (2560, 8960),
        (8960, 2560), (2048, 16384), (16384, 2048))) + tuple(
    # phase 19's Qwen3-30B-A3B attention on a tp = 2 rank
    (4, K, N, 2, 128, 0) for K, N, _ in TP_MOE_ATTN_SHAPES)
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
        # a tp = 2 rank's LLaMA-2-7B shards (phase 19)
        for K, N, _ in TP_SHAPES:
            out[name].append(check_quant(name, fn, plain, gen, M, K, N, 2,
                                         128, flush, card, tp=True))
        # whisper-small: an admission's encoder (M = 1500), a decode step
        # (8 slots)
        for K, N, _ in (ENCDEC_ENC_SHAPES if name == "quant_matmul"
                        else ENCDEC_DEC_SHAPES):
            out[name].append(check_quant(
                name, fn, plain, gen, 1500 if name == "quant_matmul" else 8,
                K, N, 2, 128, flush, card, encdec=True))
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
    # timed at a tp = 2 rank's LLaMA-2-7B decode (phase 19): 16 KV heads
    out["decode_attention"].append(check_attention(
        gen, 4, 144, 16, 1, 128, [136] * 4, [135] * 4, [1] * 4, flush, card,
        tp=True))
    # timed at whisper-small's scheduled decode (phase 18): 8 slots of 12
    # heads of 64 over its 80-position lane, mid-sequence
    out["decode_attention"].append(check_attention(
        gen, 8, 80, 12, 1, 64, [40] * 8, [39] * 8, [1] * 8, flush, card,
        encdec=True))
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
                              [1, 1, 0, 1], flush, card),
        # whisper-small's pool (phase 18), timed: 5 pages of 16 a slot
        check_paged_attention(gen, 8, 5, 16, 12, 1, 64,
                              [80, 17, 60, 41, 33, 8, 72, 50],
                              [1] * 8, flush, card, encdec=True),
        # a tp = 2 rank's LLaMA-2-7B pool (phase 19), timed: 4 slots of 9
        # pages of 16, 16 KV heads
        check_paged_attention(gen, 4, 9, 16, 16, 1, 128, [144, 37, 100, 71],
                              [1] * 4, flush, card, tp=True)]
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
    # a tp = 2 rank's 64 experts (phase 19) at the decode and prefill
    # capacities
    for C in EXPERT_C:
        for K, N, _ in EXPERT_SHAPES:
            out["quant_matmul_experts"].append(check_experts(
                gen, EXPERTS // TP_DEGREE, C, K, N, 2, 128, flush, card,
                tp=True))
    # the routed traffic, then every edge of the counts (EXPERT_ROWS_PATHS)
    for T in ROUTED_TOKENS:
        out["quant_matmul_experts"] += check_routed(gen, T, flush, card)
    for E, M, K, N, bits, g, spec in EXPERT_ROWS_PATHS:
        out["quant_matmul_experts"].append(check_experts(
            gen, E, M, K, N, bits, g, flush, card,
            rows=expert_rows(gen, spec, E, M), timed=False))
    for E, k, T in MOON_ROUTED:
        out["quant_matmul_experts"] += check_routed(
            gen, T, flush, card, E=E, top_k=k, shapes=MOON_EXPERT_SHAPES)
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
    for ng, n, _ in ENCDEC_SR_SHAPES:
        out["soft_round"].append(check_soft_round(
            gen, ng, n, 2, True, flush, card, encdec=True))
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
# phase 7 serves LLaMA-2-7B at its widths and 4 of 32 layers (its own RTN
# build; phase 3's full-depth model before PR 26, 8 layers before PR 27): a
# decode step is host-bound, about linear in the depth, and the phase's
# dozen runs of the workload took ~110 s of the run at full depth
SCHED_LAYERS = 4
SCHED_WORKLOAD = dict(n_requests=16, seed=0, prompt_lens=(16, 384),
                      budgets=(4, 48), mean_gap=2.0)
ALONE_RIDS = (0, 5, 10, 15)


def prefill_calls(res, reqs, chunk=0, extra=0):
    """(rows, tokens) of every prefill call a scheduled run made (batch 1):
    the whole prompt (after ``extra`` prefix positions: a VLM's patches),
    or its chunks from the first position not served by shared pages."""
    calls = []
    for r in reqs:
        plen = len(r.prompt) + extra
        start = res.requests[r.rid]["shared_tokens"]
        calls += ([min(chunk, plen - c) for c in range(start, plen, chunk)]
                  if chunk else [plen])
    return [(n, n) for n in calls]


def family_launches(cfg):
    """(quantized projections, expert-batched launches, attention sites) of
    one forward call of ``cfg``'s model: dense and VLM 7 projections a
    layer; MoE the 4 attention projections and 3 expert launches a layer;
    RWKV6 8 a layer (wr, wk, wv, wg, wo, ck, cv, cr) and no attention;
    the hybrid 2 a mamba layer (in_proj, out_proj) and the shared block's
    7 at each of its sites, one attention a site."""
    L = cfg.num_layers
    if cfg.family == "moe":
        return 4 * L, 3 * L, L
    if cfg.family == "rwkv":
        return 8 * L, 0, 0
    if cfg.family == "hybrid":
        sites = L // cfg.attn_every
        return 2 * L + 7 * sites, 0, sites
    return 7 * L, 0, L


def expected_launches(cfg, calls, steps, attn, prefill_attn):
    """Launch counts from the dispatch rules: the quantized projections of
    ``family_launches`` for every prefill call and every decode step, to
    the GEMV at most ``DECODE_GEMV_MAX_ROWS`` rows (``kernels/ops.py``;
    decode steps have at most 8 slots) and to the tiled matmul above (MoE:
    the expert-batched launches whatever the rows); one attention launch
    per site and decode step (``attn``), and per site of a prefill call of
    a single token, which takes the decode kernel too (``prefill_attn``:
    dense on a batch-1 lane, paged on the pool).  ``calls`` holds each
    prefill call's (rows, tokens); a VLM's prefill (patches + prompt)
    never has one token.  The unpacked head is a library matmul."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import DECODE_GEMV_MAX_ROWS
    per, experts, sites = family_launches(cfg)
    e = {k: 0 for k in build.KERNELS}
    for rows, tokens in calls:
        e["quant_gemv" if rows <= DECODE_GEMV_MAX_ROWS
          else "quant_matmul"] += per
        e["quant_matmul_experts"] += experts
        if tokens == 1:
            e[prefill_attn] += sites
    e["quant_gemv"] += per * steps
    e["quant_matmul_experts"] += experts * steps
    e[attn] += sites * steps
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


def schedule_phase(card, packed, cfg):
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import (Request, compile_sched_steps,
                                              make_workload, serve_lockstep,
                                              serve_scheduled)
    from repro_torch.launch.serve import compile_serve_steps, serve_requests
    from repro_torch.models import get_model

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
                   tag="schedule-profile", distinct=False, pos0=200):
    """Where one scheduled decode step's time goes at full width: all 8
    slots live from position ``pos0``, the step run ``n`` times.  Wall time per
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
             "pos": torch.full((SCHED_SLOTS,), pos0, dtype=torch.int32,
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
          f"{pos0}+{', distinct tokens' if distinct else ''}: wall "
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
MOE_LAYERS = 4          # depth cut from 48 (one card, and the run's time
#                         limit: 16 before PR 26, 8 before PR 27); widths
#                         are published
MOE_CAL_SAMPLES = 8


def moe_serve_phase(card):
    """Phase 8: RTN W2A16g128 + pack at full width, depth MOE_LAYERS, then
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


# --------------------------------------------------------------------------
# phase 15: training (the train CLI, TinyLlama-1.1B with remat, the
# quickstart, the MoE card vs CPU)
# --------------------------------------------------------------------------

TRAIN_ARCH = "smollm-135m"      # the train CLI's default: 30 L, d 576, tied
TRAIN_ARGS = ("--batch", "8", "--seq", "256", "--ckpt-every", "12",
              "--log-every", "1")
# cut from 40 steps for the run's time (the card's losses fell by 0.61
# over the first 20 steps and 1.06 over 24: PERF.md §4); the resumed run
# of 12 more steps is gone (the stopped chain's resume holds resume
# bit-equality)
TRAIN_STEPS = 24
# the stopped run: SIGTERM after step 6, resumed, and SIGTERM again once
# its step-12 checkpoint is written, held to the straight run's step 12
TRAIN_STOP_AT, TRAIN_CMP = 6, 12
# mean of the last 10 losses below the mean of the first 10 by this much:
# the CPU rehearsal (the same width, vocab, schedule, batch and data at 2 of
# the 30 layers) fell by 1.99 nats in 40 steps
TRAIN_MARGIN = 0.5
RESUME_ATOL = 1e-6              # SIGTERM + resume vs the straight run
BIG_ARCH = "tinyllama-1.1b"
BIG_BATCH, BIG_SEQ, BIG_STEPS = 4, 2048, 3
ATTN_REL = 1e-4                 # recomputing vs plain-loop dq/dk/dv, f32
QUICK_SOFT_ROUND = 7 * 5 * 25 * 4   # 7 linears x K=5 x T=25 x 4 blocks
QUICK_QMM = 7 * 4 * 4               # 7 linears x 4 blocks x 4 eval batches
MOE_TRAIN_STEPS = 4
MOE_LOSS_RTOL = 1e-3            # 4 f32 steps, card vs CPU


def _train_cli(args, ckpt_dir, stop_at=None):
    """``python -m repro_torch.launch.train`` in a child process on the
    card; returns (exit code, {step: (loss, gnorm)}, (ms per step after
    the first, the first step's seconds), the output).  ``stop_at``: send SIGTERM once step ``stop_at`` is logged.
    The ms line also splits the time (batch synthesis, saves, the rest)."""
    import signal
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, *TRAIN_ARGS, "--ckpt-dir", ckpt_dir, "--device",
           "cuda", *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines, losses, ms, first = [], {}, None, None
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            parts = line.split()
            if parts[:1] == ["step"] and len(parts) >= 6:
                step = int(parts[1])
                losses[step] = (float(parts[3]), float(parts[5]))
                if stop_at is not None and step == stop_at:
                    proc.send_signal(signal.SIGTERM)
            if "ms per step" in line:
                ms = float(line.split(": ")[1].split()[0])
                first = float(line.split("first step ")[1].split("s;")[0])
                print(f"[train-cli] {line.strip()}", flush=True)
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, losses, (ms, first), lines


def _ckpt_leaves(ckpt_dir, step):
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "leaves.npz")
    with np.load(path) as d:
        return [d[f"leaf_{i}"] for i in range(len(d.files))]


def train_cli_phase(card):
    """(a) The train CLI at full width and depth: 24 steps with checkpoints
    at 12 and 24; beside them a run stopped by SIGTERM after step 6, which
    saves and exits 2, resumed (and stopped again once past its step-12
    checkpoint), held to the straight run's step 12."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        straight, stopped = (os.path.join(tmp, "straight"),
                             os.path.join(tmp, "stopped"))
        # the stopped runs share the host and the card with the straight
        # and the resumed run (for the run's time); the chain only
        # collects, the checks follow its join
        chain = {}

        def stopped_chain():
            chain["first"] = _train_cli(["--steps", str(TRAIN_STEPS)],
                                        stopped, stop_at=TRAIN_STOP_AT)
            chain["saved"] = [n for n in os.listdir(stopped)
                              if n.startswith("step_")]
            chain["second"] = _train_cli(["--steps", str(TRAIN_STEPS)],
                                         stopped, stop_at=TRAIN_CMP)
        chain_thread = threading.Thread(target=stopped_chain)
        chain_thread.start()
        try:
            t0 = time.perf_counter()
            rc, losses, (ms, first_s), out = _train_cli(
                ["--steps", str(TRAIN_STEPS)], straight)
            secs = time.perf_counter() - t0
            if rc != 0 or sorted(losses) != list(range(TRAIN_STEPS)):
                fail(f"train CLI exit {rc}, steps {sorted(losses)}: "
                     + "\n".join(out[-20:]))
            ls = [losses[s][0] for s in range(TRAIN_STEPS)]
            first, last = float(np.mean(ls[:10])), float(np.mean(ls[-10:]))
            print(f"[train-cli] {TRAIN_ARCH} {' '.join(TRAIN_ARGS)}: "
                  f"{TRAIN_STEPS} steps (beside the stopped runs): the first "
                  f"{first_s:.3f}s, then {ms:.3f} ms per step (split above);"
                  f" the process {secs:.3f}s; loss first 10 "
                  f"{first:.4f} last 10 {last:.4f} (margin {TRAIN_MARGIN}); "
                  f"losses {[round(x, 4) for x in ls]}; card=[{card}]",
                  flush=True)
            if not (np.isfinite(ls).all() and last < first - TRAIN_MARGIN):
                fail(f"train CLI loss did not fall: {first} -> {last}")
        finally:
            chain_thread.join()
        rc, part, _, out = chain["first"]
        saved = chain["saved"]
        if rc != 2 or len(saved) != 1 or not any(
                "preempted" in line for line in out):
            fail(f"SIGTERM run: exit {rc}, checkpoints {saved}: "
                 + "\n".join(out[-10:]))
        at = int(saved[0].split("_")[1])
        rc, rest, _, out = chain["second"]
        if rc != 2 or f"[train] resumed from step {at}" not in out:
            fail(f"resume after SIGTERM: exit {rc}: "
                 + "\n".join(out[-10:]))
        a = _ckpt_leaves(straight, TRAIN_CMP)
        b = _ckpt_leaves(stopped, TRAIN_CMP)
        if len(a) != len(b):
            fail(f"checkpoint leaves {len(a)} vs {len(b)}")
        diffs = [float(np.abs(x.astype(np.float64) - y).max())
                 if x.size else 0.0 for x, y in zip(a, b)]
        worst = int(np.argmax(diffs))
        print(f"[train-cli] SIGTERM after step {TRAIN_STOP_AT}: exit 2, "
              f"checkpoint at step {at}; resumed, checkpoint at {TRAIN_CMP}: "
              f"max |diff| vs the straight run's {diffs[worst]:.3g} over "
              f"{len(a)} leaves (params bf16 staged through f32, Adam m/v "
              f"f32; worst leaf {worst}), "
              f"{sum(d == 0.0 for d in diffs)} leaves bit-equal; loss at "
              f"{TRAIN_CMP - 1}: straight {losses[TRAIN_CMP - 1][0]:.4f}, "
              f"resumed {rest[TRAIN_CMP - 1][0]:.4f}", flush=True)
        if diffs[worst] > RESUME_ATOL:
            fail(f"resumed run differs from the straight run by "
                 f"{diffs[worst]} (leaf {worst})")
    return {"ms_per_step": ms, "first_step_s": first_s,
            "loss_first10": first, "loss_last10": last,
            "resume_max_diff": diffs[worst], "stopped_at": at}


def _big_batches(cfg):
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=BIG_SEQ, global_batch=BIG_BATCH,
                                      seed=0))
    return [{"tokens": torch.from_numpy(data.batch(s)["tokens"]).to("cuda")}
            for s in range(BIG_STEPS)]


def big_train_run(cfg, batches):
    """BIG_STEPS steps of the train harness from seed 0; the last under
    ``torch.cuda.set_sync_debug_mode("warn")``, whose host syncs are
    counted by source line; then one forward of the loss with a graph,
    whose memory kept for the backward is read.  Returns (losses, ms per
    step of each step, peak bytes, {"file:line": syncs}, activation
    bytes)."""
    import collections
    import warnings

    from repro_torch.launch.steps import make_train_harness
    from repro_torch.models import get_model
    from repro_torch.models.common import make_ctx
    from repro_torch.optim.adam import tree_map
    h = make_train_harness(cfg, None, lr=3e-4)
    params = h.init_params(0, "cuda")
    opt = h.init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, syncs = [], [], {}
    for i, b in enumerate(batches):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        if i < len(batches) - 1:
            params, opt, m = h.step_fn(params, opt, b)
        else:
            with warnings.catch_warnings(record=True) as log:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    params, opt, m = h.step_fn(params, opt, b)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = dict(collections.Counter(
                f"{os.path.basename(w.filename)}:{w.lineno}" for w in log
                if "synchroniz" in str(w.message)))
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    loss = get_model(cfg).loss_fn(p, batches[0], make_ctx(cfg))
    torch.cuda.synchronize()
    act = torch.cuda.memory_allocated() - base
    del params, opt, m, p, loss
    gc.collect()
    torch.cuda.empty_cache()
    return losses, ms, peak, syncs, act


def attention_backward_check(cfg, card):
    """One layer's attention at S = BIG_SEQ: the recomputing backward's dq,
    dk, dv against autograd through the plain loop (f32), and the peak
    memory of each."""
    from repro_torch.models import layers as L
    B, S, D = BIG_BATCH, BIG_SEQ, cfg.resolved_head_dim
    Hkv, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    C = min(512, S)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, Hkv, G, S, D), generator=gen, device="cuda") * D ** -0.5
    k = torch.randn((S // C, B, Hkv, C, D), generator=gen, device="cuda")
    v = torch.randn((S // C, B, Hkv, C, D), generator=gen, device="cuda")
    dout = torch.randn((B, Hkv, G, S, D), generator=gen, device="cuda")
    q_pos = torch.arange(S, dtype=torch.float32, device="cuda")[None].expand(
        B, S)
    valid = torch.full((B,), float(S), device="cuda")
    grads, peaks, kept, ms = {}, {}, {}, {}
    for name, fn in (("recompute", L._flash_core),
                     ("plain", lambda *a: L._flash_fwd(*a)[0])):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        out = fn(*leaves, q_pos, valid)
        torch.cuda.synchronize()
        kept[name] = torch.cuda.memory_allocated() - base
        out.backward(dout)
        e.record()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        ms[name] = s.elapsed_time(e)
        grads[name] = [t.grad for t in leaves]
        del out, leaves
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(grads["recompute"], grads["plain"])]
    print(f"[train-attention] {cfg.name} one layer, B={B} S={S} Hkv={Hkv} "
          f"G={G} D={D}, chunk {C}: dq/dk/dv max |diff| / max |plain| "
          f"{errs} (limit {ATTN_REL}); kept from the forward for the "
          f"backward (the output included): recomputing "
          f"{kept['recompute'] / 1e9:.3f} GB, plain loop "
          f"{kept['plain'] / 1e9:.3f} GB; forward + backward peak above the "
          f"inputs: {peaks['recompute'] / 1e9:.3f} GB vs "
          f"{peaks['plain'] / 1e9:.3f} GB; ms {ms['recompute']:.3f} vs "
          f"{ms['plain']:.3f}; card=[{card}]", flush=True)
    if max(errs) > ATTN_REL:
        fail(f"recomputing attention backward vs the plain loop: {errs}")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"rel_err": errs, "peak_bytes": peaks, "kept_bytes": kept,
            "ms": ms}


def big_train_phase(card):
    """(b) TinyLlama-1.1B at full width and depth, BIG_STEPS steps at
    BIG_BATCH x BIG_SEQ with remat on (its config's) and off: finite
    losses, ms per step, peak memory; then the attention check."""
    from repro_torch.configs import get_config
    cfg = get_config(BIG_ARCH)
    t0 = time.perf_counter()
    batches = _big_batches(cfg)
    t_data = time.perf_counter() - t0
    out = {}
    for remat in (True, False):
        losses, ms, peak, syncs, act = big_train_run(
            cfg.replace(remat=remat), batches)
        out[remat] = (losses, ms, peak, syncs, act)
        print(f"[train-big] {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
              f"V={cfg.vocab_size} {cfg.dtype}, f32 Adam, {BIG_BATCH} x "
              f"{BIG_SEQ} tokens, remat {'on' if remat else 'off'}: losses "
              f"{losses}; ms per step {[round(x, 3) for x in ms]}; peak "
              f"{peak / 1e9:.3f} GB; the loss's forward keeps "
              f"{act / 1e9:.3f} GB for the backward; host syncs in the last "
              f"step {syncs} (batches made in {t_data:.3f}s); "
              f"card=[{card}]", flush=True)
        if not np.isfinite(losses).all():
            fail(f"non-finite TinyLlama loss (remat {remat}): {losses}")
    on, off = out[True][0], out[False][0]
    if not np.allclose(on, off, rtol=1e-3, atol=0):
        fail(f"remat on/off losses differ: {on} vs {off}")
    attn = attention_backward_check(cfg, card)
    return {"remat": {str(k): {"losses": v[0], "ms": v[1], "peak_bytes": v[2],
                               "syncs": v[3], "activation_bytes": v[4]}
                      for k, v in out.items()}, "attention": attn}


def _load_example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    path = os.path.join(HERE, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quickstart_phase(card):
    """(c) ``examples/quickstart_torch.py`` on the card: the paper's
    ordering fp <= AWQ+TesseraQ < AWQ < RTN, the packed model's perplexity
    through ``quant_matmul`` within PPL_REL of the fake-quant model's, and
    exact launches."""
    from repro_torch.kernels import build
    qs = _load_example("quickstart_torch")
    build.reset_launch_counts()
    res = qs.main(["--device", "cuda"])
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    ppl = res["ppl"]
    print(f"[quickstart] train loss {res['train_loss']:.4f}; ppl {ppl}; "
          f"packed {res['ppl_packed']:.6g}; {res['report']}; secs "
          f"{res['secs']}; launches {counts}; card=[{card}]", flush=True)
    expected = {k: 0 for k in build.KERNELS}
    expected.update(soft_round_fwd=QUICK_SOFT_ROUND,
                    soft_round_bwd=QUICK_SOFT_ROUND, quant_matmul=QUICK_QMM)
    if counts != expected:
        fail(f"quickstart launch counts {counts}, expected {expected}")
    if not (ppl["fp16"] <= ppl["tesseraq"] + 1e-6
            and ppl["tesseraq"] < ppl["awq"] < ppl["rtn"]):
        fail(f"quickstart perplexity ordering {ppl}")
    if abs(res["ppl_packed"] - ppl["tesseraq"]) > PPL_REL * ppl["tesseraq"]:
        fail(f"packed perplexity {res['ppl_packed']} vs fake-quant "
             f"{ppl['tesseraq']}")
    return counts, res


def moe_train_phase(card):
    """(d) The reduced qwen3 MoE in f32 trained MOE_TRAIN_STEPS steps on the
    card and on the CPU from the same params: losses within
    MOE_LOSS_RTOL."""
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch.steps import make_train_harness
    cfg = get_reduced_config(MOE_ARCH).replace(dtype="float32")
    h = make_train_harness(cfg, None, lr=1e-3)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=4))
    p0 = h.init_params(0, "cpu")
    losses = {}
    for dev in ("cuda", "cpu"):
        p = params_to(p0, dev)
        o = h.init_opt(p)
        ls = []
        for s in range(MOE_TRAIN_STEPS):
            p, o, m = h.step_fn(p, o, data.batch(s))
            ls.append(float(m["loss"]))
        losses[dev] = ls
    rel = float(np.max(np.abs(np.subtract(losses["cuda"], losses["cpu"]))
                       / np.abs(losses["cpu"])))
    print(f"[train-moe] {cfg.name} f32, {MOE_TRAIN_STEPS} steps: card "
          f"{losses['cuda']} cpu {losses['cpu']}; max rel diff {rel:.3g} "
          f"(limit {MOE_LOSS_RTOL})", flush=True)
    if not (np.isfinite(losses["cuda"]).all() and rel <= MOE_LOSS_RTOL):
        fail(f"MoE training card vs CPU: {losses}")
    return {"losses": losses, "rel": rel}


def train_phase(card):
    """Phase 15: (a) the train CLI's child processes beside (b)
    TinyLlama-1.1B, (d) the MoE card vs CPU and (c) the quickstart (for the
    run's time: PERF.md §4).  Only (c) launches kernels:
    training runs none, which (b) and (d) check; the CLI's children count
    their own."""
    from repro_torch.kernels import build
    out, cli = {}, {}
    t0 = time.perf_counter()

    def run_cli():
        try:
            cli["out"] = train_cli_phase(card)
        except BaseException as e:      # re-raised in this thread below
            cli["err"] = e
        cli["s"] = time.perf_counter() - t0
    thread = threading.Thread(target=run_cli)
    thread.start()
    try:
        build.reset_launch_counts()
        out["big"] = big_train_phase(card)
        out["moe"] = moe_train_phase(card)
        if any(build.LAUNCHES.values()):
            fail(f"training launched kernels: {dict(build.LAUNCHES)}")
        t1 = time.perf_counter()
        counts, out["quickstart"] = quickstart_phase(card)
        t2 = time.perf_counter()
    finally:
        thread.join()
    if "err" in cli:
        raise cli["err"]
    out["cli"] = cli["out"]
    print(f"[train] (a) CLI {cli['s']:.1f}s beside (b) + (d) "
          f"{t1 - t0:.1f}s and (c) quickstart {t2 - t1:.1f}s: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return counts, out


# --------------------------------------------------------------------------
# phase 16: the rest of the dense and MoE configs, the int8 KV cache and the
# host-loop calibration engines
# --------------------------------------------------------------------------

# each arch at its published widths and a depth that fits one card in bf16
# beside the RTN walk's copy of the block stack, and since PR 26 the run's
# time limit (None: full depth; each cut and its seconds in PERF.md §4):
# Mistral-7B 4 of 32 layers (whole is ~14.5 GB); Command-R-35B 2 of 40
# layers (8.4 GB of embedding and head, 1.41 GB a layer); LLaMA-3-405B 2
# of 126 (8.4 GB + 6.4 GB a layer); Moonlight-16B-A3B 2 of 48 (28.06B
# params in all, ~56 GB, so not whole beside the walk's copy)
ARCH_DEPTHS = (("mistral-7b", 4), ("command-r-35b", 2),
               ("llama3-405b", 2), ("moonshot-v1-16b-a3b", 2))
# which of them also run the scheduler (phase 7's workload on both stores)
# and one calibration: (depth, K, T, samples); Mistral's two blocks at a
# shortened schedule, one block of Command-R (soft_round at 8192 x 22528)
# and of Moonlight (the expert kernel at E = 64, top-6).  LLaMA-3-405B is
# not calibrated: a block holds ~3.2e9 rounding variables, and ν, its base
# and the two Adam moments in f32 with the int8 mask (17 bytes a variable)
# take ~54 GB before θ̂ and the block's own weights (PERF.md §7).
SCHEDULED_ARCHS = ("mistral-7b", "moonshot-v1-16b-a3b")
ARCH_CAL = {"mistral-7b": (2, 5, 10, 8), "command-r-35b": (1, 4, 5, 8),
            "moonshot-v1-16b-a3b": (1, 5, 10, 8)}
# the int8 KV cache: the reference's bound (tests/test_beyond_paper.py:
# max |difference| over max |logit| of one decode step after a prefill,
# against the forward without a cache), held where the reference holds it,
# on a 2-layer model (here at LLaMA-2-7B's widths).  At full depth the
# int8 cache's rounding compounds over the 32 layers of the random-weight
# W2 model: the card read 0.0647 for that step (the bf16 cache 0.0210) and
# 0.0617 / 0.0633 over the 16 teacher-forced steps against the bf16
# cache's logits in two calls, the kernels 0.0196 (rel. L2) from the
# "xla" path on the same int8 cache (PERF.md §6, PR 25).  The full-depth
# bound is 1.5x those; a wrong scale or cache read moves the logits by
# O(1) of their largest.
KV_REL = 5e-2
KV_REL_DEEP = 1e-1
# the engines on phase 5's block, at depth 1 since PR 26 (the run's time
# limit: the host-loop engines took ~70 s at depth 2), a short schedule
# (T cut from 10 to 5, then K from 3 to 2, T to 2 and the
# OmniQuant / SignRound host steps from 20 to 10, then T to 1, for the
# run's time: the host engines pay a NumPy harden a PAR iteration: PERF.md
# §4)
ENGINE_K, ENGINE_T, ENGINE_LAYERS = 2, 1, 1
METHOD_HOST_STEPS = 10
# the legacy host loop against the device engine on the card, in f32: its
# one batched backward and the canonical per-sample lanes take different
# cuBLAS products, so the gradients differ by f32 rounding, and Adam (or
# SignSGD) turns a rounding-level gradient into a whole step where the
# gradient is near zero; a code flips where ν (or the perturbation) ends
# near a rounding edge.  First card reading (PERF.md §6, PR 25): TesseraQ
# 20 of 404,750,336 codes, folded scales 3.5e-4 apart; OmniQuant 3 of
# 202,375,168 codes, scales 2.1e-5; SignRound (a sign step on every
# variable) 835,409 codes.  On the CPU the two are equal (tests).  A wrong
# gradient or update moves every code and the block's error.
LEGACY_CODE_SHARE = 1e-6
SIGNROUND_CODE_SHARE = 2e-2
LEGACY_SCALE_RTOL = 2e-3
LEGACY_MSE_RTOL = 1e-3


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def build_packed(arch, layers, tag, quant="W2A16g128"):
    """``arch`` at its published widths and ``layers`` layers (None: all;
    an encoder-decoder's encoder cut alike), random weights from seed 0,
    RTN to ``quant`` + pack.  Returns (cfg, model, packed, prompts) with 4
    x 128 prompt tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import (pack_model, quantize_model,
                                           quantized_memory_report)
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           calibration_batches)
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model

    full = get_config(arch)
    cfg = full if layers is None else full.replace(num_layers=layers)
    if layers is not None and cfg.family == "encdec":
        cfg = cfg.replace(encoder_layers=layers)
    model = get_model(cfg)
    qcfg = parse_quant(quant, kernel_backend="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(0, "cuda")
    torch.cuda.synchronize()
    moe = (f" E={cfg.moe.num_experts} top-{cfg.moe.top_k}"
           if cfg.family == "moe" else "")
    print(f"[{tag}] init {cfg.name} L={cfg.num_layers} of {full.num_layers} "
          f"d={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"hd={cfg.resolved_head_dim} ff={cfg.d_ff}{moe} V={cfg.vocab_size} "
          f"in {time.perf_counter() - t0:.3f}s; "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB", flush=True)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                          global_batch=4, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(data_cfg, 2, 1)]
    if cfg.family == "vlm":
        calib = [dict(b, patches=seeded_patches(cfg, len(b["tokens"]), i))
                 for i, b in enumerate(calib)]
    if cfg.family == "encdec":
        calib = [dict(b, frames=seeded_frames(cfg, len(b["tokens"]), i))
                 for i, b in enumerate(calib)]
    t0 = time.perf_counter()
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="none", init="rtn")
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    torch.cuda.synchronize()
    mse = [b["recon_mse"] for b in report["blocks"]]
    if not all(np.isfinite(mse)):
        fail(f"{tag}: non-finite recon_mse in the RTN walk")
    mem = quantized_memory_report(packed)
    print(f"[{tag}] RTN walk + pack {qcfg.tag} in "
          f"{time.perf_counter() - t0:.3f}s; recon_mse first/last "
          f"{mse[0]:.4g}/{mse[-1]:.4g}; packed {mem['quantized_bytes']} B "
          f"(fp16 {mem['fp16_bytes']} B); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    del params, pfq, qmeta
    _free()
    prompts = SyntheticCorpus(data_cfg).batch(0)["tokens"][:, :128]
    return cfg, model, packed, prompts


def lockstep_phase(tag, cfg, model, packed, prompts, card, gen=16,
                   compiled=None):
    """Warm-up, then ``serve_requests`` 4 x (128 + ``gen``) on ``"pallas"``
    with exact launch counts and finite logits.  Returns (counts, res)."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve_requests
    B, PROMPT = prompts.shape
    kw = dict(kernel_backend="pallas", device="cuda", compiled=compiled)
    serve_requests(cfg, model, packed, prompts, gen=2, collect_logits=False,
                   **kw)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = serve_requests(cfg, model, packed, prompts, gen=gen, **kw)
    counts = dict(build.LAUNCHES)
    want = expected_launches(cfg, [(B * PROMPT, PROMPT)], gen - 1,
                             "decode_attention", "decode_attention")
    if counts != want:
        fail(f"{tag} launch counts {counts}, expected {want}")
    if res.logits.shape != (B, gen, cfg.vocab_size) \
            or not np.isfinite(res.logits).all():
        fail(f"{tag}: bad logits, shape {res.logits.shape}")
    print(f"[{tag}] {B} x ({PROMPT} prompt + {gen} generated) on pallas: "
          f"prefill {res.prefill_tok_s:.1f} tok/s ({res.prefill_secs * 1e3:.3f}"
          f" ms), decode {res.decode_secs * 1e3 / (gen - 1):.3f} ms/step, "
          f"kv cache {res.cache_stats['cache_bytes']} B, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches "
          f"{counts}; card=[{card}]", flush=True)
    return counts, res


def scheduled_pair(tag, cfg, packed, card, steps=None, attn=None):
    """Phase 7's workload at ``cfg``'s vocabulary, 8 slots, on the dense
    and the paged store (``steps``: {store: SchedSteps}, else the
    scheduler's own; ``attn``: {store: the decode-attention kernel});
    exact launch counts, dense tokens == paged tokens.  Returns (summed
    counts, {store: result})."""
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import (Request, compile_sched_steps,
                                              make_workload, serve_scheduled)
    reqs = make_workload(cfg.vocab_size, **SCHED_WORKLOAD)
    width = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    max_seq = width + (-width) % SCHED_PSZ
    kw = dict(slots=SCHED_SLOTS, max_seq=max_seq, kernel_backend="pallas",
              page_size=SCHED_PSZ, device="cuda")
    steps = steps or {store: compile_sched_steps(
        cfg, max_seq=max_seq, kernel_backend="pallas",
        page_size=SCHED_PSZ if store == "paged" else 0)
        for store in ("dense", "paged")}
    attn = attn or {"dense": "decode_attention",
                    "paged": "paged_decode_attention"}
    warm = [Request(0, reqs[0].prompt[:24], 3),
            Request(1, reqs[1].prompt[:40], 2, arrival=1)]
    runs, total = {}, {k: 0 for k in build.KERNELS}
    for store in ("dense", "paged"):
        serve_scheduled(cfg, packed, warm, store=store, compiled=steps[store],
                        **kw)
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res = serve_scheduled(cfg, packed, reqs, store=store,
                              compiled=steps[store], **kw)
        counts = dict(build.LAUNCHES)
        want = expected_launches(cfg, prefill_calls(res, reqs), res.steps,
                                 attn[store], "decode_attention")
        print(f"[{tag}] {store}: {res.steps} decode steps, occupancy "
              f"{res.occupancy:.4f}, prefill {res.prefill_secs:.3f}s, "
              f"decode {res.decode_secs:.3f}s "
              f"({res.decode_secs * 1e3 / max(res.steps, 1):.3f} ms/step, "
              f"{res.decode_tok_s:.2f} useful tok/s); cache "
              f"{res.cache_stats['cache_bytes']} B; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
              f"{counts}; card=[{card}]", flush=True)
        if counts != want:
            fail(f"{tag} {store}: launches {counts}, expected {want}")
        runs[store] = res
        total = {k: total[k] + counts[k] for k in total}
    if not same_tokens(runs["dense"], runs["paged"], reqs):
        fail(f"{tag}: paged tokens differ from dense")
    return total, runs


def short_calibrate_phase(tag, arch, layers, K, T, samples, card):
    """AWQ + TesseraQ at ``arch``'s widths and ``layers`` layers (K PAR
    iterations of T steps, ``samples`` x 512 tokens), pack, perplexity of
    the packed and the fake-quant model: exact launches, finite losses, a
    final soft rate of 0, packed within ``PPL_REL`` of fake-quant.
    Returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import (DataConfig, calibration_batches,
                                           eval_batches)
    from repro_torch.eval.ppl import perplexity
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model

    cfg = get_config(arch).replace(num_layers=layers)
    model = get_model(cfg)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    tcfg = TesseraQConfig(par_iterations=K, steps_per_iteration=T,
                          batch_size=CAL_BS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=CAL_SEQ,
                          global_batch=CAL_BS, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(data_cfg, samples // CAL_BS,
                                          CAL_BS)]
    evalb = eval_batches(data_cfg, EVAL_BATCHES, CAL_BS)
    params = model.init_params(0, "cuda")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="tesseraq", init="awq",
                                        tcfg=tcfg)
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ppl_packed = perplexity(cfg, packed, evalb, backend="pallas")
    ppl_fq = perplexity(cfg, pfq, evalb, backend="pallas")
    counts = dict(build.LAUNCHES)
    moe = cfg.family == "moe"
    want = {k: 0 for k in build.KERNELS}
    want.update({"quant_matmul": (4 if moe else 7) * layers * EVAL_BATCHES,
                 "quant_matmul_experts": (3 * layers * EVAL_BATCHES if moe
                                          else 0),
                 "soft_round_fwd": 7 * K * T * layers,
                 "soft_round_bwd": 7 * K * T * layers})
    for b in report["blocks"]:
        losses = [e["loss"] for e in b["log"]]
        print(f"[{tag}] block {b['block']}: recon_mse {b['recon_mse']:.6g}; "
              f"PAR loss first {losses[0]:.6g} last {losses[-1]:.6g}; "
              f"{b['secs']:.3f}s (reconstruction {b['recon_secs']:.3f}s, "
              f"{b['recon_secs'] * 1e3 / (K * T):.3f} ms per Soften step "
              f"incl. hardens)", flush=True)
        if not all(np.isfinite(losses)) or not np.isfinite(b["recon_mse"]):
            fail(f"{tag}: non-finite loss in block {b['block']}")
        if len(losses) != K or b["log"][-1]["soft_rate"] != 0.0:
            fail(f"{tag} block {b['block']}: {len(losses)} PAR iterations, "
                 f"final soft rate {b['log'][-1]['soft_rate']}")
    print(f"[{tag}] {cfg.name} L={layers}, K={K} T={T}, {samples} x "
          f"{CAL_SEQ} tokens: walk + pack {t_cal:.3f}s, peak "
          f"{peak / 1e9:.3f} GB; perplexity packed {ppl_packed:.6g} "
          f"fake-quant {ppl_fq:.6g}; launches {counts}; card=[{card}]",
          flush=True)
    if counts != want:
        fail(f"{tag} launch counts {counts}, expected {want}")
    if not (np.isfinite(ppl_packed) and np.isfinite(ppl_fq)
            and abs(ppl_packed - ppl_fq) <= PPL_REL * ppl_fq):
        fail(f"{tag}: packed perplexity {ppl_packed} vs fake-quant {ppl_fq}")
    del params, pfq, qmeta, packed
    _free()
    return counts


def configs_phase(card):
    """Phase 16 (a)-(d): each of ``ARCH_DEPTHS`` RTN-packed and served
    lock-step with the teacher-forced ``"xla"`` check; the scheduled pair
    for ``SCHEDULED_ARCHS``; the calibrations of ``ARCH_CAL``.  Returns
    the summed launch counts."""
    from repro_torch.kernels import build
    total = {k: 0 for k in build.KERNELS}

    def add(c):
        for k in total:
            total[k] += c[k]

    for arch, layers in ARCH_DEPTHS:
        t0 = time.perf_counter()
        tag = f"configs {arch}"
        cfg, model, packed, prompts = build_packed(arch, layers, tag)
        counts, res = lockstep_phase(tag, cfg, model, packed, prompts, card)
        add(counts)
        teacher_forced_check(tag, cfg, model, packed, prompts, res)
        if arch in SCHEDULED_ARCHS:
            add(scheduled_pair(tag, cfg, packed, card)[0])
        del packed, res
        _free()
        if arch in ARCH_CAL:
            add(short_calibrate_phase(f"{tag} calibrate", arch,
                                      *ARCH_CAL[arch], card))
        print(f"[time] configs {arch} {time.perf_counter() - t0:.1f}s",
              flush=True)
    return total


def _cache_dtype(model, dtype):
    """``model`` with its caches allocated in ``dtype`` whatever the caller
    asks for (the serve loops and stores allocate the default bf16)."""
    import dataclasses
    init = model.init_cache
    return dataclasses.replace(
        model, init_cache=lambda b, s, _=None, *a, **kw: init(b, s, dtype,
                                                             *a, **kw))


def int8_sched_steps(cfg, max_seq):
    """{store: SchedSteps} of the int8 KV cache: ``make_sched_steps(kv_bits
    =8)`` over int8 stores (``compile_sched_steps`` builds no int8 steps, as
    the reference's does not)."""
    from repro_torch.launch.scheduler import SchedSteps
    from repro_torch.launch.steps import (make_paged_install_step,
                                          make_sched_steps)
    out = {}
    for store, psz in (("dense", 0), ("paged", SCHED_PSZ)):
        model, pstep, dstep = make_sched_steps(
            cfg, max_seq=max_seq, kv_bits=8, kernel_backend="pallas",
            page_size=psz)
        out[store] = SchedSteps(
            model=_cache_dtype(model, torch.int8), prefill=pstep,
            decode=dstep, page_size=psz,
            install=(make_paged_install_step(model, page_size=psz)
                     if psz else None))
    return out


def _forced(steps, model, packed, prompts, toks):
    """Logits (B, 1 + len, V) of ``steps`` = (prefill, decode) over
    ``prompts`` and then the tokens ``toks`` (B, len) fed step by step,
    the cache from ``model.init_cache``."""
    pstep, dstep = steps
    B, PROMPT = prompts.shape
    toks = torch.as_tensor(toks, dtype=torch.long, device="cuda")
    with torch.no_grad():
        cache = model.init_cache(B, PROMPT + toks.shape[1], device="cuda")
        lg, cache = pstep(packed, {"tokens": torch.as_tensor(
            prompts, dtype=torch.long, device="cuda")}, cache)
        out = [lg]
        pos = torch.full((B,), PROMPT, dtype=torch.int32, device="cuda")
        for j in range(toks.shape[1]):
            lg, cache = dstep(packed, cache, toks[:, j], pos)
            pos = pos + 1
            out.append(lg)
    return torch.stack(out, 1).float().cpu().numpy()


def reference_kv_test(cfg, model, packed, prompts):
    """The reference's int8 KV test (tests/test_beyond_paper.py) on
    ``packed``: a prefill of all but the last prompt token and one decode
    step, against the forward without a cache, as max |diff| / max
    |logit|, with an int8 cache and (for scale) a bf16 one."""
    from repro_torch.launch.steps import make_serve_steps
    from repro_torch.models import transformer
    from repro_torch.models.common import make_ctx
    with torch.no_grad():
        full = transformer.forward(packed, cfg, torch.as_tensor(
            prompts, dtype=torch.long, device="cuda"),
            make_ctx(kernel_backend="pallas"))[:, -1].float().cpu().numpy()
    out = {}
    for name, kv_bits, dt in (("int8", 8, torch.int8),
                              ("bf16", None, torch.bfloat16)):
        m, pstep, dstep = make_serve_steps(cfg, kv_bits=kv_bits,
                                           kernel_backend="pallas")
        lg = _forced((pstep, dstep), _cache_dtype(m, dt), packed,
                     prompts[:, :-1], prompts[:, -1:])
        out[name] = float(np.abs(lg[:, 1] - full).max() / np.abs(full).max())
    return out


def kv_int8_phase(card):
    """Phase 16 (e): phase 3's packed LLaMA-2-7B through
    ``make_serve_steps(kv_bits=8)`` and an int8 cache.  Lock-step: exact
    launches, half the bf16 run's cache bytes.  The reference's own test
    (``reference_kv_test``) within ``KV_REL`` at 2 layers of LLaMA-2-7B's
    widths, within ``KV_REL_DEEP`` at full depth; teacher-forced over the
    bf16 run's 16 steps, the int8 cache's logits within ``KV_REL_DEEP`` of
    the bf16 cache's, and the kernels' within ``REL_L2`` of the ``"xla"``
    path's on the same int8 cache.  Then scheduled on int8 dense and paged
    stores: exact launches (the paged run's decode on the dense kernel),
    equal tokens.  Returns the summed counts."""
    from repro_torch.launch.scheduler import make_workload
    from repro_torch.launch.steps import make_serve_steps

    tag = "kv-int8"
    cfg2, model2, packed2, prompts2 = build_packed("llama2-7b", 2, tag)
    shallow = reference_kv_test(cfg2, model2, packed2, prompts2)
    del packed2
    _free()
    cfg, model, packed, prompts = build_packed("llama2-7b", None, tag)
    GEN = 16
    _, ref = lockstep_phase(f"{tag} bf16", cfg, model, packed, prompts, card,
                            gen=GEN)
    m8, pstep, dstep = make_serve_steps(cfg, kv_bits=8,
                                        kernel_backend="pallas")
    m8 = _cache_dtype(m8, torch.int8)
    counts, res = lockstep_phase(f"{tag} int8", cfg, m8, packed, prompts,
                                 card, gen=GEN, compiled=(pstep, dstep))
    b8, b16 = res.cache_stats["cache_bytes"], ref.cache_stats["cache_bytes"]
    if 2 * b8 != b16:
        fail(f"{tag}: int8 cache {b8} B, bf16 cache {b16} B")
    deep = reference_kv_test(cfg, model, packed, prompts)
    # teacher-forced on the bf16 run's tokens: every step sees one prefix
    tf8 = _forced((pstep, dstep), m8, packed, prompts, ref.tokens[:, :-1])
    xla8 = _forced(make_serve_steps(cfg, kv_bits=8, kernel_backend="xla")[1:],
                   m8, packed, prompts, ref.tokens[:, :-1])
    run = float(np.abs(tf8 - ref.logits).max() / np.abs(ref.logits).max())
    run_dec = float(np.abs(tf8[:, 1:] - ref.logits[:, 1:]).max()
                    / np.abs(ref.logits[:, 1:]).max())
    kern = float(np.linalg.norm(tf8 - xla8) / np.linalg.norm(xla8))
    agree = float((tf8.argmax(-1) == ref.tokens).mean())
    print(f"[{tag}] the reference's test (prefill of 127 tokens + one "
          f"decode step vs the forward without a cache; max |diff| / max "
          f"|logit|): 2 layers int8 {shallow['int8']:.6g} (bound {KV_REL}), "
          f"bf16 {shallow['bf16']:.6g}; 32 layers int8 {deep['int8']:.6g} "
          f"(bound {KV_REL_DEEP}), bf16 {deep['bf16']:.6g}.  Over the 16 "
          f"steps, teacher-forced on the bf16 run's tokens, int8 vs bf16 "
          f"cache {run:.6g} ({run_dec:.6g} over the decode steps; bound "
          f"{KV_REL_DEEP}), argmax agreement {agree:.4f}, free-running "
          f"tokens equal {float((res.tokens == ref.tokens).mean()):.4f}; "
          f"kernels vs xla on the int8 cache: relative L2 {kern:.6g} (gate "
          f"{REL_L2}); cache {b8} B vs {b16} B", flush=True)
    if not (shallow["int8"] < KV_REL and deep["int8"] < KV_REL_DEEP
            and run < KV_REL_DEEP and kern < REL_L2):
        fail(f"{tag}: int8 cache at 2 layers {shallow}, at 32 {deep}, over "
             f"the run {run}, kernels vs xla {kern}")
    width = max(len(r.prompt) + r.max_new_tokens
                for r in make_workload(cfg.vocab_size, **SCHED_WORKLOAD))
    max_seq = width + (-width) % SCHED_PSZ
    sched, runs = scheduled_pair(
        f"{tag} scheduled", cfg, packed, card,
        steps=int8_sched_steps(cfg, max_seq),
        attn={"dense": "decode_attention", "paged": "decode_attention"})
    del packed, ref, res
    _free()
    return {k: counts[k] + sched[k] for k in counts}


def _differ(a, b, keys):
    """{key: elements that differ} over two {path: qmeta} and the largest
    relative difference of their folded scales."""
    diff = {k: sum(int((a[p][k] != b[p][k]).sum()) for p in b) for k in keys}
    rel = max(float(((a[p]["scale"] - b[p]["scale"]).abs()
                     / b[p]["scale"].abs().clamp(min=1e-30)).max())
              for p in b)
    return diff, rel


def engines_phase(card):
    """Phase 16 (f): AWQ + TesseraQ on phase 5's LLaMA-2-7B at depth 1 in
    f32 (K = ``ENGINE_K``, T = ``ENGINE_T``) on the ``"device"``,
    ``"reference"`` and ``"legacy"`` engines, with ms per Soften step
    (hardens and host transfers included) and host syncs per PAR
    iteration of each: the reference engine's codes,
    masks and folded scales equal to the device engine's; the legacy
    engine's within ``LEGACY_*``.  Then OmniQuant and SignRound,
    ``METHOD_HOST_STEPS`` steps on block 0, on the ``"legacy"`` host loop
    against ``"device"``.  Returns the summed launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import omniquant, recon_engine as RE, signround
    from repro_torch.core.blocks import build_stages
    from repro_torch.core.capture import split_minibatches
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.rtn import quantize_block_rtn
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import DataConfig, calibration_batches
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model

    tag = "engines"
    # in f32, where the engines' results are comparable (in bf16 a batch of
    # 4 and 4 single samples round the block's products apart)
    cfg = get_config("llama2-7b").replace(num_layers=ENGINE_LAYERS,
                                          dtype="float32")
    params = get_model(cfg).init_params(0, "cuda")
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=CAL_SEQ,
                          global_batch=CAL_BS, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(data_cfg, CAL_SAMPLES // CAL_BS,
                                          CAL_BS)]
    total = {k: 0 for k in build.KERNELS}
    steps = ENGINE_K * ENGINE_T
    metas, mses = {}, {}
    for engine in ("device", "reference", "legacy"):
        tcfg = TesseraQConfig(par_iterations=ENGINE_K,
                              steps_per_iteration=ENGINE_T,
                              batch_size=CAL_BS, engine=engine)
        build.reset_launch_counts()
        RE.reset_sync_count()
        _, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                          method="tesseraq", init="awq",
                                          tcfg=tcfg)
        torch.cuda.synchronize()
        syncs = RE.sync_count()
        counts = dict(build.LAUNCHES)
        want = {k: 0 for k in build.KERNELS}
        want.update({"soft_round_fwd": 7 * steps * ENGINE_LAYERS,
                     "soft_round_bwd": 7 * steps * ENGINE_LAYERS})
        if counts != want:
            fail(f"{tag} {engine}: launches {counts}, expected {want}")
        total = {k: total[k] + counts[k] for k in total}
        metas[engine] = qmeta
        mses[engine] = [b["recon_mse"] for b in report["blocks"]]
        ms = [b["recon_secs"] * 1e3 / steps for b in report["blocks"]]
        print(f"[{tag}] {engine}: ms per Soften step (hardens and host "
              f"transfers included) " + "/".join(f"{m:.3f}" for m in ms)
              + f"; host syncs {syncs} "
              f"({syncs / (ENGINE_K * ENGINE_LAYERS):.1f} per PAR iteration); "
              f"recon_mse " + "/".join(f"{m:.6g}" for m in mses[engine])
              + f"; launches {counts}; card=[{card}]", flush=True)
    n = sum(m.numel() for m in (v["codes"] for v in metas["device"].values()))
    for engine in ("reference", "legacy"):
        diff, rel = _differ(metas[engine], metas["device"],
                            ("codes", "hard"))
        mse_rel = max(abs(a - b) / b for a, b in zip(mses[engine],
                                                     mses["device"]))
        print(f"[{tag}] {engine} vs device: codes differ {diff['codes']}/"
              f"{n}, hard masks differ {diff['hard']}/{n}, folded scales "
              f"max relative difference {rel:.3g}, recon_mse relative "
              f"difference {mse_rel:.3g}", flush=True)
        exact = engine == "reference"
        if (max(diff.values()) > (0 if exact else LEGACY_CODE_SHARE * n)
                or rel > (0 if exact else LEGACY_SCALE_RTOL)
                or mse_rel > (0 if exact else LEGACY_MSE_RTOL)):
            fail(f"{tag}: {engine} engine against device: {diff} of {n}, "
                 f"scales {rel}, recon_mse {mse_rel}")
    del metas
    _free()

    # OmniQuant and SignRound on block 0's streams, host loop vs device
    stage = build_stages(cfg)[0]
    with torch.no_grad():
        X = torch.cat([stage.init_x(params, b) for b in calib], 0)
        bp = stage.get_block(params, 0)
        parts = split_minibatches(X)
        Y = torch.cat([stage.apply(bp, x) for x in parts], 0).float()
        _, rtn_meta = quantize_block_rtn(bp, qcfg)
    for name, limit in (("omniquant", LEGACY_CODE_SHARE),
                        ("signround", SIGNROUND_CODE_SHARE)):
        out, mse = {}, {}
        for engine in ("device", "legacy"):
            build.reset_launch_counts()
            RE.reset_sync_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "omniquant":
                bq, m = omniquant.reconstruct_block(
                    stage.apply, bp, X, Y, None, qcfg,
                    steps=METHOD_HOST_STEPS, batch_size=CAL_BS,
                    engine=engine)
            else:
                bq, m = signround.reconstruct_block(
                    stage.apply, bp, X, Y, None, rtn_meta, qcfg,
                    steps=METHOD_HOST_STEPS, batch_size=CAL_BS,
                    engine=engine)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if any(build.LAUNCHES.values()):
                fail(f"{tag} {name}: launched {dict(build.LAUNCHES)}")
            with torch.no_grad():
                mse[engine] = float(sum(
                    torch.sum(torch.square(stage.apply(bq, x).float() - y))
                    for x, y in zip(parts, split_minibatches(Y)))
                    / Y.numel())
            out[engine] = m
            print(f"[{tag}] {name} {engine}: {METHOD_HOST_STEPS} steps in "
                  f"{secs:.3f}s ({secs * 1e3 / METHOD_HOST_STEPS:.3f} ms a "
                  f"step), host syncs {RE.sync_count()}, recon_mse "
                  f"{mse[engine]:.6g}", flush=True)
        diff, rel = _differ(out["legacy"], out["device"], ("codes",))
        n = sum(m["codes"].numel() for m in out["device"].values())
        mse_rel = abs(mse["legacy"] - mse["device"]) / mse["device"]
        print(f"[{tag}] {name} legacy vs device: codes differ "
              f"{diff['codes']}/{n}, scales max relative difference "
              f"{rel:.3g}, recon_mse relative difference {mse_rel:.3g}",
              flush=True)
        if (diff["codes"] > limit * n or rel > LEGACY_SCALE_RTOL
                or mse_rel > LEGACY_MSE_RTOL):
            fail(f"{tag}: {name} legacy against device: {diff['codes']} of "
                 f"{n} codes, scales {rel}, recon_mse {mse_rel}")
    del params, X, Y, bp
    _free()
    return total


def new_configs_phase(card):
    """Phase 16: (a)-(d) ``configs_phase``, (e) ``kv_int8_phase``, (f)
    ``engines_phase``, each path's launches counted from 0."""
    t0 = time.perf_counter()
    out = {"configs": configs_phase(card)}
    t1 = time.perf_counter()
    out["kv_int8"] = kv_int8_phase(card)
    t2 = time.perf_counter()
    out["engines"] = engines_phase(card)
    t3 = time.perf_counter()
    print(f"[time] phase 16: (a)-(d) configs {t1 - t0:.1f}s, (e) int8 KV "
          f"cache {t2 - t1:.1f}s, (f) engines {t3 - t2:.1f}s", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 17: the VLM, RWKV and hybrid families (PaliGemma-3B, RWKV6-3B,
# Zamba2-1.2B) at published widths
# --------------------------------------------------------------------------

# RWKV6-3B and Zamba2-1.2B: lock-step 4 x (128 + 16), phase 7's workload on
# both stores and a profiled decode step; PaliGemma-3B scheduled only (the
# serve loop feeds tokens alone, as the reference's): 8 slots, 16 seeded
# requests of 256 patches + 16..128 prompt tokens, 4..32 generated
FAMILY_SERVED = ("rwkv6-3b", "zamba2-1.2b")
VLM_ARCH = "paligemma-3b"
VLM_WORKLOAD = dict(n_requests=16, seed=0, prompt_lens=(16, 128),
                    budgets=(4, 32), mean_gap=2.0)
VLM_FORCED = 4          # requests teacher-forced against "xla"
PATCH_STD = 0.1
# AWQ + TesseraQ (K=3, T=5; T cut from 10 for the run's time),
# 8 samples of 512 positions (PaliGemma: 256
# patches + 256 tokens) at these depths: two RWKV6 and two PaliGemma
# blocks, Zamba2 cut to its first segment (six mamba stages, then the
# shared block's first site)
FAMILY_CAL = (("rwkv6-3b", 2), ("paligemma-3b", 2), ("zamba2-1.2b", 6))
FAMILY_K, FAMILY_T = 3, 5
CAL_SAMPLES_F = 8
# The teacher-forced "xla" check's limit per family.  At W2 on these
# random-weight groups the zero point is 1 or 2, so |code - zero| <= 2 and
# the "xla" path's bf16 dequantization is exact, equal to the kernels'
# rounded-once one; what is left is the f32 summation order of the kernels
# against cuBLAS, amplified by the model.  The card read (PERF.md §6, PR 26)
# PaliGemma-3B 0.0170, held to phase 3's REL_L2; RWKV6-3B 0.0514 and
# Zamba2-1.2B 0.0710 at full depth (32 and 38 recurrent layers), held to
# 0.1, while the same two at FAMILY_CONTROL_LAYERS layers are held to
# REL_L2.  Served at FAMILY_SERVED_LAYERS (cut from full depth for the
# run's time: PERF.md §4), still held to 0.1.  A wrong kernel moves the
# logits by O(1) of their norm, and phase 2 holds each kernel to its plain
# version at these widths.
FAMILY_REL_L2 = {"rwkv6-3b": 0.1, "zamba2-1.2b": 0.1, VLM_ARCH: REL_L2}
FAMILY_CONTROL_LAYERS = 6
FAMILY_SERVED_LAYERS = 8


def seeded_patches(cfg, n, seed):
    """(n, num_patches, d_model) stub SigLIP embeddings, N(0, PATCH_STD)
    from ``seed``, in the model's dtype on the card."""
    from repro_torch.models.transformer import model_dtype
    rng = np.random.default_rng(1000 + seed)
    p = rng.normal(size=(n, cfg.num_patches, cfg.d_model)) * PATCH_STD
    return torch.as_tensor(p, dtype=torch.float32,
                           device="cuda").to(model_dtype(cfg))


def family_serve_phase(arch, card):
    """(a) / (b): ``arch`` at its widths and ``FAMILY_SERVED_LAYERS``
    layers, RTN W2A16g128 + pack; lock-step with exact
    launches and the teacher-forced ``"xla"`` check; phase 7's workload on
    both stores (exact launches, equal tokens); a profiled scheduled decode
    step.  Returns (summed counts, {"lockstep_ms", "profile"})."""
    from repro_torch.launch.scheduler import compile_sched_steps, \
        make_workload
    tag = f"families {arch}"
    cfg, model, packed, prompts = build_packed(arch, FAMILY_SERVED_LAYERS,
                                               tag)
    counts, res = lockstep_phase(tag, cfg, model, packed, prompts, card)
    rel = teacher_forced_check(tag, cfg, model, packed, prompts, res,
                               limit=FAMILY_REL_L2[arch])
    reqs = make_workload(cfg.vocab_size, **SCHED_WORKLOAD)
    width = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    max_seq = width + (-width) % SCHED_PSZ
    steps = {store: compile_sched_steps(
        cfg, max_seq=max_seq, kernel_backend="pallas",
        page_size=SCHED_PSZ if store == "paged" else 0)
        for store in ("dense", "paged")}
    sched, runs = scheduled_pair(tag, cfg, packed, card, steps=steps)
    prof = decode_profile(steps["dense"], packed, "dense", max_seq, card,
                          tag=f"{tag} profile")
    total = {k: counts[k] + sched[k] for k in counts}
    out = {"lockstep_ms": res.decode_secs * 1e3 / (res.tokens.shape[1] - 1),
           "rel_l2": rel, "profile": prof,
           "sched_ms": {s: r.decode_secs * 1e3 / max(r.steps, 1)
                        for s, r in runs.items()}}
    del packed, res, runs, steps
    _free()
    # the control: the same widths at FAMILY_CONTROL_LAYERS layers, held to
    # phase 3's limit
    ctag = f"{tag} L={FAMILY_CONTROL_LAYERS}"
    cfg, model, packed, prompts = build_packed(arch, FAMILY_CONTROL_LAYERS,
                                               ctag)
    c, res = lockstep_phase(ctag, cfg, model, packed, prompts, card)
    out["rel_l2_control"] = teacher_forced_check(ctag, cfg, model, packed,
                                                 prompts, res)
    total = {k: total[k] + c[k] for k in total}
    del packed, res
    _free()
    return total, out


def vlm_requests(cfg):
    """``VLM_WORKLOAD`` with each request's patches in ``extras``."""
    import dataclasses
    from repro_torch.launch.scheduler import make_workload
    rng = np.random.default_rng(VLM_WORKLOAD["seed"] + 1)
    return [dataclasses.replace(r, extras={"patches": (rng.normal(
        size=(cfg.num_patches, cfg.d_model)) * PATCH_STD).astype(np.float32)})
        for r in make_workload(cfg.vocab_size, **VLM_WORKLOAD)]


def extras_forced_check(tag, cfg, model, packed, res, reqs, max_seq, limit,
                     n=VLM_FORCED):
    """The first ``n`` requests' logits of a scheduled "pallas" run against
    the "xla" steps fed the same extras (a VLM's patches, an
    encoder-decoder's frames), prompt and tokens, each request alone:
    relative L2 over all their logits below ``limit``."""
    from repro_torch.launch.steps import make_serve_steps
    _, xpre, xdec = make_serve_steps(cfg, kernel_backend="xla")
    P = cfg.num_patches if cfg.family == "vlm" else 0
    got, ref = [], []
    with torch.no_grad():
        for r in reqs[:n]:
            rr = res.requests[r.rid]
            toks = torch.as_tensor(rr["tokens"], dtype=torch.long,
                                   device="cuda")
            cache = model.init_cache(1, max_seq, device="cuda")
            batch = {k: torch.as_tensor(v[None], device="cuda")
                     for k, v in r.extras.items()}
            batch["tokens"] = torch.as_tensor(r.prompt[None],
                                              dtype=torch.long,
                                              device="cuda")
            lg, cache = xpre(packed, batch, cache)
            out = [lg]
            pos = torch.tensor([P + len(r.prompt)], dtype=torch.int32,
                               device="cuda")
            for j in range(r.max_new_tokens - 1):
                lg, cache = xdec(packed, cache, toks[j:j + 1], pos)
                pos = pos + 1
                out.append(lg)
            ref.append(torch.cat(out, 0).float().cpu().numpy())
            got.append(rr["logits"])
    got, ref = np.concatenate(got), np.concatenate(ref)
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
    print(f"[{tag}] teacher-forced xla reference over {len(got)} positions "
          f"of {n} requests: relative L2 {rel:.6g} (gate "
          f"{limit}); argmax agreement {agree:.4f}", flush=True)
    if not rel < limit:
        fail(f"{tag}: logits differ from the xla backend by relative L2 "
             f"{rel}")
    return rel


def vlm_schedule_phase(card):
    """(c) PaliGemma-3B whole, RTN W2A16g128 + pack, through
    ``serve_scheduled`` on both stores (8 slots, ``vlm_requests``): exact
    launches, dense tokens == paged tokens; then the first ``VLM_FORCED``
    requests with their logits, teacher-forced against "xla".  Returns the
    summed counts."""
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import (Request, compile_sched_steps,
                                              serve_scheduled)
    tag = f"families {VLM_ARCH}"
    cfg, model, packed, _ = build_packed(VLM_ARCH, None, tag)
    reqs = vlm_requests(cfg)
    P = cfg.num_patches
    width = P + max(len(r.prompt) + r.max_new_tokens for r in reqs)
    max_seq = width + (-width) % SCHED_PSZ
    kw = dict(slots=SCHED_SLOTS, max_seq=max_seq, kernel_backend="pallas",
              page_size=SCHED_PSZ, device="cuda")
    attn = {"dense": "decode_attention", "paged": "paged_decode_attention"}
    warm = [Request(0, reqs[0].prompt[:24], 3, extras=reqs[0].extras),
            Request(1, reqs[1].prompt[:40], 2, arrival=1,
                    extras=reqs[1].extras)]
    runs, total = {}, {k: 0 for k in build.KERNELS}
    for store in ("dense", "paged"):
        steps = compile_sched_steps(cfg, max_seq=max_seq,
                                    kernel_backend="pallas",
                                    page_size=SCHED_PSZ if store == "paged"
                                    else 0)
        serve_scheduled(cfg, packed, warm, store=store, compiled=steps, **kw)
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res = serve_scheduled(cfg, packed, reqs, store=store, compiled=steps,
                              **kw)
        counts = dict(build.LAUNCHES)
        want = expected_launches(cfg, prefill_calls(res, reqs, extra=P),
                                 res.steps, attn[store], "decode_attention")
        print(f"[{tag}] {store}: {len(reqs)} requests of {P} patches + "
              f"{VLM_WORKLOAD['prompt_lens']} tokens, {res.steps} decode "
              f"steps, occupancy {res.occupancy:.4f}, prefill "
              f"{res.prefill_secs:.3f}s, decode {res.decode_secs:.3f}s "
              f"({res.decode_secs * 1e3 / max(res.steps, 1):.3f} ms/step, "
              f"{res.decode_tok_s:.2f} useful tok/s); cache "
              f"{res.cache_stats['cache_bytes']} B; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
              f"{counts}; card=[{card}]", flush=True)
        if counts != want:
            fail(f"{tag} {store}: launches {counts}, expected {want}")
        runs[store] = res
        total = {k: total[k] + counts[k] for k in total}
    if not same_tokens(runs["dense"], runs["paged"], reqs):
        fail(f"{tag}: paged tokens differ from dense")
    forced = serve_scheduled(cfg, packed, reqs[:VLM_FORCED], store="dense",
                             collect_logits=True, **kw)
    if not same_tokens(forced, runs["dense"], reqs[:VLM_FORCED]):
        print(f"[{tag}] note: the logit-collecting run's tokens differ from "
              f"the full workload's (other slots live)", flush=True)
    rel = extras_forced_check(tag, cfg, model, packed, forced, reqs, max_seq,
                           FAMILY_REL_L2[VLM_ARCH])
    out = {"sched_ms": {s: r.decode_secs * 1e3 / max(r.steps, 1)
                        for s, r in runs.items()}, "rel_l2": rel}
    del packed, runs, forced
    _free()
    return total, out


def family_calibrate_phase(arch, layers, card):
    """(d) AWQ + TesseraQ (FAMILY_K, FAMILY_T) on ``arch`` at its widths and
    ``layers`` layers, ``CAL_SAMPLES_F`` x 512 positions; the AWQ-only walk
    beside it: every calibrated block's recon_mse below AWQ's; pack;
    packed perplexity within ``PPL_REL`` of fake-quant; exact launches
    (``soft_round`` once a leaf and Soften step, ``quant_matmul`` in the
    packed perplexity).  Returns the counts and the per-block numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.blocks import build_stages, quant_leaf_paths
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import (DataConfig, calibration_batches,
                                           eval_batches)
    from repro_torch.eval.ppl import perplexity
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model

    tag = f"families {arch} calibrate"
    cfg = get_config(arch).replace(num_layers=layers)
    model = get_model(cfg)
    P = cfg.num_patches if cfg.family == "vlm" else 0
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    tcfg = TesseraQConfig(par_iterations=FAMILY_K,
                          steps_per_iteration=FAMILY_T, batch_size=CAL_BS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=CAL_SEQ - P,
                          global_batch=CAL_BS, seed=0)

    def with_patches(bs, seed0):
        out = []
        for i, b in enumerate(bs):
            b = {"tokens": torch.as_tensor(b["tokens"], device="cuda")}
            if P:
                b["patches"] = seeded_patches(cfg, len(b["tokens"]),
                                              seed0 + i)
            out.append(b)
        return out

    calib = with_patches([{"tokens": b["tokens"][:, :-1]} for b in
                          calibration_batches(data_cfg,
                                              CAL_SAMPLES_F // CAL_BS,
                                              CAL_BS)], 0)
    evalb = with_patches(eval_batches(data_cfg, EVAL_BATCHES, CAL_BS), 100)
    params = model.init_params(0, "cuda")
    stages = build_stages(cfg)
    leaves = sum(len(quant_leaf_paths(st.get_block(params, i)))
                 for st in stages if st.calibrate for i in range(st.n_blocks))
    _, _, rep_awq = quantize_model(cfg, params, calib, qcfg, method="none",
                                   init="awq", tcfg=tcfg)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="tesseraq", init="awq",
                                        tcfg=tcfg)
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ppl_packed = perplexity(cfg, packed, evalb, backend="pallas")
    ppl_fq = perplexity(cfg, pfq, evalb, backend="pallas")
    counts = dict(build.LAUNCHES)
    per, _, _ = family_launches(cfg)
    want = {k: 0 for k in build.KERNELS}
    want.update({"quant_matmul": per * EVAL_BATCHES,
                 "soft_round_fwd": leaves * FAMILY_K * FAMILY_T,
                 "soft_round_bwd": leaves * FAMILY_K * FAMILY_T})
    blocks = []
    for b, a in zip(report["blocks"], rep_awq["blocks"], strict=True):
        losses = [e["loss"] for e in b["log"]]
        step_ms = b["recon_secs"] * 1e3 / (FAMILY_K * FAMILY_T)
        print(f"[{tag}] {b['stage']} {b['block']}: recon_mse "
              f"{b['recon_mse']:.6g} (AWQ {a['recon_mse']:.6g}); PAR loss "
              f"first {losses[0]:.6g} last {losses[-1]:.6g}; {b['secs']:.3f}s "
              f"(reconstruction {b['recon_secs']:.3f}s, {step_ms:.3f} ms per "
              f"Soften step incl. hardens)", flush=True)
        if (b["stage"], b["block"]) != (a["stage"], a["block"]):
            fail(f"{tag}: walks differ in their blocks")
        if not all(np.isfinite(losses)) or not np.isfinite(b["recon_mse"]):
            fail(f"{tag}: non-finite loss in {b['stage']} {b['block']}")
        if not b["recon_mse"] < a["recon_mse"]:
            fail(f"{tag}: {b['stage']} recon_mse {b['recon_mse']} not below "
                 f"AWQ's {a['recon_mse']}")
        blocks.append({"stage": b["stage"], "secs": b["secs"],
                       "step_ms": step_ms, "recon_mse": b["recon_mse"],
                       "awq_mse": a["recon_mse"]})
    print(f"[{tag}] {cfg.name} L={layers}, K={FAMILY_K} T={FAMILY_T}, "
          f"{CAL_SAMPLES_F} x {CAL_SEQ} positions ({P} patches): walk + pack "
          f"{t_cal:.3f}s, peak {peak / 1e9:.3f} GB; perplexity packed "
          f"{ppl_packed:.6g} fake-quant {ppl_fq:.6g}; launches {counts}; "
          f"card=[{card}]", flush=True)
    if counts != want:
        fail(f"{tag} launch counts {counts}, expected {want}")
    if not (np.isfinite(ppl_packed) and np.isfinite(ppl_fq)
            and abs(ppl_packed - ppl_fq) <= PPL_REL * ppl_fq):
        fail(f"{tag}: packed perplexity {ppl_packed} vs fake-quant {ppl_fq}")
    del params, pfq, qmeta, packed
    _free()
    return counts, {"blocks": blocks, "secs": t_cal, "peak_gb": peak / 1e9}


# (e) runs in a child process beside (a)-(d) (the run's time:
# PERF.md §4): the example's own main, its launches counted in the child
EVERY_FAMILY_CHILD = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from repro_torch.kernels import build
import quantize_every_family_torch as ex
build.reset_launch_counts()
res = ex.main(["--device", "cuda"])
torch.cuda.synchronize()
print("[every-family-json]", json.dumps({"res": res,
                                          "counts": dict(build.LAUNCHES)}))
"""


def every_family_start():
    """Start (e): ``examples/quantize_every_family_torch.py`` in a child
    process on the card, its launches counted there from 0."""
    return subprocess.Popen(
        [sys.executable, "-c", EVERY_FAMILY_CHILD, os.path.join(HERE, "src"),
         os.path.join(HERE, "examples")], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def every_family_phase(card, proc):
    """(e) The every-family example's child (``every_family_start``):
    TesseraQ within 2% of AWQ's mean recon_mse or below on every family
    (the example's own mark), ``soft_round`` once a leaf and Soften
    step."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.blocks import build_stages, quant_leaf_paths
    from repro_torch.kernels import build
    from repro_torch.models import get_model
    ex = _load_example("quantize_every_family_torch")
    leaves = 0
    for arch in ex.ARCHS:
        cfg = get_reduced_config(arch)
        params = get_model(cfg).init_params(0, "cpu")
        leaves += sum(len(quant_leaf_paths(st.get_block(params, i)))
                      for st in build_stages(cfg) if st.calibrate
                      for i in range(st.n_blocks))
    out, err = proc.communicate(timeout=900)
    line = [ln for ln in out.splitlines()
            if ln.startswith("[every-family-json]")]
    if proc.returncode or not line:
        fail(f"every-family child exited {proc.returncode}:\n{out[-2000:]}"
             f"\n{err[-3000:]}")
    got = json.loads(line[0].split(" ", 1)[1])
    res, counts = got["res"], got["counts"]
    n = leaves * 3 * 12             # the example's K = 3, T = 12
    want = {k: 0 for k in build.KERNELS}
    want.update(soft_round_fwd=n, soft_round_bwd=n)
    print(f"[every-family] {res}; launches {counts}; card=[{card}]",
          flush=True)
    if counts != want:
        fail(f"every-family launch counts {counts}, expected {want}")
    for arch, r in res.items():
        if not r["tesseraq"] <= r["awq"] * 1.02:
            fail(f"every-family {arch}: TesseraQ {r['tesseraq']} vs AWQ "
                 f"{r['awq']}")
    return counts, res


def families_phase(card):
    """Phase 17: (a) RWKV6-3B and (b) Zamba2-1.2B served, (c) PaliGemma-3B
    scheduled, (d) the three calibrated, (e) the every-family example (in
    a child process beside (a)-(d)), each path's launches counted from 0.
    Returns {part: counts} and the numbers."""
    from repro_torch.kernels import build
    out, nums, t = {}, {}, [time.perf_counter()]
    example = every_family_start()
    try:
        for arch in FAMILY_SERVED:
            out[arch], nums[arch] = family_serve_phase(arch, card)
            t.append(time.perf_counter())
        out[VLM_ARCH], nums[VLM_ARCH] = vlm_schedule_phase(card)
        t.append(time.perf_counter())
        cal = {k: 0 for k in build.KERNELS}
        for arch, layers in FAMILY_CAL:
            c, nums[f"{arch} calibrate"] = family_calibrate_phase(
                arch, layers, card)
            cal = {k: cal[k] + c[k] for k in cal}
        out["calibrate"] = cal
        t.append(time.perf_counter())
        out["example"], nums["example"] = every_family_phase(card, example)
        t.append(time.perf_counter())
    finally:
        if example.poll() is None:
            example.kill()
            example.communicate()
    print(f"[time] phase 17: (a) rwkv6 {t[1] - t[0]:.1f}s, (b) zamba2 "
          f"{t[2] - t[1]:.1f}s, (c) paligemma {t[3] - t[2]:.1f}s, (d) "
          f"calibrate {t[4] - t[3]:.1f}s, (e) the example's child (beside "
          f"(a)-(d)) waited for {t[5] - t[4]:.1f}s", flush=True)
    return out, nums


# --------------------------------------------------------------------------
# phase 18: the encoder-decoder (whisper-small)
# --------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-small"
FRAME_STD = 0.1
# 16 requests of 1500 seeded frames each, prompts of 4..32 tokens (every
# decoder projection of an admission takes the GEMV: <= 32 rows), 8..48
# generated, on 8 slots
ENCDEC_WORKLOAD = dict(n_requests=16, seed=0, prompt_lens=(4, 32),
                       budgets=(8, 48), mean_gap=2.0)
ENCDEC_FORCED = 4       # requests teacher-forced against "xla"
ENCDEC_ALONE = (0, 5, 10, 15)
# the teacher-forced check's control depth (encoder and decoder layers),
# read only when the full depth is over REL_L2
ENCDEC_CONTROL_LAYERS = 4
# AWQ + TesseraQ (K=3, T=5; T cut from 10 for the run's time) at
# whisper-small's widths over 4 encoder and 4
# decoder blocks (depth cut from 12 + 12: the whole depth took 46.1 s of
# walk + pack and ~70 s with its AWQ-only walk and perplexities, PERF.md §6,
# PR 27), 8 samples of 1500 frames + 128 tokens
ENCDEC_CAL = (4, 4)
ENCDEC_K, ENCDEC_T = 3, 5
ENCDEC_CAL_SAMPLES, ENCDEC_CAL_TOKENS = 8, 128


def seeded_frames(cfg, n, seed):
    """(n, frontend_len, d_model) stub frame embeddings, N(0, FRAME_STD)
    from ``seed``, in the model's dtype on the card."""
    from repro_torch.models.transformer import model_dtype
    rng = np.random.default_rng(2000 + seed)
    f = rng.normal(size=(n, cfg.frontend_len, cfg.d_model)) * FRAME_STD
    return torch.as_tensor(f, dtype=torch.float32,
                           device="cuda").to(model_dtype(cfg))


def encdec_requests(cfg):
    """``ENCDEC_WORKLOAD`` with each request's frames in ``extras``."""
    import dataclasses
    from repro_torch.launch.scheduler import make_workload
    rng = np.random.default_rng(ENCDEC_WORKLOAD["seed"] + 2)
    return [dataclasses.replace(r, extras={"frames": (rng.normal(
        size=(cfg.frontend_len, cfg.d_model)) * FRAME_STD).astype(
            np.float32)}) for r in make_workload(cfg.vocab_size,
                                                 **ENCDEC_WORKLOAD)]


def encdec_launches(cfg, reqs, steps, attn):
    """Launch counts from the dispatch rules (``kernels/ops.py``): an
    admission's encoder (6 projections a layer) and every decoder layer's
    cross K/V (2) at M = frontend_len take the tiled matmul; the decoder's
    other 8 projections a layer at the prompt's rows take the GEMV at most
    ``DECODE_GEMV_MAX_ROWS`` rows; prefill attention is plain (not causal
    over the frames, no ``kv_len`` in the self-attention).  A decode step:
    8 GEMVs and one self-attention launch a decoder layer (cross-attention
    is the plain Sq == 1 softmax)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import DECODE_GEMV_MAX_ROWS
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    e = {k: 0 for k in build.KERNELS}

    def mm(rows):
        return ("quant_gemv" if rows <= DECODE_GEMV_MAX_ROWS
                else "quant_matmul")

    for r in reqs:
        e[mm(cfg.frontend_len)] += 6 * Le + 2 * Ld
        e[mm(len(r.prompt))] += 8 * Ld
    e["quant_gemv"] += 8 * Ld * steps
    e[attn] += Ld * steps
    return e


def admission_profile(tag, steps, packed, req, max_seq, card, n=5):
    """One admission's prefill (the encoder over 1500 frames, the cross K/V
    of every decoder layer, the prompt) at batch 1 and the full cache
    width: wall ms over ``n`` synchronized runs, then one run under
    ``torch.profiler`` for the device's busy ms and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model = steps.model
    batch = {"tokens": torch.as_tensor(req.prompt[None], dtype=torch.long,
                                       device="cuda"),
             "frames": torch.as_tensor(req.extras["frames"][None],
                                       device="cuda")}
    with torch.no_grad():
        cache = model.init_cache(1, max_seq, device="cuda")
        steps.prefill(packed, batch, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            steps.prefill(packed, batch, cache)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps.prefill(packed, batch, cache)
            torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    print(f"[{tag}] admission prefill ({model.cfg.frontend_len} frames + "
          f"{len(req.prompt)} tokens, batch 1, width {max_seq}): wall "
          f"{wall:.3f} ms; device "
          + (f"busy {busy:.3f} ms ({100 * busy / wall:.1f}% of wall), "
             f"{sum(e.count for e in kern)} launches; top kernels: "
             + "; ".join(f"{e.key[:40]} x{e.count} "
                         f"{e.self_device_time_total / 1e3:.3f}"
                         for e in top) if kern
             else "busy not measured (the profiler saw no device activity)")
          + f"; card=[{card}]", flush=True)
    return {"wall_ms": wall, "busy_ms": busy if kern else None}


def encdec_serve_phase(card):
    """(a) whisper-small whole (12 + 12 layers), RTN W2A16g128 + pack,
    through ``serve_scheduled`` on both stores with ``encdec_requests``:
    exact launches, no host sync inside a decode step, dense tokens ==
    paged tokens, requests alone == scheduled, the first
    ``ENCDEC_FORCED`` requests teacher-forced against "xla" (REL_L2; when
    it fails, the same check at ``ENCDEC_CONTROL_LAYERS`` layers and the
    two paths' W2 weights are read before the phase fails), one profiled
    decode step and one admission prefill.  Returns (counts, numbers)."""
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import (Request, compile_sched_steps,
                                              serve_scheduled)
    tag = f"encdec {ENCDEC_ARCH}"
    cfg, model, packed, _ = build_packed(ENCDEC_ARCH, None, tag)
    reqs = encdec_requests(cfg)
    width = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    max_seq = width + (-width) % SCHED_PSZ
    kw = dict(slots=SCHED_SLOTS, max_seq=max_seq, kernel_backend="pallas",
              page_size=SCHED_PSZ, device="cuda")
    attn = {"dense": "decode_attention", "paged": "paged_decode_attention"}
    steps = {store: compile_sched_steps(
        cfg, max_seq=max_seq, kernel_backend="pallas",
        page_size=SCHED_PSZ if store == "paged" else 0)
        for store in ("dense", "paged")}
    warm = [Request(0, reqs[0].prompt[:8], 3, extras=reqs[0].extras),
            Request(1, reqs[1].prompt[:12], 2, arrival=1,
                    extras=reqs[1].extras)]
    runs, total, syncs = {}, {k: 0 for k in build.KERNELS}, {}
    for store in ("dense", "paged"):
        serve_scheduled(cfg, packed, warm, store=store,
                        compiled=steps[store], **kw)
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res, n, inside, where = sync_counted(
            steps[store], lambda st, store=store: serve_scheduled(
                cfg, packed, reqs, store=store, compiled=st, **kw))
        counts = dict(build.LAUNCHES)
        want = encdec_launches(cfg, reqs, res.steps, attn[store])
        print(f"[{tag}] {store}: {len(reqs)} requests of "
              f"{cfg.frontend_len} frames + {ENCDEC_WORKLOAD['prompt_lens']} "
              f"tokens, {res.steps} decode steps, occupancy "
              f"{res.occupancy:.4f}, prefill {res.prefill_secs:.3f}s, decode "
              f"{res.decode_secs:.3f}s "
              f"({res.decode_secs * 1e3 / max(res.steps, 1):.3f} ms/step, "
              f"{res.decode_tok_s:.2f} useful tok/s); cache "
              f"{res.cache_stats['cache_bytes']} B; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; host syncs "
              f"{n} ({inside} inside decode steps; by line {where}); "
              f"launches {counts}; card=[{card}]", flush=True)
        if counts != want:
            fail(f"{tag} {store}: launches {counts}, expected {want}")
        if inside != 0 or n > 3 * len(reqs) + 4:
            fail(f"{tag} {store}: {n} host syncs ({inside} in decode steps)")
        runs[store], syncs[store] = res, n
        total = {k: total[k] + counts[k] for k in total}
    if not same_tokens(runs["dense"], runs["paged"], reqs):
        fail(f"{tag}: paged tokens differ from dense")
    for rid in ENCDEC_ALONE:
        r = reqs[rid]
        one = serve_scheduled(cfg, packed, [r], store="dense",
                              compiled=steps["dense"], **kw)
        same = np.array_equal(one.requests[rid]["tokens"],
                              runs["dense"].requests[rid]["tokens"])
        print(f"[{tag}] request {rid} (prompt {len(r.prompt)}, budget "
              f"{r.max_new_tokens}) alone at {SCHED_SLOTS} slots equals its "
              f"scheduled tokens: {same}", flush=True)
        if not same:
            fail(f"{tag}: request {rid} alone differs from scheduled")
    forced = serve_scheduled(cfg, packed, reqs[:ENCDEC_FORCED],
                             store="dense", collect_logits=True,
                             compiled=steps["dense"], **kw)
    try:
        rel = extras_forced_check(tag, cfg, model, packed, forced, reqs,
                               max_seq, REL_L2, n=ENCDEC_FORCED)
    except RuntimeError:
        encdec_forced_control(card)
        raise
    prof = decode_profile(steps["dense"], packed, "dense", max_seq, card,
                          tag=f"{tag} profile", pos0=max_seq // 2)
    adm = admission_profile(tag, steps["dense"], packed,
                            reqs[int(np.argmax([len(r.prompt)
                                                for r in reqs]))],
                            max_seq, card)
    out = {"sched_ms": {s: r.decode_secs * 1e3 / max(r.steps, 1)
                        for s, r in runs.items()},
           "rel_l2": rel, "profile": prof, "admission": adm, "syncs": syncs}
    del packed, runs, forced, steps
    _free()
    return total, out


def encdec_forced_control(card):
    """The diagnosis of a failed teacher-forced check: the same check at
    ``ENCDEC_CONTROL_LAYERS`` encoder and decoder layers, and whether the
    "xla" path's bf16 dequantization of the packed W2 weights equals the
    kernels' f32-then-rounded one (then only the summation order
    differs)."""
    from repro_torch.core.qtensor import QTensor
    from repro_torch.launch.scheduler import serve_scheduled
    tag = f"encdec {ENCDEC_ARCH} control"
    cfg, model, packed, _ = build_packed(ENCDEC_ARCH, ENCDEC_CONTROL_LAYERS,
                                         tag)
    reqs = encdec_requests(cfg)
    width = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    max_seq = width + (-width) % SCHED_PSZ
    forced = serve_scheduled(cfg, packed, reqs[:ENCDEC_FORCED],
                             slots=SCHED_SLOTS, max_seq=max_seq,
                             kernel_backend="pallas", device="cuda",
                             collect_logits=True)
    rel = extras_forced_check(tag, cfg, model, packed, forced, reqs, max_seq,
                           float("inf"), n=ENCDEC_FORCED)
    worst = 0.0
    for stack in ("encoder", "decoder"):
        for leaf in (packed[stack]["attn"]["wq"], packed[stack]["w_up"]):
            if not isinstance(leaf, QTensor):
                fail(f"{tag}: {stack} is not packed")
            a = leaf.dequantize(torch.bfloat16).float()
            b = leaf.dequantize(torch.float32).to(torch.bfloat16).float()
            worst = max(worst, float((a - b).abs().max()))
    print(f"[{tag}] {ENCDEC_CONTROL_LAYERS} + {ENCDEC_CONTROL_LAYERS} "
          f"layers: relative L2 {rel:.6g}; bf16 vs f32-rounded W2 "
          f"dequantization max |diff| {worst:.3g}; card=[{card}]",
          flush=True)
    del packed
    _free()


def encdec_calibrate_phase(card):
    """(b) AWQ + TesseraQ (ENCDEC_K, ENCDEC_T) over ``ENCDEC_CAL`` encoder
    and decoder blocks at whisper-small's widths, ``ENCDEC_CAL_SAMPLES``
    samples of 1500 frames + ``ENCDEC_CAL_TOKENS`` tokens: both stages and
    the hand-off of the encoder's stream; the AWQ-only walk beside it
    (every block below its recon_mse); pack; packed perplexity on frames
    batches within ``PPL_REL`` of fake-quant; exact launches (``soft_round``
    once a leaf and Soften step, ``quant_matmul`` in the packed
    perplexity).  Returns the counts and the per-block numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.blocks import build_stages, quant_leaf_paths
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import (DataConfig, calibration_batches,
                                           eval_batches)
    from repro_torch.eval.ppl import perplexity
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model

    tag = f"encdec {ENCDEC_ARCH} calibrate"
    Le, Ld = ENCDEC_CAL
    cfg = get_config(ENCDEC_ARCH).replace(encoder_layers=Le, num_layers=Ld)
    model = get_model(cfg)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    tcfg = TesseraQConfig(par_iterations=ENCDEC_K,
                          steps_per_iteration=ENCDEC_T, batch_size=CAL_BS)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=ENCDEC_CAL_TOKENS,
                    global_batch=CAL_BS, seed=0)

    def with_frames(bs, seed0, cut):
        return [{"tokens": torch.as_tensor(
            b["tokens"][:, :-1] if cut else b["tokens"], device="cuda"),
            "frames": seeded_frames(cfg, len(b["tokens"]), seed0 + i)}
            for i, b in enumerate(bs)]

    calib = with_frames(calibration_batches(
        dc, ENCDEC_CAL_SAMPLES // CAL_BS, CAL_BS), 0, True)
    evalb = with_frames(eval_batches(dc, EVAL_BATCHES, CAL_BS), 100, False)
    params = model.init_params(0, "cuda")
    stages = build_stages(cfg)
    leaves = sum(len(quant_leaf_paths(st.get_block(params, i)))
                 for st in stages for i in range(st.n_blocks))
    t_awq = time.perf_counter()
    _, _, rep_awq = quantize_model(cfg, params, calib, qcfg, method="none",
                                   init="awq", tcfg=tcfg)
    t_awq = time.perf_counter() - t_awq
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="tesseraq", init="awq",
                                        tcfg=tcfg)
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ppl_packed = perplexity(cfg, packed, evalb, backend="pallas")
    ppl_fq = perplexity(cfg, pfq, evalb, backend="pallas")
    counts = dict(build.LAUNCHES)
    want = {k: 0 for k in build.KERNELS}
    want.update({"quant_matmul": (6 * Le + 10 * Ld) * EVAL_BATCHES,
                 "soft_round_fwd": leaves * ENCDEC_K * ENCDEC_T,
                 "soft_round_bwd": leaves * ENCDEC_K * ENCDEC_T})
    blocks = []
    for b, a in zip(report["blocks"], rep_awq["blocks"], strict=True):
        losses = [e["loss"] for e in b["log"]]
        step_ms = b["recon_secs"] * 1e3 / (ENCDEC_K * ENCDEC_T)
        print(f"[{tag}] {b['stage']} {b['block']}: recon_mse "
              f"{b['recon_mse']:.6g} (AWQ {a['recon_mse']:.6g}); PAR loss "
              f"first {losses[0]:.6g} last {losses[-1]:.6g}; {b['secs']:.3f}s "
              f"(reconstruction {b['recon_secs']:.3f}s, {step_ms:.3f} ms per "
              f"Soften step incl. hardens)", flush=True)
        if (b["stage"], b["block"]) != (a["stage"], a["block"]):
            fail(f"{tag}: walks differ in their blocks")
        if not all(np.isfinite(losses)) or not np.isfinite(b["recon_mse"]):
            fail(f"{tag}: non-finite loss in {b['stage']} {b['block']}")
        if not b["recon_mse"] < a["recon_mse"]:
            fail(f"{tag}: {b['stage']} {b['block']} recon_mse "
                 f"{b['recon_mse']} not below AWQ's {a['recon_mse']}")
        blocks.append({"stage": b["stage"], "secs": b["secs"],
                       "step_ms": step_ms, "recon_mse": b["recon_mse"],
                       "awq_mse": a["recon_mse"]})
    if [b["stage"] for b in blocks] != ["encoder"] * Le + ["decoder"] * Ld:
        fail(f"{tag}: the walk's stages {[b['stage'] for b in blocks]}")
    print(f"[{tag}] {cfg.name} {Le} + {Ld} blocks, K={ENCDEC_K} "
          f"T={ENCDEC_T}, {ENCDEC_CAL_SAMPLES} x ({cfg.frontend_len} frames "
          f"+ {ENCDEC_CAL_TOKENS} tokens): walk + pack {t_cal:.3f}s (the "
          f"AWQ-only walk {t_awq:.3f}s), peak "
          f"{peak / 1e9:.3f} GB; perplexity packed {ppl_packed:.6g} "
          f"fake-quant {ppl_fq:.6g}; launches {counts}; card=[{card}]",
          flush=True)
    if counts != want:
        fail(f"{tag} launch counts {counts}, expected {want}")
    if not (np.isfinite(ppl_packed) and np.isfinite(ppl_fq)
            and abs(ppl_packed - ppl_fq) <= PPL_REL * ppl_fq):
        fail(f"{tag}: packed perplexity {ppl_packed} vs fake-quant {ppl_fq}")
    del params, pfq, qmeta, packed
    _free()
    return counts, {"blocks": blocks, "secs": t_cal, "peak_gb": peak / 1e9}


def encdec_parity_phase():
    """(c) The reduced whisper config from the same params on the card and
    on the CPU, each request's prefill (frames + prompt) and decode steps
    teacher-forced on the tokens of the CPU's scheduled run (so a near-tie
    of the random model's argmax cannot move the runs apart):

      * f32, RTN-packed, on the ``"xla"`` steps (the model code: non-causal
        and cross-attention, LayerNorm, the fixed cache leaves): logits
        within ``parity_gate``;
      * bf16, RTN-packed, on the ``"pallas"`` steps (the kernels take bf16
        activations; the CPU runs their plain versions): relative L2 below
        ``REL_L2``, phase 3's rounding-level bound, with the gate read;
      * f32 AWQ + TesseraQ: codes and hardened masks equal.

    Returns the card's launch counts."""
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.eval.harness import parity_gate
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import Request, serve_scheduled
    from repro_torch.launch.serve import parse_quant
    from repro_torch.launch.steps import make_serve_steps

    tag = "encdec-parity"
    cfg16 = get_reduced_config(ENCDEC_ARCH)
    cfg = cfg16.replace(dtype="float32")
    qcfg = parse_quant("W2A16g32", kernel_backend="pallas")
    steps = {"f32": make_serve_steps(cfg, kernel_backend="xla"),
             "bf16": make_serve_steps(cfg16, kernel_backend="pallas")}
    params = {k: st[0].init_params(0, "cpu") for k, st in steps.items()}
    rng = np.random.default_rng(7)

    def frames(n):
        return (rng.normal(size=(n, cfg.frontend_len, cfg.d_model))
                * FRAME_STD).astype(np.float32)

    calib = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 16)),
              "frames": frames(4)} for _ in range(2)]
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, (int(rng.integers(4, 12)),)).astype(np.int32),
        max_new_tokens=6, arrival=i, extras={"frames": frames(1)[0]})
        for i in range(4)]
    tcfg = TesseraQConfig(par_iterations=3, steps_per_iteration=15)
    max_seq = 24

    def forced(kind, packed, dev, toks):
        """Every request's logits, prefill then decode fed ``toks``."""
        model, pre, dec = steps[kind]
        cdt = torch.float32 if kind == "f32" else torch.bfloat16
        out = []
        with torch.no_grad():
            for r in reqs:
                cache = model.init_cache(1, max_seq, cdt, dev)
                lg, cache = pre(packed, {
                    "tokens": torch.as_tensor(r.prompt[None],
                                              dtype=torch.long, device=dev),
                    "frames": torch.as_tensor(r.extras["frames"][None],
                                              device=dev)}, cache)
                rows = [lg]
                pos = torch.tensor([len(r.prompt)], dtype=torch.int32,
                                   device=dev)
                for t in toks[r.rid][:-1]:
                    lg, cache = dec(packed, cache, torch.tensor(
                        [int(t)], dtype=torch.long, device=dev), pos)
                    pos = pos + 1
                    rows.append(lg)
                out.append(torch.cat(rows).float().cpu().numpy())
        return np.concatenate(out)[None]

    out, toks = {}, {}
    for dev in ("cpu", "cuda"):
        build.reset_launch_counts()
        batches = [{"tokens": torch.as_tensor(b["tokens"], device=dev),
                    "frames": torch.as_tensor(b["frames"], device=dev)}
                   for b in calib]
        logits = {}
        for kind, c in (("f32", cfg), ("bf16", cfg16)):
            p = params[kind] if dev == "cpu" else params_to(params[kind],
                                                            dev)
            pfq, qmeta, _ = quantize_model(c, p, batches, qcfg,
                                           method="none", init="rtn")
            packed = pack_model(c, pfq, qmeta, qcfg)
            if kind not in toks:
                res = serve_scheduled(
                    c, packed, reqs, slots=2, max_seq=max_seq,
                    kernel_backend="xla" if kind == "f32" else "pallas",
                    device=dev)
                toks[kind] = {r.rid: res.requests[r.rid]["tokens"]
                              for r in reqs}
            logits[kind] = forced(kind, packed, dev, toks[kind])
        p = params["f32"] if dev == "cpu" else params_to(params["f32"], dev)
        _, tq_meta, _ = quantize_model(cfg, p, batches, qcfg,
                                       method="tesseraq", init="awq",
                                       tcfg=tcfg)
        out[dev] = (logits, tq_meta, dict(build.LAUNCHES))
    (lc, qc, _), (lg, qg, counts) = out["cpu"], out["cuda"]
    gate = {k: parity_gate(lg[k], lc[k], atol=5e-2, rtol=2e-2) for k in lc}
    rel = {k: float(np.linalg.norm(lg[k] - lc[k]) / np.linalg.norm(lc[k]))
           for k in lc}
    agree = {k: float((lg[k].argmax(-1) == lc[k].argmax(-1)).mean())
             for k in lc}
    differ = {"codes": [0, 0], "hard": [0, 0]}
    for key in qc:
        for f in differ:
            a, b = qc[key][f], qg[key][f].cpu()
            differ[f][0] += int((a != b).sum())
            differ[f][1] += a.numel()
    print(f"[{tag}] {cfg.name}, teacher-forced card vs CPU: f32 on xla "
          f"{gate['f32']}, relative L2 {rel['f32']:.3g}, argmax agreement "
          f"{agree['f32']:.4f}; bf16 on pallas relative L2 {rel['bf16']:.3g} "
          f"(bound {REL_L2}), {gate['bf16']}, argmax agreement "
          f"{agree['bf16']:.4f}; f32 TesseraQ (K=3, T=15) codes differ "
          f"{differ['codes'][0]}/{differ['codes'][1]}, hardened masks "
          f"{differ['hard'][0]}/{differ['hard'][1]}; card launches {counts}",
          flush=True)
    if not gate["f32"]["ok"] or not rel["bf16"] < REL_L2:
        fail(f"{tag}: served card and CPU disagree")
    if differ["codes"][0] or differ["hard"][0]:
        fail(f"{tag}: calibration codes or masks differ card vs CPU")
    # at the reduced widths every projection has at most 32 rows (32
    # frames): the GEMV, not the tiled matmul, which (a) and (b) hold
    for k in ("quant_gemv", "decode_attention", "soft_round_fwd",
              "soft_round_bwd"):
        if counts[k] == 0:
            fail(f"{tag}: the card's run launched no {k}")
    return counts


def encdec_phase(card):
    """Phase 18: (a) whisper-small served, (b) calibrated, (c) card vs CPU
    at the reduced config, each path's launches counted from 0.  Returns
    {part: counts} and the numbers."""
    out, nums, t = {}, {}, [time.perf_counter()]
    out["serve"], nums["serve"] = encdec_serve_phase(card)
    t.append(time.perf_counter())
    out["calibrate"], nums["calibrate"] = encdec_calibrate_phase(card)
    t.append(time.perf_counter())
    out["parity"] = encdec_parity_phase()
    t.append(time.perf_counter())
    print(f"[time] phase 18: (a) serve {t[1] - t[0]:.1f}s, (b) calibrate "
          f"{t[2] - t[1]:.1f}s, (c) card vs CPU {t[3] - t[2]:.1f}s",
          flush=True)
    return out, nums


# --------------------------------------------------------------------------
# phase 19: tensor-parallel serving on torch.distributed
# --------------------------------------------------------------------------

TP_DEGREE = 2
# tokens a request of the lock-step runs generates (4 x (128 + 8): cut from
# phase 3's 16 for the run's time, a gloo decode step taking 0.16–0.6 s)
TP_GEN = 8
# (b)'s scheduled dense == paged check at tp = 2, full depth: 4 slots, 3
# seeded requests (prompts 16..64 tokens, budgets 2..8), 16-token pages
# (cut from 8 requests of up to 128 + 16 for the phase's time: a gloo
# decode step of LLaMA-2-7B on one card takes ~230 ms)
TP_WORKLOAD = dict(n_requests=3, seed=0, prompt_lens=(16, 64),
                   budgets=(2, 8), mean_gap=2.0)
TP_SLOTS, TP_PSZ = 4, 16
# (d): the serve CLI on the card with and without --tp 2 over gloo, the
# reduced default arch with FP weights in f32: there the all-reduce's
# reordered sum stays far below a token's margin, so the two must print the
# same tokens (in bf16 a near-tie can flip one; the packed path is (b)'s)
TP_CLI = ("--reduced", "--device", "cuda", "--method", "none", "--dtype",
          "float32")
TP_CLI_TP = ("--tp", str(TP_DEGREE), "--dist-backend", "gloo")
TP_SPAWN_S = 300
# (c)'s teacher-forced bound: the ranks' bf16 all-reduce of wo's partial
# products rounds otherwise than one product does, and a routing near-tie
# then picks another expert (phase 16: Moonlight 0.0482 against "xla" at 4
# layers from such flips); a wrong expert slice reads O(1)
MOE_TP_REL = 0.1
# (c)'s layer check: layer 0's expert-split MoE FFN on the same bf16 input
# as the control's, so routing is the same bytes; what is left is the
# rounding of each rank's bf16 partial sum and of their all-reduce, a few
# bf16 half-ulps (2^-9 each): the card read 0.0028 (prefill rows) and
# 0.0027 (decode rows).  A wrong expert slice reads O(1)
MOE_LAYER_REL = 0.005


def _digest(a):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tree_bytes(tree):
    """Bytes of every tensor of a param tree (a QTensor's fields and a
    PsumWeight's shard included)."""
    from repro_torch.core.qtensor import QTensor
    from repro_torch.models.layers import PsumWeight
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, PsumWeight):
        return _tree_bytes(tree.w)
    if isinstance(tree, QTensor):
        return sum(_tree_bytes(t) for t in (tree.packed, tree.scale,
                                            tree.zero, tree.act_scale))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def moe_layer_outputs(cfg, params, ctx):
    """Layer 0's ``moe_ffn`` of ``params`` under ``ctx`` on N(0, 1) bf16
    hidden states from seed 19, at a prefill's rows (4 x 128) and a decode
    step's (4 x 1): {"prefill", "decode"} as f32 numpy."""
    from repro_torch.models.common import take_layer
    from repro_torch.models.moe import moe_ffn
    rng = np.random.default_rng(19)
    mp = take_layer(params["blocks"], 0)["moe"]
    out = {}
    with torch.no_grad():
        for name, s in (("prefill", 128), ("decode", 1)):
            x = torch.as_tensor(rng.standard_normal((4, s, cfg.d_model)),
                                dtype=torch.float32, device="cuda")
            out[name] = moe_ffn(mp, x.to(torch.bfloat16), cfg,
                                ctx).float().cpu().numpy()
    return out


def _decode_syncs(run, steps):
    """``run(steps')``, ``steps`` = (prefill, decode) with the decode step
    wrapped to count the syncs it makes under
    ``torch.cuda.set_sync_debug_mode("warn")``: (result, syncs inside
    decode steps, decode steps)."""
    import warnings
    pstep, dstep = steps
    n = [0, 0]
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")

        def counted(*a, **k):
            n0 = len(log)
            out = dstep(*a, **k)
            n[0] += sum("synchroniz" in str(w.message) for w in log[n0:])
            n[1] += 1
            return out

        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = run((pstep, counted))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, n[0], n[1]


_SYNC_APIS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpy")


def tp_decode_profile(steps, model, params, prompts):
    """One decode step of the lock-step batch under ``torch.profiler``
    (after a prefill and a warm step): wall (profiler on), device busy,
    kernel launches, the runtime's synchronizing calls by name (the
    closing ``cudaDeviceSynchronize`` left out: the profiler sees the
    calls of every thread, gloo's too) and the host operators that take
    the most time."""
    from torch.profiler import ProfilerActivity, profile
    pstep, dstep = steps
    B, S = prompts.shape
    with torch.no_grad():
        cache = model.init_cache(B, S + 2, device="cuda")
        lg, cache = pstep(params, {"tokens": torch.as_tensor(
            prompts, dtype=torch.long, device="cuda")}, cache)
        tok = torch.argmax(lg, -1)
        pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
        dstep(params, cache, tok, pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dstep(params, cache, tok, pos + 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    syncs = {e.key: e.count for e in events if e.key in _SYNC_APIS}
    syncs["cudaDeviceSynchronize"] = syncs.get("cudaDeviceSynchronize",
                                               1) - 1
    host = sorted((e for e in events if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms": wall * 1e3,
            "busy_ms": sum(e.self_device_time_total for e in events
                           if e.device_type.name == "CUDA") / 1e3,
            "launches": sum(e.count for e in events
                            if e.key == "cudaLaunchKernel"),
            "syncs": {k: v for k, v in syncs.items() if v},
            "host": "; ".join(f"{e.key[:40]} x{e.count} "
                              f"{e.self_cpu_time_total / 1e3:.3f} ms"
                              for e in host[:6])}


def tp_lockstep(cfg, spec, tmp, name, sync_debug):
    """One rank's lock-step serve of its placement ``spec`` (the control's
    4 x (128 + ``TP_GEN``) on "pallas", warm-up first; the control is
    ``tmp/<name>.npz``) through the TP steps: launch counts, the logits'
    digest, the rank's peak device bytes through the serve, with
    ``sync_debug`` the syncs inside decode steps under
    ``set_sync_debug_mode`` (it sees the calling thread's syncs only), the
    steps teacher-forced on the control's tokens (their relative L2
    against the control's logits, and their digest), on more than one rank
    one profiled decode step, and for the MoE the layer check of
    ``moe_layer_outputs`` against the control's."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import compile_serve_steps, serve_requests
    from repro_torch.core.pipeline import quantized_memory_report as report
    from repro_torch.models import get_model
    from repro_torch.models.common import make_ctx
    ctrl = np.load(os.path.join(tmp, f"{name}.npz"))
    prompts = ctrl["prompts"]
    dev = spec.mesh.device
    model = get_model(cfg)
    steps = compile_serve_steps(cfg, kernel_backend="pallas", spec=spec)
    run = lambda c, gen=TP_GEN, **k: serve_requests(
        cfg, model, spec, prompts, gen=gen, kernel_backend="pallas",
        device=dev, compiled=c, **k)
    run(steps, gen=2, collect_logits=False)                      # warm-up
    build.reset_launch_counts()
    if sync_debug:
        res, syncs, n = _decode_syncs(run, steps)
    else:
        res, syncs, n = run(steps), None, TP_GEN - 1
    counts = dict(build.LAUNCHES)
    peak_serve = torch.cuda.max_memory_allocated(dev)
    # one rank is held bit for bit and counts syncs by the debug mode; the
    # teacher-forced reading and the profiler's count are for more
    one = spec.size == 1
    lmodel = spec.cache_model(model)
    forced = (ctrl["logits"] if one else _forced(
        steps, lmodel, spec.params, prompts, ctrl["tokens"][:, :-1]))
    prof = None if one else tp_decode_profile(steps, lmodel, spec.params,
                                              prompts)
    out = {"tokens": res.tokens, "logits": _digest(res.logits),
           "profile": prof,
           "forced": _digest(forced),
           "forced_rel_l2": _rel_l2(forced, ctrl["logits"]),
           "argmax_agree": float((forced.argmax(-1)
                                  == ctrl["tokens"]).mean()),
           "counts": counts, "decode_syncs": syncs, "decode_steps": n,
           "prefill_ms": res.prefill_secs * 1e3,
           "decode_ms": res.decode_secs * 1e3 / (TP_GEN - 1),
           "local_bytes": report(spec.params)["quantized_bytes"],
           "tree_bytes": _tree_bytes(spec.params), "peak_serve": peak_serve,
           "plan": spec.plan, "cache_bytes": res.cache_stats["cache_bytes"]}
    if "layer_prefill" in ctrl:
        got = moe_layer_outputs(spec.local_cfg, spec.params, make_ctx(
            kernel_backend="pallas", ep_inner=spec.ep_inner))
        out["layer_rel_l2"] = {k: _rel_l2(v, ctrl[f"layer_{k}"])
                               for k, v in got.items()}
        out["layer"] = _digest(np.stack([got["prefill"][:, :1],
                                         got["decode"]]))
    return out


def tp_schedule(cfg, spec):
    """One rank's scheduled serve of its placement ``spec``
    (``TP_WORKLOAD``) on the dense and the paged store through the TP
    steps: launch counts exact (the single-device dispatch rules), dense
    tokens == paged."""
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import make_workload, serve_scheduled
    reqs = make_workload(cfg.vocab_size, **TP_WORKLOAD)
    width = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    kw = dict(slots=TP_SLOTS, max_seq=width + (-width) % TP_PSZ,
              kernel_backend="pallas", page_size=TP_PSZ,
              device=spec.mesh.device)
    attn = {"dense": "decode_attention", "paged": "paged_decode_attention"}
    out, runs = {}, {}
    for store in ("dense", "paged"):
        build.reset_launch_counts()
        res = serve_scheduled(cfg, spec, reqs, store=store, **kw)
        counts = dict(build.LAUNCHES)
        want = expected_launches(cfg, prefill_calls(res, reqs), res.steps,
                                 attn[store], "decode_attention")
        if counts != want:
            fail(f"tp-schedule {store} rank {spec.mesh.rank}: launches "
                 f"{counts}, expected {want}")
        runs[store] = res
        out[store] = {"steps": res.steps, "counts": counts,
                      "decode_ms": res.decode_secs * 1e3 / max(res.steps, 1),
                      "prefill_s": res.prefill_secs,
                      "cache_bytes": res.cache_stats["cache_bytes"],
                      "tokens": _digest(np.concatenate(
                          [res.requests[r.rid]["tokens"] for r in reqs]))}
    out["dense_eq_paged"] = same_tokens(runs["dense"], runs["paged"], reqs)
    out["max_seq"] = kw["max_seq"]
    return out


def allreduce_ms(group, shape, device, n=20):
    """Mean wall ms of one ``dist.all_reduce`` of a bf16 ``shape`` tensor
    on ``device`` over ``group``, each waited for (a decode step's and a
    prefill's in-split output: what gloo stages through the host)."""
    import torch.distributed as dist
    x = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    for _ in range(3):
        dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        dist.all_reduce(x, group=group)
        if x.is_cuda:
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def tp_rank(tp, tmp, cfgs, schedule):
    """One rank of phase 19 on the card: its ``tp``-way mesh, then for each
    packed tree in ``cfgs`` (``{name: cfg}``) its placement — the global
    tree read into host memory (``mmap``), the rank's shards cut there and
    only they moved to the card (``ServeSpec.place``), once — the
    lock-step serve of it, and with ``schedule`` the scheduled pair on
    LLaMA-2-7B; the device bytes the rank holds after placement and at
    its peak."""
    from repro_torch.core.pipeline import quantized_memory_report as report
    from repro_torch.launch.mesh import serve_mesh
    from repro_torch.launch.sharding import ServeSpec
    t_entry = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = serve_mesh(tp, device="cuda")
    out = {"rank": mesh.rank, "shape": mesh.shape,
           "backend": torch.distributed.get_backend(mesh.group),
           "t_entry": t_entry, "t_mesh": time.time()}
    for name, cfg in cfgs.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        before = torch.cuda.memory_allocated(mesh.device)
        host = torch.load(os.path.join(tmp, f"{name}.pt"), map_location="cpu",
                          mmap=True, weights_only=False)
        spec = ServeSpec.place(mesh, cfg, host)
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated(mesh.device) - before
        glob = {"global_bytes": report(host)["quantized_bytes"],
                "global_tree_bytes": _tree_bytes(host)}
        del host
        load_s = time.perf_counter() - t0
        out[name] = tp_lockstep(cfg, spec, tmp, name,
                                sync_debug=out["backend"] == "nccl")
        out[name].update(glob, load_s=load_s, placed_bytes=placed)
        if schedule and name == "llama":
            out["schedule"] = tp_schedule(cfg, spec)
            out["schedule"]["s"] = time.perf_counter() - t0
        out[name]["peak"] = torch.cuda.max_memory_allocated(mesh.device) \
            - before
        out[name]["s"] = time.perf_counter() - t0
        del spec
        _free()
    out["allreduce_ms"] = {
        f"{where} {'x'.join(map(str, shape))}": allreduce_ms(
            mesh.group, shape, where)
        for shape in ((4, 4096), (512, 4096))
        for where in (("cuda", "cpu") if out["backend"] == "gloo"
                      else ("cuda",))}
    out["t_end"] = time.time()
    return out


def _rank_times(t_spawn, r):
    """Wall s from the spawn to the rank's entry, of its mesh (the process
    group's first collective and ``dist.new_group``), and of its work."""
    return (f"spawn {r['t_entry'] - t_spawn:.1f} s, mesh "
            f"{r['t_mesh'] - r['t_entry']:.1f} s, work "
            f"{r['t_end'] - r['t_mesh']:.1f} s")


def _sum_counts(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def _cli_requests(text):
    return [ln.strip() for ln in text.splitlines() if ln.startswith("  req")]


def tp_serve_phase(card):
    """Phase 19: serve-time tensor parallelism (``launch.sharding.
    ServeSpec``) on the card.  No-mesh controls first: LLaMA-2-7B at full
    width and depth and Qwen3-30B-A3B at ``MOE_LAYERS`` of 48, RTN
    W2A16g128 + pack, served 4 x (128 + ``TP_GEN``) on "pallas" with exact
    launches and the device bytes the serve holds (the tree and its peak
    above it); for the MoE, layer 0's FFN on seeded inputs.  Each packed
    tree goes to the ranks in a temporary file, deleted with its
    directory; a rank reads it into host memory and moves only its own
    placement to the card.  (a) One NCCL rank: tokens and logits
    bit-identical to the control, its launches, no sync inside a decode
    step.  (b) Two gloo ranks sharing the card: each rank's launches equal
    to the control's, both ranks' tokens and logits identical,
    teacher-forced on the control's tokens within ``REL_L2`` of its
    logits, per-rank packed bytes, the device bytes each rank holds after
    placement (its own tree) and at its peak through the serve (below the
    control's), a profiled decode step (the syncs gloo makes counted by
    the profiler, not gated); LLaMA-2-7B scheduled (``TP_WORKLOAD``) on
    the dense and the paged store: equal tokens, exact launches.  (c)
    Qwen3's expert split at tp = 2 (64 experts a rank) in (b)'s ranks: the
    same checks, teacher-forced within ``MOE_TP_REL``, and layer 0's
    expert-split FFN within ``MOE_LAYER_REL`` of the control's on the same
    input.  (d) The serve CLI (``TP_CLI``) with and without ``--tp 2
    --dist-backend gloo`` as subprocesses beside (a): the same tokens.
    Returns the launch counts by part."""
    import tempfile
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import serve_requests
    from repro_torch.core.pipeline import quantized_memory_report
    from repro_torch.models.common import make_ctx
    times = {}
    t0 = time.perf_counter()
    cfgs, ctrl, trees = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="tp_serve_") as tmp:
        for name, arch, layers in (("llama", "llama2-7b", None),
                                   ("moe", MOE_ARCH, MOE_LAYERS)):
            cfg, model, packed, prompts = build_packed(arch, layers,
                                                       f"tp-{name}")
            _free()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kw = dict(kernel_backend="pallas", device="cuda")
            serve_requests(cfg, model, packed, prompts, gen=2,
                           collect_logits=False, **kw)           # warm-up
            build.reset_launch_counts()
            res = serve_requests(cfg, model, packed, prompts, gen=TP_GEN,
                                 **kw)
            counts = dict(build.LAUNCHES)
            held = (torch.cuda.max_memory_allocated() - resident
                    + _tree_bytes(packed))
            want = expected_launches(cfg, [(prompts.size, prompts.shape[1])],
                                     TP_GEN - 1, "decode_attention",
                                     "decode_attention")
            if counts != want:
                fail(f"tp control launches {counts}, expected {want}")
            layer = ({f"layer_{k}": v for k, v in moe_layer_outputs(
                cfg, packed, make_ctx(kernel_backend="pallas")).items()}
                if name == "moe" else {})
            np.savez(os.path.join(tmp, f"{name}.npz"), prompts=prompts,
                     tokens=res.tokens, logits=res.logits, **layer)
            cfgs[name], trees[name] = cfg, packed
            ctrl[name] = {"counts": counts, "tokens": res.tokens,
                          "logits": _digest(res.logits),
                          "bytes": quantized_memory_report(packed)[
                              "quantized_bytes"],
                          "tree_bytes": _tree_bytes(packed), "held": held,
                          "decode_ms": res.decode_secs * 1e3 / (TP_GEN - 1),
                          "prefill_ms": res.prefill_secs * 1e3}
            print(f"[tp-serve] control {cfg.name} L={cfg.num_layers}, no "
                  f"mesh: prefill {res.prefill_secs * 1e3:.3f} ms, decode "
                  f"{ctrl[name]['decode_ms']:.3f} ms/step, packed "
                  f"{ctrl[name]['bytes']} B (tree {ctrl[name]['tree_bytes']}"
                  f" B), device bytes the serve holds at its peak {held} B, "
                  f"launches {counts}; card=[{card}]", flush=True)
            del model, packed
        times["controls"] = time.perf_counter() - t0

        # (d) runs beside the hand-over of the packed trees, and (a) and
        # (b)+(c) beside each other: their readings are identity, launches,
        # syncs and bytes; their times are each rank's own
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        clis = {k: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *TP_CLI,
             *extra], cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for k, extra in (("tp", TP_CLI_TP), ("one", ()))}
        try:
            for name in list(trees):
                torch.save(trees.pop(name), os.path.join(tmp, f"{name}.pt"))
            _free()
            times["save"] = time.perf_counter() - t0
            t_spawn = time.time()
            ranks = {}

            def gloo_ranks():
                ranks["two"] = run_ranks(
                    tp_rank, TP_DEGREE, backend="gloo", device="cuda",
                    args=(TP_DEGREE, tmp, cfgs, True), timeout=TP_SPAWN_S)
                times["b+c"] = time.perf_counter() - t0
            gloo = threading.Thread(target=gloo_ranks)
            gloo.start()
            try:
                (one,) = run_ranks(tp_rank, 1, backend="nccl", device="cuda",
                                   args=(1, tmp, {"llama": cfgs["llama"]},
                                         False), timeout=TP_SPAWN_S)
                times["a"] = time.perf_counter() - t0
                cli = {k: (p.communicate(timeout=TP_SPAWN_S), p.returncode)
                       for k, p in clis.items()}
                times["d"] = time.perf_counter() - t0
            finally:
                gloo.join()
        finally:
            for p in clis.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if "two" not in ranks:
            fail("tp (b)+(c): the spawn of the gloo ranks failed (its "
                 "traceback above)")
        two = ranks["two"]
        r = one["llama"]
        print(f"[tp-serve] (a) one {one['backend']} rank, mesh "
              f"{one['shape']}: prefill {r['prefill_ms']:.3f} ms, decode "
              f"{r['decode_ms']:.3f} ms/step (sync debug mode on, the CLIs "
              f"of (d) and the ranks of (b) running beside), syncs inside "
              f"decode steps "
              f"{r['decode_syncs']} over {r['decode_steps']}, launches "
              f"{r['counts']}, logits {r['logits']} (control "
              f"{ctrl['llama']['logits']}), device bytes placed "
              f"{r['placed_bytes']}, peak {r['peak']}, load "
              f"{r['load_s']:.3f} s, {_rank_times(t_spawn, one)}; "
              f"card=[{card}]", flush=True)
        print(f"[tp-serve] (a) one all-reduce (bf16, ms): "
              f"{one['allreduce_ms']}", flush=True)
        if r["counts"] != ctrl["llama"]["counts"]:
            fail(f"tp (a) launches {r['counts']}, the control's "
                 f"{ctrl['llama']['counts']}")
        if not (np.array_equal(r["tokens"], ctrl["llama"]["tokens"])
                and r["logits"] == ctrl["llama"]["logits"]):
            fail("tp (a): one NCCL rank is not bit-identical to the no-mesh "
                 "run")
        if r["decode_syncs"]:
            fail(f"tp (a): {r['decode_syncs']} syncs inside decode steps")
    limit = {"llama": REL_L2, "moe": MOE_TP_REL}
    for name, tag in (("llama", "(b)"), ("moe", "(c)")):
        for r in two:
            x = r[name]
            print(f"[tp-serve] {tag} {cfgs[name].name} rank {r['rank']} of "
                  f"{TP_DEGREE} over {r['backend']} on one card: plan "
                  f"{x['plan']}, packed {x['local_bytes']} of "
                  f"{x['global_bytes']} B, tree {x['tree_bytes']} of "
                  f"{x['global_tree_bytes']} B, kv cache {x['cache_bytes']} "
                  f"B; device bytes placed {x['placed_bytes']}, peak through "
                  f"the serve {x['peak_serve']} (the control's "
                  f"{ctrl[name]['held']}), peak {x['peak']}; prefill "
                  f"{x['prefill_ms']:.3f} ms, decode "
                  f"{x['decode_ms']:.3f} ms/step (no mesh "
                  f"{ctrl[name]['decode_ms']:.3f}); teacher-forced rel. L2 "
                  f"{x['forced_rel_l2']:.6g} "
                  f"(gate {limit[name]}), argmax agreement "
                  f"{x['argmax_agree']:.4f}; launches {x['counts']}; load "
                  f"{x['load_s']:.1f} s, {x['s']:.1f} s; card=[{card}]",
                  flush=True)
            print(f"[tp-serve] {tag} rank {r['rank']} profiled decode step: "
                  f"{x['profile']}", flush=True)
            if x["counts"] != ctrl[name]["counts"]:
                fail(f"tp {tag} rank {r['rank']}: launches {x['counts']}, "
                     f"the control's {ctrl[name]['counts']}")
            if not x["forced_rel_l2"] < limit[name]:
                fail(f"tp {tag} rank {r['rank']}: teacher-forced rel. L2 "
                     f"{x['forced_rel_l2']}, gate {limit[name]}")
            # the rank's card holds its own tree, never the global one
            if not x["placed_bytes"] < x["global_tree_bytes"] \
                    or not x["placed_bytes"] <= x["tree_bytes"] * 1.01:
                fail(f"tp {tag} rank {r['rank']}: {x['placed_bytes']} B on "
                     f"the card after placement, its tree {x['tree_bytes']}"
                     f" B of {x['global_tree_bytes']}")
            if name == "llama" and not x["peak_serve"] < ctrl[name]["held"]:
                fail(f"tp (b) rank {r['rank']}: peak {x['peak_serve']} B "
                     f"through the serve, the control's {ctrl[name]['held']}")
            if name == "moe":
                print(f"[tp-serve] (c) rank {r['rank']} layer 0's "
                      f"expert-split FFN on the control's input: rel. L2 "
                      f"{x['layer_rel_l2']} (gate {MOE_LAYER_REL})",
                      flush=True)
                if not max(x["layer_rel_l2"].values()) < MOE_LAYER_REL:
                    fail(f"tp (c) rank {r['rank']}: layer rel. L2 "
                         f"{x['layer_rel_l2']}, gate {MOE_LAYER_REL}")
        a, b = two[0][name], two[1][name]
        if not (np.array_equal(a["tokens"], b["tokens"])
                and a["logits"] == b["logits"]
                and a["forced"] == b["forced"]
                and a.get("layer") == b.get("layer")):
            fail(f"tp {tag}: the two ranks' tokens or logits differ")
        if name == "llama" and not set(a["plan"]) >= {"wq", "wo", "w_down"}:
            fail(f"tp (b): plan {a['plan']} does not split attention and FFN")
        if name == "moe" and a["plan"].get("w_gate") != "expert":
            fail(f"tp (c): plan {a['plan']} does not split the experts")
    for r in two:
        x = r["schedule"]
        print(f"[tp-serve] (b) scheduled rank {r['rank']}: "
              + "; ".join(f"{st} {x[st]['steps']} steps "
                          f"{x[st]['decode_ms']:.3f} ms/step, prefill "
                          f"{x[st]['prefill_s']:.3f} s, kv cache "
                          f"{x[st]['cache_bytes']} B, launches "
                          f"{x[st]['counts']}" for st in ("dense", "paged"))
              + f"; max_seq {x['max_seq']}, dense == paged "
              f"{x['dense_eq_paged']}, {x['s']:.1f} s", flush=True)
        if not x["dense_eq_paged"]:
            fail(f"tp (b) rank {r['rank']}: paged tokens differ from dense")
    for r in two:
        print(f"[tp-serve] (b) rank {r['rank']} one all-reduce over gloo "
              f"(bf16, ms): {r['allreduce_ms']}; {_rank_times(t_spawn, r)}; "
              f"card=[{card}]", flush=True)
    if two[0]["schedule"]["dense"]["tokens"] != \
            two[1]["schedule"]["dense"]["tokens"]:
        fail("tp (b): the ranks' scheduled tokens differ")

    reqs = {k: _cli_requests(out) for k, ((out, _), _) in cli.items()}
    for k, extra in (("tp", TP_CLI_TP), ("one", ())):
        (out, err), rc = cli[k]
        print(f"[tp-serve] (d) serve CLI {' '.join(TP_CLI + extra)}: rc "
              f"{rc}, {len(reqs[k])} requests printed, {times['d']:.1f} s "
              f"beside (a): "
              + " | ".join(ln for ln in out.splitlines()
                           if ln.startswith("[serve]"))
              + " | " + " | ".join(reqs[k]), flush=True)
        if rc or len(reqs[k]) != 4:
            fail(f"tp (d): the CLI failed (rc {rc}):\n{out[-2000:]}\n"
                 f"{err[-3000:]}")
    if "tp=2 over gloo" not in cli["tp"][0][0]:
        fail("tp (d): the --tp CLI did not serve over two gloo ranks")
    if reqs["tp"] != reqs["one"]:
        fail("tp (d): the CLI's tokens with --tp differ from without")
    print(f"[time] phase 19: controls {times['controls']:.1f}s, hand-over "
          f"{times['save']:.1f}s then (a) until {times['a']:.1f}s, (d) "
          f"{times['d']:.1f}s and (b)+(c) {times['b+c']:.1f}s side by side",
          flush=True)
    return {"nccl rank": one["llama"]["counts"],
            **{f"gloo rank {r['rank']}": _sum_counts(
                r["llama"]["counts"], r["moe"]["counts"],
                r["schedule"]["dense"]["counts"],
                r["schedule"]["paged"]["counts"]) for r in two}}


# --------------------------------------------------------------------------
# phase 20: the mesh-sharded reconstruction engine on torch.distributed
# --------------------------------------------------------------------------

SHARD_K, SHARD_T = 2, 1         # T cut from 5, then 2, for the run's time
# (d)'s walk; (a)-(c) calibrate its block 0 (phase 5's data: 32 x 512
# tokens, bs 4, so C = 4 canonical chunks)
SHARD_LAYERS = 2
SHARD_SPAWN_S = 900


def _moved(tree, device):
    """The tensors of a tree of dicts and lists on ``device``; other leaves
    (AWQ's choices, None) as they are."""
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moved(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def shard_digest(qmeta):
    """{linear: {codes, hard, scale: digest}} of a qmeta."""
    return {".".join(map(str, p)): {
        k: _digest(m[k].detach().cpu().numpy())
        for k in ("codes", "hard", "scale") if m.get(k) is not None}
        for p, m in qmeta.items()}


class ShardMeter:
    """What phase 20 reads around the engine in one process: every
    ``torch.distributed.broadcast`` (the engine's gathers and chain hops)
    counted, sized (bytes out of its source times its receivers) and timed
    to the end of its device copy, split into those made inside
    ``ReconstructionEngine.run`` (the Soften steps) and outside it
    (hardening, the log and the final gathers); the wall time of the runs;
    and the syncs ``torch.cuda.set_sync_debug_mode("warn")`` reports inside
    them (gloo syncs on its own thread, which the mode does not see)."""

    def __init__(self):
        import torch.distributed as dist
        from repro_torch.core import recon_engine as RE
        self.dist, self.RE = dist, RE
        self.inside = False
        self.reset()
        self._bcast, self._run = dist.broadcast, RE.ReconstructionEngine.run
        meter = self

        def broadcast(tensor, src, group=None, **kw):
            t0 = time.perf_counter()
            out = meter._bcast(tensor, src, group=group, **kw)
            if tensor.is_cuda:
                torch.cuda.synchronize()
            where = meter.run_x if meter.inside else meter.other_x
            where["n"] += 1
            where["ms"] += (time.perf_counter() - t0) * 1e3
            where["bytes"] += (tensor.numel() * tensor.element_size()
                               * (dist.get_world_size(group) - 1))
            return out

        def run(eng, *a, **k):
            n0 = len(meter.warnings)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meter.inside = True
            try:
                out = meter._run(eng, *a, **k)
                torch.cuda.synchronize()
            finally:
                meter.inside = False
            meter.run_ms += (time.perf_counter() - t0) * 1e3
            meter.step_syncs += sum("synchroniz" in str(w.message)
                                    for w in meter.warnings[n0:])
            return out

        dist.broadcast, RE.ReconstructionEngine.run = broadcast, run

    def reset(self):
        self.run_x = {"n": 0, "ms": 0.0, "bytes": 0}
        self.other_x = {"n": 0, "ms": 0.0, "bytes": 0}
        self.run_ms, self.step_syncs, self.warnings = 0.0, 0, []

    def close(self):
        self.dist.broadcast = self._bcast
        self.RE.ReconstructionEngine.run = self._run


def shard_run(meter, call):
    """``call()`` (a calibration on the engine under ``meter``) with the
    launch counts, host reads, syncs inside the steps, peak device bytes
    above what was allocated before, and the meter's readings per Soften
    step; returns (call's result, record)."""
    import warnings
    from repro_torch.core import recon_engine as RE
    from repro_torch.kernels import build
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    build.reset_launch_counts()
    RE.reset_sync_count()
    meter.reset()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        meter.warnings = log
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    steps = SHARD_K * SHARD_T
    return res, {
        "counts": dict(build.LAUNCHES), "host_reads": RE.sync_count(),
        "step_syncs": meter.step_syncs, "s": time.perf_counter() - t0,
        "peak": torch.cuda.max_memory_allocated() - before,
        "step_ms": meter.run_ms / steps,
        "exchange_ms": meter.run_x["ms"] / steps,
        "exchange_bytes": meter.run_x["bytes"] / steps,
        "broadcasts": meter.run_x["n"] / steps, "other": dict(meter.other_x)}


def shard_block(meter, data, qcfg, engine, mesh):
    """Block 0 of ``data`` (its bp and AWQ meta on the card, X and Y where
    ``data`` holds them) calibrated with TesseraQ (K = ``SHARD_K``, T =
    ``SHARD_T``, bs ``CAL_BS``, logged) on ``engine``: the record of
    ``shard_run`` with the digests, the log's losses and soft rates and
    its ``state_bytes``."""
    from repro_torch.core import tesseraq as tq
    from repro_torch.core.blocks import build_stages
    stage = build_stages(data["cfg"])[0]
    tcfg = tq.TesseraQConfig(par_iterations=SHARD_K,
                             steps_per_iteration=SHARD_T, batch_size=CAL_BS,
                             engine=engine, mesh=mesh)
    log = []
    (_, qm), rec = shard_run(meter, lambda: tq.reconstruct_block(
        stage.apply, data["bp"], data["X"], data["Y"], None, data["meta"],
        qcfg, tcfg, log=log))
    rec.update(digest=shard_digest(qm), state_bytes=log[-1]["state_bytes"],
               log=[(e["loss"], e["soft_rate"]) for e in log])
    return rec


def shard_warm(data, qcfg):
    """One device-engine step on block 0 over its first ``CAL_BS``
    samples, moved to the card (K = 1, T = 1, nothing kept), so a
    process's first Soften steps (cuBLAS's and the kernels' first calls)
    are not timed."""
    from repro_torch.core import tesseraq as tq
    from repro_torch.core.blocks import build_stages
    X, Y = (data[k][:CAL_BS].to("cuda") for k in ("X", "Y"))
    tq.reconstruct_block(
        build_stages(data["cfg"])[0].apply, data["bp"], X, Y, None,
        data["meta"], qcfg, tq.TesseraQConfig(
            par_iterations=1, steps_per_iteration=1, batch_size=CAL_BS))
    torch.cuda.synchronize()


def shard_walk(meter, data, qcfg, engine, mesh, blocks=SHARD_LAYERS):
    """``quantize_model`` (AWQ + TesseraQ, K = ``SHARD_K``, T =
    ``SHARD_T``) over ``data``'s ``SHARD_LAYERS`` blocks on ``engine``;
    ``blocks``: how many of them this process reconstructs (the per-step
    readings are averaged over them)."""
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.tesseraq import TesseraQConfig
    tcfg = TesseraQConfig(par_iterations=SHARD_K, steps_per_iteration=SHARD_T,
                          batch_size=CAL_BS, engine=engine, mesh=mesh)
    (_, qm, rep), rec = shard_run(meter, lambda: quantize_model(
        data["cfg"], data["params"], data["calib"], qcfg, method="tesseraq",
        init="awq", tcfg=tcfg))
    for k in ("step_ms", "exchange_ms", "exchange_bytes", "broadcasts"):
        rec[k] /= blocks
    rec.update(digest=shard_digest(qm),
               mse=[b["recon_mse"] for b in rep["blocks"]],
               pipeline=rep.get("pipeline"))
    return rec


def pod_walk(meter, data, qcfg):
    """(e): ``quantize_model(engine="sharded")`` on ``make_mesh((2, 1,
    1))``, two pods of one rank each (pod p owns block p), with every
    cross-pod hop of FP targets timed to the end of its device copy and
    sized (its tensors' bytes, on the side that sends or receives)."""
    import torch.distributed as dist
    from repro_torch.core import pipeline
    from repro_torch.launch.mesh import make_mesh
    hop = pipeline.reshard_between_pods
    hops = []

    def timed(x, dst_mesh, spec=None, *, src_mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hop(x, dst_mesh, spec, src_mesh=src_mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        side = x if dist.get_rank() == src_mesh.ranks[0] else out
        if side is not None:
            hops.append({"from": src_mesh.ranks, "to": dst_mesh.ranks,
                         "ms": ms, "bytes": sum(t.numel() * t.element_size()
                                                for t in side)})
        return out
    pipeline.reshard_between_pods = timed
    try:
        rec = shard_walk(meter, data, qcfg, "sharded",
                         make_mesh((2, 1, 1), device="cuda"),
                         blocks=SHARD_LAYERS // 2)
    finally:
        pipeline.reshard_between_pods = hop
    rec["hops"] = hops
    return rec


def shard_rank(tmp, shapes, walk):
    """One rank of phase 20: the handed-over model and block read into
    host memory, the block's weights and AWQ meta (and for ``walk`` the
    params and tokens) moved to the card, X and Y left on the host (the
    engine stages the rank's pool shard alone); block 0 calibrated on the
    sharded engine on each mesh of ``shapes``, and with ``walk`` the
    two-block walk on the ``(2,)`` data mesh, then on ``(2, 1, 1)``: two
    pods, one block each (``pod_walk``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import parse_quant
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = torch.load(os.path.join(tmp, "shard.pt"), map_location="cpu",
                      mmap=True, weights_only=False)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    data = {"cfg": host["cfg"], "X": host["X"], "Y": host["Y"],
            "bp": _moved(host["bp"], "cuda"),
            "meta": _moved(host["meta"], "cuda")}
    meter = ShardMeter()
    out = {"rank": torch.distributed.get_rank(),
           "backend": torch.distributed.get_backend()}
    shard_warm(data, qcfg)
    try:
        for shape in shapes:
            mesh = make_mesh(shape, device="cuda")
            out[shape] = shard_block(meter, data, qcfg, "sharded", mesh)
            out[shape]["coords"] = (mesh.data_rank, mesh.model_rank)
        if walk:
            data.update(params=_moved(host["params"], "cuda"),
                        calib=_moved(host["calib"], "cuda"))
            del data["bp"], data["meta"]
            out["walk"] = shard_walk(meter, data, qcfg, "sharded",
                                     make_mesh((2,), device="cuda"))
            out["pod"] = pod_walk(meter, data, qcfg)
    finally:
        meter.close()
    return out


def _shard_line(tag, rec, control, card):
    sb = rec["state_bytes"] if "state_bytes" in rec else None
    return (f"[shard] {tag}: {rec['step_ms']:.3f} ms a Soften step "
            f"(control {control['step_ms']:.3f}), exchange "
            f"{rec['exchange_ms']:.3f} ms and {rec['exchange_bytes']:.0f} B "
            f"a step in {rec['broadcasts']:.1f} broadcasts, outside the "
            f"steps {rec['other']}; syncs inside the steps the debug mode "
            f"sees {rec['step_syncs']}, host reads {rec['host_reads']}; "
            + (f"state bytes kept between steps {sb} (control "
               f"{control['state_bytes']}); " if sb else "")
            + f"peak {rec['peak']} B (control {control['peak']}); launches "
            f"{rec['counts']}; {rec['s']:.1f} s; card=[{card}]")


def shard_phase(card):
    """Phase 20: the mesh-sharded reconstruction engine (``engine=
    "sharded"``) on the card.  LLaMA-2-7B at full width and
    ``SHARD_LAYERS`` layers, W2A16g128, phase 5's 32 x 512 calibration
    tokens at bs ``CAL_BS`` (C = 4 canonical chunks), AWQ + TesseraQ at K =
    ``SHARD_K``, T = ``SHARD_T``.  Controls in this process on the device
    engine: block 0 from its AWQ initialization, and the walk over both
    blocks.  The model and block 0's streams, weights and meta go to the
    ranks in a temporary file.  (a) One NCCL rank on the ``(1,)`` and ``(1,
    1)`` meshes: the control's hardened masks, codes and folded scales bit
    for bit, no sync inside a step, its soft_round launches.  (b) Two gloo
    ranks sharing the card on ``(2,)``, (c) the same ranks on ``(1, 2)``
    (TP = 2: ν, v, Adam's moments and the frozen state held half a rank):
    the same equality and launches; each with its ms a Soften step, its
    exchange ms and bytes a step, the bytes it keeps between steps and its
    peak beside the control's.  (d) The same ranks:
    ``quantize_model(engine="sharded")`` over both blocks at DP 2, its
    codes, masks and scales the device walk's.  (e) The same ranks as two
    pods of one rank (``(2, 1, 1)``: the pod-pipelined walk, block 0 on
    pod 0, block 1 on pod 1, block 0's FP targets hopping to pod 1 before
    block 0 reconstructs): the device walk's codes, masks and scales,
    each rank the control's soft_round launches for its one block,
    ``report["pipeline"]`` (pods, per-block pods, block 1's wait
    measured), the efficiency, the walk's wall and each hop's ms and
    bytes.  Returns the launch counts by part."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.awq import quantize_block_awq
    from repro_torch.core.blocks import build_stages
    from repro_torch.core.capture import (capture_block_inputs,
                                          split_minibatches)
    from repro_torch.data.pipeline import DataConfig, calibration_batches
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model
    times = {}
    t0 = time.perf_counter()
    cfg = get_config("llama2-7b").replace(num_layers=SHARD_LAYERS)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    params = get_model(cfg).init_params(0, "cuda")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=CAL_SEQ,
                    global_batch=CAL_BS, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(dc, CAL_SAMPLES // CAL_BS, CAL_BS)]
    stage = build_stages(cfg)[0]
    with torch.no_grad():
        X = torch.cat([stage.init_x(params, b) for b in calib], 0)
        bp = stage.get_block(params, 0)
        parts = split_minibatches(X)
        Y = torch.cat([stage.apply(bp, x) for x in parts], 0)
        _, meta = quantize_block_awq(bp, capture_block_inputs(
            stage.apply, bp, parts), qcfg)
    data = {"cfg": cfg, "bp": bp, "meta": meta, "X": X, "Y": Y,
            "params": params, "calib": calib}
    shard_warm(data, qcfg)
    meter = ShardMeter()
    try:
        ctrl = shard_block(meter, data, qcfg, "device", None)
        ctrl_walk = shard_walk(meter, data, qcfg, "device", None)
    finally:
        meter.close()
    times["controls"] = time.perf_counter() - t0
    print(_shard_line(f"control {cfg.name} block 0 of {SHARD_LAYERS}, "
                      f"device engine, {CAL_SAMPLES} x {CAL_SEQ} tokens, bs "
                      f"{CAL_BS}, K={SHARD_K} T={SHARD_T}", ctrl, ctrl, card),
          flush=True)
    print(f"[shard] control walk over {SHARD_LAYERS} blocks: "
          f"{ctrl_walk['step_ms']:.3f} ms a Soften step, recon_mse "
          f"{ctrl_walk['mse']}, peak {ctrl_walk['peak']} B, launches "
          f"{ctrl_walk['counts']}, {ctrl_walk['s']:.1f} s", flush=True)
    steps = SHARD_K * SHARD_T
    want = {"soft_round_fwd": 7 * steps, "soft_round_bwd": 7 * steps}
    if {k: ctrl["counts"][k] for k in want} != want:
        fail(f"shard control launches {ctrl['counts']}, expected {want}")
    if ctrl["step_syncs"] or ctrl["host_reads"] != SHARD_K:
        fail(f"shard control: {ctrl['step_syncs']} syncs inside steps, "
             f"{ctrl['host_reads']} host reads for {SHARD_K} iterations")

    with tempfile.TemporaryDirectory(prefix="shard_") as tmp:
        t0 = time.perf_counter()
        torch.save(_moved({"cfg": cfg, "bp": bp, "meta": meta, "X": X,
                           "Y": Y, "params": params, "calib": calib}, "cpu"),
                   os.path.join(tmp, "shard.pt"))
        del data, params, calib, X, Y, bp, meta, parts
        _free()
        times["save"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        (one,) = run_ranks(shard_rank, 1, backend="nccl", device="cuda",
                           args=(tmp, [(1,), (1, 1)], False),
                           timeout=SHARD_SPAWN_S)
        times["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = run_ranks(shard_rank, 2, backend="gloo", device="cuda",
                        args=(tmp, [(2,), (1, 2)], True),
                        timeout=SHARD_SPAWN_S)
        times["b-e"] = time.perf_counter() - t0

    checks = [("(a)", one, (1,)), ("(a)", one, (1, 1))] + [
        (tag, r, shape) for tag, shape in (("(b)", (2,)), ("(c)", (1, 2)))
        for r in two]
    for tag, r, shape in checks:
        rec = r[shape]
        print(_shard_line(f"{tag} {r['backend']} rank {r['rank']} on "
                          f"{shape} (data, model) {rec['coords']}", rec, ctrl,
                          card), flush=True)
        if rec["digest"] != ctrl["digest"]:
            bad = sorted(p for p in ctrl["digest"]
                         if rec["digest"][p] != ctrl["digest"][p])
            fail(f"shard {tag} rank {r['rank']} on {shape}: masks, codes or "
                 f"scales differ from the device engine's at {bad}")
        if rec["counts"] != ctrl["counts"]:
            fail(f"shard {tag} rank {r['rank']} on {shape}: launches "
                 f"{rec['counts']}, the control's {ctrl['counts']}")
        if rec["log"] != ctrl["log"] or rec["host_reads"] != SHARD_K:
            fail(f"shard {tag} rank {r['rank']} on {shape}: log {rec['log']}"
                 f" ({rec['host_reads']} host reads), the control's "
                 f"{ctrl['log']}")
        if tag == "(a)" and rec["step_syncs"]:
            fail(f"shard (a) on {shape}: {rec['step_syncs']} syncs inside "
                 "the steps")
        if tag == "(c)" and not all(
                rec["state_bytes"][k] < ctrl["state_bytes"][k]
                for k in ("trainable", "moments", "frozen", "block")):
            fail(f"shard (c) rank {r['rank']}: state bytes "
                 f"{rec['state_bytes']}, the control's "
                 f"{ctrl['state_bytes']}")
    for r in two:
        w = r["walk"]
        print(f"[shard] (d) gloo rank {r['rank']} quantize_model(engine="
              f"\"sharded\") over {SHARD_LAYERS} blocks at DP 2: "
              f"{w['step_ms']:.3f} ms a Soften step (control "
              f"{ctrl_walk['step_ms']:.3f}), exchange {w['exchange_ms']:.3f}"
              f" ms and {w['exchange_bytes']:.0f} B a step; recon_mse "
              f"{w['mse']} (control {ctrl_walk['mse']}); peak {w['peak']} B "
              f"(control {ctrl_walk['peak']}); launches {w['counts']}; "
              f"{w['s']:.1f} s; card=[{card}]", flush=True)
        if w["digest"] != ctrl_walk["digest"] or w["mse"] != ctrl_walk["mse"]:
            bad = sorted(p for p in ctrl_walk["digest"]
                         if w["digest"].get(p) != ctrl_walk["digest"][p])
            fail(f"shard (d) rank {r['rank']}: the walk differs from the "
                 f"device walk at {bad}")
        if w["counts"] != ctrl_walk["counts"]:
            fail(f"shard (d) rank {r['rank']}: launches {w['counts']}, the "
                 f"device walk's {ctrl_walk['counts']}")
    for r in two:
        w = r["pod"]
        pl = w["pipeline"]
        blocks = [(b["pod"], b["recon_secs"], b["capture_wait_secs"],
                   b["fill_secs"]) for b in pl["blocks"]]
        print(f"[shard] (e) gloo rank {r['rank']} quantize_model(engine="
              f"\"sharded\") on (2, 1, 1), two pods of one rank: wall "
              f"{w['s']:.1f} s (device walk {ctrl_walk['s']:.1f} s, (d) "
              f"{r['walk']['s']:.1f} s); pipeline pods {pl['pods']} dp "
              f"{pl['dp']} tp {pl['tp']}, blocks (pod, recon s, wait s, "
              f"fill s) {blocks}, recon {pl['recon_secs']:.3f} s, wait "
              f"{pl['capture_wait_secs']}, fill {pl['fill_secs']:.3f} s, "
              f"efficiency {pl['efficiency']}; hops {w['hops']}; "
              f"{w['step_ms']:.3f} ms a Soften step on its block; "
              f"broadcasts outside the steps {w['other']}; recon_mse "
              f"{w['mse']}; peak {w['peak']} B; launches {w['counts']}; "
              f"card=[{card}]", flush=True)
        if w["digest"] != ctrl_walk["digest"] or w["mse"] != ctrl_walk["mse"]:
            bad = sorted(p for p in ctrl_walk["digest"]
                         if w["digest"].get(p) != ctrl_walk["digest"][p])
            fail(f"shard (e) rank {r['rank']}: the pod walk differs from "
                 f"the device walk at {bad}")
        owned = sum(b["pod"] == r["rank"] for b in pl["blocks"])
        for k in ("soft_round_fwd", "soft_round_bwd"):
            want_k = ctrl_walk["counts"][k] * owned // SHARD_LAYERS
            if w["counts"][k] != want_k:
                fail(f"shard (e) rank {r['rank']}: {k} launched "
                     f"{w['counts'][k]} times, the control's {want_k} for "
                     f"its {owned} block(s)")
        if pl["pods"] != 2 or [b["pod"] for b in pl["blocks"]] != [0, 1] \
                or pl["blocks"][1]["capture_wait_secs"] is None:
            fail(f"shard (e) rank {r['rank']}: report['pipeline'] {pl}")
        if not w["hops"]:
            fail(f"shard (e) rank {r['rank']}: no cross-pod hop")
    print(f"[time] phase 20: controls {times['controls']:.1f}s, hand-over "
          f"{times['save']:.1f}s, (a) {times['a']:.1f}s, (b)-(e) "
          f"{times['b-e']:.1f}s (the (e) walk "
          f"{max(r['pod']['s'] for r in two):.1f}s)", flush=True)
    return {"control": _sum_counts(ctrl["counts"], ctrl_walk["counts"]),
            "nccl rank": _sum_counts(one[(1,)]["counts"],
                                     one[(1, 1)]["counts"]),
            **{f"gloo rank {r['rank']}": _sum_counts(
                r[(2,)]["counts"], r[(1, 2)]["counts"], r["walk"]["counts"],
                r["pod"]["counts"])
               for r in two}}



MESH_ARCH = MOE_ARCH            # Qwen3-30B-A3B at full width
MESH_DENSE = BIG_ARCH           # TinyLlama-1.1B at full width
MESH_LAYERS = 2                 # depth cut from 48 and 22
MESH_BATCH, MESH_SEQ, MESH_STEPS, MESH_LR = 4, 128, 3, 1e-3
MESH_REL = 2e-2                 # bf16 losses / grad norms, mesh vs control
MESH_PPL_REL = 1e-2             # packed perplexity, (1, 2) vs no mesh
# Qwen3's bf16 grad norm after the first step moves ~2.6% under any change
# of a rounding in layer 0: the control's twin (the same function, its
# attention over KV chunks of MESH_NOISE_CHUNK) does (PERF.md §6).  The
# split is one such change too, so (b)'s grad norm at each step is held
# within MESH_NOISE_X times the twin's distance there where that exceeds
# MESH_REL; its losses within MESH_REL; and in f32 (b32) every step within
# MESH_F32_REL
MESH_NOISE_CHUNK = 64           # the bf16 control's numerically equal twin
MESH_NOISE_X = 2.0              # (b)'s grad-norm bound over the twin's
MESH_F32_REL = 1e-3             # f32 losses / grad norms, (1, 2) vs control
MESH_F32_LAYERS = 1             # the f32 run's depth (its control peaks ~45 GB)
MESH_SPAWN_S = 600
# (f) the four other families at full width on (1, 2) with seq_parallel,
# each at a cut depth (PaliGemma 2 of 18, RWKV6 2 of 32, Zamba2 6 of 38:
# one shared site, whisper 2 + 2 of 12 + 12), MESH_F_STEPS steps of
# MESH_BATCH x (MESH_SEQ + 1) tokens (PaliGemma's after 256 seeded
# patches, whisper's beside 1500 seeded frames) against each one's no-mesh
# bf16 control: losses within MESH_REL, grad norms within MESH_REL or
# MESH_NOISE_X times the farthest of the control's twins at that step, as
# (b)'s.  The recurrent families' twins (PERF.md §6): the scan over chunks
# of MESH_NOISE_CHUNK (a reordering of f32 sums), and Zamba2's Mamba
# out_proj product as the sum of its two halves over the inner width,
# each rounded to bf16 first (the same sum, split where (1, 2) splits it:
# each later Mamba layer reads that rounding).  MESH_F32 trains in f32 at
# the same depth beside its f32 control, within MESH_F32_REL
MESH_FAMILIES = (("paligemma-3b", 2), ("rwkv6-3b", 2), ("zamba2-1.2b", 6),
                 ("whisper-small", 2))
MESH_F_STEPS = 2
MESH_F32 = "zamba2-1.2b"
# (c'') TinyLlama on (1, 2) with seq_parallel and the reference's
# --attn-seq-parallel remap: each rank's attention runs its half of the
# query rows with all 32 heads against every rank's k / v (one all-gather
# a layer forward, one reduce-scatter back), MESH_F_STEPS steps against
# (c)'s control, bounded as (b) is by the control's own twin
MESH_QUERY_SPLIT = {"seq": ("model",)}
_ATTN = {"wq": "out", "wk": "out", "wv": "out", "wo": "in"}
_FFN = {"w_gate": "out", "w_up": "out", "w_down": "in"}
_VOCAB = {"embed": "vocab", "head": "vocab"}
# what each keeps split over model, and the leaves on model it gathers
# whole by broadcasts (PaliGemma's attention: one KV head; RWKV6's cr);
# whisper's 51865-token vocab does not divide by 2
MESH_F_PLANS = {
    "paligemma-3b": ({**_FFN, **_VOCAB}, 4),
    "rwkv6-3b": ({"wr": "out", "wk": "out", "wv": "out", "wg": "out",
                  "wo": "in", "ck": "out", "cv": "in", **_VOCAB}, 1),
    "zamba2-1.2b": ({**_ATTN, **_FFN, "out_proj": "in", **_VOCAB}, 0),
    "whisper-small": ({**_ATTN, "w_up": "out", "w_down": "in"}, 0),
}


def _leaf_bytes(tree):
    from repro_torch.checkpoint.manager import flatten
    return int(sum(t.numel() * t.element_size() for t in flatten(tree)))


def card_digest(tree):
    """Per leaf of ``tree``, (sum, index-weighted sum) of its bytes read
    as int32 words, in int64 on the card; one read to the host.  Two
    processes compare params by it (CUDA IPC is refused where
    ``expandable_segments`` is on)."""
    from repro_torch.checkpoint.manager import flatten
    out = []
    for t in flatten(tree):
        w = t.detach().contiguous().view(-1).view(torch.uint8)
        if w.numel() % 4:
            w = torch.cat([w, w.new_zeros((-w.numel()) % 4)])
        w = w.view(torch.int32).to(torch.int64)
        idx = torch.arange(w.numel(), device=w.device) % 1000003 + 1
        out.append(torch.stack([w.sum(), (w * idx).sum()]))
        del w, idx
    return torch.stack(out).cpu().tolist()


def mesh_batches(cfg, n):
    """``n`` batches of MESH_BATCH x (MESH_SEQ + 1) tokens of the synthetic
    corpus, on the card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=MESH_SEQ,
                                      global_batch=MESH_BATCH, seed=0))
    return [{"tokens": torch.as_tensor(data.batch(s)["tokens"],
                                       device="cuda")} for s in range(n)]


def mesh_reckon(cfg, shape):
    """Bytes reckoned from the shapes alone: params (in the model's dtype),
    gradients (the same) and Adam's two f32 moments, whole; and what a rank
    of ``shape`` keeps between steps (its slices of params and moments)."""
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import param_shardings, replicas
    from repro_torch.launch.steps import param_struct
    st = param_struct(cfg)
    n = sum(t.numel() for t in flatten(st))
    item = flatten(st)[0].element_size()
    mesh = Mesh(world=int(np.prod(shape)), rank=0, shape=shape, group=None,
                device=torch.device("cpu"))
    sh = param_shardings(mesh, st, cfg)
    local = sum(t.numel() * replicas(s) // mesh.world
                for t, s in zip(flatten(st), flatten(sh)))
    return {"params": n, "whole_bytes": n * (2 * item + 8),
            "rank_bytes": local * (item + 8),
            "control_kept_bytes": n * (item + 8)}


class MeshMeter:
    """Every ``dist.broadcast`` (the gathers of whole leaves),
    ``dist.all_reduce`` (the regions' sums, the data-group mean, the norm,
    the expert sums), ``dist.all_gather`` and ``dist.reduce_scatter`` (the
    residual rows under ``seq_parallel``) a rank makes, counted, sized (the
    whole tensor: a gather's result, a reduce-scatter's input) and timed
    to the end of its device copy; the syncs this adds are outside phase
    21 (a), which makes no collective."""
    KINDS = {"gather": "broadcast", "all_reduce": "all_reduce",
             "all_gather": "all_gather", "reduce_scatter": "reduce_scatter"}

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist
        self.real = {k: getattr(dist, op) for k, op in self.KINDS.items()}
        self.reset()
        meter = self

        def size(t):
            if isinstance(t, (list, tuple)):
                return sum(size(x) for x in t)
            return t.numel() * t.element_size()

        def timed(kind, real):
            def call(tensor, *a, **k):
                t0 = time.perf_counter()
                out = real(tensor, *a, **k)
                torch.cuda.synchronize()
                rec = meter.x[kind]
                rec["n"] += 1
                rec["ms"] += (time.perf_counter() - t0) * 1e3
                nbytes = size(a[0] if kind == "reduce_scatter" else tensor)
                rec["bytes"] += nbytes
                part = tensor[0] if isinstance(tensor, (list, tuple)) \
                    else tensor
                by = meter.by_shape.setdefault(
                    (kind, tuple(part.shape)), {"n": 0, "bytes": 0})
                by["n"] += 1
                by["bytes"] += nbytes
                return out
            return call
        for kind, op in self.KINDS.items():
            setattr(dist, op, timed(kind, self.real[kind]))

    def reset(self):
        self.x = {k: {"n": 0, "ms": 0.0, "bytes": 0} for k in self.KINDS}
        # (kind, the shape of a rank's part) -> calls and bytes
        self.by_shape = {}

    def close(self):
        for kind, op in self.KINDS.items():
            setattr(self.dist, op, self.real[kind])


def mesh_train(cfg, params, batches, mesh, steps, sync_debug=False,
               meter=None, seq_parallel=False, attn_chunk=512,
               extra_overrides=None):
    """``steps`` steps of the train harness (lr MESH_LR, ``seq_parallel``,
    ``extra_overrides``) on ``mesh`` (None: the control) from ``params``
    (whole); returns
    (params, opt state, the harness, record): (loss, grad_norm) a step, ms
    a step after the first, the bytes kept between steps, the peak above
    what was allocated before, the leaves the step keeps split over
    ``model``, and per step the exchange of ``meter`` and the syncs the
    debug mode reports inside the last step."""
    import warnings
    from repro_torch.launch.sharding import shard_tree
    from repro_torch.launch.steps import make_train_harness
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    h = make_train_harness(cfg, mesh, lr=MESH_LR, seq_parallel=seq_parallel,
                           attn_chunk=attn_chunk,
                           extra_overrides=extra_overrides)
    p = params if mesh is None else shard_tree(params, h.param_sharding)
    o = h.init_opt(p)
    kept = _leaf_bytes(p) + _leaf_bytes(o)
    rec = {"metrics": [], "ms": [], "syncs": 0, "plan": dict(h.plan)}
    for s in range(steps):
        if meter is not None and s == 1:
            meter.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as log:
            warnings.simplefilter("always")
            last = sync_debug and s == steps - 1
            if last:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                p, o, m = h.step_fn(p, o, batches[s % len(batches)])
            finally:
                if last:
                    torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        if last:
            # "called a synchronizing CUDA operation": the mode's own
            # one-time notice that it is a prototype does not count
            sites = [f"{os.path.basename(w.filename)}:{w.lineno}"
                     for w in log
                     if "called a synchronizing" in str(w.message)]
            rec["syncs"], rec["sync_sites"] = len(sites), sites
        rec["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    rec.update(kept=kept, peak=torch.cuda.max_memory_allocated() - before,
               step_ms=float(np.mean(rec["ms"][1:])))
    if meter is not None:
        rec["exchange"] = {k: {f: v / max(steps - 1, 1) for f, v in r.items()}
                           for k, r in meter.x.items()}
        rec["by_shape"] = {k: {f: v / max(steps - 1, 1) for f, v in r.items()}
                           for k, r in meter.by_shape.items()}
    return p, o, h, rec


def mesh_rank_a(cfg, batches, want_digest, want_metrics):
    """Phase 21 (a): one NCCL rank on ``(1,)`` and ``(1, 1)``, from the
    control's initial params (seed 0 on the card, as the control's); each
    run's params bit-equal to the control's by :func:`card_digest`."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import unshard_tree
    from repro_torch.models import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    params = get_model(cfg).init_params(0, "cuda")
    batches = [{k: v.to("cuda") for k, v in b.items()} for b in batches]
    out = {"rank": torch.distributed.get_rank(),
           "backend": torch.distributed.get_backend()}
    for shape in ((1,), (1, 1)):
        mesh = make_mesh(shape, device="cuda")
        p, o, h, rec = mesh_train(cfg, params, batches, mesh, MESH_STEPS,
                                  sync_debug=True)
        del o
        rec["params_equal"] = card_digest(
            unshard_tree(p, h.param_sharding)) == want_digest
        rec["metrics_equal"] = rec["metrics"] == want_metrics
        out[shape] = rec
        del p
        _free()
    return out


def mesh_family(arch, layers):
    """``arch`` at its widths and ``layers`` layers (an encoder-decoder's
    encoder cut alike)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    kw = {"encoder_layers": layers} if cfg.family == "encdec" else {}
    return cfg.replace(num_layers=layers, **kw)


class _OutProjHalves:
    """``repro_torch.models.layers`` for ``ssm`` in the hybrid's twin: the
    product with Mamba's ``out_proj`` (``di`` rows) is the sum of its two
    halves over ``di``, each rounded to the operands' dtype first."""

    def __init__(self, di):
        self.di = di

    def __getattr__(self, name):
        from repro_torch.models import layers
        return getattr(layers, name)

    def matmul(self, x, w, backend=None):
        from repro_torch.models import layers
        if w.shape[0] != self.di:
            return layers.matmul(x, w, backend)
        n = self.di // 2
        return (layers.matmul(x[..., :n], w[:n], backend)
                + layers.matmul(x[..., n:], w[n:], backend))


def mesh_family_twins(cfg):
    """A recurrent family's control twins, ``{tag: (cfg, context)}``, the
    same function each (none for the other families): its scan over chunks
    of ``MESH_NOISE_CHUNK``, and the hybrid's under a context in which
    Mamba's ``out_proj`` product is summed from two halves."""
    import dataclasses
    from unittest import mock
    from repro_torch.models import ssm
    if cfg.family not in ("rwkv", "hybrid"):
        return {}
    scan = cfg.replace(ssm=dataclasses.replace(cfg.ssm,
                                               chunk_size=MESH_NOISE_CHUNK))
    twins = {f"scan over chunks of {MESH_NOISE_CHUNK}":
             (scan, contextlib.nullcontext())}
    if cfg.family == "hybrid":
        twins["out_proj summed from two halves"] = (cfg, mock.patch.object(
            ssm, "L", _OutProjHalves(ssm._dims(cfg)[0])))
    return twins


def mesh_family_batches(cfg):
    """``MESH_F_STEPS`` batches of :func:`mesh_batches`' tokens, with
    seeded patches or frames where the family reads them, on the card."""
    out = mesh_batches(cfg, MESH_F_STEPS)
    for s, b in enumerate(out):
        if cfg.family == "vlm":
            b["patches"] = seeded_patches(cfg, MESH_BATCH, s)
        if cfg.family == "encdec":
            b["frames"] = seeded_frames(cfg, MESH_BATCH, s)
    return out


def mesh_rank_b(cfg, batches, dcfg, dbatches, ckpt, eval_batch, cfg32,
                fams):
    """Phase 21 (b)-(f) on one of two gloo ranks sharing the card: (b)
    Qwen3 on ``(1, 2)``, its work split over ``model``; (d) its trained
    params gathered, RTN-packed, sliced and the packed perplexity on ``(1,
    2)`` and without a mesh, with the launches of each; (c) TinyLlama on
    ``(2, 1)``, (e) saved there after its steps; (c') TinyLlama on ``(1,
    2)`` with ``seq_parallel``; (b32) Qwen3 in f32 at ``MESH_F32_LAYERS``
    on ``(1, 2)``; (f) each ``(tag, cfg, batches)`` of ``fams`` on ``(1,
    2)`` with ``seq_parallel``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.eval.ppl import perplexity
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import parse_quant
    from repro_torch.launch.sharding import (param_shardings, shard_tree,
                                             unshard_tree)
    from repro_torch.models.common import make_ctx
    from repro_torch.models import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = lambda bs: [{k: v.to("cuda") for k, v in b.items()}  # noqa
                          for b in bs]
    batches, dbatches = on_card(batches), on_card(dbatches)
    eval_batch = on_card([eval_batch])[0]
    out = {"rank": torch.distributed.get_rank(),
           "backend": torch.distributed.get_backend()}
    meter = MeshMeter()
    try:
        mesh = make_mesh((1, 2), device="cuda")
        params = get_model(cfg).init_params(0, "cuda")
        out["b_coords"] = (mesh.data_rank, mesh.model_rank)
        t0 = time.perf_counter()
        p, o, h, out["b"] = mesh_train(cfg, params, batches, mesh,
                                       MESH_STEPS, meter=meter)
        del o, params
        out["b"]["s"] = time.perf_counter() - t0
        # (d) the trained params, packed, on (1, 2) and without a mesh
        t0 = time.perf_counter()
        whole = unshard_tree(p, h.param_sharding)
        del p
        _free()
        qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
        calib = [{"tokens": b["tokens"][:1, :-1]} for b in batches[:2]]
        pfq, qmeta, _ = quantize_model(cfg, whole, calib, qcfg,
                                       method="none", init="rtn")
        packed = pack_model(cfg, pfq, qmeta, qcfg)
        del whole, pfq, qmeta
        _free()
        qspec = param_shardings(mesh, packed, cfg)
        local = shard_tree(packed, qspec)
        d = {"pack_s": time.perf_counter() - t0}
        for tag, tree, ctx, kw in (
                ("mesh", local, make_ctx(cfg, mesh=mesh,
                                         kernel_backend="pallas"),
                 {"shardings": qspec}),
                ("none", packed, make_ctx(cfg, kernel_backend="pallas"),
                 {})):
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            ppl = perplexity(cfg, tree, [eval_batch], ctx, **kw)
            torch.cuda.synchronize()
            d[tag] = {"ppl": ppl, "counts": dict(build.LAUNCHES),
                      "s": time.perf_counter() - t0}
        d["ep_axis"] = make_ctx(cfg, mesh=mesh).ep_axis
        d["local_experts"] = int(local["blocks"]["moe"]["w_gate"]
                                 .packed.shape[-3])
        out["d"] = d
        del local, packed
        _free()
        # (c) and (e): TinyLlama on (2, 1), saved after its steps
        mesh = make_mesh((2, 1), device="cuda")
        out["c_coords"] = (mesh.data_rank, mesh.model_rank)
        dparams = get_model(dcfg).init_params(0, "cuda")
        t0 = time.perf_counter()
        p, o, h, out["c"] = mesh_train(dcfg, dparams, dbatches, mesh,
                                       MESH_STEPS, meter=meter)
        out["c"]["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        CheckpointManager(ckpt).save(
            MESH_STEPS, {"params": p, "opt": o},
            shardings={"params": h.param_sharding, "opt": h.opt_sharding})
        out["e_save_s"] = time.perf_counter() - t0
        del p, o
        _free()
        # (c') TinyLlama on (1, 2), the residual rows split too
        mesh = make_mesh((1, 2), device="cuda")
        out["c_seq_coords"] = (mesh.data_rank, mesh.model_rank)
        t0 = time.perf_counter()
        p, o, h, out["c_seq"] = mesh_train(dcfg, dparams, dbatches, mesh,
                                           MESH_STEPS, meter=meter,
                                           seq_parallel=True)
        out["c_seq"]["s"] = time.perf_counter() - t0
        del p, o
        _free()
        # (c'') the same with the attention split by its query rows: a
        # rank's q rows and heads read where the attention runs
        from repro_torch.models import layers
        real, seen = layers.flash_attention, set()

        def attn(q, *a, **k):
            seen.add(tuple(q.shape[1:3]))
            return real(q, *a, **k)
        layers.flash_attention = attn
        try:
            t0 = time.perf_counter()
            p, o, h, out["c_q"] = mesh_train(
                dcfg, dparams, dbatches, mesh, MESH_F_STEPS, meter=meter,
                seq_parallel=True, extra_overrides=MESH_QUERY_SPLIT)
            out["c_q"]["s"] = time.perf_counter() - t0
        finally:
            layers.flash_attention = real
        out["c_q"]["q_rows_heads"] = sorted(seen)
        del p, o, dparams
        _free()
        # (b32) Qwen3 in f32 on (1, 2)
        t0 = time.perf_counter()
        p, o, h, out["b32"] = mesh_train(
            cfg32, get_model(cfg32).init_params(0, "cuda"), batches, mesh,
            MESH_STEPS, meter=meter)
        out["b32"]["s"] = time.perf_counter() - t0
        out["b32_coords"] = out["c_seq_coords"]
        del p, o
        _free()
        # (f) the other families on (1, 2), the residual rows split too
        out["f"] = {}
        for tag, fcfg, fb in fams:
            t0 = time.perf_counter()
            p, o, h, rec = mesh_train(
                fcfg, get_model(fcfg).init_params(0, "cuda"), on_card(fb),
                mesh, MESH_F_STEPS, meter=meter, seq_parallel=True)
            rec["s"] = time.perf_counter() - t0
            out["f"][tag] = rec
            del p, o, h
            _free()
    finally:
        meter.close()
    return out


def _mesh_line(tag, rec, ctrl, card):
    x = rec.get("exchange", {})
    ex = "; ".join(f"{k} {v['ms']:.1f} ms in {v['n']:.0f} calls, "
                   f"{v['bytes'] / 1e9:.3f} GB" for k, v in x.items())
    return (f"[mesh-train] {tag}: losses/grad_norms {rec['metrics']} "
            f"(control {ctrl['metrics']}); {rec['step_ms']:.1f} ms a step "
            f"(control {ctrl['step_ms']:.1f}); exchange a step: "
            f"{ex or 'none'}; kept between steps {rec['kept'] / 1e9:.3f} GB "
            f"(control {ctrl['kept'] / 1e9:.3f}); peak "
            f"{rec['peak'] / 1e9:.3f} GB (control {ctrl['peak'] / 1e9:.3f});"
            f" syncs in the last step {rec['syncs']} "
            f"{rec.get('sync_sites', [])}; card=[{card}]")


def _rel(got, want):
    """Each step's (loss, grad_norm) distance from ``want``, relative."""
    return [tuple(float(f"{abs(g - w) / abs(w):.3g}") for g, w in zip(gs, ws))
            for gs, ws in zip(got, want)]


def _within(got, want, bounds):
    """Each step's (loss, grad_norm) within its relative ``bounds`` (one
    (loss, grad_norm) pair a step) of ``want``'s."""
    assert len(got) == len(want) == len(bounds)
    return all(abs(g - w) <= r * abs(w)
               for gs, ws, rs in zip(got, want, bounds)
               for g, w, r in zip(gs, ws, rs))


def mesh_train_phase(card):
    """Phase 21: training on a mesh (``make_train_harness(cfg, mesh)``).
    Qwen3-30B-A3B at full width and ``MESH_LAYERS`` of 48, bf16 params, f32
    Adam, 4 x 129 synthetic tokens, ``MESH_STEPS`` steps at lr 1e-3; the
    no-mesh harness in this process is the control, beside its twin (the
    same function, attention over KV chunks of ``MESH_NOISE_CHUNK``: its
    distance from the control is the bf16 comparison's noise floor) and an
    f32 control at ``MESH_F32_LAYERS``.  (a) One NCCL rank on
    ``(1,)`` and ``(1, 1)``: losses, grad norms and params bit-identical to
    the control, no sync in a step.  (b) Two gloo ranks sharing the card
    on ``(1, 2)`` (64 experts a rank): each step's loss within
    ``MESH_REL`` of the control's and its grad norm within ``MESH_REL`` or
    ``MESH_NOISE_X`` times the twin's distance at that step, whichever is
    larger, the bytes a rank keeps, its peak and its exchange ms a step;
    the step splits its work over ``model``
    (its heads, 64 experts and vocab slice a rank: no leaf broadcast);
    (b32) the same in f32 at ``MESH_F32_LAYERS`` layers, every step within
    ``MESH_F32_REL`` of the f32 control.  (c)
    TinyLlama-1.1B at full width and ``MESH_LAYERS`` of 22 on ``(2, 1)``
    (DP with FSDP slices) in the same ranks, the same checks against its
    own control; (c') the same on ``(1, 2)`` with ``seq_parallel`` (heads,
    FFN columns and vocab split, the residual rows too: all-gathers and
    reduce-scatters, no broadcast); (c'') the same with the reference's
    ``--attn-seq-parallel`` remap (``MESH_QUERY_SPLIT``), ``MESH_F_STEPS``
    steps: the attention of a rank runs its ``MESH_SEQ / 2`` query rows
    with all 32 heads, each layer all-gathers its rows' k / v once a
    forward and reduce-scatters their gradient once, at the bytes the
    shapes give; its metrics within (b)'s bounds over TinyLlama's own
    twin, its ms a step and peak beside (c')'s.  (d) Qwen3's trained
    params from (b) gathered, RTN W2A16g128-packed and sliced by
    ``param_shardings``: the packed perplexity of 4 x 128 tokens on ``(1,
    2)`` through the kernels within ``MESH_PPL_REL`` of the no-mesh one,
    the expert kernel and kernel 1 launched the counts the config gives on
    each rank, beside the no-mesh run's.  (e) TinyLlama saved from ``(2,
    1)`` (whole leaves), restored without a mesh here, one more step:
    within ``MESH_REL`` of the control's next step.  (f) PaliGemma-3B,
    RWKV6-3B, Zamba2-1.2B and whisper-small at full width and the depths
    of ``MESH_FAMILIES`` on ``(1, 2)`` with ``seq_parallel`` in the same
    ranks, ``MESH_F_STEPS`` steps each: every loss within ``MESH_REL`` of
    its no-mesh control here and every grad norm within ``MESH_REL`` or
    ``MESH_NOISE_X`` times the farthest of its twins'
    (:func:`mesh_family_twins`) distance at that step; ``MESH_F32`` in f32
    within ``MESH_F32_REL`` of its f32 control; the split of
    ``MESH_F_PLANS`` (the leaves gathered whole by design broadcast, no
    leaf of the plan), rows reduce-scattered, less kept than the
    control.  Returns the launch
    counts by part."""
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.steps import make_train_harness
    from repro_torch.models import get_model
    times = {}
    t0 = time.perf_counter()
    cfg = get_config(MESH_ARCH).replace(num_layers=MESH_LAYERS)
    cfg32 = get_config(MESH_ARCH).replace(num_layers=MESH_F32_LAYERS,
                                          dtype="float32")
    dcfg = get_config(MESH_DENSE).replace(num_layers=MESH_LAYERS)
    fcfgs = {a: mesh_family(a, n) for a, n in MESH_FAMILIES}
    for c, shape in ((cfg, (1, 2)), (dcfg, (2, 1)), (dcfg, (1, 2)),
                     *((c, (1, 2)) for c in fcfgs.values())):
        r = mesh_reckon(c, shape)
        print(f"[mesh-train] {c.name} L={c.num_layers}: {r['params']} params;"
              f" params + grads + Adam moments whole "
              f"{r['whole_bytes'] / 1e9:.3f} GB; kept between steps: the "
              f"control {r['control_kept_bytes'] / 1e9:.3f} GB, a rank of "
              f"{shape} {r['rank_bytes'] / 1e9:.3f} GB (from the shapes)",
              flush=True)
    batches = mesh_batches(cfg, MESH_STEPS)
    dbatches = mesh_batches(dcfg, MESH_STEPS + 1)
    build.reset_launch_counts()
    cp, co, _, ctrl = mesh_train(cfg, get_model(cfg).init_params(0, "cuda"),
                                 batches, None, MESH_STEPS, sync_debug=True)
    del co
    ctrl_digest = card_digest(cp)
    del cp
    _free()
    # the bf16 control's twin: the same function, attention summed over
    # smaller KV chunks (its steps' distance from the control is the noise
    # floor of a bf16 comparison)
    _, _, _, twin = mesh_train(cfg, get_model(cfg).init_params(0, "cuda"),
                               batches, None, MESH_STEPS,
                               attn_chunk=MESH_NOISE_CHUNK)
    _free()
    _, _, _, ctrl32 = mesh_train(
        cfg32, get_model(cfg32).init_params(0, "cuda"), batches, None,
        MESH_STEPS)
    _free()
    dp, do, dh, dctrl = mesh_train(dcfg, get_model(dcfg).init_params(
        0, "cuda"), dbatches, None, MESH_STEPS + 1)
    del dp, do
    ctrl_counts = dict(build.LAUNCHES)
    _free()
    # TinyLlama's control twin, the noise floor of (c'')'s bound
    _, _, _, dtwin = mesh_train(dcfg, get_model(dcfg).init_params(
        0, "cuda"), dbatches, None, MESH_F_STEPS,
        attn_chunk=MESH_NOISE_CHUNK)
    _free()
    # (f)'s controls, keyed as the ranks' runs: each family's bf16 one,
    # its twins, and MESH_F32's f32 one
    fcfgs[f"{MESH_F32} f32"] = fcfgs[MESH_F32].replace(dtype="float32")
    fbatches, fctrl, ftwin = {}, {}, {}
    for a, c in fcfgs.items():
        fbatches[a] = mesh_family_batches(c)
        runs = {None: (c, contextlib.nullcontext())}
        if c.dtype != "float32":
            runs.update(mesh_family_twins(c))
        for tag, (fc, context) in runs.items():
            with context:
                _, _, _, rec = mesh_train(fc, get_model(fc).init_params(
                    0, "cuda"), fbatches[a], None, MESH_F_STEPS)
            if tag is None:
                fctrl[a] = rec
            else:
                ftwin.setdefault(a, {})[tag] = rec
            _free()
    # the ranks take host copies: CUDA IPC is refused with expandable
    # segments on this machine
    host = lambda bs: [{k: v.cpu() for k, v in b.items()}  # noqa: E731
                       for b in bs]
    times["controls"] = time.perf_counter() - t0
    for tag, rec in (("control qwen3", ctrl), ("control tinyllama", dctrl),
                     (f"control qwen3 f32 L={cfg32.num_layers}", ctrl32),
                     *((f"control {a} L={c.num_layers}", fctrl[a])
                       for a, c in fcfgs.items())):
        print(_mesh_line(tag, rec, rec, card), flush=True)
    for a, twins in ftwin.items():
        for tag, rec in twins.items():
            print(f"[mesh-train] control {fcfgs[a].name}'s twin ({tag}): "
                  f"{rec['metrics']}; its distance from the control a step "
                  f"{_rel(rec['metrics'], fctrl[a]['metrics'])}; "
                  f"card=[{card}]", flush=True)
    for name, t, c in ((cfg.name, twin, ctrl), (dcfg.name, dtwin, dctrl)):
        print(f"[mesh-train] control {name}'s twin (attention over KV chunks "
              f"of {MESH_NOISE_CHUNK}): {t['metrics']}; its distance from "
              f"the control a step {_rel(t['metrics'], c['metrics'])}; "
              f"card=[{card}]", flush=True)
    eval_batch = {"tokens": batches[0]["tokens"]}

    with tempfile.TemporaryDirectory(prefix="mesh_train_") as ckpt:
        t0 = time.perf_counter()
        (one,) = run_ranks(mesh_rank_a, 1, backend="nccl", device="cuda",
                           args=(cfg, host(batches), ctrl_digest,
                                 ctrl["metrics"]),
                           timeout=MESH_SPAWN_S)
        times["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = run_ranks(mesh_rank_b, 2, backend="gloo", device="cuda",
                        args=(cfg, host(batches), dcfg,
                              host(dbatches[:MESH_STEPS]), ckpt,
                              host([eval_batch])[0], cfg32,
                              [(a, c, host(fbatches[a]))
                               for a, c in fcfgs.items()]),
                        timeout=MESH_SPAWN_S)
        times["b-d"] = time.perf_counter() - t0
        # (e) the (2, 1) checkpoint restored without a mesh, one more step
        t0 = time.perf_counter()
        h = make_train_harness(dcfg, None, lr=MESH_LR)
        like = get_model(dcfg).init_params(0, "cuda")
        state = CheckpointManager(ckpt).restore(
            MESH_STEPS, {"params": like, "opt": h.init_opt(like)})
        _, _, m = h.step_fn(state["params"], state["opt"],
                            dbatches[MESH_STEPS])
        e_metrics = [(float(m["loss"]), float(m["grad_norm"]))]
        times["e"] = time.perf_counter() - t0
        del state, like

    for shape in ((1,), (1, 1)):
        rec = one[shape]
        print(_mesh_line(f"(a) {one['backend']} rank 0 on {shape}", rec, ctrl,
                         card) + f"; params bit-equal {rec['params_equal']}",
              flush=True)
        if not (rec["params_equal"] and rec["metrics_equal"]):
            fail(f"mesh-train (a) on {shape}: not bit-identical to the "
                 f"control ({rec['metrics']} vs {ctrl['metrics']})")
        if rec["syncs"]:
            fail(f"mesh-train (a) on {shape}: {rec['syncs']} syncs in a "
                 f"step at {rec['sync_sites']}")
    # the leaves (b) and (c') keep split over model: every group's
    split = {"b": {"wq": "out", "wo": "in", "w_gate": "expert",
                   "embed": "vocab", "head": "vocab"},
             "c_seq": {"wq": "out", "wo": "in", "w_gate": "out",
                       "w_down": "in", "embed": "vocab", "head": "vocab"}}
    split["b32"] = split["b"]
    def flat(rel):
        return [(rel, rel)] * MESH_STEPS
    # the twin's distance a step bounds (b)'s bf16 grad norm where it
    # exceeds MESH_REL
    b_bounds = [(MESH_REL, max(MESH_REL, MESH_NOISE_X * abs(g - w) / abs(w)))
                for (_, g), (_, w) in zip(twin["metrics"], ctrl["metrics"])]
    print(f"[mesh-train] (b)'s bounds a step (loss, grad_norm): "
          f"{[tuple(float(f'{x:.3g}') for x in b) for b in b_bounds]}",
          flush=True)
    for r in two:
        for part, want, shape, bounds in (
                ("b", ctrl, "(1, 2)", b_bounds),
                ("b32", ctrl32, "(1, 2) f32", flat(MESH_F32_REL)),
                ("c", dctrl, "(2, 1)", flat(MESH_REL)),
                ("c_seq", dctrl, "(1, 2) seq_parallel", flat(MESH_REL))):
            rec = r[part]
            label = "c')" if part == "c_seq" else part + ")"
            print(_mesh_line(f"({label} gloo rank {r['rank']} on {shape} "
                             f"(data, model) {r[part + '_coords']}", rec,
                             want, card) + f"; distance a step "
                  f"{_rel(rec['metrics'], want['metrics'])}; split over "
                  f"model {sorted(rec['plan'])}; {rec['s']:.1f} s",
                  flush=True)
            if not _within(rec["metrics"], want["metrics"][:MESH_STEPS],
                           bounds):
                fail(f"mesh-train ({label} rank {r['rank']}: "
                     f"{rec['metrics']} vs the control's {want['metrics']}")
            if rec["kept"] >= want["kept"]:
                fail(f"mesh-train ({label} rank {r['rank']} keeps "
                     f"{rec['kept']} B, the control {want['kept']}")
            x = rec["exchange"]
            if part in split and (
                    split[part].items() - rec["plan"].items()
                    or x["gather"]["n"]):
                fail(f"mesh-train ({label} rank {r['rank']}: split "
                     f"{rec['plan']}, {x['gather']['n']} broadcasts a step")
            if (x["reduce_scatter"]["n"] > 0) != (part == "c_seq"):
                fail(f"mesh-train ({label} rank {r['rank']}: "
                     f"{x['reduce_scatter']['n']} reduce-scatters a step")
        d = r["d"]
        L = cfg.num_layers
        want_counts = {"quant_matmul": 4 * L, "quant_matmul_experts": 3 * L}
        print(f"[mesh-train] (d) gloo rank {r['rank']}: {cfg.name} trained, "
              f"RTN W2A16g128 + pack + slice {d['pack_s']:.1f} s; ep_axis "
              f"{d['ep_axis']!r}, {d['local_experts']} experts a rank; packed"
              f" perplexity on (1, 2) {d['mesh']['ppl']:.6g} "
              f"({d['mesh']['s']:.2f} s), no mesh {d['none']['ppl']:.6g} "
              f"({d['none']['s']:.2f} s); launches on (1, 2) "
              f"{d['mesh']['counts']}, no mesh {d['none']['counts']}; "
              f"card=[{card}]", flush=True)
        if abs(d["mesh"]["ppl"] - d["none"]["ppl"]) > \
                MESH_PPL_REL * d["none"]["ppl"] \
                or not np.isfinite(d["mesh"]["ppl"]):
            fail(f"mesh-train (d) rank {r['rank']}: perplexity "
                 f"{d['mesh']['ppl']} vs {d['none']['ppl']}")
        for tag in ("mesh", "none"):
            got = {k: d[tag]["counts"][k] for k in want_counts}
            if got != want_counts or any(
                    v for k, v in d[tag]["counts"].items()
                    if k not in want_counts):
                fail(f"mesh-train (d) rank {r['rank']} {tag}: launches "
                     f"{d[tag]['counts']}, expected {want_counts}")
        if d["local_experts"] != cfg.moe.num_experts // 2:
            fail(f"mesh-train (d): {d['local_experts']} experts a rank")
    # (c''): (b)'s bounds over TinyLlama's twin; each layer's k / v
    # all-gather (the rank's part (B, S / 2, Hkv, 2 hd): k and v joined)
    # moves 2 x B x S x Hkv x hd x 2 B a forward, the remat backward runs
    # each forward again, and the reduce-scatter of their gradient moves
    # as much once
    q_bounds = [(MESH_REL, max(MESH_REL,
                               MESH_NOISE_X * abs(g - w) / abs(w)))
                for (_, g), (_, w) in zip(dtwin["metrics"],
                                          dctrl["metrics"])]
    hkv, hd, L = dcfg.num_kv_heads, dcfg.resolved_head_dim, dcfg.num_layers
    kv_part = (MESH_BATCH, MESH_SEQ // 2, hkv, 2 * hd)
    kv_layer = 2 * MESH_BATCH * MESH_SEQ * hkv * hd * 2
    fwd = 2 if dcfg.remat else 1
    none = {"n": 0, "bytes": 0}
    for r in two:
        rec, cs = r["c_q"], r["c_seq"]
        ag = rec["by_shape"].get(("all_gather", kv_part), none)
        rs = rec["by_shape"].get(("reduce_scatter", kv_part), none)
        print(_mesh_line(f"(c'') gloo rank {r['rank']} on (1, 2) "
                         f"seq_parallel + attn-seq-parallel", rec, dctrl,
                         card)
              + f"; (c') {cs['step_ms']:.1f} ms a step, peak "
              f"{cs['peak'] / 1e9:.3f} GB; k / v all-gather a step "
              f"{ag['bytes']:.0f} B in {ag['n']:.0f} calls (shapes: {fwd} "
              f"forwards x {L} layers x {kv_layer} B), their gradient's "
              f"reduce-scatter {rs['bytes']:.0f} B in {rs['n']:.0f} calls "
              f"(shapes: {L} x {kv_layer} B); a rank's (query rows, heads) "
              f"{rec['q_rows_heads']}; distance a step "
              f"{_rel(rec['metrics'], dctrl['metrics'])}, bounds "
              f"{[tuple(float(f'{x:.3g}') for x in b) for b in q_bounds]}; "
              f"split over model {sorted(rec['plan'])}; {rec['s']:.1f} s",
              flush=True)
        if not _within(rec["metrics"], dctrl["metrics"][:MESH_F_STEPS],
                       q_bounds):
            fail(f"mesh-train (c'') rank {r['rank']}: {rec['metrics']} vs "
                 f"the control's {dctrl['metrics']}")
        if (ag["n"], ag["bytes"], rs["n"], rs["bytes"]) != (
                fwd * L, fwd * L * kv_layer, L, L * kv_layer):
            fail(f"mesh-train (c'') rank {r['rank']}: k / v exchange "
                 f"{ag}, {rs} a step")
        if rec["q_rows_heads"] != [(MESH_SEQ // 2, dcfg.num_heads)]:
            fail(f"mesh-train (c'') rank {r['rank']}: the attention ran "
                 f"(rows, heads) {rec['q_rows_heads']}")
        if split["c_seq"].items() - rec["plan"].items() \
                or rec["exchange"]["gather"]["n"] \
                or rec["kept"] >= dctrl["kept"]:
            fail(f"mesh-train (c'') rank {r['rank']}: split {rec['plan']}, "
                 f"{rec['exchange']['gather']['n']} broadcasts a step, keeps "
                 f"{rec['kept']} B")
    # (f)'s bounds a step (loss, grad_norm): bf16 as (b)'s, over the
    # farthest twin; MESH_F32's f32 run within MESH_F32_REL
    f_bounds = {}
    for a, want in fctrl.items():
        if fcfgs[a].dtype == "float32":
            f_bounds[a] = [(MESH_F32_REL, MESH_F32_REL)] * MESH_F_STEPS
            continue
        far = [max([abs(t["metrics"][s][1] - w) / abs(w)
                    for t in ftwin.get(a, {}).values()], default=0.0)
               for s, (_, w) in enumerate(want["metrics"])]
        f_bounds[a] = [(MESH_REL, max(MESH_REL, MESH_NOISE_X * d))
                       for d in far]
    shown = {a: [tuple(float(f"{x:.3g}") for x in b) for b in bs]
             for a, bs in f_bounds.items()}
    print(f"[mesh-train] (f)'s bounds a step (loss, grad_norm): {shown}",
          flush=True)
    for r in two:
        for a, c in fcfgs.items():
            rec, want = r["f"][a], fctrl[a]
            plan, whole = MESH_F_PLANS[a.split()[0]]
            x = rec["exchange"]
            print(_mesh_line(f"(f) {a} L={c.num_layers} gloo rank "
                             f"{r['rank']} on (1, 2) seq_parallel", rec,
                             want, card)
                  + f"; distance a step "
                  f"{_rel(rec['metrics'], want['metrics'])}; split over "
                  f"model {sorted(rec['plan'])}; {rec['s']:.1f} s",
                  flush=True)
            if not _within(rec["metrics"], want["metrics"], f_bounds[a]):
                fail(f"mesh-train (f) {a} rank {r['rank']}: "
                     f"{rec['metrics']} vs the control's {want['metrics']}, "
                     f"bounds {f_bounds[a]}")
            if rec["kept"] >= want["kept"]:
                fail(f"mesh-train (f) {a} rank {r['rank']} keeps "
                     f"{rec['kept']} B, the control {want['kept']}")
            if rec["plan"] != plan or x["gather"]["n"] != 2 * whole \
                    or not x["reduce_scatter"]["n"]:
                fail(f"mesh-train (f) {a} rank {r['rank']}: split "
                     f"{rec['plan']}, {x['gather']['n']} broadcasts and "
                     f"{x['reduce_scatter']['n']} reduce-scatters a step")
    print(f"[mesh-train] (e) {dcfg.name} saved from (2, 1) at step "
          f"{MESH_STEPS} ({two[0]['e_save_s']:.1f} s), restored without a "
          f"mesh, step {MESH_STEPS + 1}: {e_metrics} (control "
          f"{dctrl['metrics'][MESH_STEPS:]}); {times['e']:.1f} s",
          flush=True)
    if not _within(e_metrics, dctrl["metrics"][MESH_STEPS:],
                   [(MESH_REL, MESH_REL)]):
        fail(f"mesh-train (e): {e_metrics} vs the control's "
             f"{dctrl['metrics'][MESH_STEPS:]}")
    if ctrl["syncs"]:
        fail(f"mesh-train control: {ctrl['syncs']} syncs in a step at "
             f"{ctrl['sync_sites']}")
    print(f"[time] phase 21: controls {times['controls']:.1f}s, (a) "
          f"{times['a']:.1f}s, (b)-(d), (f) {times['b-d']:.1f}s (of which "
          f"(f) {max(sum(f['s'] for f in r['f'].values()) for r in two):.1f}"
          f"s), (e) {times['e']:.1f}s", flush=True)
    return {"control": ctrl_counts,
            **{f"gloo rank {r['rank']} (d)": _sum_counts(
                r["d"]["mesh"]["counts"], r["d"]["none"]["counts"])
               for r in two}}


# --------------------------------------------------------------------------
# phase 22: the GSPMD-placed serve path, the sanitizer and the dry-run
# --------------------------------------------------------------------------

GSPMD_LAYERS = 2                # depth cut from 32 (the phase's time)
GSPMD_GEN = 8                   # 4 x (128 + 8)
# the scheduled run: 4 slots (2 a rank on (2, 1)), 4 seeded requests
GSPMD_WORKLOAD = dict(n_requests=4, seed=0, prompt_lens=(16, 64),
                      budgets=(2, 8), mean_gap=2.0)
GSPMD_SLOTS = 4
GSPMD_MESHES = ((1, 2), (2, 1))       # the two gloo ranks' meshes
GSPMD_SCHEDULED = (2, 1)              # the gloo ranks' scheduled mesh
GSPMD_SPAWN_S = 300
# (b): one PAR iteration of TesseraQ on a full-width LLaMA-2-7B layer,
# RTN init, 8 x 512 calibration tokens at bs 4
SANITIZE_CAL = dict(layers=1, samples=8, seq=512, bs=4, steps=2)
DRYRUN_ARGS = ("--arch", "llama2-7b", "--shape", "decode_32k", "--mesh",
               "single", "--quant", "W2A16g128")


def _shard_bytes(tree, specs):
    """Bytes of the rank's slices of a global tree under its shardings
    (``shard_shape``), QTensor fields leaf by leaf."""
    import math
    from repro_torch.core.qtensor import QTensor
    from repro_torch.launch.sharding import shard_shape
    if isinstance(tree, dict):
        return sum(_shard_bytes(v, specs[k]) for k, v in tree.items())
    if isinstance(tree, QTensor):
        return sum(_shard_bytes(getattr(tree, f), getattr(specs, f))
                   for f in ("packed", "scale", "zero", "act_scale"))
    if tree is None:
        return 0
    return math.prod(shard_shape(tree.shape, specs)) * tree.element_size()


def gspmd_lockstep(cfg, host, ctrl, mesh):
    """One rank's lock-step serve on ``mesh`` (the control's 4 x (128 +
    ``GSPMD_GEN``) on "pallas", warm-up first): its placement of the host
    tree ``host`` (only its slices moved to the card), the tokens and the
    logits, exact launches, the bytes it keeps against ``param_shardings``
    / ``cache_shardings``' prediction, the ms of the params' gather, and
    one decode step counted by ``hlo_stats.OpCounter`` (its collectives,
    their bytes, its host transfers)."""
    from repro_torch.kernels import build
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.serve import compile_serve_steps, serve_requests
    from repro_torch.launch.sharding import (MeshPlacement, cache_shardings,
                                             param_shardings, SERVE_OVERRIDES)
    from repro_torch.models import get_model
    prompts = ctrl["prompts"]
    B, P = prompts.shape
    t0 = time.perf_counter()
    placed = MeshPlacement.place(mesh, cfg, host)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    model = get_model(cfg)
    pstep, dstep = compile_serve_steps(cfg, kernel_backend="pallas",
                                       mesh=mesh)
    record = {}

    def counted(*a, **k):
        counter = hlo_stats.OpCounter()
        with counter:
            out = dstep(*a, **k)
        record.update(
            ops=hlo_stats.collective_op_counts(counter.collectives),
            coll_bytes=sum(c.nbytes for c in counter.collectives),
            host_transfers=hlo_stats.host_transfer_ops(counter))
        return out

    def run(gen, compiled=(pstep, dstep), **k):
        return serve_requests(cfg, model, placed, prompts, gen=gen,
                              kernel_backend="pallas", compiled=compiled,
                              mesh=mesh, **k)
    run(2, compiled=(pstep, counted), collect_logits=False)   # warm-up
    build.reset_launch_counts()
    res = run(GSPMD_GEN)
    counts = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        whole = placed.whole()
        del whole
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t0) / 3 * 1e3
    struct = model.init_cache(B, P + GSPMD_GEN, device="meta")
    predicted = (_shard_bytes(host, param_shardings(mesh, host, cfg,
                                                    SERVE_OVERRIDES))
                 + _shard_bytes(struct, cache_shardings(mesh, struct, cfg)))
    return {"tokens": res.tokens, "logits": res.logits,
            "digest": _digest(res.logits), "counts": counts,
            "prefill_ms": res.prefill_secs * 1e3,
            "decode_ms": res.decode_secs * 1e3 / (GSPMD_GEN - 1),
            "kept": _tree_bytes(placed.params)
            + res.cache_stats["cache_bytes"],
            "predicted": predicted, "gather_ms": gather_ms,
            "place_s": place_s, "step": record}, placed


def gspmd_schedule(cfg, placed, mesh):
    """One rank's scheduled run (``GSPMD_WORKLOAD``, ``GSPMD_SLOTS`` slots
    on the dense store) on ``mesh``: tokens, exact launches."""
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import make_workload, serve_scheduled
    reqs = make_workload(cfg.vocab_size, **GSPMD_WORKLOAD)
    build.reset_launch_counts()
    res = serve_scheduled(cfg, placed, reqs, slots=GSPMD_SLOTS,
                          kernel_backend="pallas", mesh=mesh)
    counts = dict(build.LAUNCHES)
    want = expected_launches(cfg, prefill_calls(res, reqs), res.steps,
                             "decode_attention", "decode_attention")
    return {"tokens": {r.rid: res.requests[r.rid]["tokens"] for r in reqs},
            "counts": counts, "want": want, "steps": res.steps,
            "decode_ms": res.decode_secs * 1e3 / max(res.steps, 1)}


def gspmd_rank(tmp, cfg, shapes):
    """One rank of phase 22: the packed tree read into host memory
    (``mmap``), then on each mesh of ``shapes`` the lock-step serve and,
    on ``GSPMD_SCHEDULED`` (or a mesh of one rank), the scheduled run."""
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctrl = dict(np.load(os.path.join(tmp, "ctrl.npz")))
    host = torch.load(os.path.join(tmp, "packed.pt"), map_location="cpu",
                      mmap=True, weights_only=False)
    out = {"rank": torch.distributed.get_rank(),
           "backend": torch.distributed.get_backend()}
    for shape in shapes:
        mesh = make_mesh(shape, device="cuda")
        out[shape], placed = gspmd_lockstep(cfg, host, ctrl, mesh)
        if shape == GSPMD_SCHEDULED or mesh.world == 1:
            out[shape]["schedule"] = gspmd_schedule(cfg, placed, mesh)
        del placed
        _free()
    return out


def sanitize_phase(card, cfg, packed, prompts, reqs, want):
    """(b) ``sanitized(transfer_guard=True)`` around the scheduled run (its
    decode steps between admissions; the admissions' first-token reads
    and the off-clock fetches are its ``allowed_transfer`` points) and
    around one PAR iteration's Soften steps (``ReconstructionEngine.run``,
    the first call of a TesseraQ walk): no raise; a planted ``.item()`` on
    a decode step's logits inside raises.  (c) ``assert_no_recompiles``
    quiet on a repeat of the scheduled run, raising on a new
    ``max_seq``."""
    from repro_torch.configs import get_config
    from repro_torch.core import recon_engine as RE
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.tesseraq import TesseraQConfig
    from repro_torch.data.pipeline import DataConfig, calibration_batches
    from repro_torch.debug import (RecompileError, assert_no_recompiles,
                                   sanitized)
    from repro_torch.kernels import build
    from repro_torch.launch.scheduler import (compile_sched_steps,
                                              serve_scheduled)
    from repro_torch.launch.serve import compile_serve_steps, parse_quant
    from repro_torch.models import get_model
    width = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    kw = dict(slots=GSPMD_SLOTS, kernel_backend="pallas", device="cuda")
    steps = compile_sched_steps(cfg, max_seq=width, kernel_backend="pallas")
    with sanitized(transfer_guard=True):
        res = serve_scheduled(cfg, packed, reqs, compiled=steps, **kw)
    if not all(np.array_equal(res.requests[r.rid]["tokens"], want[r.rid])
               for r in reqs):
        fail("sanitize (b): the guarded scheduled run's tokens differ")
    model = get_model(cfg)
    pstep, dstep = compile_serve_steps(cfg, kernel_backend="pallas")
    cache = model.init_cache(4, 136, device="cuda")
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.no_grad():
        lg, cache = pstep(packed, {"tokens": toks}, cache)
        tok = torch.argmax(lg, -1)
        pos = torch.full((4,), prompts.shape[1], dtype=torch.int32,
                         device="cuda")
        torch.cuda.synchronize()
        planted = None
        try:
            with sanitized(transfer_guard=True):
                lg, cache = dstep(packed, cache, tok, pos)
                lg[0, 0].item()
        except RuntimeError as e:
            planted = str(e).splitlines()[0]
    torch.cuda.set_sync_debug_mode("default")
    if planted is None or "synchroniz" not in planted:
        fail(f"sanitize (b): a planted .item() did not raise ({planted})")

    c = SANITIZE_CAL
    lcfg = get_config("llama2-7b").replace(num_layers=c["layers"])
    params = get_model(lcfg).init_params(0, "cuda")
    data = DataConfig(vocab_size=lcfg.vocab_size, seq_len=c["seq"],
                      global_batch=c["bs"], seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(data, c["samples"] // c["bs"],
                                          c["bs"])]
    run = RE.ReconstructionEngine.run
    guarded = []

    def first_guarded(self, *a, **k):
        if guarded:
            return run(self, *a, **k)
        with sanitized(transfer_guard=True):
            out = run(self, *a, **k)
        torch.cuda.synchronize()
        guarded.append(k.get("steps"))
        return out
    build.reset_launch_counts()
    RE.ReconstructionEngine.run = first_guarded
    try:
        quantize_model(lcfg, params, calib,
                       parse_quant("W2A16g128", kernel_backend="pallas"),
                       method="tesseraq", init="rtn",
                       tcfg=TesseraQConfig(par_iterations=1,
                                           steps_per_iteration=c["steps"],
                                           batch_size=c["bs"]))
    finally:
        RE.ReconstructionEngine.run = run
    cal_counts = dict(build.LAUNCHES)
    del params, calib
    _free()
    if guarded != [c["steps"]] or cal_counts["soft_round_fwd"] != \
            7 * c["steps"] * c["layers"]:
        fail(f"sanitize (b): guarded PAR iterations {guarded}, launches "
             f"{cal_counts}")

    with assert_no_recompiles(compile_sched_steps, compile_serve_steps,
                              build.build_library):
        again = serve_scheduled(cfg, packed, reqs, max_seq=width, **kw)
    recompiled = None
    try:
        with assert_no_recompiles(compile_sched_steps):
            serve_scheduled(cfg, packed, reqs, max_seq=width + 16, **kw)
    except RecompileError as e:
        recompiled = str(e).splitlines()[0]
    if recompiled is None:
        fail("sanitize (c): a new max_seq built no new step set")
    if not all(np.array_equal(again.requests[r.rid]["tokens"], want[r.rid])
               for r in reqs):
        fail("sanitize (c): the repeated scheduled run's tokens differ")
    print(f"[sanitize] (b) transfer guard: the scheduled run (max_seq "
          f"{width}, {res.steps} decode steps) clean, tokens equal; one PAR "
          f"iteration of {c['steps']} Soften steps on a full-width "
          f"{lcfg.name} layer clean (soft_round launches "
          f"{cal_counts['soft_round_fwd']} + {cal_counts['soft_round_bwd']});"
          f" the planted .item() raised: {planted!r}; (c) no new step set on "
          f"the repeat, a new max_seq raised: {recompiled!r}; card=[{card}]",
          flush=True)


def gspmd_phase(card):
    """Phase 22: the reference's GSPMD serve path on the card, the
    sanitizer and the dry-run.  LLaMA-2-7B at full width and
    ``GSPMD_LAYERS`` of 32, RTN W2A16g128 + pack; the no-mesh control
    serves 4 x (128 + ``GSPMD_GEN``) and the ``GSPMD_WORKLOAD`` scheduled
    run on "pallas".  The packed tree reaches the ranks in a temporary
    file; each reads it into host memory and places its slices
    (``MeshPlacement``).  (a) One NCCL rank on ``(1, 1)``: tokens and
    logits bit-identical to the control, its launches, the scheduled
    tokens.  (b) Two gloo ranks sharing the card on ``(1, 2)`` (params,
    KV heads and vocab split over ``model``; every step gathers them) and
    ``(2, 1)`` (rows and slots over ``data``): the control's tokens, its
    logits bit for bit or, where a kernel's plan moves with the rows a
    rank runs (kernel 1 at the prefill's 256 rows against 512), within
    ``parity_gate``; exact launches; the bytes a rank keeps equal to
    ``param_shardings`` / ``cache_shardings``' prediction; the params'
    gather timed alone and a decode step's collective bytes; on ``(2,
    1)`` the scheduled run's tokens.  Beside them, in this process: (b) the
    sanitizer, (c) ``assert_no_recompiles`` (``sanitize_phase``); and (d)
    the dry-run CLI (``DRYRUN_ARGS``) in a subprocess, exit 0: the fake
    process group on this torch.  Returns the launch counts by part."""
    import tempfile
    from repro_torch.eval.harness import parity_gate
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.scheduler import make_workload, serve_scheduled
    times = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gspmd_") as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        dry_out = os.path.join(tmp, "dryrun.json")
        dry = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
             "--out", dry_out], cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            cfg, model, packed, prompts = build_packed(
                "llama2-7b", GSPMD_LAYERS, "gspmd")
            counts, res = lockstep_phase("gspmd control", cfg, model, packed,
                                         prompts, card, gen=GSPMD_GEN)
            reqs = make_workload(cfg.vocab_size, **GSPMD_WORKLOAD)
            sres = serve_scheduled(cfg, packed, reqs, slots=GSPMD_SLOTS,
                                   kernel_backend="pallas", device="cuda")
            want = {r.rid: sres.requests[r.rid]["tokens"] for r in reqs}
            np.savez(os.path.join(tmp, "ctrl.npz"), prompts=prompts)
            torch.save(packed, os.path.join(tmp, "packed.pt"))
            times["controls"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ranks = {}
            nccl = threading.Thread(target=lambda: ranks.update(a=run_ranks(
                gspmd_rank, 1, backend="nccl", device="cuda",
                args=(tmp, cfg, ((1, 1),)), timeout=GSPMD_SPAWN_S)))
            gloo = threading.Thread(target=lambda: ranks.update(b=run_ranks(
                gspmd_rank, 2, backend="gloo", device="cuda",
                args=(tmp, cfg, GSPMD_MESHES), timeout=GSPMD_SPAWN_S)))
            nccl.start()
            gloo.start()
            try:
                sanitize_phase(card, cfg, packed, prompts, reqs, want)
                times["sanitize"] = time.perf_counter() - t0
            finally:
                nccl.join()
                gloo.join()
            times["ranks"] = time.perf_counter() - t0
            dry_rc = dry.wait(timeout=GSPMD_SPAWN_S)
            dry_err = dry.stderr.read()
            dry_res = (json.load(open(dry_out)) if os.path.exists(dry_out)
                       else None)
        finally:
            if dry.poll() is None:
                dry.kill()
                dry.wait()
    if "a" not in ranks or "b" not in ranks:
        fail(f"gspmd: a spawn of ranks failed (got {sorted(ranks)}); see "
             f"its traceback above")
    ctrl_digest = _digest(res.logits)
    out = {}
    for part, rs in (("(a)", ranks["a"]), ("(b)", ranks["b"])):
        for r in rs:
            total = {}
            for shape in ((1, 1),) if part == "(a)" else GSPMD_MESHES:
                x = r[shape]
                same = x["digest"] == ctrl_digest
                gate = None if same else parity_gate(
                    x["logits"], res.logits, atol=5e-2, rtol=2e-2)
                print(f"[gspmd] {part} rank {r['rank']} over {r['backend']}"
                      f" on {shape}: prefill {x['prefill_ms']:.3f} ms, decode"
                      f" {x['decode_ms']:.3f} ms/step (control "
                      f"{res.decode_secs * 1e3 / (GSPMD_GEN - 1):.3f}); "
                      f"logits bit-identical {same}"
                      + ("" if same else f", parity_gate {gate}")
                      + f"; tokens equal "
                      f"{np.array_equal(x['tokens'], res.tokens)}; kept "
                      f"{x['kept']} B (predicted {x['predicted']}); params' "
                      f"gather timed alone after the run "
                      f"{x['gather_ms']:.3f} ms; a decode step's "
                      f"collectives {x['step']['ops']} "
                      f"({x['step']['coll_bytes']} B), host transfers "
                      f"{x['step']['host_transfers']}; placement "
                      f"{x['place_s']:.3f} s; launches {x['counts']}; "
                      f"card=[{card}]", flush=True)
                if not np.array_equal(x["tokens"], res.tokens):
                    fail(f"gspmd {part} rank {r['rank']} {shape}: tokens "
                         f"differ from the control's")
                if shape != (2, 1) and not same:
                    fail(f"gspmd {part} rank {r['rank']} {shape}: logits "
                         f"not bit-identical to the control's")
                if not same and not gate["ok"]:
                    fail(f"gspmd {part} rank {r['rank']} {shape}: "
                         f"parity_gate {gate}")
                if x["counts"] != counts:
                    fail(f"gspmd {part} rank {r['rank']} {shape}: launches "
                         f"{x['counts']}, the control's {counts}")
                if x["kept"] != x["predicted"]:
                    fail(f"gspmd {part} rank {r['rank']} {shape}: keeps "
                         f"{x['kept']} B, predicted {x['predicted']}")
                if x["step"]["host_transfers"] or set(x["step"]["ops"]) - {
                        "broadcast_"}:
                    fail(f"gspmd {part} rank {r['rank']} {shape}: a decode "
                         f"step's record {x['step']}")
                total = _sum_counts(total, x["counts"])
                if "schedule" in x:
                    s = x["schedule"]
                    print(f"[gspmd] {part} rank {r['rank']} on {shape} "
                          f"scheduled: {s['steps']} decode steps "
                          f"{s['decode_ms']:.3f} ms/step, launches "
                          f"{s['counts']}, tokens equal the control's "
                          f"{all(np.array_equal(s['tokens'][k], v) for k, v in want.items())}",
                          flush=True)
                    if s["counts"] != s["want"]:
                        fail(f"gspmd {part} scheduled launches "
                             f"{s['counts']}, expected {s['want']}")
                    if not all(np.array_equal(s["tokens"][k], v)
                               for k, v in want.items()):
                        fail(f"gspmd {part} rank {r['rank']}: scheduled "
                             f"tokens differ from the control's")
                    total = _sum_counts(total, s["counts"])
            out[f"{part} {r['backend']} rank {r['rank']}"] = total
    a, b = ranks["b"]
    for shape in GSPMD_MESHES:
        if a[shape]["digest"] != b[shape]["digest"]:
            fail(f"gspmd (b) {shape}: the two ranks' logits differ")
    if dry_rc != 0 or dry_res is None or dry_res["status"] != "ok":
        fail(f"gspmd (d): the dry-run exited {dry_rc}:\n{dry_err[-3000:]}")
    km, rf = dry_res["kernel_modeled"], dry_res["roofline"]
    print(f"[gspmd] (d) dry-run {' '.join(DRYRUN_ARGS)} on this torch: rc "
          f"{dry_rc}, {dry_res['chips']} ranks, counted in "
          f"{dry_res['compile_secs']:.1f} s; kernel_modeled t_step "
          f"{km['t_step'] * 1e3:.4f} ms (t_memory {km['t_memory'] * 1e3:.4f}"
          f" ms; the fused line, the port's gathers left out); the unfused "
          f"roofline of {dry_res['counted']}: compute "
          f"{rf['t_compute'] * 1e3:.4f} ms, "
          f"memory {rf['t_memory'] * 1e3:.4f} ms, collective "
          f"{rf['t_collective'] * 1e3:.4f} ms; memory "
          f"{dry_res['memory']}", flush=True)
    print(f"[time] phase 22: controls {times['controls']:.1f}s, ranks "
          f"{times['ranks']:.1f}s (the sanitizer beside them "
          f"{times['sanitize']:.1f}s)", flush=True)
    out["control"] = counts
    return out


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
    del packed
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sched_cfg, _, packed, _ = build_packed("llama2-7b", SCHED_LAYERS,
                                           "schedule")
    sched_counts, _ = schedule_phase(card, packed, sched_cfg)
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
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_counts, _ = train_phase(card)
    print(f"[time] train {time.perf_counter() - t0:.1f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    new_counts = new_configs_phase(card)
    print(f"[time] configs, int8 KV cache, engines "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fam_counts, _ = families_phase(card)
    print(f"[time] families {time.perf_counter() - t0:.1f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    encdec_counts, _ = encdec_phase(card)
    print(f"[time] encoder-decoder {time.perf_counter() - t0:.1f}s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_counts = tp_serve_phase(card)
    print(f"[time] tensor-parallel serving {time.perf_counter() - t0:.1f}s",
          flush=True)
    _free()
    t0 = time.perf_counter()
    shard_counts = shard_phase(card)
    print(f"[time] sharded reconstruction {time.perf_counter() - t0:.1f}s",
          flush=True)
    _free()
    t0 = time.perf_counter()
    mesh_counts = mesh_train_phase(card)
    print(f"[time] training on a mesh {time.perf_counter() - t0:.1f}s",
          flush=True)
    _free()
    t0 = time.perf_counter()
    gspmd_counts = gspmd_phase(card)
    print(f"[time] GSPMD serving, sanitizer, dry-run "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

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
                           "'encdec' one whisper-small encoder layer of an "
                           "admission: 6 launches at M=1500 (4 x 768 x "
                           "768, 768 x 3072, 3072 x 768); 'tp' one "
                           "LLaMA-2-7B layer's 7 launches on a tp = 2 "
                           "rank's shards (3 x 4096 x 2048, 2048 x 4096, 2 "
                           "x 4096 x 5504, 5504 x 4096); '*_nospin' timed "
                           "without the device spin",
           "quant_gemv": "one layer of a decode step: 7 launches, M=4, W2 "
                         "g128; 'sched' the same at M=8 (the scheduled "
                         "decode's 8 slots); 'moe' one Qwen3 layer's 4 "
                         "attention projections; 'wa' the 7 at W4 "
                         "per-channel; 'encdec' one whisper-small decoder "
                         "layer of a decode step: 8 launches at M=8 (6 x "
                         "768 x 768, 768 x 3072, 3072 x 768); 'tp' the 7 "
                         "on a tp = 2 rank's shards, M=4; '*_nospin' "
                         "the same launches timed "
                         "by events alone, without the device spin",
           "decode_attention": "one layer of a decode step: 1 launch, B=4 "
                               "Hkv=32 G=1 D=128 S=144 kv_len=136; 'moe' "
                               "Qwen3's: B=4 Hkv=4 G=8 D=128 S=144 "
                               "kv_len=136; 'long' the long lane: B=4 "
                               "Hkv=32 G=1 D=128 S=kv_len=4096 (SDPA over "
                               "the live positions in all three); "
                               "'encdec' whisper-small's: B=8 Hkv=12 G=1 "
                               "D=64 S=80 kv_len=40; 'tp' a tp = 2 rank's "
                               "LLaMA shape: Hkv=16; "
                               "'*_nospin' timed without the device spin",
           "soft_round_fwd": "one layer of a Soften step: 7 launches (4 x "
                             "ng=32 out=4096, 2 x ng=32 out=11008, 1 x ng=86 "
                             "out=4096; g=128, W2, DST on); 'moe' one Qwen3 "
                             "layer's 7 (2 x ng=2048 out=768, 1 x ng=768 "
                             "out=2048, ng=16 out=4096, 2 x ng=16 out=512, "
                             "ng=32 out=2048); 'wa' the LLaMA layer's 7 at "
                             "W4 per-channel (ng=1, g=K); 'encdec' one "
                             "whisper-small encoder layer's 6 (4 x ng=6 "
                             "out=768, ng=6 out=3072, ng=24 out=768)",
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
                                     "yardstick); 'encdec' whisper-small's: "
                                     "B=8 Hkv=12 G=1 D=64, 5 pages of 16; "
                                     "'tp' a tp = 2 rank's LLaMA pool: B=4 "
                                     "Hkv=16, 9 pages of 16; "
                                     "'*_nospin' timed without "
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
                                   "experts that hold a row; 'tp' a tp = 2 "
                                   "rank's 64 experts at C=8 and 40",
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
                   "harness": harness_counts[name],
                   "train": train_counts[name],
                   "configs": new_counts["configs"][name],
                   "kv_int8": new_counts["kv_int8"][name],
                   "engines": new_counts["engines"][name],
                   **{f"families {part}": c[name]
                      for part, c in fam_counts.items()},
                   **{f"encdec {part}": c[name]
                      for part, c in encdec_counts.items()},
                   **{f"tp {part}": c[name]
                      for part, c in tp_counts.items()},
                   **{f"shard {part}": c[name]
                      for part, c in shard_counts.items()},
                   **{f"mesh train {part}": c[name]
                      for part, c in mesh_counts.items()},
                   **{f"gspmd serve {part}": c[name]
                      for part, c in gspmd_counts.items()}}
        if name.startswith("soft_round"):
            nums = summarize_soft_round(recs["soft_round"], name[-3:])
            nums["moe"] = summarize_soft_round(recs["soft_round"], name[-3:],
                                               "moe", sr_layer(MOE_SR_SHAPES))
            nums["wa"] = summarize_soft_round(
                recs["soft_round"], name[-3:], "wa",
                {(1, K, N): c for K, N, c in MAIN_SHAPES})
            nums["encdec"] = summarize_soft_round(
                recs["soft_round"], name[-3:], "encdec",
                sr_layer(ENCDEC_SR_SHAPES))
            nums["library_note"] = ("no single PyTorch call computes θ̂ or "
                                    "its gradient")
            nums["plans"] = {
                f"{r['ng']}x{r['g']}x{r['n']}": r["config"][name[-3:]]
                for r in recs["soft_round"] if r["main"] or r["moe"]
                or r["wa"] or r["encdec"]}
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
                nums["tp"] = summarize(recs[name], name, "tp", TP_SHAPES)
                nums["wa"] = summarize(recs[name], name, "wa")
                nums["encdec"] = summarize(
                    recs[name], name, "encdec",
                    ENCDEC_ENC_SHAPES if name == "quant_matmul"
                    else ENCDEC_DEC_SHAPES)
            if name.endswith("decode_attention"):
                nums["encdec"] = summarize(recs[name], name, "encdec")
                nums["tp"] = summarize(recs[name], name, "tp")
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
