#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. build: compile ``src/repro_torch/csrc/*.cu`` for sm_90a and load them;
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main path's shapes, with times (kernel, plain version, one
   PyTorch library call as a yardstick) beside the least time the card
   could take (``bound_ms``);
3. serve: LLaMA-2-7B at full width and depth (random weights from a seed),
   RTN-quantized to W2A16g128 and packed, served by ``serve_requests`` on
   the ``"pallas"`` backend (4 requests x 128 prompt tokens, 16 generated);
   the launch counts of that run prove every prefill projection, decode
   projection and decode attention went through the kernels, and a
   teacher-forced run of the ``"xla"`` backend holds its logits to
   rounding-level differences;
4. parity: the reduced llama2/tinyllama configs served on the card and,
   from the same params, on the CPU (plain versions);
5. a JSON line listing the ported kernels with their numbers;
6. last line: ``{"ok": true, "device": {...}}``.

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

# kernel vs plain version: both accumulate in f32, in different orders, and
# round the result to bf16.  Allowed: 2 bf16 ulps of the larger magnitude,
# plus an f32 reordering allowance of 2^-16 times the sum of |terms|
# (about sqrt(K) f32 roundings at K <= 11008).
ULPS = 2
REORDER = 2.0 ** -16

MAIN_SHAPES = ((4096, 4096, 4), (4096, 11008, 2), (11008, 4096, 1))  # K, N, per layer


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


def cuda_ms(fn, iters=20, flush=None):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after warm-up; ``flush`` (outside the timed region) evicts L2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOP_PER_S * 1e3
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
                main=False):
    """Kernel vs plain version at one shape, then both timed with the
    library matmul on the pre-dequantized weight; ``main`` marks the shapes
    the main path runs (summed in the kernels line)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.quant_matmul import dequantize_rows
    x, packed, scale, zero = quant_operands(gen, M, K, N, bits, group_size)
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
           "max_abs_err": err, "main": main}
    rec["kernel_ms"] = cuda_ms(lambda: fn(x, packed, scale, zero, **kw),
                               flush=flush)
    rec["plain_ms"] = cuda_ms(lambda: plain(x, packed, scale, zero, **kw),
                              iters=5, flush=flush)
    rec["library_ms"] = cuda_ms(lambda: torch.matmul(x, w), flush=flush)
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
                    main=False):
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import (decode_attention,
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
             f"B={B} S={S} Hkv={Hkv} G={G}: max |diff| {err}")
    for b in range(B):
        if active[b] == 0 and not bool((got[b] == 0).all()):
            fail(f"decode_attention: inactive slot {b} is not exact zeros")
    rec = {"B": B, "S": S, "Hkv": Hkv, "G": G, "D": D,
           "kv_len": list(kv_len), "active": list(active), "max_abs_err": err,
           "main": main}
    rec["kernel_ms"] = cuda_ms(lambda: decode_attention(q, k, v, **kw),
                               flush=flush)
    rec["plain_ms"] = cuda_ms(lambda: decode_attention_plain(q, k, v, **kw),
                              flush=flush)
    # SDPA over the live positions, K/V laid out (B, H, n, D) beforehand: one
    # call computes the same function only when every slot is live at one
    # length (causal q_pos = kv_len - 1)
    rec["library_ms"] = None
    n = kv_len[0]
    if min(active) == 1 and all(kv_len[b] == n and q_pos[b] == n - 1
                                for b in range(B)):
        qs = q.reshape(B, Hkv * G, 1, D)
        ks = k[:, :n].permute(0, 2, 1, 3).repeat_interleave(G, 1).contiguous()
        vs = v[:, :n].permute(0, 2, 1, 3).repeat_interleave(G, 1).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec["library_ms"] = cuda_ms(lambda: sdpa(qs, ks, vs), flush=flush)
    live = sum(min(kv_len[b], q_pos[b] + 1) for b in range(B) if active[b])
    nbytes = 2 * live * Hkv * D * 2 + 2 * B * Hkv * G * D * 2 + 3 * B * 4
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * live * Hkv * G * D)
    rec["launches"] = build.LAUNCHES["decode_attention"] - n0
    show("decode_attention", rec, card)
    return rec


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
    for M in (1, 32):
        out["quant_gemv"].append(check_quant(
            "quant_gemv", quant_gemv, quant_gemv_plain, gen, M, 4096, 11008,
            2, 128, flush, card))
    # main-path shape: kv_len 136 is the middle of the decode steps' 129..143
    out["decode_attention"].append(check_attention(
        gen, 4, 144, 32, 1, 128, [136] * 4, [135] * 4, [1] * 4, flush, card,
        main=True))
    out["decode_attention"].append(check_attention(
        gen, 4, 144, 4, 8, 128, [144, 77, 130, 9], [143, 76, 129, 5],
        [1, 0, 1, 1], flush, card))
    return out


def summarize(records, name):
    """One layer of the main path: its W2 g128 shapes, each weighted by how
    often a layer runs it (attention: its one launch)."""
    timed = [r for r in records if r["main"]]
    if name == "decode_attention":
        weights = [1] * len(timed)
    else:
        per_layer = {(K, N): c for K, N, c in MAIN_SHAPES}
        weights = [per_layer[(r["K"], r["N"])] for r in timed]
    tot = lambda key: sum(w * r[key] for w, r in zip(weights, timed,
                                                    strict=True))
    return {"ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
            "library_ms": tot("library_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": timed[0]["bound_by"],
            "max_abs_err": max(r["max_abs_err"] for r in records)}


# --------------------------------------------------------------------------
# phase 3: full-width LLaMA-2-7B W2A16g128 serve through the kernels
# --------------------------------------------------------------------------

EXPECTED = {"quant_matmul": 224, "quant_gemv": 3360, "decode_attention": 480}
REL_L2 = 5e-2


def serve_phase(card):
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import (pack_model, quantize_model,
                                           quantized_memory_report)
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           calibration_batches)
    from repro_torch.eval.harness import parity_gate
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant, serve_requests
    from repro_torch.launch.steps import make_serve_steps
    from repro_torch.models import get_model

    B, PROMPT, GEN = 4, 128, 16
    cfg = get_config("llama2-7b")
    model = get_model(cfg)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    t0 = time.perf_counter()
    params = model.init_params(0, "cuda")
    torch.cuda.synchronize()
    print(f"[serve] init {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
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
    print(f"[serve] RTN walk + pack {qcfg.tag} in "
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
    logits = res.logits
    if counts != EXPECTED:
        fail(f"main-path launch counts {counts}, expected {EXPECTED}")
    if logits.shape != (B, GEN, cfg.vocab_size) or not np.isfinite(logits).all():
        fail(f"bad logits: shape {logits.shape}, finite "
             f"{bool(np.isfinite(logits).all())}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] {B} x ({PROMPT} prompt + {GEN} generated) on pallas: "
          f"prefill {res.prefill_tok_s:.1f} tok/s ({res.prefill_secs * 1e3:.3f} "
          f"ms), decode {res.decode_tok_s:.1f} tok/s "
          f"({res.decode_secs * 1e3 / (GEN - 1):.3f} ms/step), launches "
          f"{counts}, packed {mem['quantized_bytes']} B (fp16 "
          f"{mem['fp16_bytes']} B), kv cache {res.cache_stats['cache_bytes']} "
          f"B, peak during serve {peak} B; card=[{card}]", flush=True)

    # teacher-forced "xla" backend over the same tokens, prefill and every
    # decode step.  The two paths round differently (the "xla" path
    # dequantizes in bf16, the kernels in f32 rounded once), and over 32
    # layers that leaves max |diff| above the reference's small-model gate
    # (0.10 measured against atol 5e-2); a wrong kernel would instead move
    # the logits by O(1) of their norm.  Gate: relative L2 difference of all
    # logits below REL_L2 (rounding-level differences are ~1e-2 or less).
    _, xpre, xdec = make_serve_steps(cfg, kernel_backend="xla")
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
    print(f"[serve] teacher-forced xla reference: relative L2 {rel:.6g} "
          f"(gate {REL_L2}); max |logit| {float(np.abs(ref).max()):.4g}; "
          f"parity_gate(5e-2, 2e-2) {gate}; argmax agreement {agree:.4f}",
          flush=True)
    if not rel < REL_L2:
        fail(f"full-width logits differ from the xla backend by relative "
             f"L2 {rel}")
    return counts


# --------------------------------------------------------------------------
# phase 4: reduced configs, card vs CPU from the same params
# --------------------------------------------------------------------------

def parity_phase():
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.eval.harness import parity_gate
    from repro_torch.kernels import build
    from repro_torch.launch.serve import parse_quant, serve_requests
    from repro_torch.models import get_model

    for arch in ("llama2-7b", "tinyllama-1.1b"):
        cfg = get_reduced_config(arch)
        model = get_model(cfg)
        qcfg = parse_quant("W2A16g32", kernel_backend="pallas")
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
        build.reset_launch_counts()
        gpu = serve_requests(cfg, model, packed_gpu, prompts, gen=6,
                             kernel_backend="pallas", device="cuda")
        counts = dict(build.LAUNCHES)
        cpu = serve_requests(cfg, model, packed_cpu, prompts, gen=6,
                             kernel_backend="pallas", device="cpu")
        gate = parity_gate(gpu.logits, cpu.logits, atol=5e-2, rtol=2e-2)
        same = bool((gpu.tokens == cpu.tokens).all())
        print(f"[parity] {cfg.name}: card vs CPU {gate}; tokens equal {same}; "
              f"card launches {counts}", flush=True)
        if not gate["ok"] or not same or min(counts.values()) == 0:
            fail(f"{cfg.name}: card and CPU disagree")


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
    print(f"[build] {len(build.KERNELS)} kernels built and loaded in "
          f"{time.perf_counter() - t0:.3f}s", flush=True)

    recs = kernel_phase(card)
    counts = serve_phase(card)
    parity_phase()

    sources = {"quant_matmul": "src/repro/kernels/quant_matmul.py:146",
               "quant_gemv": "src/repro/kernels/quant_gemv.py:120",
               "decode_attention": "src/repro/kernels/decode_attention.py:227"}
    per = {"quant_matmul": "one layer of the prefill: 7 launches, M=512, W2 g128",
           "quant_gemv": "one layer of a decode step: 7 launches, M=4, W2 g128",
           "decode_attention": "one layer of a decode step: 1 launch, B=4 "
                               "Hkv=32 G=1 D=128 S=144 kv_len=136"}
    kernels = []
    for name in build.KERNELS:
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": sources[name],
                        "launches": counts[name], **summarize(recs[name], name),
                        "per": per[name], "card": card})
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
