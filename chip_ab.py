#!/usr/bin/env python3
"""Same-call A/B of a kernel between two checkouts on one GPU.

    python3 chip_ab.py PARENT_DIR
        [--kernel quant_matmul|quant_gemv|decode_attention|decode_step|
                  int8_matmul|soft_round|quant_matmul_experts|moe_step|
                  mesh_train] [--log DIR]

``mesh_train`` is not a kernel: it runs the checkout's whole
``chip_smoke.mesh_train_phase`` (phase 21, its checks included) and
reports its ``(c)`` lines (TinyLlama on ``(2, 1)``, and ``(c')`` where the
checkout has it) and its time; ``--log DIR`` writes each process's whole
output to ``DIR/<n>_<tag>.log``.

``quant_matmul`` (the default) times ``chip_smoke.check_quant`` over
LLaMA-2-7B's prefill projections (M=512, W2 g128, ``MAIN_SHAPES``, summed
per layer as the kernels line sums them); ``quant_gemv`` times the decode
GEMV over the same projections at M=4 and at M=8 (the scheduled decode's 8
slots); ``decode_attention`` times ``chip_smoke.check_attention`` at the
LLaMA decode shape (B=4, S=144, kv_len 136, Hkv=32, G=1), Qwen3's (Hkv=4,
G=8) and the long lane (S = kv_len = 4096), and
``chip_smoke.check_paged_attention`` at the scheduled decode's (B=8, 23
pages of 16, ragged lengths, one slot inactive), beside SDPA;
``decode_step`` profiles one scheduled dense decode step of the RTN-packed
LLaMA-2-7B (8 live slots at position 200, max_seq 368, as
``chip_smoke.decode_profile``) and prints its wall and device-busy ms,
kernel launches and decode attention's device ms per step; ``moe_step``
the same for Qwen3-30B-A3B at depth 16 (phase 10's profile: each slot on
its own token), with the expert kernel's device ms and launches per step;
``int8_matmul`` times ``chip_smoke.check_int8`` over LLaMA-2-7B's 7
per-channel linears (f32 out) at M=512 and M=4, with ``torch._int_mm``
beside (timed here alike for both; at M=4 on x zero-padded to 17 rows, a
yardstick), the kernel's share of a g128 ``w4a8_matmul`` call (32
launches of K=128 column slices at M=512, N=4096), the M=512 layer again
through the checkout's own ``chip_smoke.cuda_ms`` and then at the end of
the process, the host path per call at M=4 (the wrapper,
``int8_matmul_config`` alone, ``torch._int_mm``), and hashes kernel 1's
outputs (``quant_matmul`` over
``chip_smoke.QM_PATHS`` and the prefill shapes, one expert-batched call):
the hashes must agree between the checkouts.
``quant_matmul_experts`` times one Qwen3-30B-A3B MoE layer's 3 expert
launches (E=128, W2 g128) on weights and traffic made by this script alike
for both checkouts: C=8 with every row live, and routed traffic (a seeded
uniform top-8 router, the capacity buffer zero past each expert's kept
rows) of 4 and 8 decode slots (C=8) and 512 prefill tokens (C=40), the
kept-row counts passed as ``rows`` where the checkout's wrapper takes them;
it hashes the routed outputs (equal across the checkouts, or the run
fails), kernel 1's outputs in two hashes, the paths at M >= 128 (equal,
or the run fails) and the rest (reported), and the GEMV's at M = 4 and 8
(equal, or the run fails: it shares the 2-bit table's code).  Each runs in
a fresh process per checkout: parent, this checkout, this checkout,
parent.  ``soft_round`` times ``chip_smoke.check_soft_round`` over the
three calibration paths' leaves (LLaMA-2-7B W2 g128, Qwen3-30B-A3B's
folded expert stacks and attention leaves, the W4 per-channel leaves),
forward and backward summed per layer in both readings; one LLaMA layer's
``soft_weight`` forward, and forward plus backward, with AWQ's act_scale
(the parent divides outside the kernels, this checkout in them), on the
device (a ~15 ms spin: the host's autograd path no longer sets the
reading) and by the events alone; a hash of
θ̂, dν and dv at one leaf, fused and unfused (the kernels with the division
outside), which must agree in every process; and one Soften step on
LLaMA-2-7B's block 0 at full width split into prepare and its pullback
(device time), the per-sample loop and AdamW by this script's own code.  Each process builds
its own checkout's kernels and checks them against the plain version
first.  The timing is this script's
own, the same in every process whatever its checkout's ``cuda_ms`` does:
CUDA events around each launch after an L2 flush, read twice, with a
device spin after the flush (``spin``: the device waits for the host, so a
launch shorter than its host path is timed on the device) and without it
(``nospin``: the events alone).  Prints the card's name and power limit,
then one ``RESULT <tag> <kernel> ms/layer ...`` line per process with the
kernel's and the library call's (``torch.matmul``, SDPA) times per layer
in both readings.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = """
import sys, time, torch
sys.path.insert(0, "src")
import chip_smoke as c
from repro_torch.kernels import build
from repro_torch.kernels.quant_gemv import quant_gemv, quant_gemv_plain
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_plain
torch.backends.cuda.matmul.allow_tf32 = False
build.load_library()
card = c.card_line()
gen = torch.Generator(device="cuda").manual_seed(0)
l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
SPIN_CYCLES = 300_000  # ~0.15 ms: longer than a wrapper's host path


def timer(spin):
    def cuda_ms(fn, iters=20, flush=None, **_):
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
    return cuda_ms




def step_profile(arch="llama2-7b", layers=None, n=8):
    # the decode-step profile of chip_smoke.decode_profile on the dense
    # store, counted here alike for both checkouts: the model RTN W2A16g128
    # packed from seed 0 (LLaMA-2-7B, phase 7; Qwen3-30B-A3B cut to
    # `layers`, phase 10, each slot on its own token so the slots route to
    # different experts), 8 live slots at position 200, max_seq 368; wall
    # and device-busy ms, kernel launches, decode attention's device ms and
    # the expert kernel's (for an MoE: at 8 slots every launch of
    # quant_matmul_kernel in a decode step is an expert one) per step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.data.pipeline import DataConfig, calibration_batches
    from repro_torch.launch.scheduler import compile_sched_steps
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model
    from repro_torch.models.common import DenseCacheStore
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    model = get_model(cfg)
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    params = model.init_params(0, "cuda")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=4,
                    seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(dc, 2, 1)]
    pfq, qmeta, _ = quantize_model(cfg, params, calib, qcfg, method="none",
                                   init="rtn")
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    del params, pfq
    torch.cuda.empty_cache()
    slots, max_seq = 8, 368
    steps = compile_sched_steps(cfg, max_seq=max_seq, kernel_backend="pallas")
    cs = DenseCacheStore(steps.model, slots=slots, max_seq=max_seq,
                         device="cuda")
    tok = torch.zeros((slots,), dtype=torch.int32, device="cuda")
    if layers:
        tok = torch.arange(1, slots + 1, dtype=torch.int32,
                           device="cuda") * 1009 % cfg.vocab_size
    state = {"cache": cs.cache, "tok": tok,
             "pos": torch.full((slots,), 200, dtype=torch.int32,
                               device="cuda")}
    active = torch.ones((slots,), dtype=torch.bool, device="cuda")

    def step():
        _, state["tok"], state["pos"], state["cache"] = steps.decode(
            packed, state["cache"], state["tok"], state["pos"], active, None)

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
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n
    attn = sum(e.self_device_time_total for e in kern
               if "decode_attention" in e.key) / 1e3 / n
    launches = sum(e.count for e in kern) / n
    qmm = [e for e in kern if "quant_matmul_kernel" in e.key]
    experts = sum(e.self_device_time_total for e in qmm) / 1e3 / n
    expert_launches = sum(e.count for e in qmm) / n
    return (f"wall {wall} busy {busy} launches {launches} "
            f"decode_attention {attn}"
            + (f" experts {experts} expert_launches {expert_launches}"
               if layers else ""))


def qm_digest():
    # kernel 1's outputs (quant_matmul over QM_PATHS and the LLaMA prefill
    # shapes, quant_matmul_experts at E=8) hashed bit for bit, so a change
    # that only moves its helpers can be shown to leave them as they were:
    # one hash of the paths at M >= 128 rows (the 128-row tile), one of the
    # rest (QM_PATHS' M = 33, 40, 64, 100 and the experts at C = 40); and
    # one of quant_gemv at the decode rows (M = 4 and 8 over the LLaMA
    # layer, 2 bits at g128 and g32), which shares the 2-bit table's code
    import hashlib
    from repro_torch.core.qtensor import pack
    from repro_torch.kernels.quant_matmul import quant_matmul_experts
    big, small, gemv = hashlib.sha256(), hashlib.sha256(), hashlib.sha256()
    g = torch.Generator(device="cuda").manual_seed(1)
    paths = c.QM_PATHS + tuple((512, K, N, 2, 128, 0)
                               for K, N, _ in c.MAIN_SHAPES)
    for M, K, N, bits, gs, off in paths:
        x, packed, scale, zero = c.quant_operands(g, M + off, K, N, bits, gs)
        y = quant_matmul(x[off:], packed, scale, zero, bits=bits,
                         group_size=gs)
        (big if M >= 128 else small).update(
            y.view(torch.int16).cpu().numpy().tobytes())
    codes = torch.randint(0, 4, (8, 2048, 768), generator=g, device="cuda",
                          dtype=torch.int32)
    scale = torch.rand((8, 16, 768), generator=g, device="cuda") + 0.005
    zero = torch.randint(0, 4, (8, 16, 768), generator=g,
                         device="cuda").float()
    x = torch.randn((8, 40, 2048), generator=g, device="cuda").bfloat16()
    y = quant_matmul_experts(x, pack(codes, 2), scale, zero, bits=2,
                             group_size=128)
    small.update(y.view(torch.int16).cpu().numpy().tobytes())
    for M in (4, 8):
        for K, N, _ in c.MAIN_SHAPES:
            for gs in (128, 32):
                x, packed, scale, zero = c.quant_operands(g, M, K, N, 2, gs)
                y = quant_gemv(x, packed, scale, zero, bits=2, group_size=gs)
                gemv.update(y.view(torch.int16).cpu().numpy().tobytes())
    return (f"{big.hexdigest()[:16]} {small.hexdigest()[:16]} "
            f"{gemv.hexdigest()[:16]}")


def expert_layer():
    # one Qwen3-30B-A3B MoE layer's 3 expert launches (2 x K=2048 N=768,
    # 1 x K=768 N=2048; E=128, W2 g128) on weights and traffic made here
    # alike for both checkouts: C=8 with every row live (random x), and
    # routed traffic (a seeded uniform top-8 router, the capacity buffer
    # zero past each expert's kept rows, dispatched here as the port's
    # moe._dispatch does) of 4 and 8 decode slots (C=8) and 512 prefill
    # tokens (C=40).  The checkout's wrapper gets the counts as rows where
    # it takes them; without them the result is the same function on these
    # inputs, so the routed outputs are hashed and must agree across the
    # checkouts.  Device time per layer in both readings.
    import hashlib
    import inspect
    from repro_torch.core.qtensor import pack
    from repro_torch.kernels.quant_matmul import quant_matmul_experts
    E, top_k = 128, 8
    takes_rows = "rows" in inspect.signature(
        quant_matmul_experts).parameters
    g = torch.Generator(device="cuda").manual_seed(2)
    weights = {}
    for K, N, _ in c.EXPERT_SHAPES:
        codes = torch.randint(0, 4, (E, K, N), generator=g, device="cuda",
                              dtype=torch.int32)
        scale = torch.rand((E, K // 128, N), generator=g,
                           device="cuda") * 0.015 + 0.005
        zero = torch.randint(0, 4, (E, K // 128, N), generator=g,
                             device="cuda").float()
        weights[(K, N)] = (pack(codes, 2), scale, zero)
        del codes

    def routed(tokens, C):
        logits = torch.randn((tokens, E), generator=g, device="cuda")
        idx = torch.topk(logits, top_k, dim=-1, sorted=True).indices
        flat = idx.reshape(-1)
        onehot = (flat[:, None] == torch.arange(E, device="cuda")).long()
        count = torch.cumsum(onehot, dim=0)
        pos = torch.sum((count - 1) * onehot, dim=1)
        slot = torch.where(pos < C, flat * C + pos, E * C)
        rows = torch.clamp(count[-1], max=C).to(torch.int32)
        tok = torch.arange(tokens * top_k, device="cuda") // top_k
        xs = {}
        for K in {K for K, _, _ in c.EXPERT_SHAPES}:
            t = torch.randn((tokens, K), generator=g, device="cuda")
            buf = torch.zeros((E * C + 1, K), dtype=torch.bfloat16,
                              device="cuda")
            buf[slot] = t.to(torch.bfloat16)[tok]
            xs[K] = buf[:-1].reshape(E, C, K)
        return xs, rows

    full = {K: torch.randn((E, 8, K), generator=g, device="cuda").bfloat16()
            for K in {K for K, _, _ in c.EXPERT_SHAPES}}
    cases = {"C=8 full": (full, None), "C=8 routed 4 slots": routed(4, 8),
             "C=8 routed 8 slots": routed(8, 8),
             "C=40 routed 512 tokens": routed(512, 40)}
    out, h = [], hashlib.sha256()
    for tag, (xs, rows) in cases.items():
        kw = dict(bits=2, group_size=128)
        if rows is not None and takes_rows:
            kw["rows"] = rows
        calls = [(lambda K=K, N=N: quant_matmul_experts(
            xs[K], *weights[(K, N)], **kw), cnt)
            for K, N, cnt in c.EXPERT_SHAPES]
        if rows is not None:
            for fn, _ in calls:
                h.update(fn().view(torch.int16).cpu().numpy().tobytes())
        touched = ("" if rows is None else
                   f" touched {int((rows > 0).sum())} kept {int(rows.sum())}")
        for reading, spin in (("spin", SPIN_CYCLES), ("nospin", 0)):
            t = timer(spin)
            ms = sum(cnt * t(fn, flush=l2.zero_) for fn, cnt in calls)
            out.append(f"{tag} {reading} {ms}{touched}")
    out.append(f"routed_digest {h.hexdigest()[:16]} rows_taken {takes_rows}")
    return out


def sr_leaf(g2, K, N, bits=2, gs=128):
    # one leaf's TesseraQ state as soft_weight reads it, with AWQ's
    # act_scale, and a cotangent for θ̂ (K, N)
    ops, dout = c.sr_operands(g2, K // gs, gs, N, bits)
    st = dict(zip(("base", "nu", "hard", "v", "scale", "zero"), ops))
    st["act_scale"] = torch.rand(K, generator=g2, device="cuda") + 0.5
    return st, dout.reshape(K, N)


def soft_weight_pass(st, cot, qc):
    # soft_weight forward (and, with cot, the pullback to ν and v), as the
    # Soften step calls it
    from repro_torch.core import tesseraq as tq
    if cot is None:
        return tq.soft_weight(st, qc, True)
    nu = st["nu"].detach().requires_grad_()
    v = st["v"].detach().requires_grad_()
    with torch.enable_grad():
        w = tq.soft_weight({**st, "nu": nu, "v": v}, qc, True)
        return (w,) + torch.autograd.grad(w, (nu, v), grad_outputs=cot)


# ~15 ms of device spin: longer than the host takes to enqueue one layer's
# soft_weight passes with their autograd, so the events read device time
LONG_SPIN = 100 * SPIN_CYCLES


def soft_weight_layer():
    # one LLaMA-2-7B layer's 7 leaves (W2 g128, DST on, act_scale as AWQ
    # leaves it): soft_weight forward alone, and forward plus backward,
    # device time (the long spin) and by the events alone
    from repro_torch.configs.base import QuantConfig
    qc = QuantConfig(bits=2, group_size=128, kernel_backend="pallas")
    leaves = [sr_leaf(gen, K, N) for K, N, cnt in c.MAIN_SHAPES
              for _ in range(cnt)]
    out = []
    for reading, spin in (("device", LONG_SPIN), ("nospin", 0)):
        t = timer(spin)
        fwd = t(lambda: [soft_weight_pass(st, None, qc)
                         for st, _ in leaves], flush=l2.zero_)
        both = t(lambda: [soft_weight_pass(st, cot, qc)
                          for st, cot in leaves], flush=l2.zero_)
        out.append(f"soft_weight_layer {reading} fwd {fwd} fwd_bwd {both}")
    return "; ".join(out)


def soft_round_digest():
    # θ̂, dν and dv of soft_weight with act_scale at one LLaMA leaf (32 x
    # 128 x 4096, W2), hashed bit for bit, beside the unfused reading: the
    # kernels with the division outside them
    import hashlib
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels.soft_round import soft_round, soft_round_bwd
    qc = QuantConfig(bits=2, group_size=128, kernel_backend="pallas")
    st, cot = sr_leaf(torch.Generator(device="cuda").manual_seed(1), 4096,
                      4096)
    act = st["act_scale"]
    fused = soft_weight_pass(st, cot, qc)
    ops = [st[k] for k in ("base", "nu", "hard", "v", "scale", "zero")]
    kw = dict(qmax=3, dst=True)
    unfused = (soft_round(*ops, **kw).reshape(4096, 4096) / act[:, None],
               *soft_round_bwd((cot / act[:, None]).reshape(32, 128, 4096),
                               *ops, **kw))
    h = lambda t: hashlib.sha256(t.detach().contiguous().view(
        torch.int32).cpu().numpy().tobytes()).hexdigest()[:16]
    return "digest " + " ".join(f"{k} {h(a)} {h(b)}" for k, a, b in zip(
        ("theta", "dnu", "dv"), fused, unfused, strict=True))


def soften_split():
    # one Soften step on LLaMA-2-7B's block 0 at full width (AWQ init,
    # half the variables hardened, batch 4 x 512), split as the smoke's
    # step profile splits it, with the same code for both checkouts:
    # prepare (θ̂ of the 7 leaves), its pullback under a fixed cotangent,
    # the per-sample loop (canonical_grad less both), AdamW
    from repro_torch.configs import get_config
    from repro_torch.core import recon_engine as RE
    from repro_torch.core import tesseraq as tq
    from repro_torch.core.awq import quantize_block_awq
    from repro_torch.core.blocks import build_stages, get_path
    from repro_torch.core.capture import (capture_block_inputs,
                                          split_minibatches)
    from repro_torch.data.pipeline import DataConfig, calibration_batches
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model
    from repro_torch.optim.adam import AdamW
    cfg = get_config("llama2-7b").replace(num_layers=1)
    params = get_model(cfg).init_params(0, "cuda")
    qcfg = parse_quant("W2A16g128", kernel_backend="pallas")
    tcfg = tq.TesseraQConfig(par_iterations=c.CAL_K,
                             steps_per_iteration=c.CAL_T,
                             batch_size=c.CAL_BS)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=c.CAL_SEQ,
                    global_batch=c.CAL_BS, seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device="cuda")}
             for b in calibration_batches(dc, c.CAL_SAMPLES // c.CAL_BS,
                                          c.CAL_BS)]
    stage = build_stages(cfg)[0]
    with torch.no_grad():
        X = torch.cat([stage.init_x(params, b) for b in calib], 0)
        bp = stage.get_block(params, 0)
        parts = split_minibatches(X)
        Y = torch.cat([stage.apply(bp, x) for x in parts], 0).float()
        _, meta = quantize_block_awq(bp, capture_block_inputs(
            stage.apply, bp, parts), qcfg)
    states = RE.harden_device({p: tq._leaf_state(get_path(bp, p), meta[p],
                                                 qcfg) for p in meta},
                              0.5, False)
    obj = tq._make_loss_fn(stage.apply, qcfg, tcfg)
    tr = tq._trainables(states, True)
    frozen = {"bp": bp, "sts": {p: {k: v for k, v in st.items()
                                    if k not in ("nu", "v")}
                                for p, st in states.items()}}
    xb, yb = X[:c.CAL_BS], Y[:c.CAL_BS]
    chunks = RE.grad_chunk_count(c.CAL_BS, X.shape[0])
    g2 = torch.Generator(device="cuda").manual_seed(3)
    cot = {p: torch.randn(tq._wshape(d["nu"]), generator=g2, device="cuda")
           for p, d in tr.items()}

    def prepare(pull=False):
        with torch.enable_grad():
            req = {p: {k: t.detach().requires_grad_() for k, t in d.items()}
                   for p, d in tr.items()}
            inter = obj.prepare(req, frozen)
            if pull:
                torch.autograd.grad(
                    [inter[("w",) + p] for p in req],
                    [t for d in req.values() for t in d.values()],
                    grad_outputs=[cot[p] for p in req])

    def grad():
        return RE.canonical_grad(obj, tr, frozen, xb, yb, chunks)

    opt = AdamW(lr=tcfg.lr)
    ost = opt.init(tr)
    _, grads = grad()
    # prepare and its pullback on the device (an L2 flush, then the long
    # spin); the step's pieces as the smoke's step profile reads them
    dev = timer(LONG_SPIN)  # spins after each flush
    prep = dev(prepare, iters=5, flush=l2.zero_)
    pull = dev(lambda: prepare(True), iters=5, flush=l2.zero_) - prep
    cg = c.cuda_ms(grad, iters=5)
    adam = c.cuda_ms(lambda: opt.update(grads, ost, tr), iters=5)
    return (f"soften_step prepare {prep} pullback {pull} per_sample "
            f"{cg - prep - pull} canonical_grad {cg} adamw {adam} step "
            f"{cg + adam}")


name = sys.argv[2]
out = []
if name == "int8_matmul":
    # one LLaMA-2-7B layer's 7 per-channel linears (f32 out) through the
    # checkout's check_int8 at M=512 and M=4, with torch._int_mm timed here
    # alike for both checkouts (w_q column-major; at M=4 on x zero-padded
    # to 17 rows, the smallest M it takes: a yardstick)
    smoke_ms = c.cuda_ms  # the checkout's own timer, read once below

    def int8_layer(M, library=True):
        kern = nospin = lib = 0.0
        for K, N, cnt in c.MAIN_SHAPES:
            rec = c.check_int8(gen, M, K, N, l2.zero_, card,
                               path="main" if M > 16 else "decode")
            kern += cnt * rec["kernel_ms"]
            nospin += cnt * rec.get("kernel_ms_nospin", float("nan"))
            if not library:
                continue
            xp = torch.zeros((max(M, 17), K), dtype=torch.int8,
                             device="cuda")
            xp[:M] = torch.randint(-128, 128, (M, K), generator=gen,
                                   device="cuda", dtype=torch.int8)
            wc = torch.randint(-128, 128, (K, N), generator=gen,
                               device="cuda",
                               dtype=torch.int8).t().contiguous().t()
            lib += cnt * c.cuda_ms(lambda: torch._int_mm(xp, wc),
                                   flush=l2.zero_)
        return kern, nospin, lib

    for M in (512, 4):
        for reading, spin in (("spin", SPIN_CYCLES), ("nospin", 0)):
            c.cuda_ms = timer(spin)  # check_int8 times through this name
            kern, _, lib = int8_layer(M)
            out.append(f"M={M} {reading} {kern} library {lib}")
    # the kernel's share of one w4a8_matmul g128 call at prefill: 32
    # launches of K = 128 column slices (lda 4096) at M=512, N=4096
    for reading, spin in (("spin", SPIN_CYCLES), ("nospin", 0)):
        c.cuda_ms = timer(spin)
        rec = c.check_int8(gen, 512, 128, 4096, l2.zero_, card, lda=4096)
        out.append(f"g128 {reading} {32 * rec['kernel_ms']}")
    # the M=512 layer again: through the checkout's own chip_smoke.cuda_ms
    # (its spun reading, and the events alone where its check_int8 records
    # them), then through this script's timer at the end of the process, so
    # a gap between chip_smoke's and this script's readings can be put on
    # the timer or on the process's history
    c.cuda_ms = smoke_ms
    kern, nospin, _ = int8_layer(512, library=False)
    out.append(f"M=512 smoke_timer {kern} nospin {nospin}")
    c.cuda_ms = timer(SPIN_CYCLES)
    kern, _, _ = int8_layer(512, library=False)
    out.append(f"M=512 spin_again {kern}")
    # the host path per call (host clock over 200 enqueues, no sync between
    # them) at M=4, N=K=4096: the wrapper, its plan and tensor-map encodes
    # alone (int8_matmul_config, where the checkout has it), torch._int_mm
    import repro_torch.kernels.int8_matmul as i8
    xq = torch.randint(-128, 128, (4, 4096), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (4096, 4096), generator=gen,
                       device="cuda", dtype=torch.int8)
    xs = torch.rand((4, 1), generator=gen, device="cuda") + 1e-3
    ws = torch.rand((1, 4096), generator=gen, device="cuda") + 1e-3
    x17 = torch.zeros((17, 4096), dtype=torch.int8, device="cuda")
    calls = {"int8_matmul": lambda: i8.int8_matmul(xq, wq, xs, ws,
                                                   out_dtype=torch.float32),
             "_int_mm": lambda: torch._int_mm(x17, wq)}
    if hasattr(i8, "int8_matmul_config"):
        calls["config"] = lambda: i8.int8_matmul_config(xq, wq)
    for tag, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / 200
        torch.cuda.synchronize()
        out.append(f"host_us {tag} {us}")
    out.append(f"qm_digest {qm_digest()}")
elif name == "soft_round":
    # the three paths' forward and backward per layer through the
    # checkout's check_soft_round (the LLaMA W2 g128 leaves, Qwen3's folded
    # expert stacks and attention leaves, the W4 per-channel leaves), summed
    # as its kernels line sums them, in both readings
    paths = (
        ("main", [(ng, c.SR_G, n, 2) for ng, n, _ in c.SR_SHAPES],
         c.sr_layer(c.SR_SHAPES, c.SR_G)),
        ("moe", [(ng, c.SR_G, n, 2) for ng, n, _ in c.MOE_SR_SHAPES],
         c.sr_layer(c.MOE_SR_SHAPES, c.SR_G)),
        ("wa", [(1, K, N, 4) for K, N, _ in c.MAIN_SHAPES],
         {(1, K, N): cnt for K, N, cnt in c.MAIN_SHAPES}))
    for reading, spin in (("spin", SPIN_CYCLES), ("nospin", 0)):
        c.cuda_ms = timer(spin)  # check_soft_round times through this name
        for tag, shapes, per_layer in paths:
            recs = [c.check_soft_round(gen, ng, n, bits, True, l2.zero_, card,
                                       **{tag: True}, g=g)
                    for ng, g, n, bits in shapes]
            f, b = (c.summarize_soft_round(recs, d, tag, per_layer)
                    for d in ("fwd", "bwd"))
            out.append(f"{tag} {reading} fwd {f['ms']} bwd {b['ms']} bound "
                       f"{f['bound_ms']} {b['bound_ms']}")
    c.cuda_ms = timer(SPIN_CYCLES)
    out.append(soft_weight_layer())
    out.append(soft_round_digest())
    out.append(soften_split())
elif name == "decode_step":
    out.append(step_profile())
elif name == "mesh_train":
    import contextlib
    import io
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        c.mesh_train_phase(card)
    print(text.getvalue(), flush=True)
    out += [ln for ln in text.getvalue().splitlines()
            if ln.startswith(("[mesh-train] (c", "[time] phase 21"))]
elif name == "moe_step":
    out.append(step_profile("qwen3-moe-30b-a3b", layers=16))
elif name == "quant_matmul_experts":
    out += expert_layer()
    out.append(f"qm_digest {qm_digest()}")
elif name == "decode_attention":
    lens = [368, 17, 300, 255, 96, 1, 351, 160]
    act = [1, 1, 1, 0, 1, 1, 1, 1]
    shapes = {
        "main": lambda f: c.check_attention(
            gen, 4, 144, 32, 1, 128, [136] * 4, [135] * 4, [1] * 4, f, card),
        "moe": lambda f: c.check_attention(
            gen, 4, 144, 4, 8, 128, [136] * 4, [135] * 4, [1] * 4, f, card),
        "long": lambda f: c.check_attention(
            gen, 4, 4096, 32, 1, 128, [4096] * 4, [4095] * 4, [1] * 4, f,
            card),
        "paged": lambda f: c.check_paged_attention(
            gen, 8, 23, 16, 32, 1, 128, lens, act, f, card)}
    for tag, run in shapes.items():
        for reading, spin in (("spin", SPIN_CYCLES), ("nospin", 0)):
            c.cuda_ms = timer(spin)  # the checks time through this name
            rec = run(l2.zero_)
            out.append(f"{tag} {reading} {rec['kernel_ms']} library "
                       f"{rec['library_ms']}")
else:
    fn, plain, rows = {
        "quant_matmul": (quant_matmul, quant_matmul_plain, (512,)),
        "quant_gemv": (quant_gemv, quant_gemv_plain, (4, 8))}[name]
    for M in rows:
        for reading, spin in (("spin", SPIN_CYCLES), ("nospin", 0)):
            c.cuda_ms = timer(spin)  # check_quant times through this name
            recs = [c.check_quant(name, fn, plain, gen, M, K, N, 2, 128,
                                  l2.zero_, card, main=True)
                    for K, N, _ in c.MAIN_SHAPES]
            sm = c.summarize(recs, name)
            out.append(f"M={M} {reading} {sm['ms']} library "
                       f"{sm['library_ms']}")
print("RESULT", sys.argv[1], name, "ms/layer", "; ".join(out), flush=True)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", help="checkout of the commit to compare with")
    ap.add_argument("--kernel", choices=("quant_matmul", "quant_gemv",
                                         "decode_attention", "decode_step",
                                         "int8_matmul", "soft_round",
                                         "quant_matmul_experts", "moe_step",
                                         "mesh_train"),
                    default="quant_matmul")
    ap.add_argument("--log", help="directory for each process's output")
    args = ap.parse_args()
    parent = os.path.abspath(args.parent)
    if not os.path.isfile(os.path.join(parent, "chip_smoke.py")):
        print(f"chip_ab: no chip_smoke.py in {parent}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    digests, big, small, gemv, routed = set(), set(), set(), set(), set()
    sr_digests = []
    for n, (tag, where) in enumerate((("parent", parent), ("change", HERE),
                                      ("change", HERE), ("parent", parent))):
        out = subprocess.run([sys.executable, "-c", CHILD, tag, args.kernel],
                             cwd=where, capture_output=True, text=True,
                             timeout=900)
        if args.log:
            os.makedirs(args.log, exist_ok=True)
            with open(os.path.join(args.log, f"{n}_{tag}.log"), "w") as f:
                f.write(out.stdout + out.stderr)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT")]
        if out.returncode or len(lines) != 1:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            print(f"chip_ab: the {tag} run failed ({out.returncode})",
                  file=sys.stderr)
            return 1
        print(lines[0], flush=True)
        for part in lines[0].split("; "):
            words = part.split()
            if words[0] == "qm_digest":
                digests.add(" ".join(words[1:]))
                big.add(words[1])
                small.add(words[2])
                gemv.add(words[3] if len(words) > 3 else None)
            if words[0] == "routed_digest":
                routed.add(words[1])
        for part in lines[0].split("; "):
            if part.startswith("digest "):
                words = part.split()[1:]
                sr_digests.append((tag, {words[i]: words[i + 1:i + 3]
                                         for i in range(0, len(words), 3)}))
    if args.kernel == "soft_round":
        # in every process the fused reading equals the unfused one; across
        # the checkouts θ̂ and dν are elementwise (equal), dv's order of
        # summation is the kernel's own
        bad = [(tag, k) for tag, d in sr_digests for k, (a, b) in d.items()
               if a != b]
        for k in ("theta", "dnu", "dv"):
            seen = sorted({d[k][0] for _, d in sr_digests})
            print(f"soft_weight {k} hashes across the checkouts: {seen}",
                  flush=True)
        print(f"soft_weight with act_scale: fused == unfused in every "
              f"process: {not bad} {bad}", flush=True)
        if bad:
            return 1
    if args.kernel == "quant_matmul_experts":
        # the routed outputs, kernel 1's M >= 128 paths and the GEMV's must
        # be bit for bit the parent's; the small-M paths may change with the
        # row tile
        print(f"routed expert outputs "
              f"{'bit-identical' if len(routed) == 1 else 'DIFFER'} between "
              f"the checkouts: {sorted(routed)}", flush=True)
        print(f"quant_matmul outputs at M >= 128 "
              f"{'bit-identical' if len(big) == 1 else 'DIFFER'}: "
              f"{sorted(big)}; at M < 128 (and the experts at C = 40) "
              f"{'bit-identical' if len(small) == 1 else 'changed'}: "
              f"{sorted(small)}; quant_gemv "
              f"{'bit-identical' if len(gemv) == 1 else 'DIFFER'}: "
              f"{sorted(gemv)}", flush=True)
        if len(routed) != 1 or len(big) != 1 or len(gemv) != 1:
            return 1
    if args.kernel == "int8_matmul":
        same = len(digests) == 1
        print(f"quant_matmul outputs {'bit-identical' if same else 'DIFFER'}"
              f" between the checkouts: {sorted(digests)}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
