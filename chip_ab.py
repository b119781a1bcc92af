#!/usr/bin/env python3
"""Same-call A/B of a kernel between two checkouts on one GPU.

    python3 chip_ab.py PARENT_DIR
        [--kernel quant_matmul|quant_gemv|decode_attention|decode_step]

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
kernel launches and decode attention's device ms per step.  Each runs in
a fresh process per checkout: parent, this checkout, this checkout,
parent.  Each process builds its own checkout's kernels and
checks them against the plain version first.  The timing is this script's
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




def step_profile(n=8):
    # the phase-7 decode-step profile of chip_smoke.decode_profile on the
    # dense store, counted here alike for both checkouts: LLaMA-2-7B RTN
    # W2A16g128 packed from seed 0, 8 live slots at position 200, max_seq
    # 368; wall and device-busy ms, kernel launches and decode attention's
    # device ms per step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_model, quantize_model
    from repro_torch.data.pipeline import DataConfig, calibration_batches
    from repro_torch.launch.scheduler import compile_sched_steps
    from repro_torch.launch.serve import parse_quant
    from repro_torch.models import get_model
    from repro_torch.models.common import DenseCacheStore
    cfg = get_config("llama2-7b")
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
    state = {"cache": cs.cache,
             "tok": torch.zeros((slots,), dtype=torch.int32, device="cuda"),
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
    return (f"wall {wall} busy {busy} launches {launches} "
            f"decode_attention {attn}")


name = sys.argv[2]
out = []
if name == "decode_step":
    out.append(step_profile())
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
                                         "decode_attention", "decode_step"),
                    default="quant_matmul")
    args = ap.parse_args()
    parent = os.path.abspath(args.parent)
    if not os.path.isfile(os.path.join(parent, "chip_smoke.py")):
        print(f"chip_ab: no chip_smoke.py in {parent}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for tag, where in (("parent", parent), ("change", HERE),
                       ("change", HERE), ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", CHILD, tag, args.kernel],
                             cwd=where, capture_output=True, text=True,
                             timeout=900)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT")]
        if out.returncode or len(lines) != 1:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            print(f"chip_ab: the {tag} run failed ({out.returncode})",
                  file=sys.stderr)
            return 1
        print(lines[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
