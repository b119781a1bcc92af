#!/usr/bin/env python3
"""Same-call A/B of a quantized-matmul kernel between two checkouts on one
GPU.

    python3 chip_ab.py PARENT_DIR [--kernel quant_matmul|quant_gemv]

``quant_matmul`` (the default) times ``chip_smoke.check_quant`` over
LLaMA-2-7B's prefill projections (M=512, W2 g128, ``MAIN_SHAPES``, summed
per layer as the kernels line sums them); ``quant_gemv`` times the decode
GEMV over the same projections at M=4 and at M=8 (the scheduled decode's 8
slots).  Each runs in a fresh process per checkout: parent, this checkout,
this checkout, parent.  Each process builds its own checkout's kernels and
checks them against the plain version first.  The timing is this script's
own, the same in every process whatever its checkout's ``cuda_ms`` does:
CUDA events around each launch after an L2 flush, read twice, with a
device spin after the flush (``spin``: the device waits for the host, so a
launch shorter than its host path is timed on the device) and without it
(``nospin``: the events alone).  Prints the card's name and power limit,
then one ``RESULT <tag> <kernel> ms/layer ...`` line per process with the
kernel's and ``torch.matmul``'s times per layer in both readings.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = """
import sys, torch
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


name = sys.argv[2]
fn, plain, rows = {"quant_matmul": (quant_matmul, quant_matmul_plain, (512,)),
                   "quant_gemv": (quant_gemv, quant_gemv_plain, (4, 8))}[name]
out = []
for M in rows:
    for reading, spin in (("spin", SPIN_CYCLES), ("nospin", 0)):
        c.cuda_ms = timer(spin)  # check_quant times through this name
        recs = [c.check_quant(name, fn, plain, gen, M, K, N, 2, 128,
                              l2.zero_, card, main=True)
                for K, N, _ in c.MAIN_SHAPES]
        sm = c.summarize(recs, name)
        out.append(f"M={M} {reading} {sm['ms']} library {sm['library_ms']}")
print("RESULT", sys.argv[1], name, "ms/layer", "; ".join(out), flush=True)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", help="checkout of the commit to compare with")
    ap.add_argument("--kernel", choices=("quant_matmul", "quant_gemv"),
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
