#!/usr/bin/env python3
"""Same-call A/B of the quant-matmul kernel between two checkouts on one GPU.

    python3 chip_ab.py PARENT_DIR

Times ``chip_smoke.check_quant`` over LLaMA-2-7B's prefill projections
(M=512, W2 g128, ``MAIN_SHAPES``, summed per layer as the kernels line sums
them) in a fresh process per checkout: parent, this checkout, this
checkout, parent.  Each process builds its own checkout's kernels and
checks them against the plain version first.  Prints the card's name and
power limit, then one ``RESULT <tag> quant_matmul ms/layer <t>`` line per
process.
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
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_plain
torch.backends.cuda.matmul.allow_tf32 = False
build.load_library()
card = c.card_line()
gen = torch.Generator(device="cuda").manual_seed(0)
l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
recs = [c.check_quant("quant_matmul", quant_matmul, quant_matmul_plain, gen,
                      512, K, N, 2, 128, l2.zero_, card, main=True)
        for K, N, _ in c.MAIN_SHAPES]
print("RESULT", sys.argv[1], "quant_matmul ms/layer",
      c.summarize(recs, "quant_matmul")["ms"], flush=True)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", help="checkout of the commit to compare with")
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
        out = subprocess.run([sys.executable, "-c", CHILD, tag], cwd=where,
                             capture_output=True, text=True, timeout=900)
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
