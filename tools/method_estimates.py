"""CPU estimates behind the limits of ``chip_smoke.py``'s methods phase
(phase 13), from the port alone:

* rotation: relative L2 of the FP logits of a dense model rotated by
  ``core.rotation.rotate_params`` against the unrotated model's, in bf16 at
  depth 2 and several widths (random weights, seed 0; 2 x 128 tokens);
* GPTQ: the share of ``_gptq_matrix`` codes that move when only the
  float rounding of its linear algebra changes (the CPU's intra-op thread
  count: MKL blocks the inverse and the products differently), on a
  LLaMA-2-7B ``wq``-shaped slice (4096 inputs, rms-normed Gaussian rows,
  W2 g128).

    PYTHONPATH=src python tools/method_estimates.py [--columns 512]

Takes ~1-2 min on 8 CPU cores.  A CPU run says nothing of the card's
speed; its numbers only size the phase's limits.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.gptq import _gptq_matrix
from repro_torch.core.rotation import rotate_params
from repro_torch.models import get_model, transformer


def rotation_drift():
    base = get_config("llama2-7b").replace(num_layers=2)
    cfgs = {"d64": get_reduced_config("llama2-7b"),
            "d1024": base.replace(d_model=1024, num_heads=8, num_kv_heads=8,
                                  d_ff=2752, vocab_size=4000),
            "d4096": base.replace(d_ff=2752, vocab_size=2000)}
    for name, cfg in cfgs.items():
        p = get_model(cfg).init_params(0, "cpu")
        rp = rotate_params(p, cfg, seed=0)
        toks = torch.randint(0, cfg.vocab_size, (2, 128),
                             generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            a = transformer.forward(p, cfg, toks).float()
            b = transformer.forward(rp, cfg, toks).float()
        rel = float((a - b).norm() / a.norm())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"rotation {name} {cfg.dtype}: relative L2 {rel:.4g}, argmax "
              f"agreement {agree:.4f}", flush=True)


def gptq_sensitivity(columns: int):
    g = torch.Generator().manual_seed(0)
    X = torch.randn(16384, 4096, generator=g)
    X = X / X.pow(2).mean(-1, keepdim=True).sqrt()
    W = (torch.randn(4096, columns, generator=g) * 4096 ** -0.5).to(
        torch.bfloat16).float()
    H = X.T @ X
    qc = QuantConfig(bits=2, group_size=128)
    n = torch.get_num_threads()
    runs = {}
    for th in sorted({1, n}):
        torch.set_num_threads(th)
        t0 = time.perf_counter()
        runs[th] = _gptq_matrix(W, H, qc)
        print(f"gptq {tuple(W.shape)} at {th} thread(s): "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    torch.set_num_threads(n)
    a, b = runs[1], runs[n]
    share = float((a[3] != b[3]).float().mean())
    print(f"gptq codes moved by the thread count (1 vs {n}): {share:.4g}; "
          f"max |fq diff| {float((a[0] - b[0]).abs().max()):.4g}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--columns", type=int, default=512)
    args = ap.parse_args(argv)
    rotation_drift()
    gptq_sensitivity(args.columns)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
