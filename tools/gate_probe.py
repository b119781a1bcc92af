"""Why the EVAL harness's ``"xla"`` vs ``"pallas"`` logits gate fails on a
CUDA card: the gate's packed TesseraQ model served under both backends,
with the ``"xla"`` path's arithmetic varied one piece at a time.

For each harness setting (``--smoke``, ``--reduced``, the defaults) and
each source of the FP params (drawn on the card, or drawn on the CPU and
moved to the card), the harness runs once and its gate's packed model is
served again under these ``"xla"`` variants:

* ``as_is``: the port's ``"xla"`` path;
* ``f32_reduce``: cuBLAS may not reduce bf16 products in reduced
  precision (``allow_bf16_reduced_precision_reduction = False``);
* ``f32_dequant``: ``QTensor.dequantize`` in f32 from the f32 scale and
  zero, rounded to bf16 once (as the kernels do);
* ``f32_dequant_reduce``: both.

Each line gives the gate's verdict and max |diff|, the first step whose
greedy tokens differ, and the per-step max |diff|.

    PYTHONPATH=src python tools/gate_probe.py [--settings smoke reduced default]

Needs a CUDA card (~2-4 min on an H100 with the kernels built);
``--device cpu --settings smoke`` runs the same on the plain versions.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import numpy as np
import torch

from repro_torch.bridge import params_to
from repro_torch.core import qtensor
from repro_torch.eval import harness
from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul import dequantize_rows
from repro_torch.launch.serve import serve_requests

SETTINGS = {"smoke": ["--smoke"], "reduced": ["--reduced"], "default": []}


def _f32_dequantize(self, dtype=torch.bfloat16):
    """``QTensor.dequantize`` with the kernels' rounding (their plain
    version's ``dequantize_rows``)."""
    return dequantize_rows(self.packed, self.scale, self.zero,
                           bits=self.bits, group_size=self.group_size,
                           dtype=dtype)


@contextlib.contextmanager
def variant(name):
    """The ``"xla"`` path's arithmetic as ``name`` (one of ``VARIANTS``)
    says, restored on exit."""
    mm = torch.backends.cuda.matmul
    prev_red, prev_dq = (mm.allow_bf16_reduced_precision_reduction,
                         qtensor.QTensor.dequantize)
    if "reduce" in name:
        mm.allow_bf16_reduced_precision_reduction = False
    if "dequant" in name:
        qtensor.QTensor.dequantize = _f32_dequantize
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev_red
        qtensor.QTensor.dequantize = prev_dq


VARIANTS = ("as_is", "f32_reduce", "f32_dequant", "f32_dequant_reduce")


def probe(setting, source, device):
    args = harness.parse_args(SETTINGS[setting] + ["--device", device,
                                                   "--json", ""])
    params = None
    if source == "cpu_drawn":
        from repro_torch.configs import get_config, get_reduced_config
        from repro_torch.models import get_model
        cfg = (get_reduced_config(args.arch) if args.reduced
               else get_config(args.arch))
        params = params_to(get_model(cfg).init_params(args.seed, "cpu"),
                           device)
    kept = {}
    orig = harness.logits_parity

    def keep(cfg, model, packed, prompts, **kw):
        kept.update(cfg=cfg, model=model, packed=packed, prompts=prompts,
                    kw=kw)
        return orig(cfg, model, packed, prompts, **kw)

    harness.logits_parity = keep
    t0 = time.perf_counter()
    try:
        out = harness.run_harness(args, params)
    finally:
        harness.logits_parity = orig
    secs = time.perf_counter() - t0
    print(f"[probe] {setting} {source}: harness gate {out['parity']} "
          f"({secs:.1f}s)", flush=True)
    kw = kept["kw"]
    ref = serve_requests(kept["cfg"], kept["model"], kept["packed"],
                         kept["prompts"], gen=kw["gen"],
                         kernel_backend="pallas", device=device)
    for name in VARIANTS:
        with variant(name):
            x = serve_requests(kept["cfg"], kept["model"], kept["packed"],
                               kept["prompts"], gen=kw["gen"],
                               kernel_backend="xla", device=device)
        gate = harness.parity_gate(x.logits, ref.logits, atol=kw["atol"],
                                   rtol=kw["rtol"])
        same = x.tokens == ref.tokens
        first = [int(np.argmin(r)) if not r.all() else None for r in same]
        per_step = [float(np.abs(x.logits[:, j] - ref.logits[:, j]).max())
                    for j in range(ref.logits.shape[1])]
        print(f"[probe] {setting} {source} {name}: ok {gate['ok']} max|d| "
              f"{gate['max_abs_diff']:.6g}; first flipped step {first}; "
              f"per-step max|d| {per_step}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", nargs="+", default=list(SETTINGS),
                    choices=list(SETTINGS))
    ap.add_argument("--sources", nargs="+",
                    default=["card_drawn", "cpu_drawn"],
                    choices=["card_drawn", "cpu_drawn"])
    ap.add_argument("--device", default="cuda",
                    help="'cpu' serves the kernels' plain versions")
    a = ap.parse_args()
    if a.device == "cpu":
        for s in a.settings:
            for src in a.sources:
                probe(s, src, "cpu")
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[probe] card=[{card}] torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library(verbose=False)
    for s in a.settings:
        for src in a.sources:
            probe(s, src, "cuda")


if __name__ == "__main__":
    main()
