"""TesseraQ across architecture families on the PyTorch port: quantize one
reduced model of every family (dense, MoE, RWKV, hybrid, the
encoder-decoder, VLM) and report the block-reconstruction error against the
AWQ initialization — ``examples/quantize_every_family.py``'s run (the
method is architecture-agnostic) on ``src/repro_torch``.

    PYTHONPATH=src python examples/quantize_every_family_torch.py [--device cpu]

The calibration's soft-rounding goes through the hand-written kernels (the
``"pallas"`` backend; their plain versions on the CPU).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.tesseraq import TesseraQConfig
from repro_torch.models import get_model
from repro_torch.models.transformer import model_dtype

ARCHS = ["tinyllama-1.1b", "qwen3-moe-30b-a3b", "rwkv6-3b", "zamba2-1.2b",
         "whisper-small", "paligemma-3b"]


def make_batches(cfg, rng, dev, n=1, bs=4, seq=24):
    out = []
    for _ in range(n):
        b = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (bs, seq)), device=dev)}
        if cfg.family == "encdec":
            b["frames"] = torch.as_tensor(
                rng.normal(size=(bs, cfg.frontend_len, cfg.d_model)) * .1,
                dtype=torch.float32, device=dev).to(model_dtype(cfg))
        if cfg.family == "vlm":
            b["patches"] = torch.as_tensor(
                rng.normal(size=(bs, cfg.num_patches, cfg.d_model)) * .1,
                dtype=torch.float32, device=dev).to(model_dtype(cfg))
        out.append(b)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the comparison; returns {arch: {"family", "awq", "tesseraq",
    "secs"}} (the mean block recon_mse of each walk)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    qcfg = QuantConfig(bits=3, group_size=16, kernel_backend="pallas")
    tcfg = TesseraQConfig(par_iterations=3, steps_per_iteration=12)
    rng = np.random.default_rng(0)
    out = {}
    print(f"{'arch':24s} {'family':8s} {'awq mse':>12s} {'tesseraq mse':>14s}")
    for arch in ARCHS:
        t0 = time.perf_counter()
        cfg = get_reduced_config(arch)
        params = get_model(cfg).init_params(0, dev)
        batches = make_batches(cfg, rng, dev)
        _, _, rep_awq = quantize_model(cfg, params, batches, qcfg,
                                       method="none", init="awq", tcfg=tcfg)
        _, _, rep_tq = quantize_model(cfg, params, batches, qcfg,
                                      method="tesseraq", init="awq",
                                      tcfg=tcfg)
        e_awq = float(np.mean([b["recon_mse"] for b in rep_awq["blocks"]]))
        e_tq = float(np.mean([b["recon_mse"] for b in rep_tq["blocks"]]))
        mark = "OK " if e_tq <= e_awq * 1.02 else "?? "
        out[arch] = {"family": cfg.family, "awq": e_awq, "tesseraq": e_tq,
                     "secs": time.perf_counter() - t0}
        print(f"{arch:24s} {cfg.family:8s} {e_awq:12.3e} {e_tq:14.3e} {mark}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
