"""Quickstart on the PyTorch port: train a toy LM, quantize it to 2 bits
with TesseraQ and compare against RTN / AWQ — ``examples/quickstart.py``'s
run (the paper's headline experiment at laptop scale) on
``src/repro_torch``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The calibration's soft-rounding and the packed model's perplexity go
through the hand-written kernels (the ``"pallas"`` backend; their plain
versions on the CPU).  The toy model is bf16, where the reference's is
float32, because the card's quant-matmul kernel takes bf16 activations.
"""
import argparse
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.pipeline import (pack_model, quantize_model,
                                       quantized_memory_report)
from repro_torch.core.tesseraq import TesseraQConfig
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.eval.ppl import perplexity
from repro_torch.launch.steps import make_train_harness


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the quickstart; returns its numbers: ``train_loss``, ``ppl``
    (fp16, rtn, awq, tesseraq), ``ppl_packed``, ``report`` and ``secs``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    t_start = time.perf_counter()
    # a small llama-family model, briefly trained so quantization error is
    # meaningful (random weights quantize "perfectly" and show nothing)
    cfg = get_reduced_config("llama2-7b").replace(
        num_layers=4, d_model=96, d_ff=256, vocab_size=512, dtype="bfloat16")
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=8))
    harness = make_train_harness(cfg, None, lr=2e-3)
    params = harness.init_params(0, dev)
    opt = harness.init_opt(params)
    print("training the toy LM (120 steps)...")
    t0 = time.perf_counter()
    for s in range(120):
        params, opt, m = harness.step_fn(params, opt, data.batch(s))
    train_loss = float(m["loss"])
    t_train = time.perf_counter() - t0
    print(f"  final train loss {train_loss:.3f} ({t_train:.1f}s)")

    calib = [{"tokens": torch.as_tensor(
        data.batch(10_000 + i)["tokens"][:4, :-1], device=dev)}
        for i in range(2)]
    evalb = [{"tokens": data.batch(20_000 + i)["tokens"]} for i in range(4)]
    qcfg = QuantConfig(bits=2, group_size=16, kernel_backend="pallas")
    tcfg = TesseraQConfig(par_iterations=5, steps_per_iteration=25)

    ppl = {"fp16": perplexity(cfg, params, evalb)}
    print(f"\n{qcfg.tag} perplexity (lower is better):")
    print(f"  fp16      : {ppl['fp16']:8.2f}")
    t0 = time.perf_counter()
    for label, method, init in [("rtn", "none", "rtn"),
                                ("awq", "none", "awq"),
                                ("tesseraq", "tesseraq", "awq")]:
        pq, qmeta, _ = quantize_model(cfg, params, calib, qcfg,
                                      method=method, init=init, tcfg=tcfg)
        ppl[label] = perplexity(cfg, pq, evalb)
        print(f"  {label:10s}: {ppl[label]:8.2f}")
    t_quant = time.perf_counter() - t0

    packed = pack_model(cfg, pq, qmeta, qcfg)
    rep = quantized_memory_report(packed)
    ppl_packed = perplexity(cfg, packed, evalb, backend="pallas")
    print(f"\npacked deployment artifact: {rep['quantized_bytes']/1e3:.0f} KB "
          f"({rep['compression']:.1f}x smaller than fp16)")
    print(f"packed-model ppl: {ppl_packed:.2f} "
          f"(fake-quant model: {ppl['tesseraq']:.2f})")
    return {"train_loss": train_loss, "ppl": ppl, "ppl_packed": ppl_packed,
            "report": rep,
            "secs": {"train": t_train, "quantize": t_quant,
                     "total": time.perf_counter() - t_start}}


if __name__ == "__main__":
    main(sys.argv[1:])
