"""One-command end-to-end quality harness (ZeroQuant-V2's point: PTQ systems
must be judged by comprehensive end-to-end evaluation, not recon MSE).

    PYTHONPATH=src python -m repro_torch.eval.harness --smoke --device cpu

Runs, for FP and each PTQ method (RTN / AWQ / TesseraQ) at one quant config:

  * perplexity on held-out synthetic eval batches (fake-quant params);
  * synthetic multiple-choice accuracy (PIQA/ARC-style protocol);
  * the PACKED deployment artifact's perplexity under the ``"xla"`` backend;
  * a **logits-parity gate** between the ``"xla"`` and ``"pallas"`` serve
    paths on the packed model — prefill plus >= 3 lock-step decode steps
    must agree to bf16 tolerance, otherwise the harness exits non-zero.

Results land in a machine-readable JSON (``--json``, default ``EVAL.json``)
with the reference's keys, plus ``device`` (the card's name, or "cpu").
The flags are the reference's plus ``--device`` (default ``cuda``, which
raises without a card; ``cpu`` runs the kernels' plain versions).  The
calibration runs with ``kernel_backend="pallas"``, so the TesseraQ row's
θ̂ and its gradient go through the soft_round kernels on the card (the
reference's ``"xla"`` θ̂ is the same function); the gate's ``"pallas"``
run goes through the quant-matmul, GEMV and decode-attention kernels.
Its batches carry tokens only, as the reference's do, so ``--arch
paligemma-3b`` and ``--arch whisper-small`` stop with a clear error naming
``patches`` or ``frames``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.pipeline import pack_model, quantize_model
from repro_torch.core.tesseraq import TesseraQConfig
from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                       calibration_batches, eval_batches)
from repro_torch.eval.ppl import choice_accuracy, make_choice_tasks, perplexity
from repro_torch.models import get_model

# method rows: (label, quantize_model method, init)
METHODS = (("rtn", "none", "rtn"),
           ("awq", "none", "awq"),
           ("tesseraq", "tesseraq", "awq"))


def parity_gate(a: np.ndarray, b: np.ndarray, *, atol: float,
                rtol: float) -> dict:
    """THE cross-backend logits comparison — symmetric rtol reference
    (max of both magnitudes); a copy of the reference's gate, so both
    packages hold logits to the same rule."""
    diff = np.abs(a - b)
    scale = np.maximum(np.abs(a), np.abs(b))
    ok = bool(np.all(diff <= atol + rtol * scale))
    return {"ok": ok, "max_abs_diff": float(diff.max()),
            "steps_compared": int(a.shape[1]), "atol": atol, "rtol": rtol}


def logits_parity(cfg, model, packed, prompts, *, gen: int, atol: float,
                  rtol: float, device="cuda") -> dict:
    """Prefill + (gen-1) decode steps under both backends; allclose gate."""
    from repro_torch.launch.serve import serve_requests
    runs = {b: serve_requests(cfg, model, packed, prompts, gen=gen,
                              kernel_backend=b, device=device)
            for b in ("xla", "pallas")}
    return parity_gate(runs["xla"].logits_matrix(),
                       runs["pallas"].logits_matrix(),
                       atol=atol, rtol=rtol)


def run_harness(args, params=None) -> dict:
    """The harness on ``args`` (``main``'s namespace).  ``params``: the FP
    params to judge, on ``args.device`` (default: ``init_params(args.seed)``
    of the port)."""
    from repro_torch.launch.serve import parse_quant
    dev = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = get_model(cfg)
    if params is None:
        params = model.init_params(args.seed, dev)
    qcfg = parse_quant(args.quant, kernel_backend="pallas")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.batch, seed=args.seed)

    calib = calibration_batches(data_cfg, 2, max(2, args.calib_samples // 2))
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device=dev)}
             for b in calib]
    evalb = eval_batches(data_cfg, args.eval_batches, args.batch)
    corpus = SyntheticCorpus(data_cfg)
    tasks = make_choice_tasks(corpus, args.tasks, args.seq_len)
    prompts = corpus.batch(0)["tokens"][:, :args.seq_len]
    tcfg = TesseraQConfig(par_iterations=args.par_iters,
                          steps_per_iteration=args.par_steps)

    out = {"arch": cfg.name, "qcfg": qcfg.tag, "rows": {}, "parity": {},
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    t0 = time.time()
    out["rows"]["fp"] = {
        "ppl": perplexity(cfg, params, evalb),
        "choice_acc": choice_accuracy(cfg, params, tasks),
        "secs": time.time() - t0,
    }
    print(f"[eval] fp: ppl={out['rows']['fp']['ppl']:.3f} "
          f"acc={out['rows']['fp']['choice_acc']:.3f}")

    parity_ok = True
    for label, method, init in METHODS:
        t0 = time.time()
        pq, qmeta, _ = quantize_model(cfg, params, calib, qcfg,
                                      method=method, init=init, tcfg=tcfg)
        packed = pack_model(cfg, pq, qmeta, qcfg)
        row = {
            "ppl": perplexity(cfg, pq, evalb),
            "choice_acc": choice_accuracy(cfg, pq, tasks),
            "ppl_packed_xla": perplexity(cfg, packed, evalb, backend="xla"),
        }
        row["secs"] = time.time() - t0
        out["rows"][label] = row
        print(f"[eval] {label}: ppl={row['ppl']:.3f} "
              f"acc={row['choice_acc']:.3f} "
              f"packed_xla_ppl={row['ppl_packed_xla']:.3f}")
        if label == args.parity_method:
            gate = logits_parity(cfg, model, packed, prompts,
                                 gen=args.parity_steps + 1,
                                 atol=args.parity_atol, rtol=args.parity_rtol,
                                 device=dev)
            out["parity"][label] = gate
            parity_ok = parity_ok and gate["ok"]
            print(f"[eval] parity {label} (xla vs pallas, prefill + "
                  f"{gate['steps_compared'] - 1} decode steps): "
                  f"{'PASS' if gate['ok'] else 'FAIL'} "
                  f"(max |d|={gate['max_abs_diff']:.2e})")
        del pq, qmeta, packed
    out["parity_ok"] = parity_ok
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default="W4A16g32")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--eval-batches", type=int, default=2)
    ap.add_argument("--tasks", type=int, default=8)
    ap.add_argument("--calib-samples", type=int, default=8)
    ap.add_argument("--par-iters", type=int, default=2)
    ap.add_argument("--par-steps", type=int, default=8)
    ap.add_argument("--parity-method", default="tesseraq",
                    help="which method's packed model the backend-parity "
                         "gate runs on")
    ap.add_argument("--parity-steps", type=int, default=3,
                    help="decode steps compared (on top of prefill)")
    ap.add_argument("--parity-atol", type=float, default=5e-2)
    ap.add_argument("--parity-rtol", type=float, default=2e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="EVAL.json")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI (reduced arch, short calib)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's arguments, with ``--smoke``'s sizes applied."""
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.reduced = True
        args.seq_len, args.batch = 16, 2
        args.eval_batches, args.tasks = 1, 4
        args.par_iters, args.par_steps = 1, 2
    return args


def main(argv=None, params=None):
    """The CLI; ``params`` as in ``run_harness``.  Returns 0, or 1 when the
    parity gate fails."""
    args = parse_args(argv)
    out = run_harness(args, params)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json}")
    return 0 if out["parity_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
