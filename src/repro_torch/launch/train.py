"""Training launcher with fault tolerance (the reference's
``launch/train.py`` on one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 256 --reduced --ckpt-dir /tmp/ckpt \
        --device cpu

Behaviour, as in the reference:
  * checkpoints every ``--ckpt-every`` steps, and at the last step, through
    the atomic ``CheckpointManager``;
  * SIGTERM/SIGINT set a stop flag: the step in flight finishes, a final
    checkpoint is saved and the process exits with code 2 (preemption);
  * on start it resumes from the latest complete checkpoint — exactly,
    because the data pipeline is stateless in the step index.

Loss and grad-norm are read to the host every ``--log-every`` steps and at
the last step; apart from checkpoint saves those reads are the loop's only
host syncs.  A batch reaches the card by an asynchronous copy from pinned
memory.  The last line before ``[train] done`` gives the first step's
seconds (the process's one-time costs land there) and the wall-clock ms
per later step, split into the host's batch synthesis, checkpoint saves and
the rest (the steps and the log reads).  Runs on ``--device cuda``
unless told otherwise.  ``--arch paligemma-3b`` and ``--arch
whisper-small`` stop at the first step with a clear error: the synthetic
batches carry no patches or frames, as the reference's do not
(``make_train_harness`` trains either on batches that carry them).
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch.steps import make_train_harness
from repro_torch.optim.adam import cosine_schedule


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def _to_device(batch, dev: torch.device):
    if dev.type != "cuda":
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(dev, non_blocking=True)
            for k, v in batch.items()}


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    harness = make_train_harness(
        cfg, None, lr=cosine_schedule(args.lr, 20, args.steps),
        microbatches=args.microbatches)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch,
                                      seed=args.seed))

    params = harness.init_params(args.seed, dev)
    opt_state = harness.init_opt(params)
    start = 0

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None:
        got = ckpt.restore_latest({"params": params, "opt": opt_state})
        if got[0] is not None:
            start = got[0]
            params, opt_state = got[1]["params"], got[1]["opt"]
            print(f"[train] resumed from step {start}", flush=True)

    stop = {"flag": False}

    def on_signal(sig, frame):
        stop["flag"] = True

    old = {s: signal.signal(s, on_signal)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        t0 = time.perf_counter()
        t_first = t_data = t_ckpt = 0.0
        for step in range(start, args.steps):
            t1 = time.perf_counter()
            batch = _to_device(data.batch(step), dev)
            t_data += time.perf_counter() - t1
            params, opt_state, metrics = harness.step_fn(params, opt_state,
                                                         batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if ckpt is not None and ((step + 1) % args.ckpt_every == 0
                                     or stop["flag"]
                                     or step == args.steps - 1):
                t1 = time.perf_counter()
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
                t_ckpt += time.perf_counter() - t1
            if stop["flag"]:
                print(f"[train] preempted at step {step}; checkpoint saved",
                      flush=True)
                return 2
            if step == start:
                # the first step carries the process's one-time costs
                # (imports, the allocator's growth, library handles)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t_first = time.perf_counter() - t0
                t0 = time.perf_counter()
                t_data = t_ckpt = 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        n = args.steps - start - 1
        if n > 0:
            secs = time.perf_counter() - t0
            print(f"[train] first step {t_first:.3f}s; then {n} steps in "
                  f"{secs:.3f}s: {1e3 * secs / n:.3f} ms per step (batch "
                  f"synthesis {1e3 * t_data / n:.3f}, checkpoint saves "
                  f"{1e3 * t_ckpt / n:.3f}, the rest "
                  f"{1e3 * (secs - t_data - t_ckpt) / n:.3f})", flush=True)
        print("[train] done", flush=True)
        return 0
    finally:
        for s, h in old.items():
            signal.signal(s, h)


if __name__ == "__main__":
    sys.exit(main())
