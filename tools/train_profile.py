"""Where a train step's time goes: the port's ``make_train_harness`` step at
the two sizes ``chip_smoke.py``'s phase 15 trains (smollm-135m at 8 x 256
tokens, the train CLI's, and TinyLlama-1.1B at 4 x 2048), each with remat
on and off.

For each: the host's time to enqueue a step and the step's wall time
(after warm-up steps on the same batch), then one step under
``torch.profiler``: the device's busy time (the sum of kernel times),
the launches, the host syncs and the kernels and host operators that take
the most time.

    PYTHONPATH=src python tools/train_profile.py [--steps 2] [--top 12]

Needs a CUDA card (~1.5 min on an H100); ``--device cpu --small`` runs
the same at the reduced configs on the plain versions (device columns
then read 0).
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch.steps import make_train_harness

CASES = (("smollm-135m", 8, 256), ("tinyllama-1.1b", 4, 2048))


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def profile_case(arch, batch, seq, remat, dev, steps, top, small):
    cfg = (get_reduced_config(arch) if small else get_config(arch)).replace(
        remat=remat)
    h = make_train_harness(cfg, None, lr=3e-4)
    params = h.init_params(0, dev)
    opt = h.init_opt(params)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=batch,
                                      seed=0))
    b = {"tokens": torch.from_numpy(data.batch(0)["tokens"]).to(dev)}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for _ in range(3):
        params, opt, m = h.step_fn(params, opt, b)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, m = h.step_fn(params, opt, b)
    t1 = time.perf_counter()
    sync()
    t2 = time.perf_counter()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        params, opt, m = h.step_fn(params, opt, b)
        sync()
    ka = prof.key_averages()
    kernels = [e for e in ka if _device_us(e) > 0 and e.device_type is not
               None and "cuda" in str(e.device_type).lower()]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    syncs = sum(e.count for e in ka if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    print(f"[train-profile] {cfg.name} {batch} x {seq} remat "
          f"{'on' if remat else 'off'}: host enqueue "
          f"{1e3 * (t1 - t0) / steps:.3f} ms a step, wall "
          f"{1e3 * (t2 - t0) / steps:.3f} ms; profiled step: device busy "
          f"{busy:.3f} ms, {launches} launches, {syncs} host syncs; loss "
          f"{float(m['loss']):.4f}", flush=True)
    by_dev = sorted(kernels, key=_device_us, reverse=True)[:top]
    for e in by_dev:
        print(f"    device {_device_us(e) / 1e3:9.3f} ms x{e.count:5d}  "
              f"{e.key[:90]}", flush=True)
    by_cpu = sorted(ka, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]
    for e in by_cpu:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"x{e.count:5d}  {e.key[:90]}", flush=True)
    del params, opt, m
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--small", action="store_true",
                    help="the reduced configs (a CPU rehearsal)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(f"card=[{out.stdout.strip()}] torch {torch.__version__}",
              flush=True)
    for arch, batch, seq in CASES:
        for remat in (True, False):
            profile_case(arch, batch, 64 if args.small else seq, remat, dev,
                         args.steps, args.top, args.small)


if __name__ == "__main__":
    main()
