"""Serving launcher: serve batched requests with packed (or FP) weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --reduced --method none --requests 8 --prompt-len 32 --gen 16

``--arch`` takes every id of ``repro_torch.configs.ARCH_IDS``: the dense
llama configs and the MoE ``qwen3-moe-30b-a3b``.

``serve_requests`` is the uniform lock-step loop: one batch, one shared
prompt length, a fixed ``gen`` for every row.  ``--slots N`` serves a
seeded heterogeneous workload through the continuous-batching scheduler
(``launch/scheduler.py``) instead, on the dense store or, with ``--store
paged``, on the paged KV pool (``--page-size``, ``--num-pages``), with
optional chunked prefill (``--prefill-chunk``) and copy-on-write prefix
sharing (``--share-prefix``).  ``--method tesseraq``
(default, with ``--init awq``) calibrates the random-weight model on
synthetic calibration segments with ``--par-iters`` PAR iterations of
``--par-steps`` steps each, packs it and serves the packed model;
``--method omniquant`` calibrates with OmniQuant's learnable weight
clipping instead (500 steps a block, as in the reference's CLI), and
``--init`` picks AWQ, RTN or GPTQ as the initialization;
``--method none`` serves the plain FP params (the fp16 baseline).  An
``A<act_bits>`` below 16 in ``--quant`` (``W4A8``, ``W4A4``) serves the
quantized model with per-token activation fake-quant, as the reference's
CLI does (not the FP baseline, and not the calibration).
``--backend pallas`` routes every QTensor matmul, the decode attention and
the calibration's soft-rounding through the hand-written kernels.  Runs on
``--device cuda`` unless told otherwise; ``--device cpu`` runs the kernels'
plain versions.

Not ported yet, and raising: tensor parallelism (``--tp``).
"""
from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.pipeline import (pack_model, quantize_model,
                                       quantized_memory_report)
from repro_torch.core.qtensor import PACK_FACTOR
from repro_torch.core.tesseraq import TesseraQConfig
from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                       calibration_batches)
from repro_torch.launch.steps import make_serve_steps
from repro_torch.models import get_model

_QUANT_RE = re.compile(r"W(\d+)A(\d+)(?:g(\d+))?$")


def parse_quant(tag: str, kernel_backend: str = "xla") -> QuantConfig:
    """Parse a ``W<bits>A<act_bits>[g<group>]`` tag (e.g. ``W4A16g32``)."""
    m = _QUANT_RE.match(tag)
    if m is None:
        raise ValueError(
            f"malformed quant tag {tag!r}: expected W<bits>A<act_bits>"
            f"[g<group>] with uppercase W/A, e.g. W4A16g32 or W2A16 "
            f"(per-channel)")
    bits, act, g = int(m.group(1)), int(m.group(2)), m.group(3)
    if bits not in PACK_FACTOR:
        raise ValueError(f"unsupported weight bits {bits} in {tag!r}: "
                         f"packing supports {sorted(PACK_FACTOR)}")
    if g is not None and int(g) <= 0:
        raise ValueError(f"group size must be a positive integer, got "
                         f"g{g} in {tag!r} (omit g for per-channel)")
    return QuantConfig(bits=bits, group_size=int(g) if g else None,
                       act_bits=None if act >= 16 else act,
                       kernel_backend=kernel_backend)


def _params_device(params) -> torch.device:
    return params["embed"].device


def build_params(cfg, params, qcfg: QuantConfig, data_cfg: DataConfig, *,
                 method: str, init: str, tcfg: TesseraQConfig,
                 calib_samples: int, verbose: bool = True):
    """Calibrate + pack, or pass FP params through for ``method="none"``.

    Returns (params_or_packed, memory_report_or_None)."""
    if method == "none":
        if verbose:
            print(f"[serve] serving FP {cfg.name} (no quantization)")
        return params, None
    if verbose:
        print(f"[serve] calibrating {cfg.name} to {qcfg.tag} "
              f"with {method}+{init} ...")
    t0 = time.time()
    dev = _params_device(params)
    calib = calibration_batches(data_cfg, 2, max(2, calib_samples // 2))
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1], device=dev)}
             for b in calib]
    params_fq, qmeta, _ = quantize_model(cfg, params, calib, qcfg,
                                         method=method, init=init, tcfg=tcfg)
    packed = pack_model(cfg, params_fq, qmeta, qcfg)
    report = quantized_memory_report(packed)
    if verbose:
        print(f"[serve] calibration done in {time.time()-t0:.1f}s; {report}")
    return packed, report


def compile_serve_steps(cfg, *, kernel_backend=None, act_bits=None):
    """The (prefill, decode) step pair for a (backend, act_bits) serving
    configuration.  PyTorch runs eagerly, so there is nothing to compile;
    the name is the reference's."""
    _, prefill_step, decode_step = make_serve_steps(
        cfg, act_bits=act_bits, kernel_backend=kernel_backend)
    return prefill_step, decode_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_requests(cfg, model, params, prompts, *, gen: int,
                   kernel_backend=None, act_bits=None, compiled=None,
                   collect_logits=True, max_seq=None, device="cuda"):
    """Prefill + lock-step batched decode (uniform lengths, fixed ``gen``).

    ``prompts``: (B, prompt_len) token ids (numpy or tensor); ``params``
    must already live on ``device``.  Returns a
    ``repro_torch.launch.scheduler.ServeResult`` whose ``tokens`` is the
    (B, gen) token matrix and whose ``logits`` is the (B, gen, V) stack of
    the prefill output plus each decode step's.  ``act_bits`` fake-quantizes
    activations per token (W4A8 / W4A4).  ``compiled``: a
    ``compile_serve_steps`` pair to reuse (built fresh otherwise).
    ``max_seq`` overrides the cache width (default: exactly prompt + gen);
    serving a request alone at the scheduler's width reduces over the same
    cache extent as the scheduler.  Argmax stays on the device;
    device->host copies happen after both timing regions, which end in
    ``torch.cuda.synchronize``."""
    from repro_torch.launch.scheduler import ServeResult, _latency_stats
    dev = resolve_device(device)
    if _params_device(params).type != dev.type:
        raise ValueError(f"serve_requests: params live on "
                         f"{_params_device(params)}, device is {dev}")
    B, prompt_len = prompts.shape
    if max_seq is None:
        max_seq = prompt_len + gen
    elif max_seq < prompt_len + gen:
        raise ValueError(f"max_seq {max_seq} < prompt+gen "
                         f"{prompt_len + gen}")
    pstep, dstep = (compiled if compiled is not None else
                    compile_serve_steps(cfg, kernel_backend=kernel_backend,
                                        act_bits=act_bits))

    cache = model.init_cache(B, max_seq, device=dev)
    toks_in = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    with torch.no_grad():
        _sync(dev)   # reprolint: ok[host-sync] — opens the prefill timing region
        t0 = time.perf_counter()
        logits, cache = pstep(params, {"tokens": toks_in}, cache)
        _sync(dev)   # reprolint: ok[host-sync] — prefill timing boundary
        t_prefill = time.perf_counter() - t0

        all_logits = [logits] if collect_logits else None
        tok = torch.argmax(logits, -1)
        pos = torch.full((B,), prompt_len, dtype=torch.int32, device=dev)
        toks = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = dstep(params, cache, tok, pos)
            tok = torch.argmax(logits, -1)
            pos = pos + 1
            toks.append(tok)
            if collect_logits:
                all_logits.append(logits)
        _sync(dev)   # reprolint: ok[host-sync] — closes the decode timing region
        t_decode = time.perf_counter() - t0
    # off-clock host fetches: both timing regions are closed
    tok_mat = torch.stack(toks, 1).to(torch.int32).cpu().numpy()
    lg_mat = (torch.stack(all_logits, 1).float().cpu().numpy()
              if collect_logits else None)                     # (B, gen, V)
    res = {b: {"tokens": tok_mat[b],
               "logits": None if lg_mat is None else lg_mat[b],
               "arrival": 0, "admit_step": 0, "finish_step": gen - 1,
               "latency_steps": gen - 1}
           for b in range(B)}
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    return ServeResult(
        mode="uniform", store="dense", requests=res,
        slots=B, max_seq=max_seq, steps=gen - 1,
        useful_tokens=B * gen, decode_tokens=B * (gen - 1),
        prefill_secs=t_prefill, decode_secs=t_decode,
        prefill_tok_s=B * prompt_len / max(t_prefill, 1e-9),
        decode_tok_s=(B * (gen - 1) / max(t_decode, 1e-9)
                      if gen > 1 else 0.0),
        occupancy=1.0,
        latency_steps=_latency_stats([gen - 1] * B),
        cache_stats={"store": "dense", "cache_bytes": cache_bytes,
                     "slots": B, "max_seq": max_seq},
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default="W4A16g32")
    ap.add_argument("--method", default="tesseraq",
                    choices=["tesseraq", "omniquant", "none"])
    ap.add_argument("--init", default="awq", choices=["awq", "rtn", "gptq"])
    ap.add_argument("--backend", default="xla", choices=["xla", "pallas"],
                    help="QTensor matmul dispatch for the serve steps")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=None,
                    help="serve through the continuous-batching scheduler "
                         "with this many slots over a seeded heterogeneous "
                         "workload (prompt lens up to --prompt-len, budgets "
                         "up to --gen); default: uniform lock-step loop")
    ap.add_argument("--store", default="dense", choices=["dense", "paged"],
                    help="KV cache store for --slots serving: dense per-slot "
                         "lanes, or the paged pool + page-table layout")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged pool size (default: dense-capacity parity)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunk long prompts into this many tokens per "
                         "decode iteration")
    ap.add_argument("--share-prefix", action="store_true",
                    help="copy-on-write sharing of full prompt-prefix pages "
                         "(paged store + chunked prefill only)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel serving (not ported yet)")
    ap.add_argument("--calib-samples", type=int, default=8)
    ap.add_argument("--par-iters", type=int, default=4,
                    help="TesseraQ PAR iterations")
    ap.add_argument("--par-steps", type=int, default=20,
                    help="TesseraQ steps per PAR iteration")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    if args.tp is not None:
        raise NotImplementedError(
            "--tp is not ported yet (ROADMAP queue 1, 'Parallelism')")

    dev = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = get_model(cfg)
    params = model.init_params(args.seed, dev)

    qcfg = parse_quant(args.quant, kernel_backend=args.backend)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.prompt_len,
                          global_batch=args.requests, seed=args.seed)
    tcfg = TesseraQConfig(par_iterations=args.par_iters,
                          steps_per_iteration=args.par_steps)
    served, _ = build_params(cfg, params, qcfg, data_cfg, method=args.method,
                             init=args.init, tcfg=tcfg,
                             calib_samples=args.calib_samples)

    # activations are quantized only for a quantized model, as the
    # reference's CLI does
    act = qcfg.act_bits if args.method != "none" else None
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU, plain versions")
    if args.slots is not None:
        return _serve_scheduled_cli(args, cfg, served, qcfg, act, dev, where)

    corpus = SyntheticCorpus(data_cfg)
    prompts = corpus.batch(0)["tokens"][:, :args.prompt_len]
    stats = serve_requests(cfg, model, served, prompts, gen=args.gen,
                           kernel_backend=qcfg.kernel_backend, act_bits=act,
                           device=dev)
    B, gen = args.requests, args.gen
    dt = stats.prefill_secs + stats.decode_secs
    print(f"[serve] {B} requests x {gen} tokens in {dt:.2f}s "
          f"(prefill {stats.prefill_tok_s:.1f} tok/s, decode "
          f"{stats.decode_tok_s:.1f} tok/s, backend={args.backend}, "
          f"{where})")
    print("[serve] sample generations (token ids):")
    toks = stats.tokens
    for b in range(min(B, 4)):
        print(f"  req{b}: {np.asarray(prompts[b][-8:]).tolist()} -> "
              f"{toks[b][:12].tolist()}")
    return 0


def _serve_scheduled_cli(args, cfg, served, qcfg, act, dev, where) -> int:
    """``--slots``: a seeded heterogeneous workload through the scheduler."""
    from repro_torch.launch.scheduler import make_workload, serve_scheduled
    if args.prompt_len < 1 or args.gen < 1:
        raise SystemExit("--slots needs --prompt-len and --gen >= 1")
    # clamp the plan ranges so small --prompt-len/--gen stay valid
    reqs = make_workload(cfg.vocab_size, n_requests=args.requests,
                         seed=args.seed,
                         prompt_lens=(min(max(4, args.prompt_len // 4),
                                          args.prompt_len), args.prompt_len),
                         budgets=(min(2, args.gen), args.gen))
    sched = serve_scheduled(cfg, served, reqs, slots=args.slots,
                            kernel_backend=qcfg.kernel_backend,
                            act_bits=act, store=args.store,
                            page_size=args.page_size,
                            num_pages=args.num_pages,
                            prefill_chunk=args.prefill_chunk,
                            share_prefix=args.share_prefix, device=dev)
    lat = sched.latency_steps
    print(f"[serve] scheduled {args.requests} requests over {args.slots} "
          f"slots in {sched.steps} decode steps ({sched.useful_tokens} "
          f"useful tokens, occupancy {sched.occupancy:.2f}, decode "
          f"{sched.decode_tok_s:.1f} tok/s, backend={args.backend}, "
          f"{where})")
    print(f"[serve] latency (decode steps): mean {lat['mean']:.1f} p50 "
          f"{lat['p50']:.0f} p90 {lat['p90']:.0f} p99 {lat['p99']:.0f}")
    cs = sched.cache_stats
    if sched.store == "paged":
        print(f"[serve] paged cache: {cs['cache_bytes'] / 1e6:.2f} MB, "
              f"{cs['num_pages']} pages x {cs['page_size']} tokens, peak in "
              f"use {cs['peak_pages_in_use']}, refused "
              f"{cs['refused_admissions']}, shared-page hits "
              f"{cs['shared_page_hits']}")
    else:
        print(f"[serve] dense cache: {cs['cache_bytes'] / 1e6:.2f} MB")
    for r in reqs[:4]:
        rr = sched.requests[r.rid]
        print(f"  req{r.rid}: plen={len(r.prompt)} budget={r.max_new_tokens} "
              f"arrive@{r.arrival} admit@{rr['admit_step']} "
              f"finish@{rr['finish_step']} -> {rr['tokens'][:8].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
