#!/usr/bin/env python3
"""CPU estimates behind the weight-activation checks of ``chip_smoke.py``.

    PYTHONPATH=src python tools/act_quant_estimates.py [--depths 1 8] [--ppl]

All runs use the port's plain versions on the CPU at LLaMA-2-7B's widths
(random weights, seed 0, RTN W4 per-channel + pack); they estimate ratios
and relative errors, not times:

* ``backends``: relative L2 between the ``"pallas"`` (plain versions) and
  ``"xla"`` backends' logits over 64 tokens, at A16, A8 and A4, for each
  depth in ``--depths``: how far the per-token fake-quant amplifies the
  two backends' rounding-level differences;
* ``w4a8``: relative L2 between ``ops.w4a8_matmul`` and
  ``layers.matmul(fake_quant_act(x), W, "xla")`` on 512 rows, for two
  per-channel shapes and one g128 one, at act_bits 8 and 4;
* ``--ppl``: packed vs fake-quant perplexity under act_bits=4 after an AWQ
  walk at depth 2 (about two minutes).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.pipeline import pack_model, quantize_model
from repro_torch.core.quantizer import make_qtensor
from repro_torch.data.pipeline import (DataConfig, calibration_batches,
                                       eval_batches)
from repro_torch.eval.ppl import perplexity
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.common import make_ctx

W4 = QuantConfig(bits=4, group_size=None)


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def packed_model(depth):
    cfg = get_config("llama2-7b").replace(num_layers=depth)
    params = get_model(cfg).init_params(0, "cpu")
    calib = [{"tokens": torch.zeros((1, 16), dtype=torch.long)}]
    pfq, qmeta, _ = quantize_model(cfg, params, calib, W4, method="none",
                                   init="rtn")
    return cfg, pack_model(cfg, pfq, qmeta, W4)


def backends(depth):
    cfg, packed = packed_model(depth)
    toks = torch.randint(0, cfg.vocab_size, (1, 64),
                         generator=torch.Generator().manual_seed(0))
    out = {}
    with torch.no_grad():
        for act in (None, 8, 4):
            a = transformer.forward(packed, cfg, toks, make_ctx(
                kernel_backend="pallas", act_bits=act))
            b = transformer.forward(packed, cfg, toks, make_ctx(
                kernel_backend="xla", act_bits=act))
            out[f"A{act or 16}"] = rel_l2(a, b)
    print(f"[backends] depth {depth}: pallas vs xla logits relative L2 "
          + " ".join(f"{k}={v:.4g}" for k, v in out.items())
          + f"; A8/A16 {out['A8'] / out['A16']:.3g}", flush=True)


def w4a8():
    gen = torch.Generator().manual_seed(0)
    for K, N, g in ((4096, 4096, None), (11008, 4096, None),
                    (4096, 4096, 128)):
        w = (torch.randn(K, N, generator=gen) * K ** -0.5).bfloat16()
        qt = make_qtensor(w, QuantConfig(bits=4, group_size=g))
        x = torch.randn(512, K, generator=gen).bfloat16()
        x[:, :8] *= 20                                 # outlier channels
        for bits in (8, 4):
            rel = rel_l2(ops.w4a8_matmul(x, qt, bits),
                         L.matmul(L.fake_quant_act(x, bits), qt, "xla"))
            print(f"[w4a8] K={K} N={N} g={g or K} act_bits={bits}: relative "
                  f"L2 to the fake-quant xla product {rel:.4g}", flush=True)


def ppl():
    cfg = get_config("llama2-7b").replace(num_layers=2)
    params = get_model(cfg).init_params(0, "cpu")
    qcfg = QuantConfig(bits=4, group_size=None, act_bits=4)
    ctx = make_ctx(act_bits=4)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2,
                    seed=0)
    calib = [{"tokens": torch.as_tensor(b["tokens"][:, :-1])}
             for b in calibration_batches(dc, 1, 2)]
    pfq, qmeta, _ = quantize_model(cfg, params, calib, qcfg, method="none",
                                   init="awq", ctx=ctx)
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    evalb = eval_batches(dc, 4, 2)
    for act in (None, 4):
        c = make_ctx(act_bits=act)
        a = perplexity(cfg, packed, evalb, c, backend="pallas")
        b = perplexity(cfg, pfq, evalb, c, backend="pallas")
        print(f"[ppl] depth 2, AWQ W4 per-channel, A{act or 16}: packed "
              f"{a:.6g} fake-quant {b:.6g}, relative {abs(a - b) / b:.3g}",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="*", default=[1, 8])
    ap.add_argument("--ppl", action="store_true")
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    with torch.no_grad():
        for d in args.depths:
            backends(d)
        w4a8()
    if args.ppl:
        ppl()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
