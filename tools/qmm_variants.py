#!/usr/bin/env python3
"""Build variants of ``csrc/quant_matmul.cu`` and time them side by side on
one GPU: which row tiles earn their instantiations, and what each part of
the consumer's K stage costs.

    python3 tools/qmm_variants.py [--parent DIR] [--only NAME ...]
                                  [--json PATH]

Each variant is this checkout's ``quant_matmul.cu`` with one edit (its
``RowTiles`` line, or a part of the stage taken out), compiled alone into
a shared library under ``src/repro_torch/_build/variants/`` with the
port's own ``nvcc`` flags (four compiles side by side; the wall time of
each compile is printed) and called through ctypes in ONE process,
interleaved case by case, with ``chip_smoke.cuda_ms`` (L2 flush, device
spin, CUDA events).  ``--parent`` adds another checkout's
``quant_matmul.cu`` (called without ``rows``: on x zero past each count it
is the same function).

Cases, all W2 g128: one Qwen3-30B-A3B MoE layer's 3 expert launches (E =
128; C = 8 with every row live, and routed traffic through the port's
dispatch, ``chip_smoke.routed_operands``: 4 and 8 decode slots at C = 8,
160 / 256 / 384 / 512 tokens at C = 16 / 24 / 32 / 40), and one LLaMA-2-7B
layer's 7 ``quant_matmul`` launches at M = 40, 64, 100 (the batch-1
admission prefill's tiles) and 512.  Every variant that keeps the
arithmetic must equal the port's wrappers bit for bit (else the run
fails); the ablations (``no dequant``, ``no mma``, ``loads only``,
``handshake only``) compute garbage and are timed only.

Prints the card's name and power limit, one ``BUILD <variant> <s>`` line
per compile and one ``RESULT <case> | <variant> | <ms>`` line per reading;
``--json`` also writes them all to PATH.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT = os.path.join(ROOT, "src", "repro_torch", "_build", "variants")
TILES = re.compile(r"using RowTiles = Tiles<[^>]*>;")

# the stage parts an ablation removes (exact text of quant_matmul.cu)
DEQUANT = ("    dequant<PPB, BM, kGeneral>(a, st, kt, o, g, refresh, off, nl, "
           "t);\n", "")
MMA = ("#pragma unroll\n    for (int c = 0; c < 4; ++c)\n"
       "      wgmma_rs<BM>(acc, a[c], d0 + 2 * c);\n", "")
LOADS = ("  if (lane == 0) {\n    const uint32_t bytes =",
         "  if (lane == 0) {\n    mbar_arrive(bar);\n    return;\n  }\n"
         "  if (lane == 0) {\n    const uint32_t bytes =")


# the m64n16k16 wrapper the 16-row tile needs (the kernel builds no
# 16-row tile, so it has none)
WGMMA16 = ("  } else if constexpr (BM == 32) {",
           """  } else if constexpr (BM == 16) {
    asm volatile(
      "{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %13, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\\n"
      "}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
  } else if constexpr (BM == 32) {""")


def tiles(*bm):
    line = f"using RowTiles = Tiles<{', '.join(map(str, bm))}>;"
    return [("RowTiles", line)] + ([WGMMA16] if 16 in bm else [])


# name -> edits; ablations keep this checkout's tile set
VARIANTS = {
    "as is": [],
    "tiles 8 16 32 64": tiles(8, 16, 32, 64, 128),
    "tiles 16 32 64": tiles(16, 32, 64, 128),
    "tiles 32 64": tiles(32, 64, 128),
    "tiles 8 16 64": tiles(8, 16, 64, 128),
    "tiles 8 16 32": tiles(8, 16, 32, 128),
    "tiles 16 64": tiles(16, 64, 128),
    "tiles 128": tiles(128),
    "no dequant": [DEQUANT],
    "no mma": [MMA],
    "loads only": [DEQUANT, MMA],
    "handshake only": [DEQUANT, MMA, LOADS],
}
ABLATIONS = ("no dequant", "no mma", "loads only", "handshake only")


def edit(src, edits):
    for old, new in edits:
        if old == "RowTiles":
            if len(TILES.findall(src)) != 1:
                raise SystemExit("qmm_variants: no single RowTiles line")
            src = TILES.sub(new, src)
            continue
        if src.count(old) != 1:
            raise SystemExit(f"qmm_variants: edit target not found once: "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def compile_variant(name, src_dir, text):
    d = os.path.join(OUT, re.sub(r"\W+", "_", name))
    os.makedirs(d, exist_ok=True)
    for h in ("sm90.cuh", "dequant.cuh"):
        with open(os.path.join(src_dir, h)) as f, \
                open(os.path.join(d, h), "w") as g:
            g.write(f.read())
    cu = os.path.join(d, "quant_matmul.cu")
    with open(cu, "w") as f:
        f.write(text)
    lib = os.path.join(d, "lib.so")
    cmd = [build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-shared",
           "-I", d, cu, "-o", lib]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if p.returncode:
        raise SystemExit(f"qmm_variants: nvcc failed for {name}:\n"
                         f"{p.stdout[-3000:]}{p.stderr[-3000:]}")
    return name, lib, secs


def load(lib, rows_arg):
    lib = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.launch_quant_matmul.argtypes = [P] * 5 + [I] * 5 + [P]
    lib.launch_quant_matmul_experts.argtypes = \
        [P] * (6 if rows_arg else 5) + [I] * 6 + [P]
    lib.launch_quant_matmul.restype = I
    lib.launch_quant_matmul_experts.restype = I
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout to build and time")
    ap.add_argument("--only", nargs="*", help="variants to run")
    ap.add_argument("--json", help="write the readings here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qmm_variants: no CUDA device", file=sys.stderr)
        return 1
    card = c.card_line()
    print(card, flush=True)
    with open(os.path.join(SRC, "quant_matmul.cu")) as f:
        base = f.read()
    jobs = [(n, SRC, edit(base, e)) for n, e in VARIANTS.items()
            if not args.only or n in args.only]
    if args.parent:
        psrc = os.path.join(os.path.abspath(args.parent), "src",
                            "repro_torch", "csrc")
        with open(os.path.join(psrc, "quant_matmul.cu")) as f:
            jobs.append(("parent", psrc, f.read()))
    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(lambda j: compile_variant(*j), jobs))
    record = {"card": card, "build_s": {}, "ms": {}}
    libs = {}
    for name, lib, secs in built:
        print(f"BUILD {name} {secs:.3f} s (quant_matmul.cu alone, 4 compiles "
              f"side by side)", flush=True)
        record["build_s"][name] = secs
        libs[name] = load(lib, name != "parent")

    from repro_torch.core.qtensor import pack
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_experts)
    build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    l2 = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    stream = build.stream_ptr(torch.device("cuda", 0))
    E, kw = c.EXPERTS, dict(bits=2, group_size=128)
    weights = {}
    for K, N, _ in c.EXPERT_SHAPES:
        codes = torch.randint(0, 4, (E, K, N), generator=gen, device="cuda",
                              dtype=torch.int32)
        weights[(K, N)] = (
            pack(codes, 2),
            torch.rand((E, K // 128, N), generator=gen, device="cuda")
            * 0.015 + 0.005,
            torch.randint(0, 4, (E, K // 128, N), generator=gen,
                          device="cuda").float())
        del codes
    Ks = {K for K, _, _ in c.EXPERT_SHAPES}
    cases = {"experts C=8 full": (
        8, None, {K: torch.randn((E, 8, K), generator=gen,
                                 device="cuda").bfloat16() for K in Ks})}
    for T in (4, 8, 160, 256, 384, 512):
        C, rows, xs = c.routed_operands(gen, T, E, Ks)
        cases[f"experts routed {T} C={C}"] = (C, rows, xs)

    def experts(lib, name, C, rows, xs):
        calls = []
        for K, N, cnt in c.EXPERT_SHAPES:
            packed, scale, zero = weights[(K, N)]
            x = xs[K]
            out = torch.empty((E, C, N), dtype=torch.bfloat16, device="cuda")
            ptrs = [x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                    zero.data_ptr()]
            if name != "parent":
                ptrs.append(None if rows is None else rows.data_ptr())

            def run(ptrs=ptrs, out=out, K=K, N=N):
                err = lib.launch_quant_matmul_experts(
                    *ptrs, out.data_ptr(), E, C, N, K, 2, 128, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            want = lambda x=x, p=(packed, scale, zero): quant_matmul_experts(
                x, *p, **kw, rows=rows)
            calls.append((run, out, want, cnt))
        return calls

    qm = {K_N: c.quant_operands(gen, 512, *K_N, 2, 128)
          for K_N in {(K, N) for K, N, _ in c.MAIN_SHAPES}}

    def dense(lib, name, M):
        calls = []
        for K, N, cnt in c.MAIN_SHAPES:
            x, packed, scale, zero = qm[(K, N)]
            x = x[:M]
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")

            def run(x=x, p=(packed, scale, zero), out=out, K=K, N=N):
                err = lib.launch_quant_matmul(
                    x.data_ptr(), *(t.data_ptr() for t in p), out.data_ptr(),
                    M, N, K, 2, 128, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            want = lambda x=x, p=(packed, scale, zero): quant_matmul(
                x, *p, **kw)
            calls.append((run, out, want, cnt))
        return calls

    readings = [(tag, lambda lib, name, a=a: experts(lib, name, *a))
                for tag, a in cases.items()]
    readings += [(f"quant_matmul LLaMA layer M={M}",
                  lambda lib, name, M=M: dense(lib, name, M))
                 for M in (40, 64, 100, 512)]
    bad = []
    for tag, make in readings:
        for name, lib in libs.items():
            ms = 0.0
            for run, out, want, cnt in make(lib, name):
                run()
                got = want()
                torch.cuda.synchronize()
                if name not in ABLATIONS and not torch.equal(
                        out.view(torch.int16), got.view(torch.int16)):
                    bad.append((tag, name))
                ms += cnt * c.cuda_ms(run, iters=30, flush=l2.zero_)
            record["ms"].setdefault(tag, {})[name] = ms
            print(f"RESULT {tag} | {name} | {ms:.5f} ms/layer", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    if bad:
        print(f"qmm_variants: not bit-identical to the wrappers: {bad}",
              file=sys.stderr)
        return 1
    print("every variant that keeps the arithmetic is bit-identical to the "
          "port's wrappers", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
