"""Builds the CUDA kernels in ``csrc/`` and loads them through ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object, and the objects are linked
into one shared library with a plain C interface.  The build runs at first
use, lands in ``src/repro_torch/_build/<hash>/`` (listed in ``.gitignore``)
and is keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads the library already built.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p``, sizes as ``c_int``, launches on that stream and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

``LAUNCHES`` counts the launches of each kernel.  A wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels
its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

KERNELS = ("quant_matmul", "quant_gemv", "decode_attention",
           "soft_round_fwd", "soft_round_bwd", "paged_decode_attention",
           "quant_matmul_experts", "int8_matmul")
# kernel -> the csrc/ source that holds it
SOURCES = {"quant_matmul": "quant_matmul.cu", "quant_gemv": "quant_gemv.cu",
           "decode_attention": "decode_attention.cu",
           "soft_round_fwd": "soft_round.cu",
           "soft_round_bwd": "soft_round.cu",
           "paged_decode_attention": "decode_attention.cu",
           "quant_matmul_experts": "quant_matmul.cu",
           "int8_matmul": "int8_matmul.cu"}
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (all return int, a cudaError_t)
_SIGNATURES = {
    # x, packed, scale, zero, out, M, N, K, bits, group_size, stream
    "launch_quant_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "launch_quant_gemv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, packed, scale, zero, out, E, M, N, K, bits, group_size, stream
    "launch_quant_matmul_experts": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _P],
    # x, packed, scale, zero, E, M, N, K, bits, group_size, int cfg[9]
    "quant_matmul_config": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, packed, scale, zero, N, K, bits, group_size, int cfg[12]
    "quant_gemv_config": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, kv_len, q_pos, active (or null: every slot live), out, B, S,
    # Hkv, G, D, scale, stream
    "launch_decode_attention": [_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _F, _P],
    # q, k_pool, v_pool, ptab, kv_len, q_pos, active, out, B, W, psz, Hkv,
    # G, D, scale, stream
    "launch_paged_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _F, _P],
    # k, v, S, Hkv, G, D, int cfg[9]
    "decode_attention_config": [_P, _P, _I, _I, _I, _I, _P],
    # x_q, w_q, x_scale, w_scale, out, M, N, K, lda, out_f32, stream
    "launch_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # base, nu, hard, v, scale, zero, out, ng, g, n, qmax, dst, stream
    "soft_round_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dout, base, nu, hard, v, scale, zero, dnu, dv, ng, g, n, qmax, dst,
    # stream
    "soft_round_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "need the CUDA toolkit to build")
    return found


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    return srcs, headers


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` (one nvcc per source, in parallel) and link
    them; returns the library path.  A no-op when this exact source set was
    built already."""
    srcs, headers = _sources()
    out_dir = BUILD_ROOT / _digest(srcs + headers)
    lib_path = out_dir / "libreprotorch_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    procs = []
    for src in srcs:
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _, p in procs:
        log, _ = p.communicate()
        if verbose or p.returncode:
            print(f"[build] nvcc {src.name} (rc={p.returncode}):\n{log}")
        if p.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    tmp = out_dir / f"libreprotorch_kernels.{tag}.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    for _, o, _ in procs:
        o.unlink()
    return lib_path


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library(verbose)))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    """The raw handle of the current stream of CUDA ``device`` (a tensor's
    device, so indexed), read without building a ``torch.cuda.Stream``
    object: that costs a few microseconds on every launch's host path."""
    return torch._C._cuda_getCurrentRawStream(device.index)
