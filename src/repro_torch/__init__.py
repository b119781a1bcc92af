"""PyTorch port of the ``repro`` package (TesseraQ PTQ + packed serving).

The JAX package ``repro`` is the reference; this package imports nothing of
it and never imports ``jax``.  The kernels that ``repro`` wrote in Pallas
for the TPU are hand-written CUDA kernels here (``csrc/``), each with a
plain PyTorch version beside it in ``kernels/``.

Device rule: entry points default to ``device="cuda"`` and raise when no
CUDA device is present; pass ``device="cpu"`` to run the plain versions.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (the port
    never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
