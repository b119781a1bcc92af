"""QuaRot-style rotation (Ashkboos et al., 2024): multiply the residual
stream by a random Hadamard-like orthogonal matrix to kill activation
outliers before weight/activation quantization.  The paper composes
TesseraQ with QuaRot for W4A4/W3A3 (Table 3).

Exact residual-stream rotation for the *dense llama family* (the family
the paper evaluates): RMSNorm scale vectors are first folded into the
adjacent linears (RMSNorm without per-channel scale commutes with
orthogonal Q), then every residual-writing weight is right-multiplied by Q
and every residual-reading weight left-multiplied by Q^T.  The model output
is exact in infinite precision.

The matrix is the reference's, drawn by the same numpy ``default_rng``
calls; the products run in float32 on the params' device and are cast back
to each leaf's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def hadamard(n: int, rng: np.random.Generator) -> np.ndarray:
    """Randomized orthogonal: Hadamard (power-of-2 n) with random signs,
    otherwise a Haar-random orthogonal matrix."""
    if n & (n - 1) == 0:
        h = np.array([[1.0]])
        while h.shape[0] < n:
            h = np.block([[h, h], [h, -h]])
        h = h / np.sqrt(n)
        signs = rng.choice([-1.0, 1.0], size=n)
        return (h * signs[None, :]).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return q.astype(np.float32)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def fold_rms_into_linears(params: dict, cfg: ModelConfig) -> dict:
    """Fold ln1 into (wq,wk,wv), ln2 into (w_gate,w_up), ln_f into head;
    norm scales become ones so RMSNorm commutes with rotation."""
    b = dict(params["blocks"])
    ln1 = _f32(b["ln1"])                           # (L, d)
    ln2 = _f32(b["ln2"])
    for k in ("wq", "wk", "wv"):
        b[k] = (_f32(b[k]) * ln1[:, :, None]).to(b[k].dtype)
    for k in ("w_gate", "w_up"):
        b[k] = (_f32(b[k]) * ln2[:, :, None]).to(b[k].dtype)
    b["ln1"] = torch.ones_like(b["ln1"])
    b["ln2"] = torch.ones_like(b["ln2"])
    new = dict(params, blocks=b)
    lnf = _f32(params["ln_f"])
    if "head" in params:
        new["head"] = (_f32(params["head"]) * lnf[:, None]).to(
            params["head"].dtype)
        new["ln_f"] = torch.ones_like(params["ln_f"])
    return new


def rotate_params(params: dict, cfg: ModelConfig, seed: int = 0) -> dict:
    """Apply residual-stream rotation to a dense-family model; the caller's
    params are left as they are."""
    if cfg.family != "dense":
        raise ValueError("rotate_params: rotation implemented for the dense "
                         f"family, not {cfg.family!r}")
    if cfg.tie_embeddings:
        raise ValueError("rotate_params: the fold requires untied "
                         "embeddings")
    rng = np.random.default_rng(seed)
    dev = params["embed"].device
    Qm = torch.from_numpy(hadamard(cfg.d_model, rng)).to(dev)
    p = fold_rms_into_linears(params, cfg)
    b = dict(p["blocks"])
    with torch.no_grad():
        # residual readers: x @ W  ->  (x Q) @ (Q^T W)
        for k in ("wq", "wk", "wv", "w_gate", "w_up"):
            b[k] = torch.matmul(Qm.T, _f32(b[k])).to(b[k].dtype)
        # residual writers: W -> W Q
        for k in ("wo", "w_down"):
            b[k] = torch.matmul(_f32(b[k]), Qm).to(b[k].dtype)
        out = dict(p, blocks=b)
        out["embed"] = (_f32(p["embed"]) @ Qm).to(p["embed"].dtype)
        out["head"] = (Qm.T @ _f32(p["head"])).to(p["head"].dtype)
    return out


__all__ = ["hadamard", "fold_rms_into_linears", "rotate_params"]
