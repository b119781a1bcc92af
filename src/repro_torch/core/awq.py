"""AWQ: activation-aware weight quantization (Lin et al., 2023), with the
asymmetric-clipping variant (Gong et al., 2024) the paper initializes from.

Per linear: grid-search (1) the equivalent-transformation exponent alpha for
the per-input-channel scale  s_ch = mean|X|^alpha / norm , and (2) a clipping
shrink factor on the group min/max, both against the layer reconstruction
objective  || (X/s_ch) Q(W*s_ch) - X W ||^2  on a captured token subsample.

The reference searches on the host in numpy float32; the port searches in
float32 torch on the weights' device, with TF32 off for the search's
products so the candidates' errors are float32 sums as on the host.  The
errors of one linear come to the host in one read.
"""
from __future__ import annotations

import contextlib
import warnings

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import quantizer as Q
from repro_torch.core.blocks import get_path, quant_leaf_paths, set_path

ALPHA_GRID = (0.0, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9)
CLIP_GRID = (1.0, 0.95, 0.9, 0.85)


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products in full float32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _act_scale(mean_abs: torch.Tensor, alpha: float) -> torch.Tensor:
    s = torch.pow(torch.clamp(mean_abs, min=1e-5), alpha)
    s = s / torch.exp(torch.mean(torch.log(s)))          # geo-mean normalize
    return torch.clamp(s, 1e-4, 1e4).to(torch.float32)


def _product(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X (n, in) through a (in, out) weight, or through each expert of an
    (E, in, out) stack (``einsum("ni,eio->eno")``, the reference's)."""
    return X @ w if w.ndim == 2 else torch.einsum("ni,eio->eno", X, w)


def awq_leaf(w: torch.Tensor, stats, qcfg: QuantConfig):
    """Returns (fake-quant effective weight, qmeta).  w: (..., in, out); an
    expert stack (E, in, out) shares one per-input-channel act_scale."""
    wf = w.to(torch.float32)
    X = stats.sample                                     # (n, in)
    if X.shape[0] == 0 or X.shape[1] != wf.shape[-2]:
        # no activations seen (shouldn't happen) -> fall back to RTN
        from repro_torch.core.rtn import rtn_leaf
        return rtn_leaf(w, qcfg)
    cands, errs = [], []
    with _full_f32_matmul():
        y_ref = _product(X, wf)
        for alpha in ALPHA_GRID:
            s_ch = _act_scale(stats.mean_abs, alpha)
            wt = wf * s_ch[:, None]
            for clip in CLIP_GRID:
                fq = Q.fake_quantize(wt, qcfg, gamma=clip, beta=clip)
                w_eff = fq / s_ch[:, None]
                errs.append(torch.mean((_product(X, w_eff) - y_ref) ** 2))
                cands.append((alpha, clip))
    best = (None, None, float("inf"))
    for (alpha, clip), err in zip(cands, torch.stack(errs).cpu().tolist(),
                                  strict=True):
        if err < best[2]:
            best = (alpha, clip, err)
    alpha, clip, _ = best
    if alpha is None:
        # every (alpha, clip) candidate scored non-finite (degenerate
        # capture stats: NaN/inf activations); fall back to the identity
        # transform instead of crashing in _act_scale(mean_abs, None)
        warnings.warn("awq_leaf: grid search found no finite candidate "
                      "(degenerate capture stats); falling back to "
                      "alpha=0.0, clip=1.0", stacklevel=2)
        alpha, clip = 0.0, 1.0
    s_ch = _act_scale(stats.mean_abs, alpha)
    wt = wf * s_ch[:, None]
    scale, zero = Q.compute_scale_zero(wt, qcfg, gamma=clip, beta=clip)
    codes = Q.quantize_codes(wt, scale, zero, qcfg)
    fq = Q.dequantize_codes(codes, scale, zero, qcfg) / s_ch[:, None]
    meta = {"scale": scale, "zero": zero, "act_scale": s_ch, "dst": None,
            "alpha": alpha, "clip": clip, "codes": codes.to(torch.uint8)}
    return fq.to(w.dtype), meta


def quantize_block_awq(bp, captures, qcfg: QuantConfig):
    """AWQ-initialize every linear of a block.  Returns (bp_fq, {path:
    qmeta})."""
    qmeta = {}
    for p in quant_leaf_paths(bp):
        w = get_path(bp, p)
        fq, meta = awq_leaf(w, captures[p], qcfg)
        bp = set_path(bp, p, fq)
        qmeta[p] = meta
    return bp, qmeta
