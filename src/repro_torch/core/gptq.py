"""GPTQ (Frantar et al., 2022): Hessian-guided column-wise quantization with
error compensation.  The paper uses GPTQ both as a baseline (Tables 1/2/9)
and, combined with QuaRot, as the W4A4/W3A3 competitor (Table 3).

The reference walks each linear in numpy; here the same walk runs in torch
float32 on the weight's device, with the same operations in the same
order: the damped Hessian's inverse, its upper Cholesky factor (retried
once with a larger damping when the factorization fails), then columns in
blocks of ``BLOCK``, each column quantized, its error divided by the
factor's diagonal and pushed into the block's remaining columns, and each
block's errors into the columns past it.  Weights are (in, out); GPTQ walks
the *input* dim, compensating remaining rows — equivalent to the row
formulation on W^T.  A column makes ~10 small launches, so on the card the
walk is host-paced (seconds per LLaMA-2-7B block).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.blocks import get_path, quant_leaf_paths, set_path
from repro_torch.core.quantizer import compute_scale_zero, resolve_group

PERCDAMP = 0.01
BLOCK = 128


def _upper_cholesky(Hinv: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor of ``Hinv``; when the factorization fails the
    diagonal gets 1e-4 of its mean and the factorization runs again, as
    the reference's retry does (one host read of the status)."""
    L, info = torch.linalg.cholesky_ex(Hinv)
    if int(info):
        bump = 1e-4 * torch.mean(torch.diagonal(Hinv)).double()
        Hinv = (Hinv.double() + torch.eye(
            Hinv.shape[0], dtype=torch.float64, device=Hinv.device)
            * bump).to(torch.float32)
        L = torch.linalg.cholesky(Hinv)
    return L.T


def _factor(H: torch.Tensor, dev):
    """(dead input rows, the upper Cholesky factor of the damped inverse)
    of the Hessian ``H`` (in, in), in float32 on ``dev``: all of the walk
    that depends on H alone, so an expert stack sharing one H factors it
    once."""
    H = H.to(device=dev, dtype=torch.float32).clone()
    diag = torch.diagonal(H)
    dead = diag == 0
    diag.masked_fill_(dead, 1.0)
    diag.add_(PERCDAMP * torch.mean(diag))
    Hinv = torch.linalg.inv(H)
    Hinv = (Hinv + Hinv.T) / 2              # symmetric for the factorization
    return dead, _upper_cholesky(Hinv)


def _gptq_matrix(W: torch.Tensor, H: torch.Tensor, qcfg: QuantConfig, *,
                 stale_group_scales: bool = False):
    """W: (in, out); H: (in, in); both taken in float32 on W's device.

    Returns ``(W_hat, scales, zeros, codes)``: the fake-quantized weight,
    per-group scale/zero (n_groups, out) and integer codes (in, out), uint8.

    Group scale/zero are computed from the error-COMPENSATED weights: for a
    group starting mid-block (group_size < BLOCK) the rows inside the
    current block come from its working copy ``Wb``, rows past it from
    ``Whin``.  ``stale_group_scales=True`` reads ``Whin`` alone, the
    reference's regression setting."""
    return _walk(W, *_factor(H, W.device), qcfg,
                 stale_group_scales=stale_group_scales)


def _walk(W: torch.Tensor, dead: torch.Tensor, Hc: torch.Tensor,
          qcfg: QuantConfig, *, stale_group_scales: bool = False):
    """The column walk of ``_gptq_matrix`` over W (in, out) from H's
    ``_factor``."""
    n_in, n_out = W.shape
    dev = W.device
    g = resolve_group(n_in, qcfg.group_size)
    W = W.to(torch.float32).clone()
    W.masked_fill_(dead[:, None], 0.0)

    Whin = W.clone()
    n_groups = n_in // g
    scales = torch.zeros((n_groups, n_out), dtype=torch.float32, device=dev)
    zeros = torch.zeros_like(scales)
    codes = torch.zeros((n_in, n_out), dtype=torch.uint8, device=dev)
    out = torch.zeros_like(W)
    scale = zero = None
    for i1 in range(0, n_in, BLOCK):
        i2 = min(i1 + BLOCK, n_in)
        Wb = Whin[i1:i2].clone()
        Qb = torch.empty_like(Wb)            # codes, as floats
        Eb = torch.empty_like(Wb)
        Hb = Hc[i1:i2, i1:i2]
        for j in range(i2 - i1):
            col = i1 + j
            if col % g == 0:
                seg = Whin[col:col + g].clone()
                if not stale_group_scales:
                    in_blk = min(i2, col + g) - col
                    seg[:in_blk] = Wb[j:j + in_blk]
                s, z = compute_scale_zero(seg, qcfg)
                scale, zero = s[0], z[0]
                scales[col // g], zeros[col // g] = scale, zero
            w_row = Wb[j]
            qv = torch.clamp(torch.round(w_row / scale) + zero, 0, qcfg.qmax,
                             out=Qb[j])
            dq = (qv - zero) * scale
            torch.div(w_row - dq, Hb[j, j], out=Eb[j])
            if j + 1 < i2 - i1:
                Wb[j + 1:] -= torch.outer(Hb[j, j + 1:], Eb[j])
        # the block's dequantized rows from its codes: the same f32
        # products the column loop formed
        grp = torch.arange(i1, i2, device=dev) // g
        out[i1:i2] = (Qb - zeros[grp]) * scales[grp]
        codes[i1:i2] = Qb.to(torch.uint8)
        if i2 < n_in:
            Whin[i2:] -= Hc[i1:i2, i2:].T @ Eb
        Whin[i1:i2] = Wb
    return out, scales, zeros, codes


def gptq_leaf(w: torch.Tensor, stats, qcfg: QuantConfig):
    """One linear (in, out), or an expert stack (E, in, out) whose experts
    share the stack's one Hessian (factored once).  Without a captured Hessian it is formed
    from the row subsample (identity when there is none).  Returns
    (fake-quant weight in w's dtype, qmeta)."""
    wf = w.to(torch.float32)
    H = stats.hessian
    if H is None:
        X = stats.sample.to(wf.device)
        H = (X.T @ X if X.shape[0] else
             torch.eye(wf.shape[-2], dtype=torch.float32, device=wf.device))
    if wf.ndim == 3:
        dead, Hc = _factor(H, wf.device)
        res = [_walk(wf[e], dead, Hc, qcfg) for e in range(wf.shape[0])]
        fq, scale, zero, codes = (torch.stack([r[i] for r in res])
                                  for i in range(4))
    else:
        fq, scale, zero, codes = _gptq_matrix(wf, H, qcfg)
    meta = {"scale": scale, "zero": zero, "act_scale": None, "dst": None,
            "codes": codes}
    return fq.to(w.dtype), meta


def quantize_block_gptq(bp, captures, qcfg: QuantConfig):
    """GPTQ every linear of a block from its captured statistics.  Returns
    (bp_fq, {path: qmeta})."""
    qmeta = {}
    for p in quant_leaf_paths(bp):
        w = get_path(bp, p)
        fq, meta = gptq_leaf(w, captures[p], qcfg)
        bp = set_path(bp, p, fq)
        qmeta[p] = meta
    return bp, qmeta


__all__ = ["PERCDAMP", "BLOCK", "gptq_leaf", "quantize_block_gptq"]
