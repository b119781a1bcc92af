"""Round-to-nearest baseline (paper Tables 1/9 "RTN")."""
from __future__ import annotations

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import quantizer as Q
from repro_torch.core.blocks import get_path, quant_leaf_paths, set_path


def rtn_leaf(w, qcfg: QuantConfig):
    """Returns (fake-quant weight, qmeta dict)."""
    scale, zero = Q.compute_scale_zero(w, qcfg)
    codes = Q.quantize_codes(w, scale, zero, qcfg)
    fq = Q.dequantize_codes(codes, scale, zero, qcfg, w.dtype)
    return fq, {"scale": scale, "zero": zero, "act_scale": None, "dst": None,
                "codes": codes.to(torch.uint8)}


def quantize_block_rtn(bp, qcfg: QuantConfig):
    """Fake-quantize every linear in a block. Returns (bp_fq, {path: qmeta})."""
    qmeta = {}
    for p in quant_leaf_paths(bp):
        w = get_path(bp, p)
        fq, meta = rtn_leaf(w, qcfg)
        bp = set_path(bp, p, fq.to(w.dtype))
        qmeta[p] = meta
    return bp, qmeta
