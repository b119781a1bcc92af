"""Block abstraction for block-wise reconstruction (paper Eq. 3).

An architecture is an ordered list of *stages*; each stage is a run of
structurally identical blocks.  The calibration walk
(``core/pipeline.quantize_model``) goes block by block: it collects the
block's inputs X and FP outputs block(theta, X), quantizes the block, and
writes it back.  The families ``dense`` and ``moe`` are one stage of
decoder blocks each; the other families arrive with their model code
(ROADMAP queue 1, "Remaining families").
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import Ctx, DEFAULT_CTX, take_layer

# Leaf names that are quantizable linear weights of the dense and MoE
# families (the reference adds the rwkv and mamba names with those
# families); MoE expert weights reuse the dense names under "moe", with a
# leading expert dim.  Everything else (norms, the f32 router, embeddings,
# the head) stays as it is.
QUANT_LEAF_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
})


def quant_leaf_paths(block_params) -> list:
    """Paths (as tuples of keys) of quantizable leaves inside one block."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            if path and path[-1] in QUANT_LEAF_NAMES and node.ndim >= 2 \
                    and node.shape[-2] >= 2:
                out.append(path)
    walk(block_params, ())
    return out


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree, path, value):
    """Functional set on nested dicts (the tensors are not copied)."""
    if not path:
        return value
    new = dict(tree)
    new[path[0]] = set_path(tree[path[0]], path[1:], value)
    return new


@dataclasses.dataclass
class Stage:
    name: str
    n_blocks: int
    get_block: Callable            # (params, i) -> block params
    set_block: Callable            # (params, i, bp) -> params
    init_x: Callable               # (params, batch) -> (B, S, d) stream
    apply: Callable                # (bp, x) -> x
    # (param_key, layer_idx) a block maps to in the stacked param storage —
    # used by pack_model to assemble stacked QTensors
    pack_target: Callable = lambda i: ("blocks", i)


def _copy_into(full, one):
    if isinstance(full, dict):
        for k in full:
            _copy_into(full[k], one[k])
    else:
        full.copy_(one)


def _stacked_getset(key):
    def get(params, i):
        return take_layer(params[key], i)

    def set_(params, i, bp):
        """Writes block ``i`` IN PLACE into the stacked tensors of
        ``params[key]`` (the walk owns a private copy of them)."""
        _copy_into(take_layer(params[key], i), bp)
        return params
    return get, set_


def build_stages(cfg: ModelConfig, ctx: Ctx = DEFAULT_CTX) -> list:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"build_stages: family {cfg.family!r} is not ported yet "
            "(ROADMAP queue 1, 'Remaining families')")

    def init_x(params, batch):
        return transformer.embed_tokens(params, cfg, batch["tokens"])

    def apply(bp, x):
        pos = torch.arange(x.shape[1], device=x.device)
        out, _ = transformer.block(bp, x, cfg, ctx, positions=pos)
        return out

    get, set_ = _stacked_getset("blocks")
    return [Stage("decoder", cfg.num_layers, get, set_, init_x, apply)]
