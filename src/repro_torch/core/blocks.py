"""Block abstraction for block-wise reconstruction (paper Eq. 3).

An architecture is an ordered list of *stages*; each stage is a run of
structurally identical blocks.  The calibration walk
(``core/pipeline.quantize_model``) goes block by block: it collects the
block's inputs X and FP outputs block(theta, X), quantizes the block, and
writes it back.  The families ``dense``, ``moe`` and ``vlm`` are one stage
of decoder blocks (the VLM's stream starts from the patches and the
gemma-scaled tokens, under the prefix-LM mask), ``rwkv`` one stage of RWKV
blocks, and ``hybrid`` one stage a block in forward order: the mamba
layers with the shared attention block at each of its sites, calibrated at
its first site only.  ``encdec`` is two stages that hand data across: the
encoder stage saves its final (quantized) stream as ``"enc"``, and every
decoder block takes ``ln_enc(enc)`` as its per-sample ``aux`` stream (the
keys and values of its cross-attention).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, rwkv, ssm, transformer, vlm
from repro_torch.models.common import Ctx, DEFAULT_CTX, take_layer

# Leaf names that are quantizable linear weights; MoE expert weights reuse
# the dense names under "moe", with a leading expert dim.  Everything else
# (norms, the f32 router, conv kernels, the decay LoRA, token-shift mixers,
# embeddings, the head) stays as it is.
QUANT_LEAF_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "wr", "wg", "ck", "cv", "cr",                 # rwkv time/channel mix
    "in_proj", "out_proj",                        # mamba2
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
    # (params, batch, saved=None) -> (B, S, d) stream, or None: continue
    # the running stream; ``saved`` holds earlier stages' ``save_as``
    # streams
    init_x: Callable
    apply: Callable                # (bp, x, aux=None) -> x
    # (params, batches, saved) -> the per-sample aux stream of the whole
    # calibration set, beside x for every block of the stage (the encdec
    # decoder's encoder states), or None.  The walk calls it once a stage
    # with every batch (the reference calls it per batch and concatenates)
    make_aux: Callable = lambda params, batches, saved: None
    save_as: Optional[str] = None  # store the stage's final stream as this
    # False: the walk only advances the streams through the block (the
    # hybrid's shared block after its first site)
    calibrate: bool = True
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
    fam = cfg.family

    if fam in ("dense", "moe", "vlm"):
        prefix = cfg.num_patches if fam == "vlm" else None

        def init_x(params, batch, saved=None):
            if fam == "vlm":
                return vlm.assemble_inputs(params, cfg,
                                           vlm.patches_of(batch),
                                           batch["tokens"])
            return transformer.embed_tokens(params, cfg, batch["tokens"])

        def apply(bp, x, aux=None):
            pos = torch.arange(x.shape[1], device=x.device)
            out, _ = transformer.block(bp, x, cfg, ctx, positions=pos,
                                       prefix_len=prefix)
            return out

        get, set_ = _stacked_getset("blocks")
        return [Stage("decoder", cfg.num_layers, get, set_, init_x, apply)]

    if fam == "rwkv":
        def init_x(params, batch, saved=None):
            return params["embed"][batch["tokens"]]

        def apply(bp, x, aux=None):
            return rwkv.block(bp, x, cfg, ctx)[0]

        get, set_ = _stacked_getset("blocks")
        return [Stage("rwkv", cfg.num_layers, get, set_, init_x, apply)]

    if fam == "hybrid":
        return _hybrid_stages(cfg, ctx)

    if fam == "encdec":
        return _encdec_stages(cfg, ctx)

    raise ValueError(f"build_stages: unknown family {fam!r}")


def _encdec_stages(cfg: ModelConfig, ctx: Ctx) -> list:
    """The encoder stage (its final stream saved as ``"enc"``), then the
    decoder stage, whose blocks all take ``ln_enc(saved["enc"])`` as
    ``aux``."""
    def enc_init(params, batch, saved=None):
        return encdec.embed_frames(params, cfg, encdec.frames_of(batch))

    def enc_apply(bp, x, aux=None):
        return encdec.encoder_block(bp, x, cfg, ctx)

    def dec_init(params, batch, saved=None):
        return encdec.embed_tokens(params, cfg, batch["tokens"])

    def dec_aux(params, batches, saved):
        return encdec._ln(saved["enc"], params["ln_enc"], cfg.norm_eps)

    def dec_apply(bp, x, aux=None):
        return encdec.decoder_block(bp, x, aux, cfg, ctx)

    eget, eset = _stacked_getset("encoder")
    dget, dset = _stacked_getset("decoder")
    return [
        Stage("encoder", cfg.encoder_layers, eget, eset, enc_init, enc_apply,
              save_as="enc", pack_target=lambda i: ("encoder", i)),
        Stage("decoder", cfg.num_layers, dget, dset, dec_init, dec_apply,
              make_aux=dec_aux, pack_target=lambda i: ("decoder", i)),
    ]


def _hybrid_stages(cfg: ModelConfig, ctx: Ctx) -> list:
    """One stage a block, in forward order: the mamba layers, and after
    each full segment the shared block.  The shared weights are calibrated
    at their first site; later sites only advance the streams through the
    (by then quantized) block.  Only the first stage starts a stream."""
    get_mamba, set_mamba = _stacked_getset("blocks")
    get_attn, set_attn = _stacked_getset("shared_attn")
    shared = hybrid.shared_cfg(cfg)

    def init_x(params, batch, saved=None):
        return params["embed"][batch["tokens"]]

    def mamba_apply(bp, x, aux=None):
        return ssm.mamba_block(bp, x, cfg, ctx)[0]

    def attn_apply(bp, x, aux=None):
        pos = torch.arange(x.shape[1], device=x.device)
        return transformer.block(bp, x, shared, ctx, positions=pos)[0]

    stages = []
    seen_attn = False
    for (s, e, attn_after) in hybrid._segments(cfg):
        for j in range(s, e):
            stages.append(Stage(
                f"mamba{j}", 1, (lambda j: lambda p, _: get_mamba(p, j))(j),
                (lambda j: lambda p, _, bp: set_mamba(p, j, bp))(j),
                init_x if not stages else (lambda p, b, s=None: None),
                mamba_apply,
                pack_target=(lambda j: lambda _: ("blocks", j))(j)))
        if attn_after:
            site = sum(st.name.startswith("attn") for st in stages)
            stages.append(Stage(
                f"attn{site}", 1, lambda p, _: get_attn(p, 0),
                lambda p, _, bp: set_attn(p, 0, bp),
                lambda p, b, s=None: None,
                attn_apply, calibrate=not seen_attn,
                pack_target=lambda _: ("shared_attn", 0)))
            seen_attn = True
    return stages
