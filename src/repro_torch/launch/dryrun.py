"""Multi-pod dry-run: prove every (arch x shape x mesh) step runs as a rank
of its mesh at full size, and emit its memory and roofline terms — without
the hardware.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
        --shape train_4k --mesh single [--quant W2A16g128] [--out f.json]
        [--layers N] [--tokens B,S]

A cell runs in its own process (this CLI) as rank 0 of torch's ``"fake"``
process group at the mesh's world size (256 for ``single``, 512 for
``multi``, the product for ``"d,m"``): the group's collectives move
nothing, and the rank builds its view of the mesh on the ``"meta"``
device (``launch.mesh.make_mesh`` / ``make_production_mesh``).  The step
is the reference's non-kernel program (the ``"xla"`` backend) run eagerly
on fake tensors (``FakeTensorMode``: shapes and dtypes, nothing
allocated) under ``hlo_stats.OpCounter``, which records its FLOPs, bytes,
collectives and host transfers.  The fake group is torch's test API
(``torch.testing._internal.distributed.fake_pg``), private; the tests and
the card's smoke run pin it.

The JSON keys are the reference's.  ``memory`` is the rank's:

* ``argument_bytes``: its slices of the step's arguments (params and
  optimizer state under their shardings, the cache under
  ``cache_shardings``, the batch's rows under ``batch_shardings``);
* ``output_bytes``: what the step returns (global logits on every rank,
  the new slices);
* ``temp_bytes``: the high-water mark of the bytes the step's ops
  allocated, less what its outputs still hold at the end;
* ``alias_bytes``: outputs that reuse an argument's storage (written in
  place);
* ``peak_hbm_per_device``: argument + output + temp - alias.

``whole_program`` counts every layer, since the eager loop runs each one
(the reference counts a ``lax.scan`` body once and corrects by depth
differencing); ``per_layer`` and ``overhead`` still come from the same step
at depths 1 and 2 (:func:`_depth_cfg`), and ``overhead + L * per_layer``
equals the whole.  ``compile_secs`` is the seconds the counted run took:
nothing is compiled.  The roofline is at the H100's data-sheet peaks
(``hlo_stats``).

A train cell counts the port's mesh train step
(``launch.steps.make_train_harness``) of any family: the leaves of
``train_plan`` stay split over ``model`` and the step's collectives are
its region entries and exits (all-reduces over the model group; with
``--seq-parallel`` all-gathers and reduce-scatters of the residual rows),
the sums of the replicated leaves a split region reads, its
vocab-parallel loss and the ``fsdp`` gathers over the data axes; a leaf
placed on ``model`` that the plan leaves whole (a group that does not
divide, such as PaliGemma's attention with its one KV head, or RWKV's
``cr``) is gathered whole by broadcasts.  ``--seq-parallel`` is taken by
every train cell.  ``--attn-seq-parallel`` (the reference's ``{"seq":
("model",)}``) is taken by every train cell too: the attention of the
dense, MoE, VLM and hybrid families then splits by its query rows where
the sequence divides by ``model`` (all-gathers of each layer's k / v and
of its attention weights, reduce-scatters of their gradients), and RWKV6's
and the encoder-decoder's steps, which carry no ``"seq"`` label, count as
without it.  Serve cells refuse both flags (ROADMAP queue 1, item 10):
the GSPMD serve steps split no activations, so a cell would count the
program without them.

A serve cell counts the port's GSPMD serve steps, which gather every
weight split over ``model`` and each row's cache lane on every step: its
collectives, ``temp_bytes`` and FLOPs are that design's, not what a
sharded program would move or hold, and the JSON's ``counted`` says so.
Its ``kernel_modeled.t_step`` therefore leaves the counted collectives and
FLOPs out (the fused line at ``model_flops``).

``--layers`` cuts the arch to ``N`` layers (an encoder-decoder's encoder
alike) and ``--tokens`` sets the shape's rows and sequence length (the
VLM's sequence holds its patches): a cell at the size a smaller run
trains, whose ``collective_ops`` (calls and bytes a torch op, as the
counter records them) are that run's exchange a step, from the shapes
alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ModelConfig, QuantConfig, ShapeConfig
from repro_torch.core.qtensor import QTensor
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.sharding import (SERVE_OVERRIDES, MeshPlacement,
                                         batch_shardings, shard_shape,
                                         shard_tree)
from repro_torch.launch.steps import (make_serve_steps, make_train_harness,
                                      prefill_input_specs,
                                      quantize_param_struct,
                                      serve_input_specs, train_input_specs)
from repro_torch.models import get_model
from repro_torch.optim.adam import tree_map

_QUANT_RE = re.compile(r"W(\d+)A(\d+)(?:g(\d+))?$")


def parse_quant(tag):
    """'W2A16g128' -> QuantConfig (the ``"xla"`` backend); '' or 'none' ->
    None."""
    if not tag or tag == "none":
        return None
    m = _QUANT_RE.match(tag)
    if not m:
        raise ValueError(f"bad quant tag {tag}")
    bits, act, g = int(m.group(1)), int(m.group(2)), m.group(3)
    return QuantConfig(bits=bits, group_size=int(g) if g else None,
                       act_bits=None if act >= 16 else act,
                       kernel_backend="xla")


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, tuples (an optimizer state, a step's
    outputs) and QTensors."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif isinstance(tree, QTensor):
        tree = [tree.packed, tree.scale, tree.zero, tree.act_scale]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in _leaves(tree)}


def _rows_bytes(mesh, batch: dict) -> int:
    """The bytes of the rank's rows of a batch under ``batch_shardings``."""
    specs = batch_shardings(mesh, batch)
    return sum(math.prod(shard_shape(v.shape, specs[k])) * v.element_size()
               for k, v in batch.items())


def _fake_group(world: int) -> None:
    """This process as rank 0 of a ``"fake"`` group of ``world`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(mesh_kind: str):
    """The mesh's world size and a builder of rank 0's view of it."""
    if mesh_kind in ("single", "multi"):
        multi = mesh_kind == "multi"
        return (512 if multi else 256), lambda: make_production_mesh(
            multi_pod=multi, device="meta")
    dims = tuple(int(x) for x in mesh_kind.split(","))
    return math.prod(dims), lambda: make_mesh(dims, device="meta")


def _run_step(cfg: ModelConfig, shape: ShapeConfig, mesh, qcfg, *,
              attn_chunk, microbatches=1, grad_compression=False,
              serve_sharding="tp", kv_bits=None, seq_parallel=False,
              attn_seq_parallel=False):
    """Run one step of ``cfg`` as rank 0 of ``mesh`` on fake tensors under
    an ``OpCounter``; returns (counter, memory dict)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = get_model(cfg)
    with FakeTensorMode():
        # the init draws from a CPU generator; the fakes then move to the
        # mesh's device, where every other input of the step lies
        params = tree_map(lambda t: t.to(mesh.device),
                          model.init_params(0, "cpu"))
        if shape.kind == "train":
            h = make_train_harness(cfg, mesh, attn_chunk=attn_chunk,
                                   microbatches=microbatches,
                                   grad_compression=grad_compression,
                                   seq_parallel=seq_parallel,
                                   extra_overrides=(
                                       {"seq": ("model",)}
                                       if attn_seq_parallel else None))
            local = shard_tree(params, h.param_sharding)
            del params
            opt = h.init_opt(local)
            batch = train_input_specs(cfg, shape)
            args = (local, opt)
            arg_bytes = _nbytes(args) + _rows_bytes(mesh, batch)

            def step():
                return h.step_fn(local, opt, batch)
        else:
            if qcfg is not None:
                params = quantize_param_struct(params, cfg, qcfg)
            cmodel, pstep, dstep = make_serve_steps(
                cfg, mesh, act_bits=qcfg.act_bits if qcfg else None,
                attn_chunk=attn_chunk, kernel_backend="xla", kv_bits=kv_bits)
            placed = MeshPlacement.place(
                mesh, cfg, params,
                SERVE_OVERRIDES if serve_sharding == "tp" else None)
            del params
            if shape.kind == "prefill":
                ins = prefill_input_specs(cfg, shape)
                batch = ins["batch"]
            else:
                ins = serve_input_specs(cfg, shape, kv_bits=kv_bits)
                batch = {"t": ins["tokens"], "p": ins["pos"]}
            cache = cmodel.init_cache(shape.global_batch, shape.seq_len,
                                      _leaves(ins["cache"])[0].dtype,
                                      mesh.device)
            args = (placed.params, cache)
            arg_bytes = _nbytes(args) + _rows_bytes(mesh, batch)

            def step():
                if shape.kind == "prefill":
                    return pstep(placed, batch, cache)
                return dstep(placed, cache, batch["t"], batch["p"])
        counter = hlo_stats.OpCounter()
        with counter:
            out = step()
        held = _storages(args)
        alias = sum(t.numel() * t.element_size() for t in _leaves(out)
                    if t.untyped_storage()._cdata in held)
        out_bytes = _nbytes(out)
        temp = counter.peak_live_bytes - counter.live_bytes
        del out
    return counter, {
        "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        "temp_bytes": temp, "alias_bytes": alias,
        "peak_hbm_per_device": arg_bytes + out_bytes + temp - alias}


# what a serve cell's counted terms (``memory``, ``whole_program``,
# ``collectives``, ``roofline``) describe
_COUNTED_SERVE = (
    "the port's GSPMD serve steps: each rank gathers every weight split "
    "over model and its rows' cache lane, and runs the whole model on its "
    "rows; the collectives and temp bytes are those gathers', the FLOPs "
    "past model_flops that whole model's; not what a sharded program "
    "moves or holds")
_COUNTED_TRAIN = (
    "the port's mesh train step: the leaves train_plan splits stay split "
    "over model, its collectives the region entries' and exits' (with "
    "seq_parallel all-gathers and reduce-scatters of the residual rows; "
    "with attn_seq_parallel each layer's all-gather of its rows' k / v and "
    "reduce-scatter of their gradient, and the all-gather of its "
    "attention weights and reduce-scatter of theirs), the replicated "
    "leaves' gradient sums, the vocab-parallel loss's and the fsdp "
    "gathers'; the leaves on model the plan leaves whole gathered by "
    "broadcasts")


def _depth_cfg(cfg: ModelConfig, depth_mult: int) -> ModelConfig:
    """Depth-reduced config for differencing."""
    if cfg.family == "hybrid":
        return cfg.replace(num_layers=cfg.attn_every * depth_mult)
    kw = {"num_layers": depth_mult}
    if cfg.family == "encdec":
        kw["encoder_layers"] = depth_mult
    return cfg.replace(**kw)


def run_cell(arch: str, shape_name: str, mesh_kind: str, quant: str = "",
             attn_chunk: int = 512, block_correction: bool = True,
             verbose: bool = True, microbatches: int = 1,
             seq_parallel: bool = False, grad_compression: bool = False,
             serve_sharding: str = "tp", attn_seq_parallel: bool = False,
             kv_bits=None, layers=None, tokens=None):
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers, **(
            {"encoder_layers": layers} if cfg.family == "encdec" else {}))
    shape = SHAPES_BY_NAME[shape_name]
    if tokens is not None:
        shape = dataclasses.replace(shape, global_batch=tokens[0],
                                    seq_len=tokens[1])
    for flag, on in (("--seq-parallel", seq_parallel),
                     ("--attn-seq-parallel", attn_seq_parallel)):
        if on and shape.kind != "train":
            raise ValueError(
                f"dryrun: {flag} splits rows of the mesh train step; the "
                f"GSPMD serve steps gather whole weights and split no "
                f"activations, so a serve cell would count the program "
                f"without it (ROADMAP queue 1, item 10)")
    ok, why = cfg.shape_valid(shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "why": why}

    world, build = _mesh(mesh_kind)
    _fake_group(world)
    mesh = build()
    chips = mesh.world
    qcfg = parse_quant(quant)
    opts = dict(attn_chunk=attn_chunk, microbatches=microbatches,
                grad_compression=grad_compression,
                serve_sharding=serve_sharding, kv_bits=kv_bits,
                seq_parallel=seq_parallel,
                attn_seq_parallel=attn_seq_parallel)

    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "chips": chips, "quant": quant or "fp16",
              "kind": shape.kind, "status": "ok",
              "opts": dict(opts),
              "counted": (_COUNTED_TRAIN if shape.kind == "train"
                          else _COUNTED_SERVE)}

    t0 = time.time()
    counter, result["memory"] = _run_step(cfg, shape, mesh, qcfg, **opts)
    result["compile_secs"] = time.time() - t0
    whole = hlo_stats.cost_terms(counter)
    result["whole_program"] = {k: v for k, v in whole.items()
                               if k != "coll_detail"}
    result["collectives"] = whole["coll_detail"]
    ops: dict = {}
    for c in counter.collectives:
        calls, nbytes = ops.get(c.op, (0, 0))
        ops[c.op] = (calls + 1, nbytes + c.nbytes)
    result["collective_ops"] = ops
    result["host_transfers"] = hlo_stats.host_transfer_ops(counter)

    if block_correction:
        d1cfg, d2cfg = _depth_cfg(cfg, 1), _depth_cfg(cfg, 2)
        d1, d2 = d1cfg.num_layers, d2cfg.num_layers
        t1 = hlo_stats.cost_terms(_run_step(d1cfg, shape, mesh, qcfg,
                                            **opts)[0])
        t2 = hlo_stats.cost_terms(_run_step(d2cfg, shape, mesh, qcfg,
                                            **opts)[0])
        per_layer = {k: (t2[k] - t1[k]) / (d2 - d1)
                     for k in ("flops", "bytes", "coll")}
        result["per_layer"] = per_layer
        result["overhead"] = {k: t1[k] - d1 * per_layer[k]
                              for k in ("flops", "bytes", "coll")}

    terms = hlo_stats.compose(whole, None, cfg.num_layers, chips)
    result["roofline"] = terms.as_dict()
    mf = hlo_stats.model_flops(cfg, shape, shape.kind)
    result["model_flops"] = mf
    result["useful_ratio"] = mf / max(terms.flops, 1.0)
    kb = hlo_stats.kernel_modeled_bytes(cfg, shape, shape.kind,
                                        qcfg.bits if qcfg else None)
    t_memory = kb / (chips * hlo_stats.HBM_BW)
    if shape.kind == "train":
        t_step = max(t_memory, terms.t_compute, terms.t_collective)
    else:
        # the counted serve program's gathers and FLOPs are the port's
        # (``_COUNTED_SERVE``): the fused line takes the model's FLOPs and
        # no collective
        t_step = max(t_memory, mf / (chips * hlo_stats.PEAK_FLOPS))
    result["kernel_modeled"] = {"bytes": kb, "t_memory": t_memory,
                                "t_step": t_step}

    if verbose:
        r = result["roofline"]
        print(f"{arch} {shape_name} {mesh_kind} [{result['quant']}]: "
              f"compute={r['t_compute']:.3e}s memory={r['t_memory']:.3e}s "
              f"collective={r['t_collective']:.3e}s -> {r['bottleneck']} "
              f"(counted in {result['compile_secs']:.0f}s)")
        print("  memory:", result["memory"])
        print("  collectives:", "; ".join(
            f"{op} {n} calls, {b / 1e9:.4f} GB" for op, (n, b) in
            sorted(result["collective_ops"].items())) or "none")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single",
                    help="single | multi | 'd,m' (e.g. 2,4 for tests)")
    ap.add_argument("--quant", default="",
                    help="e.g. W2A16g128, W4A4, W4A16g128; empty = fp16")
    ap.add_argument("--attn-chunk", type=int, default=512)
    ap.add_argument("--no-block-correction", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--attn-seq-parallel", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--serve-sharding", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--kv-bits", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to this many layers")
    ap.add_argument("--tokens", default="",
                    help="'B,S': the shape's rows and sequence length")
    args = ap.parse_args(argv)

    try:
        res = run_cell(args.arch, args.shape, args.mesh, args.quant,
                       attn_chunk=args.attn_chunk,
                       block_correction=not args.no_block_correction,
                       microbatches=args.microbatches,
                       seq_parallel=args.seq_parallel,
                       attn_seq_parallel=args.attn_seq_parallel,
                       grad_compression=args.grad_compression,
                       serve_sharding=args.serve_sharding,
                       kv_bits=args.kv_bits or None, layers=args.layers,
                       tokens=(tuple(int(x) for x in args.tokens.split(","))
                               if args.tokens else None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 0 if res["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
