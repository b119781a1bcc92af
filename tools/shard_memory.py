"""Bytes a rank of the sharded reconstruction engine holds for one block of a
dense config, from the shapes alone (meta tensors: nothing is allocated).

    PYTHONPATH=src python tools/shard_memory.py [--arch llama3-405b]
        [--quant W2A16g128] [--tp 1 2 4 8]

For each TP degree (a ``(1, tp)`` mesh: ``launch.sharding.ParamSpec``
decides each leaf's split, and a leaf whose dim does not divide stays
whole) it prints, in GB (1e9 bytes):

* persistent, kept between steps: the rank's slices of ν and v, of their
  two Adam moments, of the frozen state (masks, bases, scales, zeros,
  act_scale) and of the block's weights;
* step, held whole during a Soften step: ν and v gathered over the model
  group (none at TP 1: they are the persistent arrays), θ̂, the gradient's
  running total and one lane's gradient with respect to θ̂, and the
  pullback's dν and dv;
* run, held whole during a ``run`` call (a PAR iteration): the frozen
  state and the block's weights gathered (none at TP 1).

The per-sample forward and backward's activations (which grow with the
sequence length) and the calibration streams are not counted.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.quantizer import resolve_group
from repro_torch.core.tesseraq import _leaf_state
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.serve import parse_quant
from repro_torch.launch.sharding import ParamSpec, shard_tree

META = torch.device("meta")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return 0 if tree is None else tree.numel() * tree.element_size()


def dense_block(cfg):
    """The dense block's leaves on the meta device, in the model dtype."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    shapes = {"ln1": (d,), "ln2": (d,),
              "wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
              "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d),
              "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return {k: torch.empty(s, dtype=torch.bfloat16, device=META)
            for k, s in shapes.items()}


def block_states(bp, qcfg):
    """TesseraQ's per-linear state of every linear of ``bp`` (AWQ's
    act_scale included)."""
    states = {}
    for k, w in bp.items():
        if w.ndim < 2:
            continue
        ng = w.shape[0] // resolve_group(w.shape[0], qcfg.group_size)
        meta = {"scale": torch.empty(ng, w.shape[1], device=META),
                "zero": torch.empty(ng, w.shape[1], device=META),
                "act_scale": torch.empty(w.shape[0], device=META)}
        states[(k,)] = _leaf_state(w, meta, qcfg)
    return states


def rank_bytes(bp, states, tp: int) -> dict:
    mesh = Mesh(world=tp, rank=0, shape=(1, tp), group=None, device=META)
    spec = ParamSpec.for_mesh(mesh)
    specs = spec.state_specs(states)
    local = shard_tree(states, specs, mesh)
    tr = {p: {k: st[k] for k in ("nu", "v")} for p, st in local.items()}
    frozen = {p: {k: v for k, v in st.items() if k not in ("nu", "v")}
              for p, st in local.items()}
    block = shard_tree(bp, spec.block_specs(bp), mesh)
    whole_tr = _nbytes({p: {k: st[k] for k in ("nu", "v")}
                        for p, st in states.items()})
    theta = sum(st["nu"].numel() * 4 for st in states.values())
    whole_frozen = _nbytes(states) - whole_tr + _nbytes(bp)
    out = {"trainable": _nbytes(tr), "moments": 2 * _nbytes(tr),
           "frozen": _nbytes(frozen), "block": _nbytes(block)}
    out["persistent"] = sum(out.values())
    out["step"] = ((whole_tr if tp > 1 else 0) + theta + 2 * theta
                   + whole_tr)
    out["run"] = whole_frozen if tp > 1 else 0
    out["split"] = sorted(p[0] for p, sp in specs.items()
                          if sp["nu"] is not None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-405b")
    ap.add_argument("--quant", default="W2A16g128")
    ap.add_argument("--tp", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    qcfg = parse_quant(args.quant)
    bp = dense_block(cfg)
    states = block_states(bp, qcfg)
    n = sum(st["nu"].numel() for st in states.values())
    print(f"{cfg.name} one block at {args.quant}: {n} rounding variables; "
          "GB a rank (1e9 B)")
    for tp in args.tp:
        b = rank_bytes(bp, states, tp)
        gb = {k: b[k] / 1e9 for k in ("trainable", "moments", "frozen",
                                       "block", "persistent", "step", "run")}
        print(f"TP {tp}: persistent {gb['persistent']:.2f} (nu+v "
              f"{gb['trainable']:.2f}, moments {gb['moments']:.2f}, frozen "
              f"{gb['frozen']:.2f}, block {gb['block']:.2f}); step "
              f"{gb['step']:.2f}; run {gb['run']:.2f}; total "
              f"{gb['persistent'] + gb['step'] + gb['run']:.2f}; split "
              f"{','.join(b['split'])}")


if __name__ == "__main__":
    main()
