"""Roofline accounting from a recorded op stream.

The reference lowers each step to XLA and reads its cost from the compiled
program: ``cost_analysis`` for FLOPs and bytes accessed, and the optimized
HLO text for collectives and host transfers.  PyTorch runs eagerly and has
no HLO, so here every count comes from the dispatcher: :class:`OpCounter`
is a ``TorchDispatchMode`` that sees each aten op and each ``c10d``
collective a step issues, on real tensors or on fake ones (the dry-run),
and records

* FLOPs by ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
  attention);
* bytes as each op's inputs plus its outputs: the unfused upper bound, like
  XLA's "bytes accessed" of an unfused program (a view moves nothing);
* each collective with its tensor bytes and its group's size;
* host transfers: ``aten._local_scalar_dense`` (``.item()``) and copies
  from a device to the CPU;
* the high-water mark of the bytes its ops' outputs keep alive
  (``temp_bytes``).

:func:`collective_bytes` prices the collectives with the reference's ring
factors: all-reduce 2(n-1)/n, all-gather / all-to-all (n-1)/n,
reduce-scatter n-1 (on its result), collective-permute 1.  The torch op
that stands for each reference kind is in :data:`C10D_KINDS`; the port's
gathers are one ``broadcast_`` a member (``launch.sharding.unshard_leaf``),
whose slices add up to the gathered result, so a broadcast is priced as its
share of an all-gather.

The roofline's constants are the data-sheet peaks of the card the port
runs on, an NVIDIA H100 80GB HBM3 (SXM) as ``nvidia-smi`` names it: 989e12
dense bf16 FLOP/s, 3.35e12 B/s of HBM3, and 450e9 B/s a direction of
NVLink (:data:`NVLINK_BW`, where the reference's TPU v5e constants had
``ICI_BW``, its inter-chip link).

The eager loop runs every layer, so a whole step's count needs no
correction for a scan body counted once; the dry-run still reports a
layer's cost and the step's overhead from depths 1 and 2.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

CARD = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s
INT8_PEAK_OPS = 1979e12      # dense int8 op/s
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction

_FACTORS = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: float(n - 1),   # applied to the (small) result
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}

# c10d op -> the reference's collective kind it stands for
C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "broadcast_": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# the tensor arguments whose bytes a c10d op is priced on: the gathered
# output of an all-gather, the result of a reduce-scatter, the tensors of
# every other kind
_C10D_PRICED = {"allgather_": 0, "_allgather_base_": 0,
                "reduce_scatter_": 0, "_reduce_scatter_base_": 0}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> Optional[int]:
    """The size of the process group among a c10d op's arguments."""
    for a in args:
        if (isinstance(a, torch.ScriptObject)
                and a._type().qualified_name().endswith("c10d.ProcessGroup")):
            return dist.ProcessGroup.unbox(a).size()
    return None


@dataclasses.dataclass
class Collective:
    """One collective a step issued: the reference kind it stands for, its
    torch op, the bytes of the tensors it is priced on, its group's size."""
    kind: str
    op: str
    nbytes: int
    group: int


class OpCounter(TorchDispatchMode):
    """Counts what a step does, op by op (see the module docstring):
    ``flops``, ``bytes``, ``collectives`` (a list of :class:`Collective`),
    ``host_transfers`` (op names), ``ops`` (aten ops run) and
    ``peak_live_bytes`` / ``live_bytes`` over the storages its ops
    allocated.  Enter it inside a ``FakeTensorMode`` to count a step at any
    size without allocating."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives: list = []
        self.host_transfers: list = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._refs: Dict[int, list] = {}     # storage -> [tensors, bytes]

    # -- live bytes ----------------------------------------------------------
    def _track(self, outs, inputs) -> None:
        seen = {t.untyped_storage()._cdata for t in inputs}
        for t in outs:
            key = t.untyped_storage()._cdata
            if key in seen:
                continue
            if key not in self._refs:
                n = t.untyped_storage().nbytes()
                self._refs[key] = [0, n]
                self.live_bytes += n
                self.peak_live_bytes = max(self.peak_live_bytes,
                                           self.live_bytes)
            self._refs[key][0] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live_bytes -= ref[1]
            del self._refs[key]

    # -- the dispatcher ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace == "c10d":
            kind = C10D_KINDS.get(name)
            if kind is not None:
                at = _C10D_PRICED.get(name)
                priced = _tensors(args[0] if at is None else args[at])
                if name == "recv_":
                    priced = []           # the sender's bytes price the hop
                self.collectives.append(Collective(
                    kind, name, sum(_nbytes(t) for t in priced),
                    _group_size(args) or 1))
            return out
        if func.namespace != "aten":
            return out
        self.ops += 1
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out)
        if name == "_local_scalar_dense":
            self.host_transfers.append(name)
        elif name in ("_to_copy", "copy_") and outs and ins:
            src = ins[-1] if name == "copy_" else ins[0]
            if outs[0].device.type == "cpu" and src.device.type != "cpu":
                self.host_transfers.append(name)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
        self._track(outs, ins)
        return out


def collective_bytes(record) -> Dict:
    """Modeled bytes on the wire per collective kind over an
    :class:`OpCounter`'s ``collectives`` (a group of one moves nothing)."""
    per_kind: Dict[str, float] = {}
    for c in record:
        if c.group < 2:
            continue
        per_kind[c.kind] = (per_kind.get(c.kind, 0.0)
                            + c.nbytes * _FACTORS[c.kind](c.group))
    return {"per_kind": per_kind, "total": sum(per_kind.values()),
            "n_ops": len(record)}


def collective_op_counts(record) -> Dict[str, int]:
    """Collectives per torch op (``allreduce_``, ``broadcast_``, ...): the
    contract a serve or recon step pins, as the reference's HLO lint pins
    the kinds in its optimized HLO."""
    counts: Dict[str, int] = {}
    for c in record:
        counts[c.op] = counts.get(c.op, 0) + 1
    return counts


def host_transfer_ops(counter: OpCounter) -> int:
    """Ops of a step that move data to the host: zero for the hot serving
    and recon steps (a nonzero count is a host value read inside the
    step)."""
    return len(counter.host_transfers)


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    bytes_hbm: float
    bytes_coll: float
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.bytes_coll / (self.chips * NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total(self) -> float:
        # roofline: overlapped execution -> max term bounds the step
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "bytes_hbm": self.bytes_hbm,
            "bytes_coll": self.bytes_coll, "chips": self.chips,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck, "t_total": self.t_total,
        }


def cost_terms(counter: OpCounter, scale: float = 1.0) -> Dict:
    """One rank's FLOPs, bytes and collective bytes from a step's record."""
    coll = collective_bytes(counter.collectives)
    return {"flops": counter.flops * scale, "bytes": counter.bytes * scale,
            "coll": coll["total"] * scale, "coll_detail": coll}


def compose(whole: Dict, block: Optional[Dict], n_layers: int,
            chips: int) -> RooflineTerms:
    """The mesh's totals from one rank's: ``whole`` plus ``n_layers - 1``
    more ``block``s where the whole counted a layer once (None: it counted
    every layer, as the eager loop does), times ``chips``."""
    f, b, c = whole["flops"], whole["bytes"], whole["coll"]
    if block is not None and n_layers > 1:
        f += (n_layers - 1) * block["flops"]
        b += (n_layers - 1) * block["bytes"]
        c += (n_layers - 1) * block["coll"]
    return RooflineTerms(flops=f * chips, bytes_hbm=b * chips,
                         bytes_coll=c * chips, chips=chips)


def kernel_modeled_bytes(cfg, shape, kind: str, bits: Optional[int]) -> float:
    """Analytic lower bound on HBM traffic per step with fully-fused kernels
    (packed weights read once, dequantized on chip, attention never
    materializing scores): the optimized-kernel roofline line beside the
    unfused upper bound the op stream counts."""
    n_active = cfg.active_param_count()
    wbytes = n_active * {2: 0.25, 3: 0.5, 4: 0.5, 8: 1.0}.get(bits, 2.0)
    hd = cfg.resolved_head_dim
    B, S = shape.global_batch, shape.seq_len
    kv_per_tok = 2 * cfg.num_kv_heads * hd * 2 * cfg.num_layers
    if cfg.family in ("rwkv", "hybrid"):
        kv_per_tok = 0   # O(1) state
    act_bytes = 0.0
    if kind == "train":
        # params fwd+bwd (3x streams) + opt state + remat carries
        return 3 * n_active * 2 + n_active * 8 + B * S * cfg.d_model * 2 * \
            cfg.num_layers
    if kind == "prefill":
        return wbytes + B * S * kv_per_tok + B * S * cfg.d_model * 2 * \
            cfg.num_layers * 4
    # decode: read weights once + read full KV cache + write one slot
    state = (cfg.num_layers * B * cfg.num_heads * hd * hd * 4
             if cfg.family in ("rwkv", "hybrid") else B * S * kv_per_tok)
    return wbytes + state + act_bytes


def model_flops(cfg, shape, kind: str) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D per forward token (decode/
    prefill), N = active params."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch                      # decode: one token each
    return 2.0 * n * tokens
