"""The serving stack's tensor-parallel placement contract (``ServeSpec``).

The reference's serve-time TP runs each family's step under ``shard_map``
with per-leaf specs; here each rank of a :class:`launch.mesh.Mesh`
holds its LOCAL shard of every split leaf and runs the family forward on
it.  What the reference expresses as spec trees plus ``place_params`` is
:func:`shard_serve_params`: the global tree sliced into the rank's local
tree once, at placement.  The split tables are family-keyed because leaf
names collide across families with different layouts (rwkv's time-mix
``wk``/``wv`` feed a global per-head group norm, so rwkv splits only its
channel-mix pair).

Feasibility is decided per ATOMIC GROUP: an out-split producer and its
in-split consumer must agree (``wo`` consumes the heads ``wq``/``wk``/``wv``
produced; ``w_down`` the d_ff ``w_gate``/``w_up`` produced), so if any
member cannot split — head counts, or a QTensor's group-count or packed-row
dims not dividing the TP degree — the whole group replicates.  Embedding
and head stay replicated: the only collective a serve step makes is the
all-reduce at the end of an in-split linear (``models.layers.PsumWeight``)
and of the expert-local MoE FFN.

All of this is a pure function of shapes.

The reconstruction stack's side of the contract is :class:`ParamSpec`: for
every per-block array the sharded engine carries (the weight, ν / v and
their frozen companions, and through them the Adam moments) the dim it
splits over the ``model`` axis, or None where it replicates.

Training on a mesh reads the reference's logical-axis rules:
:func:`logical_table` maps logical dim names to mesh axes,
:func:`resolve_spec` turns a leaf's logical dims into a
:class:`PartitionSpec` (a dim that does not divide by its axes' extent
replicates, and the first dim to claim an axis keeps it), and
:func:`param_shardings` / :func:`batch_shardings` give a tree of
:class:`NamedSharding` for params (``QTensor``-aware) and batches.  Each
rank holds the slice its shardings name (:func:`shard_tree`) and gathers
whole leaves from the slices with :func:`unshard_tree`.

The reference's GSPMD serve path reads the same rules: params under
``param_shardings(..., SERVE_OVERRIDES)`` (weights resident over ``model``,
no ``fsdp`` split), caches under :func:`cache_shardings`, and activations
under the constraints whose specs :func:`make_sharder` names (the port
applies none as constraints: its serve fork holds whole activations, and
its mesh train step writes out the split the constraints on heads, vocab
and ``res_seq`` ask for, ``launch.steps.train_plan``).  :class:`MeshPlacement` is one rank's placement of a serve
param tree on such a mesh, and :func:`mesh_cache_model` a model whose
caches are the rank's slices, their layout recorded on the mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import PACK_FACTOR, QTensor
from repro_torch.launch.mesh import (dp_axes, tp_axis, tp_size,
                                     validate_single_pod)
from repro_torch.models.common import (LEAF_FIXED, LEAF_TOKEN, _get_leaf,
                                       _leaf_paths, _set_leaf)
from repro_torch.models.layers import PsumWeight

# --------------------------------------------------------------------------
# ParamSpec: the reconstruction stack's tensor-parallel placement contract
# --------------------------------------------------------------------------

# leaf name -> logical dims of the trailing (in, out) dims, the reference's
# table; ``recon_split`` reads where ``tensor`` sits
PARAM_RULES = {
    "wq": ("fsdp", "tensor"), "wk": ("fsdp", "tensor"),
    "wv": ("fsdp", "tensor"), "wo": ("tensor", "fsdp"),
    "w_gate": ("fsdp", "tensor"), "w_up": ("fsdp", "tensor"),
    "w_down": ("tensor", "fsdp"),
    # rwkv
    "wr": ("fsdp", "tensor"), "wg": ("fsdp", "tensor"),
    "ck": ("fsdp", "tensor"), "cv": ("tensor", "fsdp"),
    "cr": ("fsdp", "tensor"),
    # mamba2
    "in_proj": ("fsdp", None), "out_proj": ("tensor", "fsdp"),
    # embeddings / head
    "embed": ("vocab", "fsdp"), "head": ("fsdp", "vocab"),
    "router": (None, None),
}

# TesseraQ's per-linear state layouts (``core.tesseraq._leaf_state``): the
# rounding variables and their frozen companions in the grouped weight
# layout, the DST / scale family in the per-group layout
RECON_GROUPED_KEYS = ("nu", "hard", "base")     # (..., ng, g, out)
RECON_GROUPVEC_KEYS = ("v", "scale", "zero")    # (..., ng, out)


def recon_split(name: str) -> Optional[str]:
    """Which weight channel a reconstruction leaf splits over the TP axis:
    ``"out"`` for output-channel-split linears (q/k/v/gate/up: ``tensor``
    on their out dim), ``"in"`` for input-channel-split ones (o/down),
    None for everything else."""
    rule = PARAM_RULES.get(name)
    if not rule or len(rule) < 2:
        return None
    if rule[-1] == "tensor":
        return "out"
    if rule[0] == "tensor":
        return "in"
    return None


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Tensor-parallel placement contract for block reconstruction.

    For every per-block array the sharded engine carries, the dim (an
    index into its shape) it splits over ``tp_axis(mesh)``, or None where
    it replicates (the reference's ``PartitionSpec`` entry):

      * out-split leaves (wq/wk/wv/w_gate/w_up, ...): the ``out`` dim, the
        last dim of the weight, of the grouped ν layout and of the
        per-group ``scale`` / ``v`` layout;
      * in-split leaves (wo/w_down, ...): the ``in`` dim, dim -2 of the
        weight, the group-count dim (-3) of ν, dim -2 of ``scale`` and the
        only dim of ``act_scale`` (quant groups tile the in dim, so the
        three gathers concatenate consistently).

    A dim that does not divide by the TP degree falls back to replication
    per leaf (at LLaMA-2-7B W2 g128, TP = 4, ``w_down``'s 86 groups).  The
    Adam moments follow their parameter (``optim.adam.AdamW.state_specs``).
    Without a ``model`` axis nothing splits; at TP degree 1 every spec
    names its dim, and the gathers are the identity."""

    mesh: Any
    axis: Optional[str]
    size: int

    @classmethod
    def for_mesh(cls, mesh) -> "ParamSpec":
        return cls(mesh, tp_axis(mesh) if mesh is not None else None,
                   tp_size(mesh))

    @property
    def active(self) -> bool:
        return self.axis is not None

    def _split_at(self, ndim: int, dim: int, extent: int) -> Optional[int]:
        if (self.axis is None or ndim + dim < 0
                or extent % max(self.size, 1)):
            return None
        return ndim + dim

    def weight_spec(self, name: str, shape) -> Optional[int]:
        """Split dim of a quantizable weight leaf ``(..., in, out)``."""
        split = recon_split(name)
        if split == "out":
            return self._split_at(len(shape), -1, shape[-1])
        if split == "in" and len(shape) >= 2:
            return self._split_at(len(shape), -2, shape[-2])
        return None

    def state_spec(self, name: str, key: str, shape) -> Optional[int]:
        """Split dim of one reconstruction-state array of leaf ``name``."""
        split = recon_split(name)
        if split is None:
            return None
        ndim = len(shape)
        if key in RECON_GROUPED_KEYS and ndim >= 3:
            dim = -1 if split == "out" else -3
        elif key in RECON_GROUPVEC_KEYS and ndim >= 2:
            dim = -1 if split == "out" else -2
        elif key == "act_scale" and ndim >= 1 and split == "in":
            dim = -1
        else:
            return None
        return self._split_at(ndim, dim, shape[dim])

    def block_specs(self, bp):
        """Spec tree matching a block-param tree (norms, routers and every
        other non-split leaf None)."""
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            if node is None or not hasattr(node, "shape"):
                return None
            return self.weight_spec(path[-1], node.shape)
        return walk(bp, ())

    def state_specs(self, states):
        """Spec tree matching a ``{path: {key: tensor}}`` reconstruction
        state tree (an absent ``act_scale`` mirrored as None)."""
        return {p: {k: (None if v is None
                        else self.state_spec(p[-1], k, v.shape))
                    for k, v in st.items()}
                for p, st in states.items()}


# --------------------------------------------------------------------------
# the reference's logical-axis rules: specs, shardings, slices and gathers
# --------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry per leading dim of a tensor: the mesh axis it splits over,
    a tuple of axes (split over their product, row-major), or None
    (replicated); dims past the last entry replicate.  The reference's
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh (the reference's
    ``NamedSharding``): which slice of a leaf each rank holds."""
    mesh: Any
    spec: PartitionSpec


def logical_table(mesh, overrides=None) -> dict:
    """Logical dim name -> tuple of mesh axes."""
    tp = ("model",) if "model" in mesh.axis_names else ()
    table = {
        "batch": dp_axes(mesh),
        "fsdp": ("data",) if "data" in mesh.axis_names else (),
        "tensor": tp, "expert": tp, "vocab": tp, "heads": tp,
        "kv_heads": tp,
        None: (), "seq": (),
        "res_seq": (),      # residual-stream sequence dim
        "embed": (),
    }
    if overrides:
        table.update(overrides)
    return table


def _axis_size(mesh, axes) -> int:
    bad = [a for a in axes if a not in mesh.axis_names]
    if bad:
        raise ValueError(f"axes {bad} are not on the mesh's "
                         f"{mesh.axis_names}")
    return math.prod(int(mesh.shape[mesh.axis_names.index(a)]) for a in axes)


def resolve_spec(mesh, logical: tuple, shape, overrides=None) -> PartitionSpec:
    """Logical dim names -> :class:`PartitionSpec`: a dim that its axes'
    extent does not divide replicates, and an axis goes to the first dim
    that claims it.  A spec may name fewer dims than the tensor has."""
    table = logical_table(mesh, overrides)
    out, used = [], set()
    for name, dim in zip(logical, shape):
        axes = tuple(table.get(name, ()))
        if axes and dim % _axis_size(mesh, axes) == 0 \
                and not (set(axes) & used):
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    return PartitionSpec(*out)


MOE_EXPERT_LEAVES = frozenset({"w_gate", "w_up", "w_down"})


def _leaf_ndim(leaf) -> int:
    return leaf.packed.ndim if isinstance(leaf, QTensor) else leaf.ndim


def _leaf_logical(path, leaf, cfg: ModelConfig) -> tuple:
    """Logical dim names of a param leaf: ``PARAM_RULES`` on its trailing
    (in, out) dims, None on the leading (layer) dims; a stacked MoE
    expert weight puts ``expert`` on its expert dim and ``fsdp`` on its
    reduction dim (the reference gathers that dim at its ``shard_map``
    entry, ZeRO-3 style)."""
    n = _leaf_ndim(leaf)
    if path[-1] not in PARAM_RULES:
        return (None,) * n
    rule = PARAM_RULES[path[-1]]
    lead = [None] * (n - 2)
    # stacked MoE experts: (L, E, in, out) or (E, in, out)
    if cfg.family == "moe" and path[-1] in MOE_EXPERT_LEAVES and n >= 3:
        lead[-1] = "expert"
        rule = ("fsdp", None)
    return tuple(lead) + rule


def _qtensor_spec(mesh, qt: QTensor, logical, overrides=None) -> QTensor:
    """A QTensor of shardings: ``packed`` takes the leaf's logical dims,
    ``scale`` / ``zero`` the out dim alone, ``act_scale`` none of the
    trailing ones."""
    lead, in_l, out_l = logical[:-2], logical[-2], logical[-1]

    def named(lg, t):
        return NamedSharding(mesh, resolve_spec(mesh, lg, t.shape, overrides))
    return QTensor(
        packed=named(lead + (in_l, out_l), qt.packed),
        scale=named(lead + (None, out_l), qt.scale),
        zero=named(lead + (None, out_l), qt.zero),
        bits=qt.bits, group_size=qt.group_size, shape=qt.shape,
        act_scale=(named(lead + (None,), qt.act_scale)
                   if qt.act_scale is not None else None))


def param_shardings(mesh, params, cfg: ModelConfig, overrides=None):
    """A tree of :class:`NamedSharding` matching ``params`` (a QTensor
    gets a QTensor of them).  Reads only the mesh's axis names and
    extents and the leaves' shapes."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, QTensor):
            return _qtensor_spec(mesh, node, _leaf_logical(path, node, cfg),
                                 overrides)
        return NamedSharding(mesh, resolve_spec(
            mesh, _leaf_logical(path, node, cfg), node.shape, overrides))
    return walk(params, ())


def batch_shardings(mesh, batch_struct):
    """Batch dicts: dim 0 over the data-parallel axes, where they divide
    it; scalars replicate."""
    dp = dp_axes(mesh)

    def one(leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim and dp and leaf.shape[0] % _axis_size(mesh, dp) == 0:
            spec[0] = dp if len(dp) > 1 else dp[0]
        return NamedSharding(mesh, PartitionSpec(*spec))
    return {k: one(v) for k, v in batch_struct.items()}


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_of(spec, mesh):
    """(PartitionSpec, mesh) of one spec leaf: a NamedSharding, a
    PartitionSpec on ``mesh``, or an int — :class:`ParamSpec`'s split dim
    over the ``model`` axis."""
    if isinstance(spec, NamedSharding):
        return spec.spec, spec.mesh
    if isinstance(spec, int):
        ent = [None] * (spec + 1)
        ent[spec] = tp_axis(mesh)
        return PartitionSpec(*ent), mesh
    return spec, mesh


def shard_leaf(t: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """The rank's slice of ``t`` under ``spec`` (see :func:`_spec_of`):
    along each split dim, block ``mesh.index_of(axes)`` of
    ``mesh.size_of(axes)``, contiguous; ``t`` itself where nothing
    splits."""
    spec, mesh = _spec_of(spec, mesh)
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if axes:
            t = _shard(t, dim, mesh.index_of(axes), mesh.size_of(axes))
    return t


def _gather_dim(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """The whole of ``x`` along ``dim`` from the slices of the rank's line
    over ``axes``: each member broadcasts its slice, in line order, and
    they are concatenated (the exact bytes; gloo runs broadcast on CUDA
    tensors)."""
    n = mesh.size_of(axes)
    if n == 1:
        return x
    group = mesh.group_of(axes)
    x = x.contiguous()
    parts = []
    for src in mesh.ranks_of(axes):
        buf = x if src == mesh.rank else torch.empty_like(x)
        dist.broadcast(buf, src, group=group)
        parts.append(buf)
    return torch.cat(parts, dim)


def unshard_leaf(t: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """The inverse of :func:`shard_leaf`: the whole leaf gathered from
    the ranks' slices (a collective of every rank of each split line)."""
    spec, mesh = _spec_of(spec, mesh)
    for dim, entry in reversed(list(enumerate(spec))):
        axes = _axes_of(entry)
        if axes:
            t = _gather_dim(t, dim, axes, mesh)
    return t


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, QTensors and named tuples
    (an optimizer state) and its spec tree; a None leaf or spec passes the
    leaf through."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, QTensor):       # its shape follows its packed
        return _localize_qtensor(QTensor(
            packed=_map_specs(fn, tree.packed, specs.packed),
            scale=_map_specs(fn, tree.scale, specs.scale),
            zero=_map_specs(fn, tree.zero, specs.zero), bits=tree.bits,
            group_size=tree.group_size, shape=tree.shape,
            act_scale=_map_specs(fn, tree.act_scale, specs.act_scale)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v, s)
                            for v, s in zip(tree, specs)))
    if tree is None or specs is None:
        return tree
    return fn(tree, specs)


def shard_tree(tree, specs, mesh=None):
    """The rank's slice of every split leaf of ``tree`` (``specs`` mirrors
    it with NamedShardings, PartitionSpecs on ``mesh``, or ParamSpec's
    split dims over the ``model`` axis); a QTensor's ``shape`` follows its
    sliced ``packed``."""
    return _map_specs(lambda t, s: shard_leaf(t, s, mesh), tree, specs)


def unshard_tree(tree, specs, mesh=None):
    """The inverse of :func:`shard_tree`: every leaf whole, gathered from
    the ranks' slices; called by every rank of the mesh."""
    return _map_specs(lambda t, s: unshard_leaf(t, s, mesh), tree, specs)


def replicas(sharding) -> int:
    """How many ranks hold each slice of a leaf under ``sharding``: the
    mesh's ranks over the product of the extents it splits over."""
    spec, mesh = _spec_of(sharding, None)
    split = math.prod(mesh.size_of(_axes_of(e)) for e in spec if e)
    return mesh.world // split


def shard_shape(shape, sharding) -> tuple:
    """The shape of a rank's slice of a leaf of ``shape`` under
    ``sharding`` (the reference's ``NamedSharding.shard_shape``)."""
    spec, mesh = _spec_of(sharding, None)
    out = list(shape)
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if axes:
            out[dim] //= mesh.size_of(axes)
    return tuple(out)


# --------------------------------------------------------------------------
# the GSPMD serve half: activation constraints, cache and serve placement
# --------------------------------------------------------------------------

def check_overrides(mesh, overrides) -> None:
    """Refuse logical-axis overrides that name an axis the mesh lacks (the
    reference's ``resolve_spec`` fails on them at its first constraint)."""
    for name, axes in (overrides or {}).items():
        bad = [a for a in tuple(axes) if a not in mesh.axis_names]
        if bad:
            raise ValueError(f"shard override {name!r} -> {tuple(axes)} names "
                             f"axes {bad} that are not on the mesh's "
                             f"{mesh.axis_names}")


@dataclasses.dataclass(frozen=True)
class Sharder:
    """The reference's activation sharding constraints (``make_sharder``)
    as the specs they name: :meth:`spec` resolves ``names`` through
    :func:`resolve_spec` as the reference does, so a bad override raises
    as the reference's would.  The port applies no constraint: one never
    changes a value; its serve fork holds whole activations of the rank's
    rows, and the mesh train step splits them itself
    (``layers.ModelSplit``)."""
    mesh: Any
    overrides: tuple = ()           # (logical name, axes) pairs

    def spec(self, shape, names) -> PartitionSpec:
        return resolve_spec(self.mesh, tuple(names), tuple(shape),
                            dict(self.overrides))


def make_sharder(mesh, overrides=None) -> Sharder:
    return Sharder(mesh, tuple((k, tuple(v)) for k, v in
                               (overrides or {}).items()))


def _map_dict(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_dict(fn, v) for k, v in tree.items()}
    return fn(tree)


def cache_shardings(mesh, cache_struct, cfg: ModelConfig):
    """KV / state caches ``(L, B, ...)``: the batch dim over the DP axes
    where they divide it; with a ``model`` axis, on a leaf of 4 dims or
    more, the heads (dim -2) over it where it divides them, else, on a 5-D
    leaf, the sequence dim (GQA with fewer KV heads than the TP degree),
    else the last dim.  The reference's rule, leaf for leaf."""
    dp = dp_axes(mesh)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    tp = "model" if "model" in mesh.axis_names else None

    def one(leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim >= 2 and dp and leaf.shape[1] % _axis_size(mesh, dp) == 0:
            spec[1] = dp_spec
        if leaf.ndim >= 4 and tp:
            n = _axis_size(mesh, (tp,))
            hdim = leaf.ndim - 2
            if leaf.shape[hdim] % n == 0:
                spec[hdim] = tp
            elif leaf.ndim == 5 and leaf.shape[2] % n == 0:
                spec[2] = tp
            elif leaf.ndim == 5 and leaf.shape[-1] % n == 0:
                spec[-1] = tp
        return NamedSharding(mesh, PartitionSpec(*spec))
    return _map_dict(one, cache_struct)


# the reference's serve_sharding="tp": weights resident over ``model``, no
# ``fsdp`` split (an FSDP all-gather a decode step would dominate it)
SERVE_OVERRIDES = {"fsdp": ()}


@dataclasses.dataclass(frozen=True, eq=False)
class MeshPlacement:
    """One rank's placement of a serve param tree on a mesh (the reference's
    GSPMD serve path): ``shardings`` is ``param_shardings(mesh, params,
    cfg, SERVE_OVERRIDES)`` of the global tree (by default) and ``params``
    the rank's slices of it on ``mesh.device``, cut once by :meth:`place`.
    The serve loops take it where they take a param tree; the steps of
    ``launch.steps.make_serve_steps(cfg, mesh)`` gather its leaves whole
    (:meth:`whole`) inside each step."""
    mesh: Any
    cfg: ModelConfig
    shardings: Any = dataclasses.field(repr=False)
    params: Any = dataclasses.field(repr=False)

    @classmethod
    def place(cls, mesh, cfg: ModelConfig, params,
              overrides=SERVE_OVERRIDES) -> "MeshPlacement":
        """Cut the rank's slices of the GLOBAL tree ``params`` where it lies
        and move only them (and the replicated leaves) to ``mesh.device``.
        ``overrides=None`` keeps the ``fsdp`` split (the dry-run's
        ``--serve-sharding fsdp``)."""
        validate_single_pod(mesh, "MeshPlacement.place")
        specs = param_shardings(mesh, params, cfg, overrides)
        local = _map_specs(lambda t, s: shard_leaf(t, s).to(mesh.device),
                           params, specs)
        return cls(mesh, cfg, specs, local)

    def whole(self):
        """Every leaf whole, gathered from the ranks' slices (a collective
        of every rank of each ``model`` line)."""
        return unshard_tree(self.params, self.shardings)


def mesh_cache_model(model, mesh, cfg: ModelConfig):
    """``model`` with an ``init_cache`` that allocates the rank's slices of
    the global cache under :func:`cache_shardings` (zeros, as every
    family's ``init_cache`` starts) and records those shardings on the
    mesh, where :func:`mesh_cache_layout` reads them; everything else
    stays ``model``'s."""
    def init_cache(batch, max_seq, dtype=torch.bfloat16, device="cuda"):
        struct = model.init_cache(batch, max_seq, dtype, "meta")
        specs = cache_shardings(mesh, struct, cfg)
        out = struct
        for path in _leaf_paths(struct):
            leaf = _get_leaf(struct, path)
            out = _set_leaf(out, path, torch.zeros(
                shard_shape(leaf.shape, _get_leaf(specs, path)),
                dtype=leaf.dtype, device=device))
        if mesh.cache_layouts.setdefault(_layout_key(cfg, batch, out),
                                         specs) != specs:
            raise ValueError(f"a {cfg.name} cache of {batch} rows and "
                             f"max_seq {max_seq} has the slices of another "
                             f"layout on this mesh")
        return out

    return dataclasses.replace(model, init_cache=init_cache)


def _layout_key(cfg: ModelConfig, batch: int, cache) -> tuple:
    return (cfg, batch, tuple(tuple(_get_leaf(cache, p).shape)
                              for p in _leaf_paths(cache)))


def mesh_cache_layout(mesh, cfg: ModelConfig, cache, batch: int):
    """The :func:`cache_shardings` that :func:`mesh_cache_model` allocated
    ``cache`` (the rank's slices of a cache of ``batch`` rows) under."""
    try:
        return mesh.cache_layouts[_layout_key(cfg, batch, cache)]
    except KeyError:
        raise ValueError(f"this {cfg.name} cache of {batch} rows was not "
                         f"allocated on this mesh by mesh_cache_model(...)"
                         f".init_cache") from None


# leaf name -> split ("out" | "in" | "expert"), per family.  Absent names
# (norms, routers, rwkv time-mix, mamba in/out_proj) replicate.
SERVE_SPLIT_TABLES = {
    "dense": {"wq": "out", "wk": "out", "wv": "out", "wo": "in",
              "w_gate": "out", "w_up": "out", "w_down": "in"},
    "moe": {"wq": "out", "wk": "out", "wv": "out", "wo": "in",
            "w_gate": "expert", "w_up": "expert", "w_down": "expert"},
    "encdec": {"wq": "out", "wk": "out", "wv": "out", "wo": "in",
               "w_up": "out", "w_down": "in"},
    "rwkv": {"ck": "out", "cv": "in"},
}
SERVE_SPLIT_TABLES["vlm"] = SERVE_SPLIT_TABLES["dense"]
SERVE_SPLIT_TABLES["hybrid"] = SERVE_SPLIT_TABLES["dense"]

# atomic fallback groups per family
SERVE_GROUPS = {
    "dense": (frozenset({"wq", "wk", "wv", "wo"}),
              frozenset({"w_gate", "w_up", "w_down"})),
    "moe": (frozenset({"wq", "wk", "wv", "wo"}),
            frozenset({"w_gate", "w_up", "w_down"})),
    "encdec": (frozenset({"wq", "wk", "wv", "wo"}),
               frozenset({"w_up", "w_down"})),
    "rwkv": (frozenset({"ck", "cv"}),),
}
SERVE_GROUPS["vlm"] = SERVE_GROUPS["dense"]
SERVE_GROUPS["hybrid"] = SERVE_GROUPS["dense"]

# the mesh train step's groups beside the serve ones (``serve_plan(...,
# train=True)``): RWKV's time mix by heads (serving keeps it whole, since
# its cache replicates the per-head state; training has no cache) and
# Mamba's out_proj over its inner width (the rank's rows of ``di``)
TRAIN_SPLIT_TABLES = {
    "rwkv": {"wr": "out", "wk": "out", "wv": "out", "wg": "out",
             "wo": "in"},
    "hybrid": {"out_proj": "in"},
}
TRAIN_GROUPS = {
    "rwkv": (frozenset({"wr", "wk", "wv", "wg", "wo"}),),
    "hybrid": (frozenset({"out_proj"}),),
}

# the group whose split makes attention head-local (cfg and cache localize)
_ATTN_GROUP_MEMBER = "wq"
# a member of each group split by heads -> the head counts it cuts
_HEAD_GROUPS = {"wq": ("num_heads", "num_kv_heads"), "wr": ("num_heads",)}

# the dim each split cuts: of a weight (..., in, out) and its packed /
# scale / zero, and of an AWQ act_scale (..., in)
_WEIGHT_DIM = {"out": -1, "in": -2, "expert": -3}
_ACT_DIM = {"in": -1, "expert": -2}


def _split_ok(leaf, split: str, tp: int) -> bool:
    """Can ``leaf`` split ``split``-wise over a TP degree of ``tp``?  An
    in-split QTensor shard must take whole quant groups (``ng % tp``) and
    whole packed container rows (``(K // ppb) % tp``)."""
    if tp <= 1:
        return True
    if isinstance(leaf, QTensor):
        K, N = leaf.shape[-2], leaf.shape[-1]
        ppb = PACK_FACTOR[leaf.bits]
        ng = leaf.scale.shape[-2]
        if split == "out":
            return N % tp == 0
        if split == "in":
            return ng % tp == 0 and (K // ppb) % tp == 0
        if split == "expert":
            return leaf.packed.ndim >= 3 and leaf.packed.shape[-3] % tp == 0
        return False
    if getattr(leaf, "ndim", 0) < 2:
        return False
    if split == "out":
        return leaf.shape[-1] % tp == 0
    if split == "in":
        return leaf.shape[-2] % tp == 0
    if split == "expert":
        return leaf.ndim >= 3 and leaf.shape[-3] % tp == 0
    return False


def serve_plan(cfg: ModelConfig, params, tp: int,
               train: bool = False) -> dict:
    """The placement decision: ``{leaf name: split}`` for every leaf that
    splits over the TP axis (absent = replicated).  A group split by heads
    (the attention's, RWKV's time mix) also needs its head counts
    divisible by ``tp`` (the forward reshapes heads).  ``train`` adds the
    mesh train step's groups (:data:`TRAIN_GROUPS`)."""
    if tp < 1:
        raise ValueError(f"serve_plan: TP degree must be >= 1, got {tp}")
    table = dict(SERVE_SPLIT_TABLES.get(cfg.family,
                                        SERVE_SPLIT_TABLES["dense"]))
    groups = SERVE_GROUPS.get(cfg.family, SERVE_GROUPS["dense"])
    if train:
        table.update(TRAIN_SPLIT_TABLES.get(cfg.family, {}))
        groups = groups + TRAIN_GROUPS.get(cfg.family, ())

    found: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        name = path[-1]
        if name in table:
            found.setdefault(name, []).append(node)

    walk(params, ())
    plan: dict = {}
    for group in groups:
        members = sorted(n for n in group if n in found)
        if not members:
            continue
        ok = all(_split_ok(leaf, table[n], tp)
                 for n in members for leaf in found[n])
        for member, counts in _HEAD_GROUPS.items():
            if member in group:
                ok = ok and all(getattr(cfg, c) % tp == 0 for c in counts)
        if ok:
            for n in members:
                plan[n] = table[n]
    return plan


def _localize_qtensor(qt: QTensor) -> QTensor:
    """Rebuild a QTensor's logical ``shape`` from its (shard-local) packed
    tensor: an out-split shard shrinks ``out``, an in-split one ``in`` by
    whole groups (``group_size`` stays); an expert split touches leading
    dims only, which never live in ``shape``."""
    k_local = qt.packed.shape[-2] * PACK_FACTOR[qt.bits]
    n_local = qt.packed.shape[-1]
    if (k_local, n_local) == tuple(qt.shape[-2:]):
        return qt
    return QTensor(packed=qt.packed, scale=qt.scale, zero=qt.zero,
                   bits=qt.bits, group_size=qt.group_size,
                   shape=(k_local, n_local), act_scale=qt.act_scale)


def _shard(t: torch.Tensor, dim: int, rank: int, size: int,
           device=None) -> torch.Tensor:
    """Shard ``rank`` of ``size`` equal slices of ``t`` along ``dim``, made
    contiguous where it lies (the kernels check contiguity), then moved to
    ``device`` (None: left where it is); at ``size`` 1, ``t`` itself."""
    if size > 1:
        n = t.shape[dim] // size
        t = t.narrow(dim, rank * n, n).contiguous()
    return t if device is None else t.to(device)


def shard_serve_params(params, plan: dict, rank: int, size: int,
                       group=None, device=None):
    """The rank's local tree of a global param tree under ``plan``: every
    split leaf cut to shard ``rank`` of ``size`` (out-split: the last dim
    of the weight, or of ``packed``/``scale``/``zero``; in-split: dim -2 of
    those and the last dim of ``act_scale``; expert: dim -3, and dim -2 of
    ``act_scale``), each slice contiguous, each QTensor's ``shape`` rebuilt
    by :func:`_localize_qtensor`.  In-split leaves come wrapped in
    ``PsumWeight(w, group)`` (``group`` None: the default group), so
    ``layers.matmul`` all-reduces their partial products and the family
    forwards stay free of sharding logic.

    The slices are cut where ``params`` lies and only they move to
    ``device`` (None: nothing moves), with the replicated leaves: slicing a
    host tree puts no more than the rank's own tree on its card.  A leaf
    already on ``device`` is not copied (at ``size`` 1 the local tree is
    the global tensors themselves)."""
    def move(t):
        return t if device is None or t is None else t.to(device)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        split = plan.get(path[-1]) if path else None
        if split is None or node is None:
            return move(node)
        dim = _WEIGHT_DIM[split]
        if isinstance(node, QTensor):
            act = node.act_scale
            act = (_shard(act, _ACT_DIM[split], rank, size, device)
                   if act is not None and split in _ACT_DIM else move(act))
            node = _localize_qtensor(QTensor(
                packed=_shard(node.packed, dim, rank, size, device),
                scale=_shard(node.scale, dim, rank, size, device),
                zero=_shard(node.zero, dim, rank, size, device),
                bits=node.bits, group_size=node.group_size, shape=node.shape,
                act_scale=act))
        else:
            node = _shard(node, dim, rank, size, device)
        return PsumWeight(node, group) if split == "in" else node
    return walk(params, ())


def localize_serve_cfg(cfg: ModelConfig, plan: dict, tp: int) -> ModelConfig:
    """Per-shard model config: head counts divided by the TP degree when
    a group split by heads splits (the attention's; RWKV's time mix in the
    train step), with ``head_dim`` pinned to its resolved value.  ``d_ff``
    never appears in a forward reshape, and the MoE's ``num_experts``
    stays global (routing is over global expert ids)."""
    if tp <= 1 or not any(plan.get(m) == "out" for m in _HEAD_GROUPS):
        return cfg
    return cfg.replace(num_heads=cfg.num_heads // tp,
                       num_kv_heads=cfg.num_kv_heads // tp,
                       head_dim=cfg.resolved_head_dim)


def serve_cache_layout(cache_spec, cache, plan: dict, tp: int) -> dict:
    """The local cache layout: ``{leaf path: local shape}`` for a global
    cache tree (a ``"meta"`` one will do), keyed on the declared leaf kind.
    Token and fixed leaves (KV lanes ``(L, B, S, H, hd)``, paged pools,
    encdec cross caches) take ``H // tp`` heads — dim -2 in every layout —
    when the attention group splits and the head count divides; state
    leaves (rwkv shift/wkv, mamba conv/ssm) replicate."""
    attn = plan.get(_ATTN_GROUP_MEMBER) == "out" and tp > 1
    out = {}
    for path in _leaf_paths(cache):
        shape = list(_get_leaf(cache, path).shape)
        kind = cache_spec.leaf(path).kind
        if (attn and kind in (LEAF_TOKEN, LEAF_FIXED) and len(shape) >= 2
                and shape[-2] % tp == 0):
            shape[-2] //= tp
        out[path] = tuple(shape)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class ServeSpec:
    """One rank's serve-time placement: the one object that carries
    tensor parallelism from the mesh to the decode kernels.

    :meth:`place` decides the plan from the global params' shapes and cuts
    the rank's local tree (``params``, on ``mesh.device``) once.  The serve
    steps (``launch.steps.make_serve_steps(spec=...)``) run the family
    forward on :attr:`local_cfg`, and the serve loops (``serve_requests``,
    ``serve_scheduled``) take the spec where they take a param tree, so a
    plan never meets params placed under another.  ``cfg`` is the global
    config; the global model keeps describing the cache spec while
    :meth:`cache_model` allocates the rank's KV heads.  Steps depend on
    :attr:`key` only and never hold ``params``."""

    mesh: Any
    cfg: ModelConfig
    plan: dict
    params: Any = dataclasses.field(repr=False)

    @classmethod
    def place(cls, mesh, cfg: ModelConfig, params) -> "ServeSpec":
        """Place the GLOBAL tree ``params`` on ``mesh`` (a
        ``launch.mesh.Mesh``): the plan of its shapes over
        ``tp_size(mesh)``, and the rank's shard of every split leaf
        (:func:`shard_serve_params` at its ``model`` position, in-split
        leaves reducing over its group) moved to ``mesh.device``.  Pass a
        host tree: only the rank's own tree then reaches its card."""
        if mesh is None or tp_axis(mesh) is None:
            raise ValueError("ServeSpec.place needs a mesh with a 'model' "
                             "axis (launch.mesh.serve_mesh)")
        validate_single_pod(mesh, "ServeSpec.place")
        size = tp_size(mesh)
        plan = serve_plan(cfg, params, size)
        return cls(mesh, cfg, plan, shard_serve_params(
            params, plan, mesh.model_rank, size, mesh.group, mesh.device))

    @property
    def size(self) -> int:
        return tp_size(self.mesh)

    @property
    def key(self) -> tuple:
        """What the steps of this placement depend on: the mesh, the
        global config and the plan."""
        return self.mesh, self.cfg, tuple(sorted(self.plan.items()))

    @property
    def local_cfg(self) -> ModelConfig:
        """The per-shard config the family forward runs on."""
        return localize_serve_cfg(self.cfg, self.plan, self.size)

    @property
    def ep_inner(self):
        """The model group when the MoE experts split over it, else None
        (``Ctx.ep_inner``)."""
        return self.mesh.group if self.plan.get("w_gate") == "expert" \
            else None

    def cache_model(self, model):
        """``model`` with an ``init_cache`` that allocates the local cache
        layout (:func:`serve_cache_layout`; zeros, as every family's
        ``init_cache`` starts), so the dense and paged stores hold the
        rank's heads only.  Everything else — the global config, the
        cache spec — stays the global model's."""
        plan, size = self.plan, self.size     # not self: it holds params

        def init_cache(batch, max_seq, dtype=torch.bfloat16, device="cuda"):
            struct = model.init_cache(batch, max_seq, dtype, "meta")
            layout = serve_cache_layout(model.cache_spec, struct, plan, size)
            cache = struct
            for path, shape in layout.items():
                cache = _set_leaf(cache, path, torch.zeros(
                    shape, dtype=_get_leaf(struct, path).dtype,
                    device=device))
            return cache

        return dataclasses.replace(model, init_cache=init_cache)


def unplace(params):
    """A serve loop's ``params`` argument as ``(param tree, spec)``: a
    placed :class:`ServeSpec` gives its local tree and itself, a
    :class:`MeshPlacement` its local tree and None, a param tree itself
    and None."""
    if isinstance(params, ServeSpec):
        return params.params, params
    if isinstance(params, MeshPlacement):
        return params.params, None
    return params, None
