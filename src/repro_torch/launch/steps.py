"""The train step on one device or on a mesh (``make_train_harness``,
``jit_train_step``), the prefill/decode steps for single-device,
tensor-parallel and GSPMD-placed serving, the scheduler's masked decode
step and the paged store's admission step, and the dry-run's input specs
(fake tensors: shapes and dtypes, nothing allocated)."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import flatten
from repro_torch.configs.base import ModelConfig, QuantConfig, ShapeConfig
from repro_torch.core.blocks import QUANT_LEAF_NAMES
from repro_torch.core.qtensor import PACK_FACTOR, QTensor
from repro_torch.core.quantizer import resolve_group
from repro_torch.launch.mesh import (batch_rows, dp_axes, dp_size,
                                     tp_size, validate_single_pod)
from repro_torch.launch.sharding import (MOE_EXPERT_LEAVES, SERVE_GROUPS,
                                         TRAIN_GROUPS, MeshPlacement,
                                         NamedSharding,
                                         PartitionSpec, ServeSpec,
                                         batch_shardings, check_overrides,
                                         localize_serve_cfg,
                                         mesh_cache_layout, mesh_cache_model,
                                         param_shardings, replicas,
                                         serve_plan, shard_leaf, shard_tree,
                                         unshard_leaf, unshard_tree)
from repro_torch.models import get_model
from repro_torch.models.common import (CACHE_SLOT_AXIS, _get_leaf,
                                       _leaf_paths, _set_leaf, make_ctx,
                                       page_rows, write_slot)
from repro_torch.models.layers import ModelSplit
from repro_torch.models.transformer import _DTYPES, ROW_PARAMS
from repro_torch.optim.adam import (AdamW, clip_by_global_norm, tree_leaves,
                                    tree_map)
from repro_torch.optim.compression import compress_decompress, init_error


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainHarness:
    """``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    with ``metrics = {"loss", "grad_norm"}`` (f32 device scalars);
    ``init_params(seed, device)``; ``init_opt(params)``.  On a mesh
    ``param_sharding`` / ``opt_sharding`` are the placement ``step_fn``
    reads (trees of ``launch.sharding.NamedSharding``); None on one
    device.  ``mesh`` is the harness's mesh, ``plan`` the leaves its step
    keeps split over ``model`` (:func:`train_plan`; empty without a
    split)."""
    cfg: ModelConfig
    step_fn: Any
    init_params: Any
    init_opt: Any
    param_sharding: Any = None
    opt_sharding: Any = None
    batch_sharding: Any = None
    mesh: Any = None
    plan: Any = dataclasses.field(default_factory=dict)


def _value_and_grad(model, ctx, params, batch):
    """(loss, grads) of ``model.loss_fn``, taken by ``torch.autograd.grad``
    over fresh leaves that alias ``params`` (``detach`` copies nothing), so
    the caller's tensors are neither modified nor marked.  A leaf the loss
    does not read (``embed`` of an untied model under a batch's
    ``inputs_embeds``) gets a zero gradient, as ``jax.grad`` gives it."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = model.loss_fn(p, batch, ctx)
        grads = iter(torch.autograd.grad(loss, tree_leaves(p),
                                         materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), p)


def param_struct(cfg: ModelConfig):
    """The whole param tree of ``cfg`` as fake tensors: shapes and dtypes,
    nothing allocated (the reference's ``jax.eval_shape`` of
    ``init_params``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return get_model(cfg).init_params(0, "cpu")


def make_train_harness(cfg: ModelConfig, mesh=None, *, lr=3e-4,
                       grad_clip: float = 1.0,
                       grad_compression: bool = False,
                       attn_chunk: int = 512,
                       microbatches: int = 1,
                       seq_parallel: bool = False,
                       extra_overrides=None) -> TrainHarness:
    """The reference's train harness: next-token loss, gradients (averaged
    over ``microbatches`` slices of the batch, summed in
    ``cfg.optimizer_dtype``), clipping to ``grad_clip`` by the global norm,
    optional int8 compression with error feedback, then AdamW (``lr`` a
    float or a schedule of the step, e.g. ``optim.adam.cosine_schedule``).

    ``step_fn`` is pure: it returns new tensors and never writes its
    inputs, so one ``params`` may start two runs.  ``remat`` follows
    ``cfg.remat``.

    On a ``mesh`` (a ``launch.mesh.Mesh``; every rank calls ``step_fn``)
    the params and the optimizer state are the rank's slices under
    ``param_shardings`` / ``opt_sharding_like`` and the batch is the
    global one; see :func:`_mesh_step`.  On a ``model`` axis of more than
    one rank every family's step splits its work over that axis as the
    reference's partitioner does (:func:`train_plan`,
    ``layers.ModelSplit``): each rank computes its attention heads, FFN
    or channel-mix columns, experts, RWKV time-mix heads, rows of Mamba's
    ``out_proj`` and vocab slice, where their group divides.
    ``seq_parallel`` (the reference's ``res_seq`` -> ``model``) also
    splits the residual stream's rows between the regions over that axis,
    where every stream divides by it.
    ``extra_overrides`` are the reference's remaps of its activation
    constraints; they must name the mesh's axes (``make_ctx`` checks).
    ``{"seq": ("model",)}`` (the reference's ``--attn-seq-parallel``) on
    such an axis splits the attention of the families whose forward
    carries the reference's ``"seq"`` label (:data:`QUERY_SPLIT_FAMILIES`)
    by its query rows instead of its heads (``ModelSplit.qrows``), where
    every stream divides by the axis; elsewhere (another stream length,
    RWKV6, the encoder-decoder) the step is the one without it.  Every
    other remap changes nothing.  None of these changes the values, as in
    the reference."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    overrides = dict(extra_overrides or {})
    if seq_parallel:
        overrides["res_seq"] = ("model",)
    model = get_model(cfg)
    ctx = make_ctx(cfg, attn_chunk=attn_chunk, mesh=mesh,
                   shard_overrides=overrides or None)
    acc_dt = _DTYPES[cfg.optimizer_dtype]           # Adam m/v and sums
    opt = AdamW(lr=lr, state_dtype=acc_dt)

    def init_opt(params):
        state = {"adam": opt.init(params)}
        if grad_compression:
            state["ef"] = init_error(params)
        return state

    def grads_of(params, batch, local=None, fwd=(model, ctx)):
        """(loss, grads) over ``microbatches`` slices of ``batch``, by
        ``fwd = (model, ctx)``.  On a mesh ``local(ub) -> (rows, weight)``
        cuts each slice to the rank's rows and weighs its loss and
        gradients by the rank's share of it."""
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch of {n} does not split into "
                             f"{microbatches} microbatches")

        def one(ub):
            if local is None:
                return _value_and_grad(*fwd, params, ub)
            rows, w = local(ub)
            l_i, g_i = _value_and_grad(*fwd, params,
                                       {k: v[rows] for k, v in ub.items()})
            if w is None:
                return l_i, g_i
            return l_i * w, tree_map(lambda g: g * w.to(g.dtype), g_i)
        if microbatches == 1:
            return one(batch)
        dev = tree_leaves(params)[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        grads = tree_map(lambda t: torch.zeros(t.shape, dtype=acc_dt,
                                               device=dev), params)
        for i in range(microbatches):
            l_i, g_i = one({k: v.reshape(microbatches, n // microbatches,
                                         *v.shape[1:])[i]
                            for k, v in batch.items()})
            loss = loss + l_i
            grads = tree_map(lambda a, g: a + g.to(acc_dt), grads, g_i)
        return loss / microbatches, tree_map(lambda g: g / microbatches,
                                             grads)

    def finish(params, opt_state, grads, loss, pspec=None):
        reps = None if pspec is None else tree_map(replicas, pspec)
        grads, gnorm = clip_by_global_norm(grads, grad_clip, reps,
                                           None if pspec is None else mesh)
        new_state = {}
        if grad_compression:
            grads, new_state["ef"] = compress_decompress(
                grads, opt_state["ef"], mesh)
        new_p, new_state["adam"] = opt.update(grads, opt_state["adam"],
                                              params)
        return new_p, new_state, {"loss": loss, "grad_norm": gnorm}

    if mesh is None:
        def step_fn(params, opt_state, batch):
            dev = tree_leaves(params)[0].device
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            loss, grads = grads_of(params, batch)
            return finish(params, opt_state, grads, loss)
        return TrainHarness(cfg, step_fn, model.init_params, init_opt)

    struct = param_struct(cfg)
    pspec = param_shardings(mesh, struct, cfg)
    ospec = _opt_sharding(mesh, pspec, grad_compression)
    plan = train_plan(mesh, cfg, struct, pspec)
    split = model_split(mesh, plan, ctx.ep_axis)
    qsplit = (tp_size(mesh) > 1 and cfg.family in QUERY_SPLIT_FAMILIES
              and tuple(overrides.get("seq", ())) == ("model",))
    # (rows split, queries split) -> (model, ctx) of that forward.  The
    # query split runs every head, and the attention is the one group of
    # QUERY_SPLIT_FAMILIES split by heads: its forward is the global one
    fwds = {(False, False): (model, ctx)}
    rows_options = (False, True) if seq_parallel else (False,)
    if split is not None:
        lmodel = get_model(localize_serve_cfg(cfg, plan, split.size))
        for rows in rows_options:
            fwds[(rows, False)] = (lmodel, dataclasses.replace(
                ctx, tp=dataclasses.replace(split, seq=rows)))
    if qsplit:
        base = split or ModelSplit(mesh.group_of("model"), tp_size(mesh),
                                   mesh.index_of("model"))
        for rows in rows_options:
            fwds[(rows, True)] = (model, dataclasses.replace(
                ctx, tp=dataclasses.replace(base, seq=rows, qrows=True)))

    def step_fn(params, opt_state, batch):
        return _mesh_step(mesh, cfg, pspec, plan, fwds, grads_of, finish,
                          params, opt_state, batch)
    return TrainHarness(cfg, step_fn, model.init_params, init_opt,
                        param_sharding=pspec, opt_sharding=ospec, mesh=mesh,
                        plan=plan)


def _opt_sharding(mesh, pspec, compressed: bool) -> dict:
    """The optimizer state's shardings: Adam's moments and the error
    feedback buffers like their params (ZeRO-1 falls out of the ``fsdp``
    split), the step counter replicated."""
    out = {"adam": AdamW().state_specs(pspec)._replace(
        step=NamedSharding(mesh, PartitionSpec()))}
    if compressed:
        out["ef"] = pspec
    return out


def opt_sharding_like(mesh, opt_struct, params_struct, cfg):
    """Adam m/v (and EF buffers) shard exactly like their parameters; the
    step counter replicates.  ``opt_struct`` names which parts exist."""
    return _opt_sharding(mesh, param_shardings(mesh, params_struct, cfg),
                         "ef" in opt_struct)


def jit_train_step(harness: TrainHarness, mesh, params_struct, batch_struct):
    """The reference's sharded train step over ``mesh``: returns ``(step,
    (pspec, ospec, bspec))``, ``step(params, opt_state, batch)`` taking the
    rank's slices (``shard_tree(whole, pspec)``) and the global batch.
    There is nothing to compile or donate: ``step`` is the harness's
    ``step_fn``, which must have been made for ``mesh`` and place the
    params as ``params_struct``'s shardings do."""
    if harness.mesh is not mesh:
        raise ValueError("jit_train_step: the harness was made for another "
                         "mesh (make_train_harness(cfg, mesh))")
    pspec = param_shardings(mesh, params_struct, harness.cfg)
    if _specs(pspec) != _specs(harness.param_sharding):
        raise ValueError("jit_train_step: params_struct places the params "
                         "otherwise than the harness's config does")
    return harness.step_fn, (pspec, harness.opt_sharding,
                             batch_shardings(mesh, batch_struct))


def _specs(tree) -> list:
    return [s.spec for s in flatten(tree)]


# the dim of each vocab leaf that ``vocab`` splits
_VOCAB_DIM = {"embed": -2, "head": -1}
_SPLIT_DIM = {"out": -1, "in": -2, "expert": -3}
# a member of each split group -> the ``layers.ModelSplit`` region its
# leaves run in (the MoE's experts split by ``ep_axis``, not by name)
_REGIONS = {"wq": "attn", "w_up": "ffn", "ck": "ffn", "wr": "time",
            "out_proj": "out_proj", "embed": "vocab", "head": "vocab"}


def _on_model(sharding, dim: int) -> bool:
    spec = tuple(sharding.spec)
    return len(spec) >= -dim and spec[dim] == "model"


def train_plan(mesh, cfg: ModelConfig, struct, pspec) -> dict:
    """``{leaf name: split}`` of the leaves a mesh train step keeps split
    over ``model`` on a ``model`` axis of more than one rank (the rest are
    gathered whole): the groups ``launch.sharding.serve_plan(...,
    train=True)`` splits whose every member ``param_shardings`` places with
    that dim on ``model``, and ``embed`` / ``head`` as ``"vocab"`` where
    the vocab dim of each is on ``model``.  The groups are Megatron's out /
    in split of each family's attention and FFN (the VLM's, Zamba2's
    shared block's, whisper's self- and cross-attention and MLP), the
    MoE's experts, RWKV's time mix by heads and its channel mix, and
    Mamba's ``out_proj`` over its inner width.  A group that does not
    divide (heads, a dim) is gathered whole, as the reference's
    divisibility fallback leaves it replicated."""
    tp = tp_size(mesh)
    if tp <= 1:
        return {}
    placed: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            placed.setdefault(path[-1], []).append(node)
    walk(pspec, ())
    plan = serve_plan(cfg, struct, tp, train=True)
    for group in SERVE_GROUPS[cfg.family] + TRAIN_GROUPS.get(cfg.family, ()):
        names = [n for n in group if n in plan]
        if not all(_on_model(sh, _SPLIT_DIM[plan[n]])
                   for n in names for sh in placed[n]):
            for n in names:
                del plan[n]
    vocab = [n for n in _VOCAB_DIM if n in placed]
    if all(_on_model(sh, _VOCAB_DIM[n]) for n in vocab for sh in placed[n]):
        plan.update((n, "vocab") for n in vocab)
    return plan


def model_split(mesh, plan: dict, ep_axis=None):
    """The ``layers.ModelSplit`` of ``plan`` on ``mesh`` (None where
    nothing splits): the region of each group the plan keeps split, and
    the MoE's experts exactly where the ctx has an ``ep_axis`` (which
    makes ``moe_ffn`` compute the rank's experts alone: the plan must keep
    them split)."""
    if (plan.get("w_gate") == "expert") != (ep_axis is not None):
        raise ValueError(f"the plan splits w_gate {plan.get('w_gate')!r} "
                         f"but the ctx's ep_axis is {ep_axis!r}")
    splits = {r for n, r in _REGIONS.items()
              if plan.get(n) not in (None, "expert")}
    if ep_axis is not None:
        splits.add("experts")
    if not splits:
        return None
    return ModelSplit(mesh.group_of("model"), tp_size(mesh),
                      mesh.index_of("model"), frozenset(splits))


def entry_shardings(pspec, cfg: ModelConfig, plan=None):
    """What a mesh step gathers of each leaf: its sharding, except that a
    leaf of ``plan`` (:func:`train_plan`) and a stacked MoE expert weight
    keep their ``model`` split (the rank computes its own part) and
    gather only their ``fsdp`` dim — the reference's ``shard_map``
    entry."""
    def local(sh):
        if sh is None:
            return None
        return NamedSharding(sh.mesh, PartitionSpec(*(
            None if e == "model" else e for e in sh.spec)))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        spec = (node.packed if isinstance(node, QTensor) else node).spec
        expert = (cfg.family == "moe" and path[-1] in MOE_EXPERT_LEAVES
                  and len(spec) >= 3)
        if not (expert or path[-1] in (plan or {})):
            return node
        if isinstance(node, QTensor):
            return QTensor(local(node.packed), local(node.scale),
                           local(node.zero), node.bits, node.group_size,
                           node.shape, local(node.act_scale))
        return local(node)
    return walk(pspec, ())


def _sum_over(group, leaves: list) -> list:
    """``leaves`` summed over ``group``, one all-reduce a dtype over the
    flattened tensors."""
    by_dtype: dict = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = list(leaves)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        o = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[o:o + n].view(leaves[i].shape)
            o += n
    return out


def _reduce_over_data(mesh, loss, grads):
    """Sum ``loss`` and ``grads`` over the mesh's data-parallel group."""
    out = _sum_over(mesh.data_group, [loss] + tree_leaves(grads))
    it = iter(out[1:])
    return out[0], tree_map(lambda _: next(it), grads)


def _reduce_rows(split, grads):
    """Under a split of the residual rows each rank's gradient of a
    :data:`models.transformer.ROW_PARAMS` leaf (the norms) is its rows'
    part: sum those over the model group."""
    paths = [p for p in _leaf_paths(grads)
             if p.rsplit("/", 1)[-1] in ROW_PARAMS]
    for p, g in zip(paths, _sum_over(split.group,
                                     [_get_leaf(grads, p) for p in paths])):
        grads = _set_leaf(grads, p, g)
    return grads


def _streams(cfg: ModelConfig, batch) -> tuple:
    """The lengths of the residual streams the forward runs on ``batch``:
    the text (or ``inputs_embeds``), the VLM's patches and text as one,
    and the encoder-decoder's frames and text as two."""
    if "inputs_embeds" in batch:
        return (batch["inputs_embeds"].shape[1],)
    S = batch["tokens"].shape[1] - 1
    if cfg.family == "vlm":
        return (batch["patches"].shape[1] + S,)
    if cfg.family == "encdec":
        return (batch["frames"].shape[1], S)
    return (S,)


# the families whose forward carries the reference's ``"seq"`` label (the
# constraints on q / k / v in ``transformer.attention``, which the VLM and
# Zamba2's shared block run too): ``{"seq": ("model",)}`` splits their
# attention by its query rows.  RWKV6 and the encoder-decoder carry none
QUERY_SPLIT_FAMILIES = frozenset({"dense", "moe", "vlm", "hybrid"})


def _mesh_step(mesh, cfg, pspec, plan, fwds, grads_of, finish, params,
               opt_state, batch):
    """One train step on a mesh, from the rank's slices:

    * the leaves of ``plan`` and the MoE expert weights keep their
      ``model`` split and gather only their ``fsdp`` dim; every other leaf
      is gathered whole over its split axes (:func:`entry_shardings`);
    * the loss and its gradients on the rank's rows of each microbatch
      (its block over the data-parallel axes) by ``fwds[(rows,
      queries)]``: the
      forward of the rank's heads, columns, experts and vocab slice under
      the ``model`` split (``Ctx.tp``), with the residual rows split too
      (``rows``) where ``seq_parallel`` asked for it and every residual
      stream divides by the model axis (:func:`_streams`: the
      encoder-decoder splits its frames and its text both or neither),
      and the attention split by its query rows where the harness took
      ``{"seq": ("model",)}`` and the streams divide alike; the norms'
      gradients of split rows are then summed over the model group;
    * loss and gradients summed over the data group, each rank's weighted
      by its share of the global batch's loss weights (``1 / D`` without a
      ``loss_mask``), so they are the global batch's mean;
    * the gradients cut to the rank's slices (those of ``plan``'s leaves
      come out of the backward already cut over ``model``), clipped by
      the global norm (each distinct slice counted once), compressed with
      the whole leaf's amax, and AdamW on the slices."""
    entry = entry_shardings(pspec, cfg, plan)
    batch = {k: torch.as_tensor(v, device=mesh.device)
             for k, v in batch.items()}
    D = dp_size(mesh)

    def local(ub):
        n = next(iter(ub.values())).shape[0]
        rows = batch_rows(mesh, n)
        if D == 1:
            return rows, None
        if "loss_mask" not in ub:
            return rows, torch.full((), 1.0 / D, device=mesh.device)
        lw = ub["loss_mask"][:, 1:].to(torch.float32)
        return rows, (torch.clamp(lw[rows].sum(), min=1.0)
                      / torch.clamp(lw.sum(), min=1.0))

    divides = all(n % tp_size(mesh) == 0 for n in _streams(cfg, batch))
    rows = divides and (True, False) in fwds
    fwd = fwds[(rows, divides and (rows, True) in fwds)]
    whole = unshard_tree(params, entry)
    loss, grads = grads_of(whole, batch, local, fwd)
    del whole
    if rows:
        grads = _reduce_rows(fwd[1].tp, grads)
    if D > 1:
        loss, grads = _reduce_over_data(mesh, loss, grads)
    grads = shard_tree(grads, entry)
    return finish(params, opt_state, grads, loss, pspec)


def train_donate_argnums(*argnums: int) -> tuple:
    """The reference's train-step donation policy.  The torch step has no
    donation: ``step_fn`` returns new tensors and leaves its inputs alone.
    The train CLI reuses buffers only by rebinding ``params`` and
    ``opt_state`` to the step's outputs, which drops the last reference to
    the old ones, so the caching allocator hands their memory to the next
    step; nothing is updated in place.  Returns ``()``."""
    return ()



# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


def quantize_param_struct(params_struct, cfg: ModelConfig,
                          qcfg: QuantConfig):
    """A param struct (:func:`param_struct`) in its packed ``QTensor``
    deployment layout: every quantizable leaf whose in dim the container
    packs becomes uint8 codes and f32 scales and zero points of its
    groups, as fake tensors (the dry-run's serve cells)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if (path[-1] in QUANT_LEAF_NAMES and node.ndim >= 2
                and node.shape[-2] >= 2):
            *lead, in_f, out_f = node.shape
            g = resolve_group(in_f, qcfg.group_size)
            ppb = PACK_FACTOR[qcfg.bits]
            if in_f % ppb:
                return node
            dev = node.device
            return QTensor(
                packed=torch.empty((*lead, in_f // ppb, out_f),
                                   dtype=torch.uint8, device=dev),
                scale=torch.empty((*lead, in_f // g, out_f),
                                  dtype=torch.float32, device=dev),
                zero=torch.empty((*lead, in_f // g, out_f),
                                 dtype=torch.float32, device=dev),
                bits=qcfg.bits, group_size=g, shape=(in_f, out_f))
        return node

    with _fake_mode(params_struct):
        return walk(params_struct, ())


def check_serve_mesh(mesh, spec=None) -> None:
    """A serve ``mesh`` is the reference's GSPMD-placed path
    (:class:`launch.sharding.MeshPlacement`): it runs on one pod, and it
    does not take a placed ``ServeSpec`` (tensor parallelism places the
    params itself; the reference refuses overrides with ``tp_shard``)."""
    if mesh is None:
        return
    validate_single_pod(mesh, "GSPMD serving")
    if isinstance(spec, ServeSpec):
        raise ValueError("serving on a mesh places the params by "
                         "param_shardings (MeshPlacement); a placed "
                         "ServeSpec carries its own placement: pass one or "
                         "the other")


def make_serve_steps(cfg: ModelConfig, mesh=None, *, act_bits=None,
                     attn_chunk: int = 512, kv_bits=None,
                     kernel_backend=None, page_size: int = 0, spec=None,
                     extra_overrides=None):
    """Returns (model, prefill_step, decode_step).

    ``kernel_backend`` ("xla" | "pallas" | None = env/default) selects the
    QTensor matmul and decode-attention path for both steps; ``act_bits``
    fake-quantizes activations per token in both (W4A8 / W4A4);
    ``attn_chunk`` is the prefill attention's KV chunk; ``kv_bits=8``
    writes and reads the cache as the int8 KV cache (``Ctx.kv_bits``; the
    caller allocates the cache, int8 for an int8 store).  ``page_size > 0``
    builds paged-cache steps: prefill accepts ``start_pos``/``ptab``
    (chunked prefill over a page table) and decode accepts ``ptab``.

    ``spec`` (a placed ``launch.sharding.ServeSpec``) builds the steps of
    serve-time tensor parallelism: they take the rank's local params
    (``spec.params``) and cache, and the returned model allocates that
    local cache.  ``mesh`` builds the reference's GSPMD-placed steps
    (:func:`_make_gspmd_serve_steps`); they take a
    ``launch.sharding.MeshPlacement`` where the others take params, and
    the returned model allocates the rank's slices of a cache.
    ``extra_overrides`` (the reference's remaps of its activation
    constraints) must name the mesh's axes and change nothing else (see
    :func:`make_train_harness`); it does not compose with ``spec``, as the
    reference's with ``tp_shard``."""
    check_serve_mesh(mesh, spec)
    if spec is not None:
        if extra_overrides:
            raise ValueError("make_serve_steps: shard overrides do not "
                             "compose with a placed ServeSpec (it owns "
                             "serve-time placement)")
        return _make_tp_serve_steps(
            cfg, spec, act_bits=act_bits, attn_chunk=attn_chunk,
            kv_bits=kv_bits, kernel_backend=kernel_backend,
            page_size=page_size)
    model = get_model(cfg)
    ctx = make_ctx(attn_chunk=attn_chunk, kernel_backend=kernel_backend,
                   act_bits=act_bits, kv_bits=kv_bits, page_size=page_size)
    if mesh is not None:
        return _make_gspmd_serve_steps(cfg, mesh, model, ctx,
                                       extra_overrides)

    def prefill_step(params, batch, cache, start_pos=0, ptab=None):
        return model.prefill(params, batch, cache, ctx, start_pos=start_pos,
                             ptab=ptab)

    def decode_step(params, cache, tokens, pos, active=None, ptab=None):
        return model.decode_step(params, cache, tokens, pos, ctx,
                                 active=active, ptab=ptab)

    return model, prefill_step, decode_step


def _dp_entry(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _model_part(sharding):
    """A cache leaf's sharding with its data-parallel entry dropped: what
    the rank gathers of its own rows' lane (the ``model`` split)."""
    return NamedSharding(sharding.mesh, PartitionSpec(*(
        e if e == "model" else None for e in sharding.spec)))


def _make_gspmd_serve_steps(cfg: ModelConfig, mesh, model, ctx,
                            extra_overrides=None):
    """The reference's GSPMD serve steps as one rank's eager steps.

    The placement is the reference's: params under ``param_shardings(mesh,
    params, cfg, {"fsdp": ()})`` (a ``MeshPlacement``, placed once by the
    caller), caches under ``cache_shardings`` (the returned model
    allocates the rank's slices and records their layout on the mesh,
    ``mesh_cache_model``; a step reads it back), the batch under
    ``batch_shardings`` (its rows over the data-parallel axes where they
    divide them).  Each step:

    * gathers the leaves split over ``model`` whole
      (``MeshPlacement.whole``: ``unshard_tree``);
    * gathers its rows' cache lane over ``model`` where
      ``cache_shardings`` split it (heads, else GQA's sequence, else the
      last dim);
    * runs the unmeshed step, with the same kernels, on its rows;
    * cuts its slice of the new cache;
    * gathers the logits over the data-parallel axes, so every rank returns
      the global logits, as the reference's GSPMD program does.

    The values are the unmeshed step's on each row; the bytes moved are not
    GSPMD's (the reference's partitioner shards the matmuls and reduces
    partial sums; here a rank gathers whole weights and lanes), nor are
    its FLOPs at a ``model`` axis over one rank (each rank runs the whole
    model on its rows).  The ServeSpec TP steps are the port's serving
    path on a mesh; these steps hold the reference's placement for its
    tests and the dry-run.  The dense store only: a paged pool has no rows to split over the data
    axes."""
    if ctx.page_size:
        raise ValueError("make_serve_steps(mesh): the GSPMD serve steps run "
                         "on the dense store (page_size 0)")
    check_overrides(mesh, extra_overrides)
    dp = _dp_entry(mesh)

    def run(params, cache, batch, call):
        if not isinstance(params, MeshPlacement) or params.mesh != mesh:
            raise ValueError("the GSPMD serve steps take a MeshPlacement "
                             "on their own mesh (MeshPlacement.place(mesh, "
                             "cfg, params))")
        n = next(v for v in batch.values() if v is not None).shape[0]
        specs = mesh_cache_layout(mesh, cfg, cache, n)
        split = dp is not None and n % dp_size(mesh) == 0
        if split:
            rows = batch_rows(mesh, n)
            batch = {k: None if v is None else v[rows]
                     for k, v in batch.items()}
        lane = cache
        for p in _leaf_paths(cache):
            lane = _set_leaf(lane, p, unshard_leaf(
                _get_leaf(cache, p), _model_part(_get_leaf(specs, p))))
        logits, new = call(params.whole(), lane, batch)
        out = new
        for p in _leaf_paths(new):
            out = _set_leaf(out, p, shard_leaf(
                _get_leaf(new, p), _model_part(_get_leaf(specs, p))))
        if split:
            logits = unshard_leaf(logits.contiguous(), NamedSharding(
                mesh, PartitionSpec(dp)))
        return logits, out

    def prefill_step(params, batch, cache, start_pos=0, ptab=None):
        return run(params, cache, batch, lambda p, c, b: model.prefill(
            p, b, c, ctx, start_pos=start_pos, ptab=ptab))

    def decode_step(params, cache, tokens, pos, active=None, ptab=None):
        return run(params, cache, {"tokens": tokens, "pos": pos,
                                   "active": active},
                   lambda p, c, b: model.decode_step(
                       p, c, b["tokens"], b["pos"], ctx, active=b["active"],
                       ptab=ptab))

    return mesh_cache_model(model, mesh, cfg), prefill_step, decode_step


def mesh_write_slot(mesh, cache, slot_cache, slot: int, slots: int):
    """``write_slot`` on a GSPMD-placed cache of ``slots`` slots: where the
    slots split over the data-parallel axes, only the rank holding
    ``slot`` writes it, at its local index; ``slot_cache`` (one request:
    its row replicated) writes its model slice, which has the lane's."""
    if _dp_entry(mesh) is not None and slots % dp_size(mesh) == 0:
        rows = batch_rows(mesh, slots)
        if not rows.start <= slot < rows.stop:
            return cache
        slot -= rows.start
    return write_slot(cache, slot_cache, slot)


def _make_tp_serve_steps(cfg: ModelConfig, spec, *, act_bits=None,
                         attn_chunk: int = 512, kv_bits=None,
                         kernel_backend=None, page_size: int = 0):
    """Serve steps under the tensor-parallel contract: the reference's
    ``shard_map`` body is this rank's own forward.  The family forward runs
    on a model built from the LOCALIZED config (head counts per shard;
    the forwards reshape by them) over the rank's local params, whose
    in-split leaves all-reduce over the model group (``PsumWeight``);
    ``Ctx.ep_inner`` carries that group when the MoE experts split.  The
    global model keeps describing the cache spec; the returned model
    allocates the local cache.  At TP degree 1 every shard is the whole
    leaf and every all-reduce a one-rank identity: bit-identical to the
    un-meshed steps."""
    if spec.cfg != cfg:
        raise ValueError(f"make_serve_steps: the spec was placed for "
                         f"{spec.cfg.name}, the steps are for {cfg.name}")
    model = get_model(cfg)
    lcfg = spec.local_cfg
    lmodel = model if lcfg is cfg else get_model(lcfg)
    ctx = make_ctx(attn_chunk=attn_chunk, kernel_backend=kernel_backend,
                   act_bits=act_bits, kv_bits=kv_bits, page_size=page_size,
                   ep_inner=spec.ep_inner)

    def prefill_step(params, batch, cache, start_pos=0, ptab=None):
        return lmodel.prefill(params, batch, cache, ctx, start_pos=start_pos,
                              ptab=ptab)

    def decode_step(params, cache, tokens, pos, active=None, ptab=None):
        return lmodel.decode_step(params, cache, tokens, pos, ctx,
                                  active=active, ptab=ptab)

    return spec.cache_model(model), prefill_step, decode_step


def make_paged_install_step(model, *, page_size: int):
    """Admission step for the paged store, whole-prefill path: move a B=1
    request cache (prefilled dense at the full ``max_seq`` width — exactly
    the computation dense admission runs, which is what makes paged
    admission bit-identical) into the slot's pages, in place.

    Token leaves scatter rows ``[0, plen)`` into the pool pages named by
    ``ptab_row`` (W,), on the device; state/fixed leaves take the
    ``write_slot`` path.  ``slot`` and ``plen`` are host ints."""
    spec = model.cache_spec
    token_paths = set(spec.token_paths)

    def install(cache, c1, slot: int, ptab_row, *, plen: int):
        zero = torch.zeros((1,), dtype=torch.int32, device=ptab_row.device)
        for path, _ in spec.leaves:
            src, dst = _get_leaf(c1, path), _get_leaf(cache, path)
            if path in token_paths:
                # pools (lead, P + 1, psz, *tail) <- rows (lead, plen, *tail)
                pidx, off = page_rows(ptab_row[None], zero, plen, page_size,
                                      dst.shape[1] - 1)
                dst[:, pidx[0], off[0]] = src[:, 0, :plen].to(dst.dtype)
            else:
                dst.narrow(CACHE_SLOT_AXIS, slot, 1).copy_(src)
        return cache

    return install


def make_sched_steps(cfg: ModelConfig, *, max_seq: int, act_bits=None,
                     attn_chunk: int = 512, kv_bits=None,
                     kernel_backend=None, page_size: int = 0, mesh=None,
                     spec=None, extra_overrides=None):
    """Step pair for the slot scheduler (``repro_torch.launch.scheduler``).

    Returns ``(model, prefill_step, sched_decode_step)``.  The decode step
    wraps the model's ``decode_step`` with occupancy masking, all on the
    device, so every step issues the same launches whatever the occupancy
    and the loop never waits on the host:

      * inactive slots write at position ``max_seq``, past the cache, so
        ``update_cache`` drops the write (paged: past the table, so the
        write lands on the spare page) and a finished slot's KV state stops
        changing the moment it completes;
      * the greedy next token is selected on the device and frozen for
        inactive slots (``where(active, argmax, tok)``), as is ``pos``.

    Active rows see exactly the arguments the plain serve loop passes (same
    pos, same kv_len), which is what makes scheduled decode bit-compatible
    with serving a request alone.  ``spec``: the tensor-parallel steps of
    ``make_serve_steps``; ``mesh``: its GSPMD-placed steps.  Every rank
    then runs the same host loop on the same logits (the all-reduce, or
    the logits' gather over the data axes, gives every rank the same
    bytes)."""
    model, prefill_step, decode_step = make_serve_steps(
        cfg, mesh, act_bits=act_bits, attn_chunk=attn_chunk, kv_bits=kv_bits,
        kernel_backend=kernel_backend, page_size=page_size, spec=spec,
        extra_overrides=extra_overrides)

    def sched_decode_step(params, cache, tok, pos, active, ptab=None):
        write_pos = torch.where(active, pos, max_seq)
        logits, cache = decode_step(params, cache, tok, write_pos,
                                    active=active.to(torch.int32), ptab=ptab)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        tok = torch.where(active, nxt, tok)
        pos = torch.where(active, pos + 1, pos)
        return logits, tok, pos, cache

    return model, prefill_step, sched_decode_step


# --------------------------------------------------------------------------
# donation policy and the dry-run's input specs
# --------------------------------------------------------------------------

def cache_donate_argnums(*argnums: int) -> tuple:
    """The reference's serve-step donation policy: the cache arguments are
    donated.  Here a step writes the cache leaves it holds whole in place
    (``update_cache``), and on a mesh it cuts a new slice of a gathered
    lane, which replaces the rank's old slice once the caller rebinds it:
    the cache arguments are the ones whose buffers the step reuses.
    Returns ``argnums``."""
    return argnums


def _fake(shape, dtype, device="meta"):
    return torch.empty(shape, dtype=dtype, device=device)


def _fake_mode(tree=None):
    """The ``FakeTensorMode`` to make fakes under: the active one, else the
    one ``tree``'s fakes were made under (fakes of two modes do not mix),
    else a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    mode = detect_fake_mode(tree_leaves(tree) if tree is not None else None)
    return mode if mode is not None else FakeTensorMode()


def _frontend_inputs(cfg: ModelConfig, B: int, S: int, batch: dict) -> dict:
    dt = _DTYPES[cfg.dtype]
    if cfg.family == "encdec":
        F = cfg.frontend_len or S
        batch["frames"] = _fake((B, F, cfg.d_model), dt)
    if cfg.family == "vlm":
        batch["patches"] = _fake((B, cfg.num_patches, cfg.d_model), dt)
    return batch


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A train step's batch as fake tensors: ``(B, S + 1)`` tokens (the
    VLM's text after its patches, so patches + text = S), frames or
    patches where the family takes them."""
    B, S = shape.global_batch, shape.seq_len
    with _fake_mode():
        text = S - cfg.num_patches if cfg.family == "vlm" else S
        return _frontend_inputs(cfg, B, S, {
            "tokens": _fake((B, text + 1), torch.int32)})


def serve_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                      kv_bits=None) -> dict:
    """A decode step's inputs as fake tensors: one new token a row against
    a ``seq_len`` cache (int8 for ``kv_bits=8``)."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch.int8 if kv_bits == 8 else torch.bfloat16
    with _fake_mode():
        return {"cache": get_model(cfg).init_cache(B, S, dt, "meta"),
                "tokens": _fake((B,), torch.int32),
                "pos": _fake((B,), torch.int32)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A prefill's inputs as fake tensors: ``(B, S)`` tokens (the VLM's
    text after its patches) and a ``seq_len`` cache."""
    B, S = shape.global_batch, shape.seq_len
    with _fake_mode():
        text = S - cfg.num_patches if cfg.family == "vlm" else S
        return {"batch": _frontend_inputs(cfg, B, S, {
                    "tokens": _fake((B, text), torch.int32)}),
                "cache": get_model(cfg).init_cache(B, S, device="meta")}
