"""Shared forward context and cache plumbing for the model code.

The dense store's cache is a dict of leaves stacked ``(layers, slots,
max_seq, kv_heads, head_dim)`` — the reference's slot-major layout.  The
paged store keeps each token leaf as a page POOL ``(layers, num_pages + 1,
page_size, kv_heads, head_dim)`` shared by every slot and indexed through a
per-slot page table.  The pool's last page is a spare that the allocator
never hands out: writes the reference drops (scatter ``mode="drop"`` at an
out-of-range page) land there instead, since PyTorch has no dropping
scatter, and no page table ever names it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.qtensor import QTensor
from repro_torch.models.layers import PsumWeight


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call forward context.

    ``kernel_backend`` is the per-call QTensor dispatch: "xla" (dequantize
    + dense matmul; dense masked-softmax decode attention) or "pallas" (the
    hand-written kernels; their plain versions on a CPU tensor).  ``None``
    falls back to ``resolve_backend``'s default.  ``attn_chunk`` is the KV
    chunk of the prefill online softmax.  ``page_size > 0`` marks the cache
    as page pools read through a page table (the paged store).
    ``act_bits`` turns on per-token activation fake-quant
    (``layers.fake_quant_act``) at the inputs of the quantized projections
    (W4A4, W4A8).  ``kv_bits = 8`` is the int8 KV cache, the reference's
    beyond-paper option: k and v are written as
    ``clip(round(a / kv_scale), -128, 127)`` in the cache's dtype (int8 for
    an int8 store) and read back as ``cache * kv_scale`` in the
    activations' dtype; ``kv_scale`` is static (the reference's default is
    a bound for post-RoPE keys and values at unit-variance init).  A paged
    int8 pool is gathered into the dense lane before that, so its decode
    runs the dense decode-attention kernel.  ``remat`` recomputes each
    decoder layer's forward in the backward (``maybe_remat``; ``make_ctx``
    defaults it from ``cfg.remat``).

    ``ep_inner`` is the serve-time TP ranks' model process group when the
    MoE experts are split over it (``launch.steps.make_serve_steps(
    spec=...)``): ``models.moe.moe_ffn`` then computes the rank's
    local experts and all-reduces their output over it.

    ``mesh`` (a ``launch.mesh.Mesh``), ``dp_axes`` and ``ep_axis`` are the
    mesh ctx of training and evaluation on a mesh (``make_ctx(cfg,
    mesh=...)``): the forward runs on the rank's rows of the batch (its
    block over ``dp_axes``), and ``ep_axis`` (``"model"`` for the MoE
    family on a ``model`` axis of more than one rank) splits the experts
    over that axis (``models.moe.moe_ffn``).

    ``tp`` (a ``layers.ModelSplit``) is the mesh train step's split over
    the ``model`` axis (``launch.steps.make_train_harness``): the
    transformer's blocks enter and leave each region through
    ``layers.enter`` / ``layers.leave``, which all-reduce (or, with the
    residual rows split, all-gather and reduce-scatter) over its group,
    the embedding and the loss run over the rank's vocab slice, and the
    forward runs on a config with the rank's head counts.

    Fields of the reference's Ctx that are not here, and why: ``shard``
    (its activation sharding constraints, from which GSPMD derives the
    split program; the port writes that program out: ``tp`` and the
    region entries and exits are what the reference's constraints on
    heads, vocab and ``res_seq`` make its partitioner do) and ``decode``
    (read only by those constraints).
    """
    kernel_backend: Optional[str] = None
    act_bits: Optional[int] = None
    kv_bits: Optional[int] = None
    kv_scale: float = 0.05
    attn_chunk: int = 512
    page_size: int = 0
    remat: bool = False
    ep_axis: Optional[str] = None
    ep_inner: Any = None
    mesh: Any = None
    dp_axes: tuple = ()
    tp: Any = None


DEFAULT_CTX = Ctx()

_CTX_FIELDS = {f.name for f in dataclasses.fields(Ctx)}
_MESH_FIELDS = {"mesh", "ep_axis", "dp_axes"}


def make_ctx(cfg=None, *, mesh=None, shard_overrides=None, **fields) -> Ctx:
    """THE :class:`Ctx` constructor: validates the fields and rejects
    unknown names.  ``remat`` (omitted or None) defaults to ``cfg.remat``
    when a config is given, as the reference's ``make_ctx`` does, else to
    False (the serve steps).  ``kv_bits`` must be None or 8, as in the
    reference.  ``mesh`` derives ``dp_axes`` and ``ep_axis`` as the
    reference does: ``"model"`` only for the MoE family on a ``model``
    axis of more than one rank.  ``shard_overrides`` (the reference's
    logical-axis remaps of its activation constraints, e.g.
    ``{"seq": ("model",)}``) must name the mesh's axes and change nothing
    else: this Ctx has no ``shard``; without a mesh they are ignored, as
    in the reference.  Fields the reference has and this Ctx has not (the
    class docstring says why) are unknown here."""
    unknown = set(fields) - (_CTX_FIELDS - _MESH_FIELDS)
    if unknown:
        raise TypeError(f"make_ctx: unknown Ctx field(s) {sorted(unknown)}; "
                        f"valid fields: {sorted(_CTX_FIELDS)}")
    if fields.get("remat") is None:
        fields["remat"] = bool(cfg.remat) if cfg is not None else False
    backend = fields.get("kernel_backend")
    if backend is not None and backend not in ("xla", "pallas"):
        raise ValueError(f"make_ctx: unknown kernel_backend {backend!r} "
                         f"(expected 'xla', 'pallas' or None)")
    kv_bits = fields.get("kv_bits")
    if kv_bits not in (None, 8):
        raise ValueError(f"make_ctx: unsupported kv_bits {kv_bits!r} "
                         f"(the int8 KV cache supports None or 8)")
    chunk = fields.get("attn_chunk", 512)
    if chunk < 1:
        raise ValueError(f"make_ctx: attn_chunk must be >= 1, got {chunk}")
    page_size = fields.get("page_size", 0)
    if page_size < 0:
        raise ValueError(f"make_ctx: page_size must be >= 0, got {page_size}")
    if page_size and chunk % page_size:
        raise ValueError(f"make_ctx: attn_chunk ({chunk}) must be a "
                         f"multiple of page_size ({page_size})")
    if mesh is not None:
        # lazy import: models sit below launch/ in the layering
        from repro_torch.launch.mesh import dp_axes, tp_axis, tp_size
        from repro_torch.launch.sharding import check_overrides
        check_overrides(mesh, shard_overrides)
        moe = cfg is not None and cfg.family == "moe"
        fields.update(mesh=mesh, dp_axes=dp_axes(mesh),
                      ep_axis=(tp_axis(mesh) if moe and tp_size(mesh) > 1
                               else None))
    return Ctx(**fields)


def maybe_remat(fn, ctx: Ctx):
    """``fn`` recomputed in the backward when ``ctx.remat`` is on (the
    non-reentrant ``torch.utils.checkpoint``: the forward keeps only
    ``fn``'s inputs and reruns it when the gradient reaches it).  The
    model draws no random numbers, so no RNG state is saved for the rerun
    (saving it reads the CUDA generator's state to the host).  Without a
    graph being recorded it is ``fn`` itself."""
    if not (ctx.remat and torch.is_grad_enabled()):
        return fn

    def run(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            **kwargs)
    return run


def take_layer(params, i):
    """Slice layer ``i`` out of stacked (L, ...) block params (views)."""
    if isinstance(params, dict):
        return {k: take_layer(v, i) for k, v in params.items()}
    if isinstance(params, QTensor):
        return params.layer(i)
    if isinstance(params, PsumWeight):
        return PsumWeight(take_layer(params.w, i), params.group)
    return params[i]


def unstack_layers(params, n: int) -> list:
    """Every layer of stacked (L, ...) block params at once: a list of ``n``
    per-layer trees of views.  A tensor is taken apart by one ``unbind``,
    whose backward is one ``stack`` of the layers' gradients, where ``n``
    calls of ``take_layer`` would each write a zero-filled gradient of the
    whole stack."""
    if isinstance(params, dict):
        per_key = {k: unstack_layers(v, n) for k, v in params.items()}
        return [{k: per_key[k][i] for k in params} for i in range(n)]
    if isinstance(params, QTensor):
        return [params.layer(i) for i in range(n)]
    if isinstance(params, PsumWeight):
        return [PsumWeight(w, params.group)
                for w in unstack_layers(params.w, n)]
    return list(params.unbind(0))


# --------------------------------------------------------------------------
# cache layout contract (CacheSpec) + slot plumbing
# --------------------------------------------------------------------------

CACHE_SLOT_AXIS = 1      # the slot axis of every stacked cache leaf

LEAF_TOKEN = "token"     # per-token extent on token_axis; pageable
LEAF_STATE = "state"     # O(1)-in-seq recurrent state; always slot-major
LEAF_FIXED = "fixed"     # fixed extent (e.g. encdec cross-attn); slot-major


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Layout of one cache leaf within the stacked cache tree."""
    kind: str                       # LEAF_TOKEN | LEAF_STATE | LEAF_FIXED
    token_axis: int = 2             # per-token axis (token leaves only)


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """A model family's declared cache layout.

    ``leaves`` maps a leaf path ("k", "mamba/conv", ...) to its
    :class:`LeafSpec`.  ``chunkable`` marks families whose prefill can
    resume mid-sequence (chunked prefill); ``shareable`` marks families
    whose full prompt-prefix pages may be shared copy-on-write (requires
    ``chunkable`` plus a prompt fully described by its token ids)."""
    family: str
    leaves: Tuple[Tuple[str, LeafSpec], ...]
    slot_axis: int = CACHE_SLOT_AXIS
    chunkable: bool = False
    shareable: bool = False

    def leaf(self, path: str) -> LeafSpec:
        for p, ls in self.leaves:
            if p == path:
                return ls
        raise KeyError(f"cache leaf {path!r} not declared for family "
                       f"{self.family!r}")

    @property
    def token_paths(self) -> Tuple[str, ...]:
        return tuple(p for p, ls in self.leaves if ls.kind == LEAF_TOKEN)

    def validate(self, cache) -> None:
        """Check a cache tree structurally matches this spec."""
        got = set(_leaf_paths(cache))
        want = {p for p, _ in self.leaves}
        if got != want:
            raise ValueError(
                f"cache leaves {sorted(got)} do not match CacheSpec for "
                f"family {self.family!r} (declared {sorted(want)})")


def _leaf_paths(tree, prefix=()) -> List[str]:
    if isinstance(tree, dict):
        out: List[str] = []
        for k, v in sorted(tree.items()):
            out += _leaf_paths(v, prefix + (k,))
        return out
    return ["/".join(prefix)]


def _get_leaf(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _set_leaf(tree, path: str, value):
    """Functional leaf replacement (trees are plain nested dicts)."""
    keys = path.split("/")
    if len(keys) == 1:
        return {**tree, keys[0]: value}
    return {**tree, keys[0]: _set_leaf(tree[keys[0]], "/".join(keys[1:]),
                                       value)}


def write_slot(cache, slot_cache, slot: int):
    """Copy a single-request cache (size 1 on the slot axis) into ``slot``
    of a batched cache, in place; returns ``cache``.  ``slot`` is a host
    int, so nothing goes to the device and back."""
    for path in _leaf_paths(cache):
        dst = _get_leaf(cache, path)
        dst.narrow(CACHE_SLOT_AXIS, slot, 1).copy_(_get_leaf(slot_cache, path))
    return cache


def read_slot(cache, slot: int):
    """Slot ``slot`` as a batch-of-1 cache (a copy; inverse of write_slot)."""
    out = cache
    for path in _leaf_paths(cache):
        leaf = _get_leaf(cache, path)
        out = _set_leaf(out, path,
                        leaf.narrow(CACHE_SLOT_AXIS, slot, 1).clone())
    return out


def update_cache(cache_k, cache_v, k, v, pos):
    """Insert k, v (B, S_new, H, D) into caches (B, S, H, D) at ``pos``.

    ``pos`` is (B,) per-request write offsets.  Rows whose position is
    ``>= S`` are dropped, as the reference's scatter drops them (the
    scheduler freezes a finished slot by writing at ``pos = S``).  The write
    is IN PLACE, where the reference builds new arrays: every row's index
    is clamped into range and carries the value that index ends up with —
    the new row if one of the call's rows lands there, else the old one —
    so duplicate indices all write one value and the result is
    deterministic."""
    B, S_new = k.shape[0], k.shape[1]
    S = cache_k.shape[1]
    dev = k.device
    b = torch.arange(B, device=dev)[:, None]
    pos = pos[:, None].long()
    if S_new == 1:                  # decode: one index per row, no collision
        idx = pos.clamp(max=S - 1)
        new = (pos < S)[:, :, None, None]
        for cache, vals in ((cache_k, k), (cache_v, v)):
            cache[b, idx] = torch.where(new, vals.to(cache.dtype),
                                        cache[b, idx])
        return cache_k, cache_v
    idx = (pos + torch.arange(S_new, device=dev)[None, :]).clamp(max=S - 1)
    j = idx - pos                               # row of k that lands there
    new = ((j >= 0) & (j < S_new))[:, :, None, None]
    src = j.clamp(0, S_new - 1)[:, :, None, None].expand(B, S_new,
                                                         *k.shape[2:])
    for cache, vals in ((cache_k, k), (cache_v, v)):
        vals = torch.gather(vals.to(cache.dtype), 1, src)
        cache[b, idx] = torch.where(new, vals, cache[b, idx])
    return cache_k, cache_v


# --------------------------------------------------------------------------
# paged token leaves: device verbs
# --------------------------------------------------------------------------
#
# A paged token leaf is a pool (P + 1, page_size, *tail) once the layer axis
# is sliced off; page P is the spare.  A page table ``ptab`` (slots, W)
# int32 maps each slot's logical page j (tokens [j*psz, (j+1)*psz)) to a
# pool page.  W = max_seq // page_size spans the FULL logical width, so the
# gathered virtual cache has exactly the dense lane's shape; unallocated
# entries point at page 0, whose values are finite and sit beyond kv_len,
# where attention masks the scores to exactly -1e30 in dense and paged
# alike.  So dense and paged attention run elementwise-identical
# reductions: outputs are bit-identical.


def gather_pages(pool, ptab):
    """Materialize a slot-major virtual cache from a page pool.

    pool (P, psz, *tail), ptab (B, W) int32 -> (B, W*psz, *tail)."""
    psz = pool.shape[1]
    g = pool[ptab.long()]                            # (B, W, psz, *tail)
    return g.reshape(ptab.shape[0], ptab.shape[1] * psz, *pool.shape[2:])


def page_rows(ptab, pos, n: int, page_size: int, spare: int):
    """(page, offset) of positions ``pos[b] + [0, n)`` through ``ptab``;
    positions past the table go to page ``spare``.  Both (B, n) int64."""
    W = ptab.shape[1]
    tpos = pos[:, None].long() + torch.arange(n, device=ptab.device)[None, :]
    page_log = tpos // page_size
    pidx = torch.gather(ptab.long(), 1, page_log.clamp(0, W - 1))
    return torch.where(page_log < W, pidx, spare), tpos % page_size


def page_write_tokens(pool, vals, ptab, pos, page_size: int):
    """Scatter per-token values into pool pages, in place; returns ``pool``.

    pool (P + 1, psz, *tail) with page P the spare; vals (B, S, *tail);
    ptab (B, W); pos (B,) start positions.  Rows whose position lands past
    the table (the scheduler's ``pos = max_seq`` freeze for inactive slots)
    go to the spare page, which no table names: the reference's dropped
    write.  Live rows of distinct slots land on distinct pages."""
    rows = page_rows(ptab, pos, vals.shape[1], page_size, pool.shape[0] - 1)
    return _page_write(pool, vals, rows)


def _page_write(pool, vals, rows):
    pidx, off = rows
    pool[pidx.reshape(-1), off.reshape(-1)] = vals.reshape(
        -1, *vals.shape[2:]).to(pool.dtype)
    return pool


def page_update_cache(cache_k, cache_v, k, v, pos, ptab, page_size: int):
    """Paged counterpart of :func:`update_cache` (same call shape); the
    page rows are resolved once for both pools."""
    rows = page_rows(ptab, pos, k.shape[1], page_size, cache_k.shape[0] - 1)
    return _page_write(cache_k, k, rows), _page_write(cache_v, v, rows)


# --------------------------------------------------------------------------
# CacheStore: dense + paged cache layout/allocator behind one verb set
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """Outcome of a successful admission: where the request's tokens live.

    ``shared_tokens`` > 0 means the first ``shared_tokens`` prompt
    positions are served by copy-on-write shared pages (already filled by
    an earlier request with the same prefix) — prefill starts there."""
    slot: int
    pages: Tuple[int, ...] = ()
    shared_tokens: int = 0


def _nbytes(cache) -> int:
    return sum(t.numel() * t.element_size()
               for t in (_get_leaf(cache, p) for p in _leaf_paths(cache)))


class DenseCacheStore:
    """One contiguous ``max_seq`` lane per slot.

    Admission always succeeds (a free slot IS the capacity unit); the
    class exists so the scheduler speaks one store API and so paged runs
    have an explicit bit-identity/memory anchor to compare against."""

    kind = "dense"

    def __init__(self, model, *, slots: int, max_seq: int,
                 dtype=torch.bfloat16, device="cpu"):
        self.spec = model.cache_spec
        self.slots, self.max_seq, self.dtype = slots, max_seq, dtype
        self.cache = model.init_cache(slots, max_seq, dtype, device)
        self.spec.validate(self.cache)
        self.ptab_h = None                  # no page table: dense lanes

    def try_admit(self, slot: int, total_len: int,
                  prompt: Optional[np.ndarray] = None,
                  share: bool = False) -> Optional[AdmitPlan]:
        if total_len > self.max_seq:
            raise ValueError(f"request needs {total_len} positions; "
                             f"max_seq is {self.max_seq}")
        return AdmitPlan(slot=slot)

    def register_prefix(self, slot: int, prompt: np.ndarray) -> None:
        pass

    def release(self, slot: int) -> None:
        pass

    def cache_bytes(self) -> int:
        return _nbytes(self.cache)

    def stats(self) -> Dict[str, Any]:
        return {"store": self.kind, "cache_bytes": self.cache_bytes(),
                "slots": self.slots, "max_seq": self.max_seq}


class PagedCacheStore:
    """Fixed pool of ``page_size``-token pages + per-slot page tables.

    Token leaves of the family cache become pools ``(lead, num_pages + 1,
    page_size, *tail)`` (the last page is the spare that dropped writes
    land on); state/fixed leaves keep their dense slot-major layout.  The
    host side owns the allocator: a free list, per-page refcounts, and a
    prompt-prefix map for copy-on-write sharing of FULL prompt-prefix pages
    (keyed by the exact token bytes up to the page end, so two requests
    share a page only when every token influencing its KV values is
    identical).  Shared pages are never written again: a sharer's prefill
    starts after the shared region and decode writes land beyond the
    prompt, so "copy-on-write" needs no copies.
    """

    kind = "paged"

    def __init__(self, model, *, slots: int, max_seq: int, page_size: int,
                 num_pages: int, dtype=torch.bfloat16, device="cpu"):
        if page_size < 1 or max_seq % page_size:
            raise ValueError(f"max_seq ({max_seq}) must be a positive "
                             f"multiple of page_size ({page_size})")
        if num_pages < 1:
            raise ValueError(f"need at least one page, got {num_pages}")
        self.spec = model.cache_spec
        self.slots, self.max_seq, self.dtype = slots, max_seq, dtype
        self.page_size, self.num_pages = page_size, num_pages
        self.W = max_seq // page_size
        struct = model.init_cache(slots, max_seq, dtype, "meta")  # shapes only
        self.spec.validate(struct)
        self.cache = struct
        for path in _leaf_paths(struct):
            t = _get_leaf(struct, path)
            ls = self.spec.leaf(path)
            shape = tuple(t.shape)
            if ls.kind == LEAF_TOKEN:
                if (self.spec.slot_axis, ls.token_axis) != (1, 2):
                    raise NotImplementedError(
                        f"paged leaf {path!r}: pool layout assumes slot "
                        f"axis 1 / token axis 2")
                shape = (shape[0], num_pages + 1, page_size) + shape[3:]
            self.cache = _set_leaf(self.cache, path, torch.zeros(
                shape, dtype=t.dtype, device=device))
        self.ptab_h = np.zeros((slots, self.W), np.int32)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros((num_pages,), np.int64)
        self._slot_pages: Dict[int, Tuple[int, ...]] = {}
        self._prefix_map: Dict[bytes, int] = {}     # token-bytes -> page
        self._page_key: Dict[int, bytes] = {}
        self.peak_pages_in_use = 0
        self.refused_admissions = 0
        self.shared_page_hits = 0

    # ---- allocator -------------------------------------------------------

    def pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.page_size)

    def _prefix_chain(self, prompt: np.ndarray) -> List[int]:
        """Longest run of already-resident full prompt-prefix pages.

        Sharing stops before the LAST prompt token: its logits seed the
        generation, so at least one position must run through prefill."""
        psz = self.page_size
        pages = []
        for j in range((len(prompt) - 1) // psz):
            page = self._prefix_map.get(prompt[:(j + 1) * psz].tobytes())
            if page is None:
                break
            pages.append(page)
        return pages

    def try_admit(self, slot: int, total_len: int,
                  prompt: Optional[np.ndarray] = None,
                  share: bool = False) -> Optional[AdmitPlan]:
        """Allocate a lifetime's worth of pages, or return None (request
        waits in queue) when the pool can't cover it right now."""
        need = self.pages_needed(total_len)
        if need > self.W:
            raise ValueError(f"request needs {need} pages; max_seq allows "
                             f"{self.W}")
        if need > self.num_pages:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.num_pages} — it can never be admitted; raise "
                f"num_pages or lower the request's length")
        shared = (self._prefix_chain(prompt)
                  if (share and prompt is not None) else [])
        fresh = need - len(shared)
        if fresh > len(self._free):
            self.refused_admissions += 1
            return None
        pages = tuple(shared) + tuple(self._free.pop() for _ in range(fresh))
        for p in pages:
            self._ref[p] += 1
        self.shared_page_hits += len(shared)
        self._slot_pages[slot] = pages
        self.ptab_h[slot] = 0
        self.ptab_h[slot, :need] = pages
        in_use = self.num_pages - len(self._free)
        self.peak_pages_in_use = max(self.peak_pages_in_use, in_use)
        return AdmitPlan(slot=slot, pages=pages,
                         shared_tokens=len(shared) * self.page_size)

    def register_prefix(self, slot: int, prompt: np.ndarray) -> None:
        """Publish this request's full prompt-prefix pages for sharing —
        call AFTER its prefill has filled them.  An identical prefix that is
        resident twice (admitted before this one published) keeps its first
        registration."""
        psz = self.page_size
        pages = self._slot_pages.get(slot, ())
        for j in range(len(prompt) // psz):
            key = prompt[:(j + 1) * psz].tobytes()
            if key not in self._prefix_map:
                self._prefix_map[key] = pages[j]
                self._page_key[pages[j]] = key

    def release(self, slot: int) -> None:
        for p in self._slot_pages.pop(slot, ()):
            self._ref[p] -= 1
            if self._ref[p] == 0:
                key = self._page_key.pop(p, None)
                if key is not None:
                    del self._prefix_map[key]
                self._free.append(p)
        self.ptab_h[slot] = 0

    # ---- accounting ------------------------------------------------------

    def cache_bytes(self) -> int:
        """Device bytes of the pools (spare pages included) plus the page
        table."""
        return _nbytes(self.cache) + self.ptab_h.nbytes

    def stats(self) -> Dict[str, Any]:
        return {
            "store": self.kind, "cache_bytes": self.cache_bytes(),
            "slots": self.slots, "max_seq": self.max_seq,
            "page_size": self.page_size, "num_pages": self.num_pages,
            "pages_in_use": self.num_pages - len(self._free),
            "peak_pages_in_use": self.peak_pages_in_use,
            "refused_admissions": self.refused_admissions,
            "shared_page_hits": self.shared_page_hits,
        }
