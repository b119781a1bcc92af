"""Slot-based continuous-batching request scheduler, and the serve result
surface (``ServeResult``) every serve entry point returns.

  * a FIFO **request queue** with per-request arrival times (decode-step
    units, from a seeded plan — see :func:`make_workload`);
  * a fixed number of **slots**, each owning one lane of the batched cache
    (the cache layout is declared by ``Model.cache_spec``; ``write_slot``
    moves a prefilled request's cache into its slot under the dense store,
    the paged install step scatters it into pool pages under the paged
    store);
  * **ragged lengths**: each request prefills at its true prompt length
    (batch of 1 at the full cache width) and decodes until its own token
    budget, not the batch max;
  * **completion masking**: a finished slot's token, write cursor and KV
    state are frozen on the device (``launch.steps.make_sched_steps``) and
    its logits are never recorded again;
  * **admission mid-decode**: a freed slot is handed the next queued
    request without stopping the other slots.

The reference's "decode compiles once across occupancy" is, in this eager
port, a pair of conditions: every decode step issues the same kernel
launches whatever the occupancy (occupancy is a device mask), and the decode
loop makes no host sync.  Completions are budget driven (host-known at
admission), so the only host round trips are one per admission (the first
generated token, plus the admission window's timing boundary) and one at
the end; host mirrors go to the device as private copies (pinned and
asynchronous on a card), and the per-step token tensors are fetched after
the loop.  ``collect_logits=True`` fetches each step's logits to the host
instead, so logit-collecting runs sync per step and are not timed.

Per-request outputs equal serving the same request alone through
``serve_requests`` at the same cache width: active rows see exactly the
arguments the plain loop passes, and every op of the decode path is
batch-row independent (up to the rounding of a library matmul across row
counts; the port's own kernels are row-independent).

``store="paged"`` swaps the dense per-slot lanes for a paged KV pool
(``models.common.PagedCacheStore``): token leaves live in a fixed pool of
``page_size``-token pages, admission allocates a lifetime's worth of pages
(waiting in queue when the pool is tight), and the page table reaches the
decode step as a device tensor.  Paged outputs are bit-identical to the
dense store's.  ``prefill_chunk > 0`` splits prompts into chunks
interleaved one per iteration with decode (chunk steps run at full cache
width, so dense and paged chunked prefill stay bit-identical), and
``share_prefix=True`` lets paged chunked admission reuse full prompt-prefix
pages copy-on-write.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.debug.sanitize import allowed_transfer
from repro_torch.launch.serve import (_params_device, compile_serve_steps,
                                      place_on_mesh, serve_requests)
from repro_torch.launch.sharding import unplace
from repro_torch.launch.steps import (check_serve_mesh,
                                      make_paged_install_step,
                                      make_sched_steps, mesh_write_slot)
from repro_torch.models.common import (DenseCacheStore, PagedCacheStore,
                                       write_slot)


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued generation request.

    ``arrival`` is in scheduler-clock units (decode steps): the request is
    admissible once the scheduler has dispatched that many decode steps.
    ``extras`` carries further per-request prefill inputs, unbatched:
    ``patches`` (num_patches, d_model) for the VLM, ``frames``
    (frontend_len, d_model) for the encoder-decoder."""
    rid: int
    prompt: np.ndarray                  # (plen,) int32
    max_new_tokens: int
    arrival: int = 0
    extras: Optional[Dict[str, np.ndarray]] = None


def _push(host_arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host->device transfer of a buffer the scheduler keeps MUTATING.

    ``torch.tensor`` copies the buffer, so a later in-place change of the
    host mirror cannot reach a step already queued on the device.  On a
    card the private copy is pinned and transferred asynchronously: the
    pinned block is not reused before its copy has run, and the copy does
    not wait for the steps queued ahead of it."""
    t = torch.tensor(host_arr)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _set_slot(a: torch.Tensor, s: int, v: int) -> torch.Tensor:
    """``a`` with entry ``s`` set to ``v``, as a new tensor (the old one may
    still be held by the token trace).  ``s`` and ``v`` reach the device as
    kernel arguments, so nothing is copied and nothing syncs."""
    return torch.where(torch.arange(a.shape[0], device=a.device) == s, v, a)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        with allowed_transfer():
            torch.cuda.synchronize(dev)


@dataclasses.dataclass(frozen=True)
class SchedSteps:
    """Step set for one (arch, max_seq, backend, store) configuration."""
    model: Any
    prefill: Any              # (params, batch, cache[, start_pos, ptab])
    decode: Any               # (params, cache, tok, pos, active[, ptab])
    install: Any = None       # paged admission (cache, c1, slot, ptab_row)
    page_size: int = 0
    placement: Any = None     # ServeSpec.key of the TP steps, or the mesh
                              # of the GSPMD steps (None: neither)


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """The one result surface every serve entry point returns
    (``serve_requests``, ``serve_scheduled``, ``serve_lockstep``).

    ``requests`` maps rid -> per-request record (``tokens`` (gen,) int32,
    ``logits`` (gen, V) or None, admission/finish bookkeeping where the
    mode tracks it).  ``latency_steps`` holds mean/p50/p90/p99 percentiles
    in decode-step units.  ``cache_stats`` is the cache store's accounting
    (``CacheStore.stats()``: bytes always; page-pool counters when paged).
    Mode-specific extras (e.g. lock-step's wasted-token accounting) ride in
    ``extra``.  Mapping-style ``result["key"]`` access resolves attributes,
    falling back to ``extra``."""
    mode: str                               # "uniform"|"scheduled"|"lockstep"
    store: str                              # "dense" | "paged"
    requests: Dict[int, Dict[str, Any]]
    slots: int
    max_seq: int
    steps: int
    useful_tokens: int
    decode_tokens: int
    prefill_secs: float
    decode_secs: float
    prefill_tok_s: float
    decode_tok_s: float
    occupancy: float
    latency_steps: Dict[str, float]
    cache_stats: Dict[str, Any]
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __getitem__(self, key: str):
        if key in self.extra:
            return self.extra[key]
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    # reprolint: ok[host-sync] — cold accessor over already-fetched host arrays; runs after the timed loop
    def token_matrix(self) -> np.ndarray:
        """(B, gen) token ids, rids in sorted order — uniform-budget runs
        only (ragged budgets cannot stack; use ``requests`` directly)."""
        rids = sorted(self.requests)
        return np.stack([np.asarray(self.requests[r]["tokens"], np.int32)
                         for r in rids], 0)

    # reprolint: ok[host-sync] — cold accessor over already-fetched host arrays; runs after the timed loop
    def logits_matrix(self) -> Optional[np.ndarray]:
        """(B, gen, V) float32 logits, or None when not collected."""
        rids = sorted(self.requests)
        if not rids or self.requests[rids[0]].get("logits") is None:
            return None
        return np.stack([np.asarray(self.requests[r]["logits"], np.float32)
                         for r in rids], 0)

    @property
    def tokens(self) -> np.ndarray:
        return self.token_matrix()

    @property
    def logits(self) -> Optional[np.ndarray]:
        return self.logits_matrix()


# reprolint: ok[host-sync] — pure host statistics over python floats; no device values involved
def _latency_stats(latencies) -> Dict[str, float]:
    lat = np.asarray(latencies, np.float64)
    return {"mean": float(lat.mean()), "p50": float(np.percentile(lat, 50)),
            "p90": float(np.percentile(lat, 90)),
            "p99": float(np.percentile(lat, 99))}


def make_workload(vocab_size: int, *, n_requests: int, seed: int,
                  prompt_lens=(8, 32), budgets=(2, 24),
                  mean_gap: float = 1.0, long_frac: float = 0.0,
                  long_prompt_lens=None, long_budgets=None) -> List[Request]:
    """Seeded heterogeneous request plan: mixed prompt lengths, mixed token
    budgets, Poisson inter-arrival gaps in decode-step units.  A pure
    function of its arguments (numpy only), so the same seed yields the
    reference's plan on every run.

    ``long_frac > 0`` makes the plan long-tailed: that fraction of requests
    draws from ``long_prompt_lens``/``long_budgets`` instead."""
    rng = np.random.default_rng(seed)
    t = 0
    reqs = []
    for rid in range(n_requests):
        is_long = long_frac > 0 and rng.random() < long_frac
        pl = long_prompt_lens if is_long else prompt_lens
        bu = long_budgets if is_long else budgets
        plen = int(rng.integers(pl[0], pl[1] + 1))
        budget = int(rng.integers(bu[0], bu[1] + 1))
        prompt = rng.integers(0, vocab_size, (plen,)).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                            arrival=t))
        t += int(rng.poisson(mean_gap))
    return reqs


def _prefill_len(cfg: ModelConfig, req: Request) -> int:
    """Cache positions a request's prefill consumes: its prompt, plus the
    image-patch prefix for the VLM (the patches share the decoder cache).
    An encoder-decoder's frames fill the fixed cross-attention leaves, not
    the decoder's token cache."""
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    return len(req.prompt) + extra


# per-configuration step sets: every run over the same (cfg, width, backend,
# act_bits, store) reuses ONE SchedSteps
_SCHED_STEP_CACHE: dict = {}


def compile_sched_steps(cfg: ModelConfig, *, max_seq: int,
                        kernel_backend=None, act_bits=None,
                        page_size: int = 0, mesh=None,
                        spec=None) -> SchedSteps:
    """The scheduler's step set for a serving configuration, built once and
    memoized per (cfg, width, backend, act_bits, page_size, placement).
    PyTorch runs eagerly, so nothing is compiled; the name is the
    reference's.  ``page_size > 0`` builds the paged-store step set
    (page-table-aware steps plus the paged admission install step).
    ``spec`` (a placed ``launch.sharding.ServeSpec``) builds the
    tensor-parallel steps of ``make_serve_steps``, ``mesh`` its
    GSPMD-placed steps (dense store only); their model allocates the
    rank's local cache."""
    check_serve_mesh(mesh, spec)
    placement = spec.key if spec is not None else mesh
    key = (cfg, max_seq, kernel_backend, act_bits, page_size, placement)
    if key not in _SCHED_STEP_CACHE:
        model, pstep, dstep = make_sched_steps(
            cfg, max_seq=max_seq, act_bits=act_bits,
            kernel_backend=kernel_backend, page_size=page_size, mesh=mesh,
            spec=spec)
        install = (make_paged_install_step(model, page_size=page_size)
                   if page_size else None)
        _SCHED_STEP_CACHE[key] = SchedSteps(
            model=model, prefill=pstep, decode=dstep, install=install,
            page_size=page_size, placement=placement)
    return _SCHED_STEP_CACHE[key]


# what debug.sanitize.assert_no_recompiles probes
compile_sched_steps._cache_size = lambda: len(_SCHED_STEP_CACHE)


def serve_scheduled(cfg: ModelConfig, params, requests: List[Request], *,
                    slots: int, max_seq: Optional[int] = None,
                    kernel_backend=None, act_bits=None,
                    collect_logits: bool = False,
                    compiled: Optional[SchedSteps] = None,
                    store: str = "dense", page_size: int = 16,
                    num_pages: Optional[int] = None,
                    prefill_chunk: int = 0, share_prefix: bool = False,
                    device="cuda", mesh=None) -> ServeResult:
    """Serve ``requests`` through the slot scheduler.

    Returns a :class:`ServeResult`; per-request records are keyed by rid
    (``tokens`` is exactly ``max_new_tokens`` long: the prefill token plus
    its decode steps; ``shared_tokens`` is the prompt prefix served by
    shared pages).  ``decode_tok_s`` counts USEFUL tokens only — every
    request's own budget, which is also the number actually generated; the
    lock-step baseline reports the same numerator.  ``params`` must already
    live on ``device``; ``act_bits`` fake-quantizes activations per token.

    ``store="paged"``: token-leaf KV lives in a pool of ``num_pages`` pages
    of ``page_size`` tokens (default pool: capacity parity with the dense
    store); admission waits in queue when the pool is tight instead of
    failing.  ``prefill_chunk > 0``: prompts of chunkable families prefill
    in chunks of that many tokens, one chunk interleaved per decode
    iteration.  ``share_prefix=True`` (paged + chunked only): full
    prompt-prefix pages are shared copy-on-write across requests.

    ``params`` may be a placed ``launch.sharding.ServeSpec``: the loop then
    serves as one tensor-parallel rank, on the spec's local tree, and the
    stores allocate the rank's local cache (its KV heads).  Every rank runs
    this same host loop: admissions, pages and tokens agree because the
    logits after each all-reduce are the same bytes on every rank.  With a
    ``mesh`` the loop serves as one rank of the reference's GSPMD
    placement (``serve_requests`` says how), on the dense store; every
    rank runs it too, on the global logits its steps return."""
    if slots < 1:
        raise ValueError(f"need at least one slot, got {slots}")
    if store not in ("dense", "paged"):
        raise ValueError(f"unknown store {store!r} (dense|paged)")
    check_serve_mesh(mesh, params)
    if mesh is not None and store != "dense":
        raise ValueError("serve_scheduled(mesh=...): the GSPMD-placed steps "
                         "run on the dense store")
    params = place_on_mesh(mesh, cfg, params)     # what the steps take
    tree, tp = unplace(params)
    if tp is not None:
        params = tree
    if mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    if _params_device(tree).type != dev.type:
        raise ValueError(f"serve_scheduled: params live on "
                         f"{_params_device(tree)}, device is {dev}")
    paged = store == "paged"
    order = sorted(requests, key=lambda r: (r.arrival, r.rid))
    if max_seq is None:
        max_seq = max(_prefill_len(cfg, r) + r.max_new_tokens
                      for r in order)
        if paged:                       # page-align the derived width
            max_seq += (-max_seq) % page_size
    for r in order:
        if r.max_new_tokens < 1:
            raise ValueError(f"request {r.rid}: max_new_tokens must be >= 1")
        if _prefill_len(cfg, r) + r.max_new_tokens > max_seq:
            raise ValueError(
                f"request {r.rid}: prefill length ({_prefill_len(cfg, r)}) "
                f"+ budget ({r.max_new_tokens}) exceeds max_seq ({max_seq})")
    steps_ = compiled if compiled is not None else compile_sched_steps(
        cfg, max_seq=max_seq, kernel_backend=kernel_backend,
        act_bits=act_bits, page_size=page_size if paged else 0, mesh=mesh,
        spec=tp)
    if steps_.page_size != (page_size if paged else 0):
        raise ValueError(
            f"step set was built for page_size={steps_.page_size}, run "
            f"wants {'page_size=%d' % page_size if paged else 'dense'}")
    if steps_.placement != (tp.key if tp is not None else mesh):
        raise ValueError("step set was built for another placement than "
                         "the run's (compile_sched_steps(spec=...) with the "
                         "ServeSpec served, or mesh=... with the mesh)")
    model = steps_.model
    spec = model.cache_spec

    if paged:
        if num_pages is None:
            num_pages = slots * (max_seq // page_size)   # dense capacity
        cstore = PagedCacheStore(model, slots=slots, max_seq=max_seq,
                                 page_size=page_size, num_pages=num_pages,
                                 device=dev)
        for r in order:     # requests the pool can NEVER hold fail fast
            need = cstore.pages_needed(_prefill_len(cfg, r)
                                       + r.max_new_tokens)
            if need > num_pages:
                raise ValueError(
                    f"request {r.rid} needs {need} pages but the pool only "
                    f"has {num_pages} — it can never be admitted; raise "
                    f"num_pages or lower the request's length")
    else:
        cstore = DenseCacheStore(model, slots=slots, max_seq=max_seq,
                                 device=dev)
    cache = cstore.cache
    cdtype = cstore.dtype
    if mesh is None:
        put_slot = write_slot
    else:
        def put_slot(cache, c1, s):
            return mesh_write_slot(mesh, cache, c1, s, slots)
    ptab_d = _push(cstore.ptab_h, dev) if paged else None
    # chunked prefill applies to chunkable families only; prefix sharing
    # additionally needs the paged store (pages are the sharing unit)
    chunk_ok = prefill_chunk > 0 and spec.chunkable
    share_ok = share_prefix and paged and chunk_ok and spec.shareable

    tok = torch.zeros((slots,), dtype=torch.int32, device=dev)
    pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
    active_h = np.zeros((slots,), bool)        # host mirror of occupancy
    active_d = _push(active_h, dev)
    slot_rid = np.full((slots,), -1, np.int64)
    remaining = np.zeros((slots,), np.int64)   # decode steps left per slot
    res = {r.rid: {"arrival": r.arrival, "admit_step": None,
                   "finish_step": None, "shared_tokens": 0, "tokens": [],
                   "logits": []}
           for r in order}
    pending = deque(order)
    inflight = None       # at most one chunked prefill in flight
    trace = []            # (active snapshot, slot->rid snapshot, tok)
    t = 0                 # scheduler clock, in decode steps dispatched
    steps = 0
    occupancy_acc = 0
    prefill_secs = 0.0
    prompt_tokens = sum(_prefill_len(cfg, r) for r in order)

    def prompt_tensor(req, lo=0, hi=None):
        return _push(req.prompt[None, lo:hi].astype(np.int64), dev)

    def finish_prefill(s, req, lg1):
        """Common post-prefill bookkeeping (whole or final chunk); returns
        whether the slot goes live."""
        nonlocal tok, pos
        with allowed_transfer():
            # reprolint: ok[host-sync] — the one per-admission sync: the first generated token
            tok0 = int(torch.argmax(lg1[0], -1).item())
        tok = _set_slot(tok, s, tok0)
        pos = _set_slot(pos, s, _prefill_len(cfg, req))
        r = res[req.rid]
        r["admit_step"] = t
        r["tokens"].append(tok0)
        if collect_logits:
            with allowed_transfer():
                # reprolint: ok[host-sync] — admission-time logits fetch; rides the per-admission sync above
                r["logits"].append(lg1[0].float().cpu().numpy())
        if share_ok:
            cstore.register_prefix(s, req.prompt)
        if req.max_new_tokens == 1:
            r["finish_step"] = t                 # done at prefill
            cstore.release(s)
            return False
        slot_rid[s] = req.rid
        remaining[s] = req.max_new_tokens - 1
        active_h[s] = True
        return True

    with torch.no_grad():
        _sync(dev)   # reprolint: ok[host-sync] — opens the timed region
        t_start = time.perf_counter()
        while pending or active_h.any() or inflight is not None:
            # ---- admission: queued requests into free slots ---------------
            dirty = ptab_dirty = False
            while pending and pending[0].arrival <= t:
                busy = active_h.copy()
                if inflight is not None:
                    if chunk_ok:
                        break        # one in-flight chunked prefill at a time
                    busy[inflight["slot"]] = True
                free = np.flatnonzero(~busy)
                if len(free) == 0:
                    break
                req = pending[0]
                s = int(free[0])
                total = _prefill_len(cfg, req) + req.max_new_tokens
                plan = cstore.try_admit(s, total, prompt=req.prompt,
                                        share=share_ok)
                if plan is None:
                    break            # pool exhausted: FCFS head waits
                pending.popleft()
                ptab_dirty |= paged
                res[req.rid]["shared_tokens"] = plan.shared_tokens
                if chunk_ok:
                    # slot + pages reserved; the prompt prefills one chunk
                    # per loop iteration, interleaved with decode below
                    inflight = {"req": req, "slot": s,
                                "cursor": plan.shared_tokens,
                                "c1": (None if paged else model.init_cache(
                                    1, max_seq, cdtype, dev))}
                    continue
                # ---- whole prefill at full cache width --------------------
                tp0 = time.perf_counter()
                batch = {"tokens": prompt_tensor(req)}
                for k, v in (req.extras or {}).items():
                    batch[k] = _push(v[None], dev)
                c1 = model.init_cache(1, max_seq, cdtype, dev)
                lg1, c1 = steps_.prefill(params, batch, c1)
                if paged:
                    cache = steps_.install(cache, c1, s,
                                           _push(cstore.ptab_h[s], dev),
                                           plen=_prefill_len(cfg, req))
                else:
                    cache = put_slot(cache, c1, s)
                # finish_prefill's first-token read waits for the prefill
                # and the install: it closes the admission window
                dirty |= finish_prefill(s, req, lg1)
                ptab_dirty |= paged      # budget-1 admissions release pages
                prefill_secs += time.perf_counter() - tp0
            # ---- one prefill chunk for the in-flight request --------------
            if inflight is not None:
                tp0 = time.perf_counter()
                req, s = inflight["req"], inflight["slot"]
                cur = inflight["cursor"]
                plen = len(req.prompt)   # chunkable families: text only
                end = min(cur + prefill_chunk, plen)
                chunk = {"tokens": prompt_tensor(req, cur, end)}
                if paged:
                    lg1, cache = steps_.prefill(
                        params, chunk, cache, cur,
                        _push(cstore.ptab_h[s:s + 1], dev))
                else:
                    lg1, inflight["c1"] = steps_.prefill(
                        params, chunk, inflight["c1"], cur)
                inflight["cursor"] = end
                if end == plen:
                    if not paged:
                        cache = put_slot(cache, inflight["c1"], s)
                    dirty |= finish_prefill(s, req, lg1)
                    ptab_dirty |= paged
                    inflight = None
                _sync(dev)   # reprolint: ok[host-sync] — prefill-window timing boundary, once per chunk (a no-op after the last chunk's first-token read)
                prefill_secs += time.perf_counter() - tp0
            if not active_h.any():
                if not pending and inflight is None:
                    break
                if inflight is None:
                    if pending[0].arrival <= t:
                        # nothing active or in flight -> every page is free,
                        # and per-request pool fit was pre-validated; an
                        # admission failure here is an allocator invariant
                        # break
                        raise RuntimeError(
                            f"scheduler stalled: request {pending[0].rid} "
                            f"not admissible with an idle pool (stats: "
                            f"{cstore.stats()})")
                    t = pending[0].arrival       # idle: jump to next arrival
                else:
                    t += 1                       # chunk-only iteration
                continue
            if dirty:
                active_d = _push(active_h, dev)
            if ptab_dirty:
                ptab_d = _push(cstore.ptab_h, dev)
            # ---- one masked decode step over every slot -------------------
            logits, tok, pos, cache = steps_.decode(params, cache, tok, pos,
                                                    active_d, ptab_d)
            if collect_logits:
                with allowed_transfer():
                    # reprolint: ok[host-sync] — per-step fetch only when collect_logits=True; an untimed parity/debug path
                    lg_np = logits.float().cpu().numpy()
                for s in np.flatnonzero(active_h):
                    res[slot_rid[s]]["logits"].append(lg_np[s])
            del logits
            trace.append((active_h.copy(), slot_rid.copy(), tok))
            steps += 1
            occupancy_acc += int(active_h.sum())
            t += 1
            # ---- budget completions (host-known, zero sync) ---------------
            done = active_h & (remaining == 1)
            remaining[active_h] -= 1
            if done.any():
                for s in np.flatnonzero(done):
                    res[slot_rid[s]]["finish_step"] = t
                    slot_rid[s] = -1
                    cstore.release(int(s))
                active_h[done] = False
                active_d = _push(active_h, dev)
                if paged:
                    ptab_d = _push(cstore.ptab_h, dev)
        _sync(dev)   # reprolint: ok[host-sync] — closes the timed region
        total_secs = time.perf_counter() - t_start
    decode_secs = max(total_secs - prefill_secs, 1e-9)

    # ---- reconstruct per-request streams (host transfers OFF the clock) ---
    if trace:
        with allowed_transfer():
            # reprolint: ok[host-sync] — off-clock fetch of every step's tokens at once; timed region already closed
            tok_np = torch.stack([tk for _, _, tk in trace]).cpu().numpy()
        for (mask, rids, _), row in zip(trace, tok_np, strict=True):
            for s in np.flatnonzero(mask):
                res[rids[s]]["tokens"].append(int(row[s]))

    useful = 0
    latencies = []
    for r in order:
        rr = res[r.rid]
        # reprolint: ok[host-sync] — host python list → array; no device values involved
        rr["tokens"] = np.asarray(rr["tokens"], np.int32)
        assert rr["tokens"].shape == (r.max_new_tokens,)
        rr["logits"] = (np.stack(rr["logits"], 0)
                        if rr["logits"] else None)
        rr["latency_steps"] = rr["finish_step"] - rr["arrival"]
        latencies.append(rr["latency_steps"])
        useful += r.max_new_tokens
    decode_tokens = useful - len(order)          # first tokens come from prefill
    return ServeResult(
        mode="scheduled", store=cstore.kind, requests=res,
        slots=slots, max_seq=max_seq, steps=steps,
        useful_tokens=useful, decode_tokens=decode_tokens,
        prefill_secs=prefill_secs, decode_secs=decode_secs,
        prefill_tok_s=prompt_tokens / max(prefill_secs, 1e-9),
        decode_tok_s=decode_tokens / decode_secs,
        occupancy=(occupancy_acc / (steps * slots)) if steps else 0.0,
        latency_steps=_latency_stats(latencies),
        cache_stats=cstore.stats(),
        extra={"prefill_chunk": prefill_chunk if chunk_ok else 0,
               "share_prefix": share_ok},
    )


def serve_lockstep(cfg: ModelConfig, model, params, requests: List[Request],
                   *, slots: int, kernel_backend=None, act_bits=None,
                   compiled=None, pad_id: int = 0,
                   device="cuda") -> ServeResult:
    """The pre-scheduler serve loop as a baseline.

    FCFS static batching: requests are grouped ``slots`` at a time in
    arrival order; each batch pads every prompt to the batch max length and
    decodes in lock-step for the batch max budget — short requests pay for
    the batch's longest member, and padded rows decode garbage (this
    baseline exists to be measured against; its outputs are not
    parity-gated).  Arrival gaps are ignored, which only flatters the
    baseline."""
    order = sorted(requests, key=lambda r: (r.arrival, r.rid))
    if compiled is None:
        compiled = compile_serve_steps(cfg, kernel_backend=kernel_backend,
                                       act_bits=act_bits)
    prefill_secs = decode_secs = 0.0
    raw_decode_tokens = 0
    prompt_tokens = 0
    max_width = 0
    steps = 0
    for i in range(0, len(order), slots):
        group = order[i:i + slots]
        plen = max(len(r.prompt) for r in group)
        gen = max(r.max_new_tokens for r in group)
        prompts = np.full((len(group), plen), pad_id, np.int32)
        for j, r in enumerate(group):
            prompts[j, :len(r.prompt)] = r.prompt
        st = serve_requests(cfg, model, params, prompts, gen=gen,
                            compiled=compiled, collect_logits=False,
                            device=device)
        prefill_secs += st.prefill_secs
        decode_secs += st.decode_secs
        raw_decode_tokens += len(group) * (gen - 1)
        prompt_tokens += len(group) * plen
        max_width = max(max_width, plen + gen)
        steps += gen - 1
    useful = sum(r.max_new_tokens for r in order)
    decode_tokens = useful - len(order)
    decode_secs = max(decode_secs, 1e-9)
    # every request's latency is its group's padded span (batch max budget),
    # measured like the scheduler: decode steps from arrival-batch start
    lats = []
    for i in range(0, len(order), slots):
        group = order[i:i + slots]
        lats += [max(r.max_new_tokens for r in group)] * len(group)
    return ServeResult(
        mode="lockstep", store="dense", requests={},
        slots=slots, max_seq=max_width, steps=steps,
        useful_tokens=useful, decode_tokens=decode_tokens,
        prefill_secs=prefill_secs, decode_secs=decode_secs,
        prefill_tok_s=prompt_tokens / max(prefill_secs, 1e-9),
        # useful-token goodput: same numerator the scheduler reports
        decode_tok_s=decode_tokens / decode_secs,
        occupancy=(decode_tokens / raw_decode_tokens
                   if raw_decode_tokens else 0.0),
        latency_steps=_latency_stats(lats),
        cache_stats={"store": "dense"},
        extra={"raw_decode_tokens": raw_decode_tokens,
               "wasted_decode_tokens": raw_decode_tokens - decode_tokens},
    )
