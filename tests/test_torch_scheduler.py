"""The port's continuous-batching scheduler, its cache verbs and its dense
and paged stores, against the JAX reference and against the reference's own
contracts re-proved between two port runs.

Against the reference (same numpy inputs, reduced configs):
* cache verbs (``gather_pages``, ``page_write_tokens`` with dropped rows,
  ``write_slot``/``read_slot``, the dropping ``update_cache``): equal;
* ``PagedCacheStore``'s allocator over one sequence of admits, shares and
  releases: page tables and ``stats()`` equal, ``cache_bytes`` larger by
  exactly the spare page of each token leaf;
* ``make_workload``: equal plans;
* ``serve_scheduled`` in f32 on the dense and paged stores, the ``"xla"``
  backend with W4-packed weights and ``"pallas"`` (the kernels' plain
  versions) with FP params — the reference's ``"pallas"`` backend cannot
  run packed weights on the installed jax (ROADMAP fault 3.1): tokens and
  admission/finish steps equal, logits within atol 1e-4 (summation order
  only).  Both packages run these with an f32 KV cache (their models'
  ``init_cache`` wrapped to ignore the stores' bf16 default): in a bf16
  cache, a K/V value that the two packages' f32 matmuls place on either
  side of a bf16 rounding midpoint is stored one bf16 ulp apart, which
  moved decode logits by up to 7.5e-4 on reduced llama2 (one V element in
  2048 differed after a 9-token prefill).

Within the port, in the configs' bf16 (the reference's contracts from
``tests/test_scheduler.py`` and ``tests/test_paged_cache.py``): scheduled ==
alone, uniform == lock-step, dense == paged bit for bit (tokens and logits)
on both backends, chunked dense == chunked paged, chunked ~ whole prefill,
pool exhaustion, prefix sharing, budget-1 requests, validation and the
lock-step baseline's accounting.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import pack_model as jpack_model  # noqa: E402
from repro.core.rtn import rtn_leaf as jrtn_leaf  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core.pipeline import pack_model, quantize_model  # noqa: E402
from repro_torch.launch.scheduler import (Request,  # noqa: E402
                                          compile_sched_steps, make_workload,
                                          serve_lockstep, serve_scheduled)
from repro_torch.launch.serve import serve_requests  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

ARCHS = ["llama2-7b", "tinyllama-1.1b"]
QKW = dict(bits=4, group_size=32)
MAX_SEQ, PSZ = 16, 4
CPU = dict(device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# cache verbs against the reference
# --------------------------------------------------------------------------

def test_gather_pages_matches_reference():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((7, 4, 2, 3)).astype(np.float32)
    ptab = rng.integers(0, 7, (3, 5)).astype(np.int32)
    want = np.asarray(jcommon.gather_pages(jnp.asarray(pool),
                                           jnp.asarray(ptab)))
    got = tcommon.gather_pages(_t(pool), _t(ptab)).numpy()
    np.testing.assert_array_equal(got, want)


def test_page_write_tokens_matches_reference_with_dropped_rows():
    """Rows whose position lands past the table are dropped by the
    reference and land on the port's spare page; the real pages agree."""
    rng = np.random.default_rng(1)
    P, psz, W = 9, 4, 3
    pool = rng.standard_normal((P, psz, 2, 3)).astype(np.float32)
    ptab = np.array([[4, 1, 7], [0, 2, 3], [8, 6, 5]], np.int32)
    vals = rng.standard_normal((3, 5, 2, 3)).astype(np.float32)
    pos = np.array([2, W * psz, 9], np.int32)   # row 1 wholly, row 2 partly out
    want = np.asarray(jcommon.page_write_tokens(
        jnp.asarray(pool), jnp.asarray(vals), jnp.asarray(ptab),
        jnp.asarray(pos), psz))
    port_pool = _t(np.concatenate([pool, np.zeros_like(pool[:1])]))
    got = tcommon.page_write_tokens(port_pool, _t(vals), _t(ptab), _t(pos),
                                    psz)
    assert got is port_pool                     # in place
    np.testing.assert_array_equal(got[:P].numpy(), want)
    assert not np.array_equal(want, pool)       # something was written


def test_write_read_slot_match_reference():
    cfg = get_reduced_config("llama2-7b")
    jm, tm = jget_model(jget_reduced("llama2-7b")), get_model(cfg)
    rng = np.random.default_rng(2)
    base = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in jm.init_cache(3, 6, jnp.float32).items()}
    one = {k: rng.standard_normal(v.shape[:1] + (1,) + v.shape[2:])
           .astype(np.float32) for k, v in base.items()}
    want = jcommon.write_slot({k: jnp.asarray(v) for k, v in base.items()},
                              {k: jnp.asarray(v) for k, v in one.items()}, 1)
    cache = {k: _t(v) for k, v in base.items()}
    got = tcommon.write_slot(cache, {k: _t(v) for k, v in one.items()}, 1)
    assert got is cache
    tm.cache_spec.validate(got)
    for k in base:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(
            tcommon.read_slot(got, 1)[k].numpy(),
            np.asarray(jcommon.read_slot(want, 1)[k]))
    np.testing.assert_array_equal(tcommon.read_slot(got, 0)["k"].numpy(),
                                  base["k"][:, :1])


@pytest.mark.parametrize("S_new,pos", [(1, [3, 8, 0, 7]), (3, [0, 6, 8, 4])],
                         ids=["decode", "prefill"])
def test_update_cache_drops_rows_past_the_cache(S_new, pos):
    """Positions >= S are dropped exactly as the reference's scatter drops
    them (rows 1 and 2 reach past S = 8)."""
    rng = np.random.default_rng(3)
    ck = rng.standard_normal((4, 8, 2, 3)).astype(np.float32)
    cv = rng.standard_normal((4, 8, 2, 3)).astype(np.float32)
    k = rng.standard_normal((4, S_new, 2, 3)).astype(np.float32)
    v = rng.standard_normal((4, S_new, 2, 3)).astype(np.float32)
    pos = np.array(pos, np.int32)
    wk, wv = jcommon.update_cache(jnp.asarray(ck), jnp.asarray(cv),
                                  jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos))
    gk, gv = tcommon.update_cache(_t(ck), _t(cv), _t(k), _t(v), _t(pos))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# --------------------------------------------------------------------------
# the paged allocator against the reference
# --------------------------------------------------------------------------

def test_paged_store_allocator_matches_reference():
    """One sequence of admits (with prefix sharing), refusals and releases:
    page tables, plans and stats equal the reference's; ``cache_bytes``
    differs by exactly one page per token leaf (the spare)."""
    cfg = get_reduced_config("tinyllama-1.1b")
    tm, jm = get_model(cfg), jget_model(jget_reduced("tinyllama-1.1b"))
    kw = dict(slots=3, max_seq=32, page_size=8, num_pages=7)
    ts = tcommon.PagedCacheStore(tm, **kw)
    js = jcommon.PagedCacheStore(jm, **kw)
    a = np.arange(17, dtype=np.int32)
    b = np.concatenate([a[:16], [99, 98, 97]]).astype(np.int32)
    ops = [("try_admit", 0, 20, a, True), ("register_prefix", 0, a),
           ("try_admit", 1, 22, b, True), ("register_prefix", 1, b),
           ("try_admit", 2, 30, a, True),           # refused: pool short
           ("release", 0), ("try_admit", 2, 30, a, True),
           ("try_admit", 0, 9, None, False), ("release", 1), ("release", 2),
           ("try_admit", 1, 20, b, True), ("release", 0), ("release", 1)]

    def apply(st, op):
        if op[0] != "try_admit":
            return getattr(st, op[0])(*op[1:])
        plan = st.try_admit(op[1], op[2], prompt=op[3], share=op[4])
        return plan and (plan.slot, tuple(plan.pages), plan.shared_tokens)

    for op in ops:
        assert apply(ts, op) == apply(js, op), op
        np.testing.assert_array_equal(ts.ptab_h, js.ptab_h, err_msg=str(op))
        got, want = ts.stats(), js.stats()
        spare = sum(leaf.shape[0] * leaf.shape[2] * int(np.prod(
            leaf.shape[3:])) * leaf.element_size()
                    for leaf in ts.cache.values())
        assert got.pop("cache_bytes") - want.pop("cache_bytes") == spare
        assert got == want, op
    assert js.stats()["refused_admissions"] >= 1
    assert js.stats()["shared_page_hits"] >= 2
    for leaf in ts.cache.values():
        assert leaf.shape[1] == kw["num_pages"] + 1


def test_paged_store_refcounts_shared_pages():
    """A shared page is freed only when the LAST holder releases it, and the
    prefix map forgets it afterwards."""
    m = get_model(get_reduced_config("tinyllama-1.1b"))
    store = tcommon.PagedCacheStore(m, slots=2, max_seq=32, page_size=8,
                                    num_pages=6)
    prompt = np.arange(17, dtype=np.int32)
    p0 = store.try_admit(0, 20, prompt=prompt, share=True)
    assert p0 is not None and p0.shared_tokens == 0
    store.register_prefix(0, prompt)
    p1 = store.try_admit(1, 20, prompt=prompt.copy(), share=True)
    assert p1.shared_tokens == 16 and p1.pages[:2] == p0.pages[:2]
    store.release(0)
    assert store.stats()["pages_in_use"] == 3
    store.release(1)
    assert store.stats()["pages_in_use"] == 0
    assert store.try_admit(0, 20, prompt=prompt, share=True).shared_tokens == 0


@pytest.mark.parametrize("kw", [
    dict(n_requests=6, seed=3, prompt_lens=(4, 10), budgets=(2, 8)),
    dict(n_requests=16, seed=0, prompt_lens=(16, 384), budgets=(4, 48),
         mean_gap=2.0),
    dict(n_requests=9, seed=5, long_frac=0.3, long_prompt_lens=(40, 90),
         long_budgets=(10, 20))], ids=["small", "chip-smoke", "long-tail"])
def test_make_workload_matches_reference(kw):
    got = make_workload(32000, **kw)
    want = jsched.make_workload(32000, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert (g.rid, g.max_new_tokens, g.arrival) == \
            (w.rid, w.max_new_tokens, w.arrival)
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.prompt.dtype == np.int32


# --------------------------------------------------------------------------
# serve_scheduled against the reference (f32)
# --------------------------------------------------------------------------

_REF = {}


def _rtn_packed(cfg, params):
    """The reference's RTN codes for every block linear, packed."""
    qcfg = JQuantConfig(**QKW)
    qmeta = {}
    for name, w in params["blocks"].items():
        if name.startswith("ln"):
            continue
        for i in range(w.shape[0]):
            qmeta[("blocks", i, name)] = jrtn_leaf(w[i], qcfg)[1]
    return jpack_model(cfg, params, qmeta, qcfg)


def _f32_cache_steps(steps, dtype):
    """``steps`` with its model's caches allocated in ``dtype`` whatever the
    store asks for."""
    init = steps.model.init_cache
    model = dataclasses.replace(
        steps.model,
        init_cache=lambda b, s, _=None, *a: init(b, s, dtype, *a))
    return dataclasses.replace(steps, model=model)


def _reference_runs(arch):
    """JAX params (FP and W4-packed), the workload, and the reference's
    scheduled runs on both stores and both backends, memoized."""
    if arch not in _REF:
        cfg = jget_reduced(arch).replace(dtype="float32")
        params = jget_model(cfg).init_params(jax.random.PRNGKey(0))
        packed = _rtn_packed(cfg, params)
        reqs = jsched.make_workload(cfg.vocab_size, n_requests=4, seed=3,
                                    prompt_lens=(6, 9), budgets=(2, 6),
                                    mean_gap=1.0)
        runs = {}
        for store in ("dense", "paged"):
            for backend, p in (("xla", packed), ("pallas", params)):
                steps = _f32_cache_steps(jsched.compile_sched_steps(
                    cfg, max_seq=MAX_SEQ, kernel_backend=backend,
                    page_size=PSZ if store == "paged" else 0), jnp.float32)
                r = jsched.serve_scheduled(
                    cfg, p, reqs, slots=2, max_seq=MAX_SEQ,
                    kernel_backend=backend, store=store, page_size=PSZ,
                    collect_logits=True, compiled=steps)
                runs[(store, backend)] = r
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        _REF[arch] = dict(params=to_np(params), packed=to_np(packed),
                          reqs=reqs, runs=runs)
    return _REF[arch]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("store", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduled_f32_matches_reference(arch, store, backend):
    ref = _reference_runs(arch)
    cfg = get_reduced_config(arch).replace(dtype="float32")
    params = params_to_torch(ref["packed" if backend == "xla" else "params"])
    reqs = make_workload(cfg.vocab_size, n_requests=4, seed=3,
                         prompt_lens=(6, 9), budgets=(2, 6), mean_gap=1.0)
    steps = _f32_cache_steps(compile_sched_steps(
        cfg, max_seq=MAX_SEQ, kernel_backend=backend,
        page_size=PSZ if store == "paged" else 0), torch.float32)
    got = serve_scheduled(cfg, params, reqs, slots=2, max_seq=MAX_SEQ,
                          kernel_backend=backend, store=store, page_size=PSZ,
                          collect_logits=True, compiled=steps, **CPU)
    want = ref["runs"][(store, backend)]
    assert got.steps == want.steps and got.store == want.store
    for q in reqs:
        g, w = got.requests[q.rid], want.requests[q.rid]
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_allclose(g["logits"], w["logits"], atol=1e-4,
                                   rtol=0)
        assert (g["admit_step"], g["finish_step"]) == \
            (w["admit_step"], w["finish_step"])
    for key in ("useful_tokens", "decode_tokens", "occupancy",
                "latency_steps"):
        assert got[key] == want[key], key
    gs, ws = dict(got.cache_stats), dict(want.cache_stats)
    gs.pop("cache_bytes"), ws.pop("cache_bytes")
    assert gs == ws


# --------------------------------------------------------------------------
# the reference's contracts between two port runs (bf16)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    """Reduced tinyllama (GQA) in bf16: FP params and W4-packed params."""
    cfg = get_reduced_config("tinyllama-1.1b")
    m = get_model(cfg)
    params = m.init_params(0, "cpu")
    calib = [{"tokens": torch.randint(
        0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(0))}]
    qcfg = QuantConfig(**QKW)
    pfq, qmeta, _ = quantize_model(cfg, params, calib, qcfg, method="none",
                                   init="rtn")
    return cfg, m, params, pack_model(cfg, pfq, qmeta, qcfg)


def _tokens_equal(a, b, reqs):
    for q in reqs:
        np.testing.assert_array_equal(
            a.requests[q.rid]["tokens"], b.requests[q.rid]["tokens"],
            err_msg=f"rid {q.rid} diverged")


def _assert_alone_parity(cfg, m, params, reqs, sched, **kw):
    for q in reqs:
        alone = serve_requests(cfg, m, params, q.prompt[None],
                               gen=q.max_new_tokens, max_seq=sched.max_seq,
                               collect_logits=False, **kw, **CPU)
        np.testing.assert_array_equal(
            alone.tokens[0], sched.requests[q.rid]["tokens"],
            err_msg=f"rid {q.rid} diverged from serving alone")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_determinism_and_alone_parity(dense, backend):
    """More requests than slots, staggered arrivals: the same plan gives the
    same tokens and admissions, and every request equals serving it alone
    (packed W4 weights)."""
    cfg, m, _, packed = dense
    reqs = make_workload(cfg.vocab_size, n_requests=6, seed=3,
                         prompt_lens=(4, 10), budgets=(2, 8))
    assert len({len(r.prompt) for r in reqs}) > 1
    assert len({r.arrival for r in reqs}) > 1
    s1 = serve_scheduled(cfg, packed, reqs, slots=2, kernel_backend=backend,
                         **CPU)
    s2 = serve_scheduled(cfg, packed, reqs, slots=2, kernel_backend=backend,
                         **CPU)
    _tokens_equal(s1, s2, reqs)
    for q in reqs:
        assert s1.requests[q.rid]["admit_step"] == \
            s2.requests[q.rid]["admit_step"]
    _assert_alone_parity(cfg, m, packed, reqs, s1, kernel_backend=backend)
    assert max(s1.requests[q.rid]["admit_step"] - q.arrival
               for q in reqs) > 0                   # queueing happened
    assert s1.latency_steps["p99"] >= s1.latency_steps["p50"]


def test_finished_request_is_frozen(dense):
    """A short request beside a long one gets exactly its budget, and its
    stream does not move when the neighbour runs longer."""
    cfg, m, params, _ = dense
    rng = np.random.default_rng(0)
    short = Request(0, rng.integers(0, cfg.vocab_size, (6,)).astype(np.int32),
                    2)
    long_ = Request(1, rng.integers(0, cfg.vocab_size, (9,)).astype(np.int32),
                    9)
    s1 = serve_scheduled(cfg, params, [short, long_], slots=2, max_seq=24,
                         **CPU)
    assert s1.requests[0]["tokens"].shape == (2,)
    assert s1.requests[1]["tokens"].shape == (9,)
    _assert_alone_parity(cfg, m, params, [short, long_], s1)
    longer = dataclasses.replace(long_, max_new_tokens=14)
    s2 = serve_scheduled(cfg, params, [short, longer], slots=2, max_seq=24,
                         **CPU)
    np.testing.assert_array_equal(s1.requests[0]["tokens"],
                                  s2.requests[0]["tokens"])


def test_uniform_workload_matches_lockstep_loop(dense):
    cfg, m, params, _ = dense
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 8)).astype(np.int32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=4)
            for i in range(3)]
    sched = serve_scheduled(cfg, params, reqs, slots=3, **CPU)
    lock = serve_requests(cfg, m, params, prompts, gen=4,
                          max_seq=sched.max_seq, collect_logits=False, **CPU)
    for i in range(3):
        np.testing.assert_array_equal(lock.tokens[i],
                                      sched.requests[i]["tokens"])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_dense_vs_paged_tokens_and_logits_identity(dense, backend):
    """THE paging contract: per-request tokens AND logits bit-identical
    between the stores, at a page size that does not divide the prompts."""
    cfg, _, _, packed = dense
    reqs = make_workload(cfg.vocab_size, n_requests=5, seed=17,
                         prompt_lens=(4, 10), budgets=(3, 6), mean_gap=1.0)
    kw = dict(slots=2, max_seq=20, kernel_backend=backend,
              collect_logits=True, **CPU)
    a = serve_scheduled(cfg, packed, reqs, **kw)
    b = serve_scheduled(cfg, packed, reqs, store="paged", page_size=4, **kw)
    for q in reqs:
        np.testing.assert_array_equal(a.requests[q.rid]["logits"],
                                      b.requests[q.rid]["logits"])
    _tokens_equal(a, b, reqs)
    assert b.cache_stats["store"] == "paged"
    assert b.cache_stats["pages_in_use"] == 0


def test_chunked_dense_vs_chunked_paged_identity(dense):
    """Chunk boundaries on and off page boundaries: the same chunk schedule
    on both stores gives bit-identical logits."""
    cfg, _, params, _ = dense
    reqs = make_workload(cfg.vocab_size, n_requests=4, seed=11,
                         prompt_lens=(8, 16), budgets=(2, 5), mean_gap=1.0)
    for chunk in (4, 6):
        kw = dict(slots=2, max_seq=24, prefill_chunk=chunk,
                  collect_logits=True, **CPU)
        a = serve_scheduled(cfg, params, reqs, **kw)
        b = serve_scheduled(cfg, params, reqs, store="paged", page_size=4,
                            **kw)
        assert a.extra["prefill_chunk"] == chunk
        for q in reqs:
            np.testing.assert_array_equal(a.requests[q.rid]["logits"],
                                          b.requests[q.rid]["logits"])


def test_chunked_vs_whole_prefill_agree(dense):
    cfg, _, params, _ = dense
    reqs = make_workload(cfg.vocab_size, n_requests=4, seed=13,
                         prompt_lens=(5, 12), budgets=(2, 5), mean_gap=1.0)
    whole = serve_scheduled(cfg, params, reqs, slots=2, max_seq=32, **CPU)
    chunked = serve_scheduled(cfg, params, reqs, slots=2, max_seq=32,
                              prefill_chunk=4, **CPU)
    _tokens_equal(chunked, whole, reqs)


def test_pool_exhaustion_refused_then_recovered(dense):
    cfg, _, params, _ = dense
    rng = np.random.default_rng(7)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, (9,)).astype(np.int32),
                    6) for i in range(3)]
    # each request: 15 positions -> 2 pages of 8; a pool of 3 fits one
    paged = serve_scheduled(cfg, params, reqs, slots=3, max_seq=32,
                            store="paged", page_size=8, num_pages=3, **CPU)
    ref = serve_scheduled(cfg, params, reqs, slots=3, max_seq=32, **CPU)
    _tokens_equal(paged, ref, reqs)
    assert paged.cache_stats["refused_admissions"] >= 1
    assert paged.cache_stats["pages_in_use"] == 0
    assert paged.cache_stats["peak_pages_in_use"] <= 3


def test_pool_and_width_errors(dense):
    cfg, m, params, _ = dense
    req = Request(0, np.arange(9, dtype=np.int32), 8)    # 17 -> 3 pages
    with pytest.raises(ValueError, match="never be admitted"):
        serve_scheduled(cfg, params, [req], slots=1, max_seq=32,
                        store="paged", page_size=8, num_pages=2, **CPU)
    with pytest.raises(ValueError, match="multiple of page_size"):
        tcommon.PagedCacheStore(m, slots=1, max_seq=30, page_size=8,
                                num_pages=4)


def test_prefix_sharing_hits_and_diverges(dense):
    """Two prompts with a common 24-token prefix: the sharer reuses the
    full prefix pages, and both requests' outputs equal a run without
    sharing and a dense run — also after the prompts diverge."""
    cfg, _, params, _ = dense
    common = np.arange(100, 124, dtype=np.int32)
    reqs = [Request(0, common.copy(), 4),
            Request(1, np.concatenate([common, [7, 9]]).astype(np.int32), 4,
                    arrival=2)]
    kw = dict(slots=2, max_seq=32, prefill_chunk=8, **CPU)
    shared = serve_scheduled(cfg, params, reqs, store="paged", page_size=8,
                             share_prefix=True, **kw)
    plain = serve_scheduled(cfg, params, reqs, store="paged", page_size=8,
                            **kw)
    dense_run = serve_scheduled(cfg, params, reqs, **kw)
    _tokens_equal(shared, plain, reqs)
    _tokens_equal(shared, dense_run, reqs)
    assert shared.cache_stats["shared_page_hits"] == 3     # 24 = 3 x 8
    assert shared.requests[1]["shared_tokens"] == 24
    assert plain.cache_stats["shared_page_hits"] == 0
    assert shared.cache_stats["pages_in_use"] == 0
    assert shared.extra["share_prefix"] and not plain.extra["share_prefix"]


@pytest.mark.parametrize("store", ["dense", "paged"])
def test_budget_one_requests(dense, store):
    """Budget-1 requests finish at prefill and never occupy a slot."""
    cfg, m, params, _ = dense
    reqs = make_workload(cfg.vocab_size, n_requests=5, seed=21,
                         prompt_lens=(4, 8), budgets=(1, 3), mean_gap=1.0)
    assert min(r.max_new_tokens for r in reqs) == 1
    s = serve_scheduled(cfg, params, reqs, slots=2, store=store,
                        page_size=4, **CPU)
    for q in reqs:
        assert s.requests[q.rid]["tokens"].shape == (q.max_new_tokens,)
        if q.max_new_tokens == 1:
            rr = s.requests[q.rid]
            assert rr["finish_step"] == rr["admit_step"]
    _assert_alone_parity(cfg, m, params, reqs, s)
    if store == "paged":
        assert s.cache_stats["pages_in_use"] == 0


def test_scheduler_validates_inputs(dense):
    cfg, _, params, _ = dense
    r = Request(0, np.zeros((4,), np.int32), 4)
    with pytest.raises(ValueError, match="at least one slot"):
        serve_scheduled(cfg, params, [r], slots=0, **CPU)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        serve_scheduled(cfg, params, [r], slots=1, max_seq=6, **CPU)
    with pytest.raises(ValueError, match="max_new_tokens"):
        serve_scheduled(cfg, params, [Request(1, r.prompt, 0)], slots=1,
                        **CPU)
    with pytest.raises(ValueError, match="unknown store"):
        serve_scheduled(cfg, params, [r], slots=1, store="ring", **CPU)
    with pytest.raises(ValueError, match="page_size"):
        serve_scheduled(cfg, params, [r], slots=1, max_seq=8, store="paged",
                        page_size=4,
                        compiled=compile_sched_steps(cfg, max_seq=8), **CPU)
    with pytest.raises(ValueError, match="max_seq"):
        serve_requests(cfg, get_model(cfg), params, r.prompt[None], gen=4,
                       max_seq=6, **CPU)
    assert compile_sched_steps(cfg, max_seq=8) is \
        compile_sched_steps(cfg, max_seq=8)


def test_lockstep_baseline_accounting(dense):
    cfg, m, params, _ = dense
    reqs = make_workload(cfg.vocab_size, n_requests=4, seed=5,
                         prompt_lens=(4, 8), budgets=(2, 8))
    lock = serve_lockstep(cfg, m, params, reqs, slots=2, **CPU)
    sched = serve_scheduled(cfg, params, reqs, slots=2, **CPU)
    assert lock["useful_tokens"] == sched["useful_tokens"] \
        == sum(r.max_new_tokens for r in reqs)
    assert lock["decode_tokens"] == sched["decode_tokens"]
    assert lock["raw_decode_tokens"] >= lock["decode_tokens"]
    assert lock["wasted_decode_tokens"] == \
        lock["raw_decode_tokens"] - lock["decode_tokens"]
    assert lock.mode == "lockstep" and sched.mode == "scheduled"
