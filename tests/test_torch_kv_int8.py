"""The port's int8 KV cache (``Ctx.kv_bits = 8``, static ``kv_scale``)
against the JAX reference, all on the CPU, in f32 models.

* The reference's ``test_int8_kv_cache_decode_accuracy`` on the port's own
  params: a decode step over an int8 cache within a relative error of 0.05
  of the full forward (the reference's bound).
* From the reference's params, bridged: the int8 cache leaves after
  prefill and after a decode step equal to the reference's, integer for
  integer, and the decode logits through ``parity_gate`` (and atol 1e-4:
  the dequantized cache is exact, so only summation order is left), under
  the port's ``"xla"`` and ``"pallas"`` (plain versions) backends.
* The scheduler on int8 stores: dense and paged tokens and logits equal
  (bit for bit), both equal to the reference's scheduler on int8 stores
  (tokens equal, logits atol 1e-4), and equal to the same steps over bf16
  stores (the reference's scheduler allocates its admission cache in the
  default dtype; a bf16 store holds the same integers exactly).
* Under ``"pallas"``, paged int8 decode takes the gather and the dense
  decode-attention wrapper, not the paged one (the paged kernel reads bf16
  pages only).
* An int8 pool allocates, installs and drops writes as a bf16 pool does;
  int8 cache bytes are half of bf16's.
* Reduced Qwen3 (the MoE family shares the attention) served lock-step
  with an int8 cache against the reference: tokens equal, logits atol
  1e-4.
* ``make_ctx(kv_bits=4)`` raises the reference's ``ValueError``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.eval.harness import parity_gate as jparity_gate  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.serve import serve_requests as jserve  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.eval.harness import parity_gate  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.scheduler import (SchedSteps,  # noqa: E402
                                          make_workload, serve_scheduled)
from repro_torch.launch.serve import serve_requests  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

CPU = dict(device="cpu")
MAX_SEQ, PSZ = 24, 4
WL = dict(n_requests=4, seed=3, prompt_lens=(6, 9), budgets=(2, 6),
          mean_gap=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cache_dtype(model, dtype):
    """``model`` with its caches allocated in ``dtype`` whatever the caller
    asks for (either package)."""
    init = model.init_cache
    return dataclasses.replace(
        model, init_cache=lambda b, s, _=None, *a, **kw: init(b, s, dtype,
                                                             *a, **kw))


_REF = {}


def _reference_params(arch):
    if arch not in _REF:
        cfg = jget_reduced(arch).replace(dtype="float32")
        p = jget_model(cfg).init_params(jax.random.PRNGKey(0))
        _REF[arch] = jax.tree_util.tree_map(np.asarray, p)
    return _REF[arch]


# --------------------------------------------------------------------------
# the decode step over an int8 cache
# --------------------------------------------------------------------------

def test_int8_kv_cache_decode_accuracy():
    """The reference's own test, on the port."""
    cfg = get_reduced_config("tinyllama-1.1b").replace(dtype="float32")
    m = get_model(cfg)
    p = m.init_params(0, "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        full = ttransformer.forward(p, cfg, toks)
        ctx8 = tcommon.make_ctx(kv_bits=8, kv_scale=0.05)
        cache = m.init_cache(2, 24, dtype=torch.int8, device="cpu")
        _, cache = ttransformer.prefill(p, cfg, toks[:, :-1], cache, ctx8)
        lg, _ = ttransformer.decode_step(
            p, cfg, cache, toks[:, -1], torch.full((2,), 15,
                                                   dtype=torch.int32), ctx8)
    rel = float((lg - full[:, -1]).abs().max() / full[:, -1].abs().max())
    assert rel < 0.05
    assert cache["k"].dtype == torch.int8 and cache["v"].dtype == torch.int8


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_int8_cache_and_logits_match_reference(backend):
    arch = "tinyllama-1.1b"
    jp = _reference_params(arch)
    jcfg = jget_reduced(arch).replace(dtype="float32")
    cfg = get_reduced_config(arch).replace(dtype="float32")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12))
    pos = np.full((2,), 11, np.int32)

    jctx = jcommon.Ctx(kv_bits=8, kv_scale=0.05)
    jcache = jget_model(jcfg).init_cache(2, 16, dtype=jnp.int8)
    _, jcache = jtransformer.prefill(jp, jcfg, jnp.asarray(toks[:, :-1]),
                                     jcache, jctx)
    jpre = jax.tree_util.tree_map(np.asarray, jcache)
    jlg, jcache = jtransformer.decode_step(jp, jcfg, jcache,
                                           jnp.asarray(toks[:, -1]),
                                           jnp.asarray(pos), jctx)

    p = params_to_torch(jp, "cpu")
    ctx = tcommon.make_ctx(kv_bits=8, kernel_backend=backend)
    cache = get_model(cfg).init_cache(2, 16, dtype=torch.int8, device="cpu")
    with torch.no_grad():
        _, cache = ttransformer.prefill(p, cfg, torch.from_numpy(toks[:, :-1]),
                                        cache, ctx)
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(cache[leaf].numpy(), jpre[leaf])
        lg, cache = ttransformer.decode_step(
            p, cfg, cache, torch.from_numpy(toks[:, -1]),
            torch.from_numpy(pos), ctx)
    for leaf in ("k", "v"):
        assert cache[leaf].dtype == torch.int8
        np.testing.assert_array_equal(cache[leaf].numpy(),
                                      np.asarray(jcache[leaf]))
    got, want = lg.numpy()[:, None], np.asarray(jlg)[:, None]
    gate = parity_gate(got, want, atol=5e-2, rtol=2e-2)
    assert gate == jparity_gate(got, want, atol=5e-2, rtol=2e-2)
    assert gate["ok"], gate
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_make_ctx_refuses_kv_bits_4_as_the_reference():
    with pytest.raises(ValueError) as got:
        tcommon.make_ctx(kv_bits=4)
    with pytest.raises(ValueError) as want:
        jcommon.make_ctx(jget_reduced("llama2-7b"), kv_bits=4)
    assert str(got.value) == str(want.value)
    assert tcommon.make_ctx(kv_bits=8).kv_scale == 0.05
    assert tcommon.make_ctx().kv_bits is None


# --------------------------------------------------------------------------
# the stores and the scheduler
# --------------------------------------------------------------------------

def _port_steps(cfg, store, dtype, backend="xla"):
    """The scheduler's step set with ``kv_bits=8``, over stores of
    ``dtype`` (the scheduler's own ``compile_sched_steps`` builds no int8
    steps, as the reference's does not)."""
    psz = PSZ if store == "paged" else 0
    model, pstep, dstep = tsteps.make_sched_steps(
        cfg, max_seq=MAX_SEQ, kv_bits=8, kernel_backend=backend,
        page_size=psz)
    install = (tsteps.make_paged_install_step(model, page_size=psz)
               if psz else None)
    return SchedSteps(model=_cache_dtype(model, dtype), prefill=pstep,
                      decode=dstep, install=install, page_size=psz)


def _reference_steps(cfg, store):
    psz = PSZ if store == "paged" else 0
    model, pstep, dstep = jsteps.make_sched_steps(
        cfg, max_seq=MAX_SEQ, kv_bits=8, kernel_backend="xla", page_size=psz)
    install = (jax.jit(jsteps.make_paged_install_step(model, page_size=psz),
                       static_argnames=("plen",)) if psz else None)
    return jsched.SchedSteps(model=_cache_dtype(model, jnp.int8),
                             prefill=jax.jit(pstep), decode=jax.jit(dstep),
                             write_slot=jax.jit(jcommon.write_slot),
                             install=install, page_size=psz)


_SCHED = {}


def _scheduled(store, dtype, backend="xla"):
    key = (store, str(dtype), backend)
    if key not in _SCHED:
        cfg = get_reduced_config("tinyllama-1.1b").replace(dtype="float32")
        p = params_to_torch(_reference_params("tinyllama-1.1b"), "cpu")
        reqs = make_workload(cfg.vocab_size, **WL)
        _SCHED[key] = serve_scheduled(
            cfg, p, reqs, slots=2, max_seq=MAX_SEQ, kernel_backend=backend,
            store=store, page_size=PSZ, collect_logits=True,
            compiled=_port_steps(cfg, store, dtype, backend), **CPU)
    return _SCHED[key]


def _same_run(a, b, atol=0.0):
    assert a.steps == b.steps
    for rid in a.requests:
        np.testing.assert_array_equal(a.requests[rid]["tokens"],
                                      b.requests[rid]["tokens"])
        np.testing.assert_allclose(np.stack(a.requests[rid]["logits"]),
                                   np.stack(b.requests[rid]["logits"]),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_scheduled_int8_dense_equals_paged(backend):
    dense = _scheduled("dense", torch.int8, backend)
    paged = _scheduled("paged", torch.int8, backend)
    _same_run(dense, paged)
    assert dense.cache_stats["store"] == "dense"
    assert paged.cache_stats["store"] == "paged"


@pytest.mark.parametrize("store", ["dense", "paged"])
def test_scheduled_int8_matches_reference(store):
    cfg = jget_reduced("tinyllama-1.1b").replace(dtype="float32")
    reqs = jsched.make_workload(cfg.vocab_size, **WL)
    want = jsched.serve_scheduled(
        cfg, _reference_params("tinyllama-1.1b"), reqs, slots=2,
        max_seq=MAX_SEQ, kernel_backend="xla", store=store, page_size=PSZ,
        collect_logits=True, compiled=_reference_steps(cfg, store))
    got = _scheduled(store, torch.int8)
    _same_run(got, want, atol=1e-4)
    for key in ("useful_tokens", "decode_tokens", "occupancy",
                "latency_steps"):
        assert got[key] == want[key], key
    # the same steps over a bf16 store (the reference's default-dtype
    # admission cache) hold the same integers: the same run exactly
    _same_run(got, _scheduled(store, torch.bfloat16))


@pytest.mark.parametrize("kv_bits", [8, None])
def test_paged_int8_decode_takes_the_dense_kernel(monkeypatch, kv_bits):
    """Paged decode over an int8 pool calls the dense decode-attention
    wrapper once a layer and step; over an f32 pool, the paged one."""
    calls = {"dense": 0, "paged": 0}
    dense, paged = tdecode.decode_attention, tdecode.paged_decode_attention

    def count(kind, fn):
        def run(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(tdecode, "decode_attention", count("dense", dense))
    monkeypatch.setattr(tdecode, "paged_decode_attention",
                        count("paged", paged))
    cfg = get_reduced_config("tinyllama-1.1b").replace(dtype="float32")
    p = params_to_torch(_reference_params("tinyllama-1.1b"), "cpu")
    reqs = make_workload(cfg.vocab_size, **WL)
    model, pstep, dstep = tsteps.make_sched_steps(
        cfg, max_seq=MAX_SEQ, kv_bits=kv_bits, kernel_backend="pallas",
        page_size=PSZ)
    steps = SchedSteps(
        model=_cache_dtype(model, torch.int8 if kv_bits else torch.float32),
        prefill=pstep, decode=dstep,
        install=tsteps.make_paged_install_step(model, page_size=PSZ),
        page_size=PSZ)
    res = serve_scheduled(cfg, p, reqs, slots=2, max_seq=MAX_SEQ,
                          kernel_backend="pallas", store="paged",
                          page_size=PSZ, compiled=steps, **CPU)
    layers = cfg.num_layers * res.steps
    want = ({"dense": layers, "paged": 0} if kv_bits
            else {"dense": 0, "paged": layers})
    assert calls == want


def test_int8_pool_allocates_installs_and_drops_as_bf16():
    cfg = get_reduced_config("tinyllama-1.1b")
    m = get_model(cfg)
    install = tsteps.make_paged_install_step(m, page_size=PSZ)
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    runs = {}
    for dt in (torch.int8, torch.bfloat16):
        rng = np.random.default_rng(2)
        st = tcommon.PagedCacheStore(m, slots=2, max_seq=16, page_size=PSZ,
                                     num_pages=6, dtype=dt, device="cpu")
        dense = tcommon.DenseCacheStore(m, slots=2, max_seq=16, dtype=dt,
                                        device="cpu")
        assert {t.dtype for t in st.cache.values()} == {dt}
        assert {t.dtype for t in dense.cache.values()} == {dt}
        plan = st.try_admit(1, 7)
        c1 = m.init_cache(1, 16, dt, "cpu")
        for leaf in ("k", "v"):
            c1[leaf].copy_(torch.from_numpy(
                rng.integers(-128, 128, c1[leaf].shape)).to(dt))
        cache = install(st.cache, c1, 1, torch.from_numpy(st.ptab_h[1]),
                        plen=7)
        # frozen slots write at max_seq, past the table: the spare page
        kv = torch.from_numpy(rng.integers(-128, 128, (2, 1) + tail)).to(dt)
        for i in range(cfg.num_layers):
            tcommon.page_update_cache(
                cache["k"][i], cache["v"][i], kv, kv,
                torch.tensor([16, 16], dtype=torch.int32),
                torch.from_numpy(st.ptab_h), PSZ)
        runs[dt] = dict(pools={k: v.float() for k, v in cache.items()},
                        plan=plan, paged=st.cache_bytes(),
                        dense=dense.cache_bytes(), table=st.ptab_h.nbytes)
    a, b = runs[torch.int8], runs[torch.bfloat16]
    assert a["plan"] == b["plan"]
    for leaf in ("k", "v"):
        assert torch.equal(a["pools"][leaf], b["pools"][leaf])
        assert a["pools"][leaf][:, :-1].abs().sum() > 0   # the install
        assert a["pools"][leaf][:, -1].abs().sum() > 0    # the spare
    assert 2 * a["dense"] == b["dense"]
    assert 2 * (a["paged"] - a["table"]) == b["paged"] - b["table"]


# --------------------------------------------------------------------------
# the MoE family
# --------------------------------------------------------------------------

_MOE = {}


def _moe_reference():
    """The reference's reduced Qwen3 (f32) served lock-step with an int8
    cache, memoized."""
    if not _MOE:
        arch = "qwen3-moe-30b-a3b"
        jcfg = jget_reduced(arch).replace(dtype="float32")
        jp = _reference_params(arch)
        prompts = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                                    (2, 8))
        _, jpstep, jdstep = jsteps.make_serve_steps(jcfg, kv_bits=8,
                                                    kernel_backend="xla")
        _MOE.update(params=jp, prompts=prompts, res=jserve(
            jcfg, _cache_dtype(jget_model(jcfg), jnp.int8), jp, prompts,
            gen=4, compiled=(jax.jit(jpstep), jax.jit(jdstep))))
    return _MOE


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_moe_int8_cache_serve_matches_reference(backend):
    ref = _moe_reference()
    cfg = get_reduced_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    model, pstep, dstep = tsteps.make_serve_steps(cfg, kv_bits=8,
                                                  kernel_backend=backend)
    got = serve_requests(cfg, _cache_dtype(model, torch.int8),
                         params_to_torch(ref["params"], "cpu"),
                         ref["prompts"], gen=4, compiled=(pstep, dstep),
                         **CPU)
    want = ref["res"]
    gate = parity_gate(got.logits, want.logits, atol=5e-2, rtol=2e-2)
    assert gate["ok"], gate
    np.testing.assert_allclose(got.logits, want.logits, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.tokens, want.tokens)
