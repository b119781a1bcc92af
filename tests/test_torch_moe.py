"""The port's MoE family (qwen3-moe) against the JAX reference on the same
numpy inputs, all on the CPU (the kernels' plain versions).

Against the reference:
* ``quant_matmul_experts_plain`` (what the expert wrapper runs on a CPU
  tensor) against ``ops.qtensor_expert_matmul`` (the Pallas expert kernel in
  interpret mode): atol 1e-5 in f32 (summation order only), within 1 bf16
  ulp in bf16 — the tolerances of the single-matrix quant_matmul test;
* routing: ``_route`` indices equal and gates atol 1e-6 (the router's f32
  products in another order move a logit by ~1e-7); ``_capacity``
  equal; the dispatch's ``keep``/``slot`` integers equal to the ones read
  back from the reference's capacity buffer, drops included;
* ``moe_ffn`` in f32: atol 1e-4 (f32 products in another order);
* the RTN walk + ``pack_model`` of the reduced qwen3: packed ``(L, E, ...)``
  bytes and zero points equal, scales rtol 1e-6;
* serving the reduced qwen3 in f32 against the reference's ``"xla"``
  backend (its ``"pallas"`` decode path cannot run on the installed jax,
  ROADMAP fault 3.1): tokens equal, logits atol 1e-4, lock-step and
  scheduled on both stores (the scheduled runs with an f32 KV cache, as
  ``test_torch_scheduler.py`` explains);
* capture of expert inputs, AWQ on an expert stack, and TesseraQ K=3 /
  T=15 on one reduced f32 MoE block from the same AWQ initialization:
  codes and hardened masks equal, as the dense block's test holds them.

Within the port, in bf16: the expert-batched wrapper equals one
``quant_matmul`` per expert bit for bit; scheduled runs are deterministic
and dense == paged bit for bit; chunked prefill and prefix sharing are
refused by the MoE cache spec and run whole prefill.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import awq as jawq  # noqa: E402
from repro.core import blocks as jblocks  # noqa: E402
from repro.core import capture as jcap  # noqa: E402
from repro.core import pack_model as jpack_model  # noqa: E402
from repro.core import quantize_model as jquantize_model  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro.core import tesseraq as jtq  # noqa: E402
from repro.data.pipeline import (DataConfig, SyntheticCorpus,  # noqa: E402
                                 calibration_batches)
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.launch.serve import serve_requests as jserve  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import CACHE_SPECS as JCACHE_SPECS  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import awq as tawq  # noqa: E402
from repro_torch.core import blocks as tblocks  # noqa: E402
from repro_torch.core import capture as tcap  # noqa: E402
from repro_torch.core import tesseraq as ttq  # noqa: E402
from repro_torch.core.pipeline import pack_model, quantize_model  # noqa: E402
from repro_torch.core.qtensor import QTensor, pack  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    quant_matmul_experts, quant_matmul_experts_plain)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.scheduler import (compile_sched_steps,  # noqa: E402
                                          make_workload, serve_scheduled)
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.registry import CACHE_SPECS  # noqa: E402
from _torch_parity import assert_within_bf16_ulps  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
QC = dict(bits=2, group_size=32)
CPU = dict(device="cpu")
MAX_SEQ, PSZ = 24, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: one intra-op thread is faster for them and does not
    oversubscribe the cores that parallel test workers and XLA share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------------
# the expert-batched quant-matmul
# --------------------------------------------------------------------------

def _expert_operands(seed, E, M, K, N, bits, group_size):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, (E, K, N)).astype(np.uint8)
    packed = np.array(jqt.pack(jnp.asarray(codes), bits))
    ng = K // group_size
    scale = rng.uniform(0.005, 0.05, (E, ng, N)).astype(np.float32)
    zero = rng.integers(0, 1 << bits, (E, ng, N)).astype(np.float32)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    act = rng.uniform(0.5, 2.0, (K,)).astype(np.float32)
    return x, packed, scale, zero, act


_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bits,group_size,E,M,K,N", [
    (2, 32, 4, 8, 128, 48), (3, 32, 3, 40, 96, 40), (4, 128, 2, 16, 256, 24),
    (2, 64, 5, 8, 64, 20)], ids=["w2g32", "w3g32", "w4g128", "w2-per-channel"])
def test_expert_matmul_plain_matches_reference(bits, group_size, E, M, K, N,
                                               dt):
    """The port's expert dispatch (plain version on a CPU tensor) against
    the reference's fused expert grid in interpret mode, act_scale
    included."""
    x, packed, scale, zero, act = _expert_operands(bits * K + E, E, M, K, N,
                                                   bits, group_size)
    jdt, tdt = _DTYPES[dt]
    jw = jqt.QTensor(jnp.asarray(packed), jnp.asarray(scale),
                     jnp.asarray(zero), bits, group_size, (K, N),
                     act_scale=jnp.asarray(act))
    want = jops.qtensor_expert_matmul(jnp.asarray(x, jdt), jw)
    tw = QTensor(torch.from_numpy(packed), torch.from_numpy(scale),
                 torch.from_numpy(zero), bits, group_size, (K, N),
                 act_scale=torch.from_numpy(act))
    before = dict(build.LAUNCHES)
    got = tops.qtensor_expert_matmul(torch.from_numpy(x).to(tdt), tw)
    assert build.LAUNCHES == before      # a CPU tensor launches nothing
    assert got.dtype == tdt and got.shape == (E, M, N)
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert_within_bf16_ulps(got, want, n=1)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_expert_matmul_fused_equals_unrolled(bits, dt):
    """The expert-batched wrapper equals one quant_matmul per expert (the
    reference's fused-vs-unrolled contract), bit for bit."""
    x, packed, scale, zero, act = _expert_operands(11 * bits, 6, 12, 64, 40,
                                                   bits, 32)
    tdt = _DTYPES[dt][1]
    tw = QTensor(torch.from_numpy(packed), torch.from_numpy(scale),
                 torch.from_numpy(zero), bits, 32, (64, 40),
                 act_scale=torch.from_numpy(act))
    a = torch.from_numpy(x).to(tdt)
    fused = tops.qtensor_expert_matmul(a, tw)
    assert torch.equal(fused, tops.qtensor_expert_matmul_unrolled(a, tw))
    plain = quant_matmul_experts_plain(
        a / tw.act_scale.to(tdt), tw.packed, tw.scale, tw.zero, bits=bits,
        group_size=32)
    assert torch.equal(fused, plain)


def test_expert_matmul_rejects_non_stacked_weights():
    x, packed, scale, zero, _ = _expert_operands(0, 2, 4, 64, 16, 2, 32)
    w2 = QTensor(torch.from_numpy(packed[0]), torch.from_numpy(scale[0]),
                 torch.from_numpy(zero[0]), 2, 32, (64, 16))
    a = torch.from_numpy(x)
    for fn in (tops.qtensor_expert_matmul,
               tops.qtensor_expert_matmul_unrolled):
        with pytest.raises(ValueError, match="expert-stacked"):
            fn(a, w2)
        with pytest.raises(ValueError, match="expert-stacked"):
            fn(a[0], w2)
    args = [torch.from_numpy(t) for t in (x, packed, scale, zero)]
    with pytest.raises(ValueError, match="expert-stacked"):
        quant_matmul_experts(args[0][0], *args[1:], bits=2, group_size=32)
    with pytest.raises(ValueError, match="expert counts"):
        quant_matmul_experts(args[0][:1], *args[1:], bits=2, group_size=32)
    with pytest.raises(ValueError, match="packed rows"):
        quant_matmul_experts(args[0], args[1][:, :-1], *args[2:], bits=2,
                             group_size=32)


_ROWS = {"empty": [0, 0, 0, 0], "ragged": [0, 3, 8, 5],
         "full": [8, 8, 8, 8]}


def _zero_past(x, rows):
    """x (E, M, K) with rows m >= rows[e] zeroed, as the capacity buffer
    holds them."""
    x = x.copy()
    for e, r in enumerate(rows):
        x[e, max(r, 0):] = 0.0
    return x


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("counts", list(_ROWS))
def test_expert_matmul_rows_matches_reference(counts, dt):
    """With ``rows``, the port's expert dispatch (plain version on a CPU
    tensor) against the reference's fused expert grid in interpret mode on
    x zeroed past each count (the reference has no ``rows``; the dispatch
    guarantees those zeros): the tolerances of
    test_expert_matmul_plain_matches_reference, atol 1e-5 in f32 and 1 bf16
    ulp in bf16."""
    rows = _ROWS[counts]
    E, M, K, N = 4, 8, 128, 48
    x, packed, scale, zero, act = _expert_operands(7 + len(counts), E, M, K,
                                                   N, 2, 32)
    x = _zero_past(x, rows)
    jdt, tdt = _DTYPES[dt]
    jw = jqt.QTensor(jnp.asarray(packed), jnp.asarray(scale),
                     jnp.asarray(zero), 2, 32, (K, N),
                     act_scale=jnp.asarray(act))
    want = np.asarray(jops.qtensor_expert_matmul(jnp.asarray(x, jdt),
                                                 jw)).astype(np.float32)
    tw = QTensor(torch.from_numpy(packed), torch.from_numpy(scale),
                 torch.from_numpy(zero), 2, 32, (K, N),
                 act_scale=torch.from_numpy(act))
    before = dict(build.LAUNCHES)
    got = tops.qtensor_expert_matmul(torch.from_numpy(x).to(tdt), tw,
                                     torch.tensor(rows, dtype=torch.int32))
    assert build.LAUNCHES == before
    assert got.dtype == tdt and got.shape == (E, M, N)
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert_within_bf16_ulps(got, want, n=1)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_expert_matmul_rows_mask_random_x(dt):
    """On random x (nonzero past the counts) the plain version keeps rows
    below each count bit for bit and writes +0 (by bit pattern) past it;
    counts are clamped to [0, M]."""
    E, M, K, N = 5, 12, 64, 40
    x, packed, scale, zero, _ = _expert_operands(3, E, M, K, N, 3, 32)
    tdt = _DTYPES[dt][1]
    args = [torch.from_numpy(x).to(tdt)] + [torch.from_numpy(t) for t in
                                            (packed, scale, zero)]
    rows = [-3, 0, 5, 12, 100]
    full = quant_matmul_experts_plain(*args, bits=3, group_size=32)
    got = quant_matmul_experts_plain(
        *args, bits=3, group_size=32,
        rows=torch.tensor(rows, dtype=torch.int32))
    bits_of = (lambda t: t.view(torch.int16)) if dt == "bf16" else \
        (lambda t: t.view(torch.int32))
    for e, r in enumerate(rows):
        r = min(max(r, 0), M)
        assert torch.equal(bits_of(got[e, :r]), bits_of(full[e, :r]))
        assert not bits_of(got[e, r:]).any()
    assert bool(full.abs().sum(-1).gt(0).all())    # every row was nonzero


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4])
def test_expert_matmul_rows_fused_equals_unrolled(bits, dt):
    """With ``rows``, the expert-batched wrapper equals one quant_matmul
    per expert masked the same way, bit for bit."""
    x, packed, scale, zero, act = _expert_operands(5 * bits, 6, 12, 64, 40,
                                                   bits, 32)
    tdt = _DTYPES[dt][1]
    tw = QTensor(torch.from_numpy(packed), torch.from_numpy(scale),
                 torch.from_numpy(zero), bits, 32, (64, 40),
                 act_scale=torch.from_numpy(act))
    a = torch.from_numpy(x).to(tdt)
    rows = torch.tensor([0, 12, 7, 1, 0, 13], dtype=torch.int32)
    fused = tops.qtensor_expert_matmul(a, tw, rows)
    assert torch.equal(fused, tops.qtensor_expert_matmul_unrolled(a, tw,
                                                                  rows))
    assert not fused[0].any() and not fused[4].any()


def test_expert_matmul_rejects_bad_rows():
    """``rows`` is an int32 (E,) tensor on x's device, contiguous; the
    wrappers check that without reading its values."""
    x, packed, scale, zero, _ = _expert_operands(0, 3, 4, 64, 16, 2, 32)
    args = [torch.from_numpy(t) for t in (x, packed, scale, zero)]
    kw = dict(bits=2, group_size=32)
    for fn in (quant_matmul_experts, tops.quant_matmul_experts_unrolled):
        with pytest.raises(TypeError, match="int32"):
            fn(*args, **kw, rows=torch.zeros(3, dtype=torch.int64))
        with pytest.raises(ValueError, match=r"expected \(3,\)"):
            fn(*args, **kw, rows=torch.zeros(4, dtype=torch.int32))
        with pytest.raises(ValueError, match=r"expected \(3,\)"):
            fn(*args, **kw, rows=torch.zeros((3, 1), dtype=torch.int32))
        with pytest.raises(ValueError, match="is on meta"):
            fn(*args, **kw, rows=torch.zeros(3, dtype=torch.int32,
                                             device="meta"))
        with pytest.raises(ValueError, match="contiguous"):
            fn(*args, **kw, rows=torch.zeros(6, dtype=torch.int32)[::2])


# --------------------------------------------------------------------------
# routing, capacity dispatch, the MoE FFN
# --------------------------------------------------------------------------

def _skewed_tokens(seed, T, d, E):
    """Tokens and an f32 router that favours expert 0, so capacity drops
    pairs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, d)) + 0.5).astype(np.float32)
    router = (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32)
    router[:, 0] += 0.4
    return x, router


def _reference_slots(idx, E, C):
    """(keep, slot) of the reference's ``_expert_compute``, read back from
    its capacity buffer: token t's row carries the value t + 1, each slot
    row of the (E, C) buffer holds the token it took (0: empty), and a
    token's choices go to distinct experts, so row r // C names the
    choice."""
    T, k = idx.shape
    seen = {}

    def rec(a, w, backend=None):
        seen.setdefault("h", np.asarray(a))
        return jnp.zeros(a.shape[:2] + (w.shape[-1],), a.dtype)

    orig = jlayers.expert_matmul
    jlayers.expert_matmul = rec
    try:
        w = jnp.zeros((E, 1, 1), jnp.float32)
        jmoe._expert_compute(
            jnp.arange(1, T + 1, dtype=jnp.float32)[:, None],
            jnp.asarray(idx), jnp.ones((T, k), jnp.float32), w, w, w,
            e_start=0, e_local=E, capacity=C, act_bits=None, backend="xla")
    finally:
        jlayers.expert_matmul = orig
    buf = seen["h"].reshape(E * C)
    keep = np.zeros(T * k, bool)
    slot = np.full(T * k, E * C, np.int64)
    for r, v in enumerate(buf):
        if v > 0:
            t = int(v) - 1
            j = int(np.flatnonzero(idx[t] == r // C)[0])
            keep[t * k + j], slot[t * k + j] = True, r
    return keep, slot


@pytest.mark.parametrize("T,E,k", [(48, 4, 2), (37, 8, 2), (64, 16, 4)])
def test_route_capacity_and_dispatch_match_reference(T, E, k):
    x, router = _skewed_tokens(T + E, T, 16, E)
    jidx, jgate = jmoe._route(jnp.asarray(x), jnp.asarray(router), k)
    idx, gate = tmoe._route(torch.from_numpy(x), torch.from_numpy(router), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), atol=1e-6,
                               rtol=0)
    for tokens in (1, 4, 8, 37, 512, 2048):
        for cf in (1.0, 1.25):
            assert tmoe._capacity(tokens, 128, 8, cf) == \
                jmoe._capacity(tokens, 128, 8, cf)
    C = tmoe._capacity(T, E, k, 1.25)
    keep, slot, _ = tmoe._dispatch(idx, E, C)
    want_keep, want_slot = _reference_slots(np.asarray(jidx), E, C)
    assert not want_keep.all()                   # capacity dropped pairs
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)


@pytest.mark.parametrize("T,E,k,drops", [(48, 4, 2, True),
                                        (37, 8, 2, True),
                                        (64, 16, 4, True), (1, 8, 2, False),
                                        (3, 16, 2, False)])
def test_dispatch_rows_match_reference_recount(T, E, k, drops):
    """``_dispatch``'s per-expert counts (int32, what the expert kernel
    takes) equal a numpy recount of the pairs the reference routed to each
    expert, and clamped to the capacity (as the kernel clamps them) the
    pairs its dispatch kept, drops past capacity excluded; experts with no
    pair count 0."""
    x, router = _skewed_tokens(T * E + k, T, 16, E)
    jidx, _ = jmoe._route(jnp.asarray(x), jnp.asarray(router), k)
    idx, _ = tmoe._route(torch.from_numpy(x), torch.from_numpy(router), k)
    C = tmoe._capacity(T, E, k, 1.25)
    _, _, rows = tmoe._dispatch(idx, E, C)
    want_keep, _ = _reference_slots(np.asarray(jidx), E, C)
    flat = np.asarray(jidx).reshape(-1)
    want = np.bincount(flat[want_keep], minlength=E)
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (E,)
    routed = np.bincount(flat, minlength=E)
    np.testing.assert_array_equal(rows.numpy(), routed)
    np.testing.assert_array_equal(rows.clamp(max=C).numpy(), want)
    assert (routed > C).any() == drops           # pairs dropped past C
    assert (want == np.minimum(routed, C)).all()
    if T * k < E:
        assert (want == 0).any()                 # some expert empty


def _moe_weights(seed, d, f, E):
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
    return {"router": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f),
            "w_down": w(E, f, d)}


def test_moe_ffn_matches_reference_f32():
    jcfg = jget_reduced(ARCH).replace(dtype="float32")
    cfg = get_reduced_config(ARCH).replace(dtype="float32")
    mp = _moe_weights(3, cfg.d_model, cfg.d_ff, cfg.moe.num_experts)
    x = np.random.default_rng(4).standard_normal(
        (3, 20, cfg.d_model)).astype(np.float32)
    want = jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, mp),
                        jnp.asarray(x), jcfg, jcommon.DEFAULT_CTX)
    got = tmoe.moe_ffn(params_to_torch(mp), torch.from_numpy(x), cfg,
                       tcommon.DEFAULT_CTX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _qtensor_experts(seed, E, K, N, bits, group_size):
    """One expert-stacked projection as numpy (packed, scale, zero)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, (E, K, N)).astype(np.uint8)
    ng = K // group_size
    return (np.array(jqt.pack(jnp.asarray(codes), bits)),
            rng.uniform(0.005, 0.05, (E, ng, N)).astype(np.float32),
            rng.integers(0, 1 << bits, (E, ng, N)).astype(np.float32))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_moe_ffn_one_token_matches_reference(backend):
    """One token through the reduced qwen3 MoE FFN (top-2 of 8 experts, so
    6 experts hold no row and the port's expert kernel skips them) with
    W2 g32 QTensor experts, in f32 on both backends: the port against the
    reference at atol 1e-4, as test_moe_ffn_matches_reference_f32."""
    jcfg = jget_reduced(ARCH).replace(dtype="float32")
    cfg = get_reduced_config(ARCH).replace(dtype="float32")
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    rng = np.random.default_rng(9)
    mp = {"router": (rng.standard_normal((d, E)) * d ** -0.5
                     ).astype(np.float32)}
    for i, (name, K, N) in enumerate((("w_gate", d, f), ("w_up", d, f),
                                      ("w_down", f, d))):
        mp[name] = (*_qtensor_experts(20 + i, E, K, N, 2, 32), (K, N))
    x = rng.standard_normal((1, 1, d)).astype(np.float32)

    def tree(qt, arr):
        out = {"router": arr(mp["router"])}
        for k in ("w_gate", "w_up", "w_down"):
            p, s, z, shape = mp[k]
            out[k] = qt(arr(p), arr(s), arr(z), 2, 32, shape)
        return out

    jmp = tree(jqt.QTensor, jnp.asarray)
    tmp = tree(QTensor, torch.from_numpy)
    jctx = dataclasses.replace(jcommon.DEFAULT_CTX, kernel_backend=backend)
    want = jmoe.moe_ffn(jmp, jnp.asarray(x), jcfg, jctx)
    idx, _ = tmoe._route(torch.from_numpy(x[0]), tmp["router"],
                         cfg.moe.top_k)
    _, _, rows = tmoe._dispatch(
        idx, E, tmoe._capacity(1, E, cfg.moe.top_k,
                               cfg.moe.capacity_factor))
    assert int((rows == 0).sum()) == E - cfg.moe.top_k
    got = tmoe.moe_ffn(tmp, torch.from_numpy(x), cfg,
                       tcommon.make_ctx(kernel_backend=backend))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_moe_refuses_expert_parallelism():
    """The mesh-wide expert parallelism (``ep_axis``) comes from a mesh
    alone: ``make_ctx`` derives it (``"model"`` for the MoE family on a
    model axis of more than one rank) and refuses it as a field.  On a
    mesh of one rank the mesh paths are the single-device one, bit for
    bit.  The serve-time inner one (``ep_inner``, held against the
    reference in ``tests/test_torch_tp_serve.py``) takes the model axis's
    ProcessGroup and refuses a mesh-axis name.  Both mesh paths on several
    ranks are held against the reference in
    ``tests/test_torch_train_mesh.py``."""
    from repro_torch.launch.mesh import Mesh, make_mesh
    cfg = get_reduced_config(ARCH)
    mp = params_to_torch(_moe_weights(0, cfg.d_model, cfg.d_ff,
                                      cfg.moe.num_experts))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 5, cfg.d_model)).astype(np.float32))
    with pytest.raises(TypeError, match="unknown Ctx field"):
        tcommon.make_ctx(ep_axis="model")
    tp2 = Mesh(world=2, rank=0, shape=(1, 2), group=None,
               device=torch.device("cpu"))
    assert tcommon.make_ctx(cfg, mesh=tp2).ep_axis == "model"
    want = tmoe.moe_ffn(mp, x, cfg, tcommon.make_ctx())
    for shape in ((1,), (1, 1)):
        ctx = tcommon.make_ctx(cfg, mesh=make_mesh(shape, device="cpu"))
        assert ctx.ep_axis is None
        assert torch.equal(tmoe.moe_ffn(mp, x, cfg, ctx), want)
    with pytest.raises(TypeError, match="ProcessGroup"):
        tmoe.moe_ffn(mp, x, cfg, tcommon.make_ctx(ep_inner="model"))


def test_model_api_accepts_moe():
    """The registry, the configs and the cache contract of the MoE family,
    as the reference declares them."""
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.moe.num_experts,
            full.moe.top_k, full.d_ff, full.vocab_size) == \
        (48, 2048, 128, 8, 768, 151936)
    cfg = get_reduced_config(ARCH)
    m = get_model(cfg)
    spec, jspec = m.cache_spec, JCACHE_SPECS["moe"]
    assert spec is CACHE_SPECS["moe"]
    assert (spec.chunkable, spec.shareable) == (jspec.chunkable,
                                                jspec.shareable) == (False,
                                                                     False)
    assert spec.token_paths == tuple(jspec.token_paths)
    params = m.init_params(0, "cpu")
    mp = params["blocks"]["moe"]
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    assert mp["router"].dtype == torch.float32
    assert tuple(mp["router"].shape) == (cfg.num_layers, d, E)
    assert tuple(mp["w_down"].shape) == (cfg.num_layers, E, f, d)
    assert "w_gate" not in params["blocks"]
    stages = tblocks.build_stages(cfg)
    assert [s.n_blocks for s in stages] == [cfg.num_layers]
    bp = stages[0].get_block(params, 0)
    paths = tblocks.quant_leaf_paths(bp)
    assert sorted(paths) == sorted(jblocks.quant_leaf_paths(
        jax.tree_util.tree_map(lambda t: t.float().numpy(), bp)))
    assert ("moe", "w_up") in paths and ("moe", "router") not in paths


# --------------------------------------------------------------------------
# RTN + pack, and serving, against the reference
# --------------------------------------------------------------------------

B, PROMPT, GEN = 3, 12, 5
_REF = {}


def _calib(vocab):
    dc = DataConfig(vocab_size=vocab, seq_len=16, global_batch=2, seed=0)
    return [b["tokens"][:, :-1] for b in calibration_batches(dc, 2, 2)]


def _prompts(vocab):
    dc = DataConfig(vocab_size=vocab, seq_len=PROMPT, global_batch=B, seed=1)
    return SyntheticCorpus(dc).batch(0)["tokens"][:, :PROMPT]


def _reference(dtype):
    """JAX params, RTN + pack, and the ``"xla"`` lock-step serve, memoized."""
    if dtype not in _REF:
        cfg = jget_reduced(ARCH).replace(dtype=dtype)
        model = jget_model(cfg)
        params = model.init_params(jax.random.PRNGKey(0))
        calib = [{"tokens": jnp.asarray(t)} for t in _calib(cfg.vocab_size)]
        qcfg = JQuantConfig(**QC)
        pfq, qmeta, _ = jquantize_model(cfg, params, calib, qcfg,
                                        method="none", init="rtn")
        packed = jpack_model(cfg, pfq, qmeta, qcfg)
        prompts = _prompts(cfg.vocab_size)
        res = jserve(cfg, model, packed, prompts, gen=GEN,
                     kernel_backend="xla")
        _REF[dtype] = dict(params=_np(params), packed=_np(packed),
                           prompts=prompts, logits=res.logits,
                           tokens=res.tokens, packed_j=packed, cfg=cfg)
    return _REF[dtype]


def test_rtn_pack_of_expert_stacks_matches_reference():
    """The port's RTN walk + pack on the bridged params: every linear,
    expert stacks (L, E, in/ppb, out) included, packs to the reference's
    bytes, scales and zero points; the router stays the f32 input."""
    ref = _reference("bfloat16")
    cfg = get_reduced_config(ARCH)
    params = params_to_torch(ref["params"])
    calib = [{"tokens": torch.from_numpy(t.astype(np.int64))}
             for t in _calib(cfg.vocab_size)]
    qcfg = QuantConfig(**QC)
    pfq, qmeta, _ = quantize_model(cfg, params, calib, qcfg, method="none",
                                   init="rtn")
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    names = [("wq",), ("wk",), ("wv",), ("wo",), ("moe", "w_gate"),
             ("moe", "w_up"), ("moe", "w_down")]
    for path in names:
        got, want = packed["blocks"], ref["packed"]["blocks"]
        for key in path:
            got, want = got[key], want[key]
        assert got.bits == want.bits and got.group_size == want.group_size
        assert tuple(got.shape) == tuple(want.shape)
        if path[0] == "moe":
            E = cfg.moe.num_experts
            assert got.packed.shape[:2] == (cfg.num_layers, E)
        np.testing.assert_array_equal(got.packed.numpy(), want.packed)
        np.testing.assert_allclose(got.scale.numpy(), want.scale, rtol=1e-6)
        np.testing.assert_array_equal(got.zero.numpy(), want.zero)
    np.testing.assert_array_equal(
        packed["blocks"]["moe"]["router"].numpy(),
        ref["packed"]["blocks"]["moe"]["router"])
    # pack is generic over leading dims: one (L, E) stack packs in one call
    codes = qmeta[("blocks", 0, "moe", "w_up")]["codes"]
    np.testing.assert_array_equal(
        pack(codes, 2).numpy(),
        np.asarray(jqt.pack(jnp.asarray(codes.numpy()), 2)))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_serve_f32_matches_reference(backend):
    """Lock-step serving of the reduced qwen3 in f32: the port's backend
    against the reference's ``"xla"`` backend."""
    ref = _reference("float32")
    cfg = get_reduced_config(ARCH).replace(dtype="float32")
    packed = params_to_torch(ref["packed"])
    res = tserve.serve_requests(cfg, get_model(cfg), packed, ref["prompts"],
                                gen=GEN, kernel_backend=backend, **CPU)
    np.testing.assert_array_equal(res.tokens, ref["tokens"])
    np.testing.assert_allclose(res.logits, ref["logits"], atol=1e-4, rtol=0)


def _f32_cache_steps(steps, dtype):
    """``steps`` with its model's caches allocated in ``dtype`` whatever the
    store asks for."""
    init = steps.model.init_cache
    model = dataclasses.replace(
        steps.model,
        init_cache=lambda b, s, _=None, *a: init(b, s, dtype, *a))
    return dataclasses.replace(steps, model=model)


_WL = dict(n_requests=5, seed=4, prompt_lens=(5, 12), budgets=(2, 7),
           mean_gap=1.0)


def _reference_scheduled(store):
    ref = _reference("float32")
    key = ("sched", store)
    if key not in _REF:
        cfg = ref["cfg"]
        reqs = jsched.make_workload(cfg.vocab_size, **_WL)
        steps = _f32_cache_steps(jsched.compile_sched_steps(
            cfg, max_seq=MAX_SEQ, kernel_backend="xla",
            page_size=PSZ if store == "paged" else 0), jnp.float32)
        _REF[key] = jsched.serve_scheduled(
            cfg, ref["packed_j"], reqs, slots=2, max_seq=MAX_SEQ,
            kernel_backend="xla", store=store, page_size=PSZ,
            collect_logits=True, compiled=steps)
    return _REF[key]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("store", ["dense", "paged"])
def test_scheduled_f32_matches_reference(store, backend):
    """Continuous batching in f32 (2 slots, staggered arrivals, inactive
    slots routed like live ones): tokens, admission and finish steps equal,
    logits atol 1e-4."""
    want = _reference_scheduled(store)
    ref = _reference("float32")
    cfg = get_reduced_config(ARCH).replace(dtype="float32")
    reqs = make_workload(cfg.vocab_size, **_WL)
    steps = _f32_cache_steps(compile_sched_steps(
        cfg, max_seq=MAX_SEQ, kernel_backend=backend,
        page_size=PSZ if store == "paged" else 0), torch.float32)
    got = serve_scheduled(cfg, params_to_torch(ref["packed"]), reqs, slots=2,
                          max_seq=MAX_SEQ, kernel_backend=backend,
                          store=store, page_size=PSZ, collect_logits=True,
                          compiled=steps, **CPU)
    assert got.steps == want.steps
    for q in reqs:
        g, w = got.requests[q.rid], want.requests[q.rid]
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_allclose(g["logits"], w["logits"], atol=1e-4,
                                   rtol=0)
        assert (g["admit_step"], g["finish_step"]) == \
            (w["admit_step"], w["finish_step"])


# --------------------------------------------------------------------------
# the scheduler's contracts between two port runs (bf16)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_packed():
    cfg = get_reduced_config(ARCH)
    params = get_model(cfg).init_params(0, "cpu")
    calib = [{"tokens": torch.randint(
        0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(0))}]
    qcfg = QuantConfig(**QC)
    pfq, qmeta, _ = quantize_model(cfg, params, calib, qcfg, method="none",
                                   init="rtn")
    return cfg, pack_model(cfg, pfq, qmeta, qcfg)


def _tokens_equal(a, b, reqs):
    for q in reqs:
        np.testing.assert_array_equal(
            a.requests[q.rid]["tokens"], b.requests[q.rid]["tokens"],
            err_msg=f"rid {q.rid} diverged")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_scheduled_determinism_and_dense_equals_paged(moe_packed, backend):
    """Two scheduled runs are equal, and the paged store equals the dense
    one bit for bit (tokens and logits); asking for chunked prefill and
    prefix sharing runs whole prefill, as the MoE cache spec says."""
    cfg, packed = moe_packed
    reqs = make_workload(cfg.vocab_size, n_requests=6, seed=3,
                         prompt_lens=(4, 14), budgets=(2, 8))
    kw = dict(slots=2, max_seq=MAX_SEQ, kernel_backend=backend,
              collect_logits=True, page_size=PSZ, **CPU)
    a = serve_scheduled(cfg, packed, reqs, **kw)
    b = serve_scheduled(cfg, packed, reqs, **kw)
    _tokens_equal(a, b, reqs)
    p = serve_scheduled(cfg, packed, reqs, store="paged", **kw)
    _tokens_equal(a, p, reqs)
    for q in reqs:
        assert np.array_equal(a.requests[q.rid]["logits"],
                              p.requests[q.rid]["logits"])
        assert a.requests[q.rid]["admit_step"] == \
            p.requests[q.rid]["admit_step"]
    c = serve_scheduled(cfg, packed, reqs, store="paged", prefill_chunk=4,
                        share_prefix=True, **kw)
    _tokens_equal(a, c, reqs)
    assert c.cache_stats["shared_page_hits"] == 0
    assert all(c.requests[q.rid]["shared_tokens"] == 0 for q in reqs)


def test_cli_serves_moe_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--reduced", "--quant", "W2A16g32",
                        "--method", "tesseraq", "--init", "awq",
                        "--par-iters", "2", "--par-steps", "2", "--backend",
                        "pallas", "--device", "cpu", "--requests", "2",
                        "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "calibrating qwen3-moe-smoke" in out and "2 requests x 3" in out


# --------------------------------------------------------------------------
# calibration: capture, AWQ, TesseraQ on one MoE block
# --------------------------------------------------------------------------

def _block_params(cfg, seed=0):
    """One reduced MoE block as numpy arrays (random f32 weights)."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    w = lambda i, o: (rng.standard_normal((i, o)) * i ** -0.5).astype(
        np.float32)
    return {"ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32),
            "wq": w(d, cfg.num_heads * hd), "wk": w(d, cfg.num_kv_heads * hd),
            "wv": w(d, cfg.num_kv_heads * hd), "wo": w(cfg.num_heads * hd, d),
            "moe": _moe_weights(seed + 1, d, cfg.d_ff, cfg.moe.num_experts)}


_BLOCK = {}


def _block_reference():
    """The reduced MoE block (f32), its captures in both packages, the
    port's AWQ initialization, and the reference's TesseraQ K=3 / T=15 on
    its device engine from that initialization.  Memoized."""
    if not _BLOCK:
        cfg = get_reduced_config(ARCH).replace(dtype="float32")
        jcfg = jget_reduced(ARCH).replace(dtype="float32")
        bp = _block_params(cfg)
        X = np.random.default_rng(1).standard_normal(
            (8, 16, cfg.d_model)).astype(np.float32)
        stage = tblocks.build_stages(cfg)[0]
        jstage = jblocks.build_stages(jcfg)[0]
        tbp, jbp = params_to_torch(bp), jax.tree_util.tree_map(jnp.asarray,
                                                               bp)
        tX = torch.from_numpy(X)
        with torch.no_grad():
            Y = stage.apply(tbp, tX).numpy()
        caps = tcap.capture_block_inputs(stage.apply, tbp,
                                         list(torch.split(tX, 4)))
        jcaps = jcap.capture_block_inputs(jstage.apply, jbp,
                                          [jnp.asarray(X[:4]),
                                           jnp.asarray(X[4:])])
        _, meta = tawq.quantize_block_awq(tbp, caps, QuantConfig(**QC))
        jmeta = {p: {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v)
                         else v) for k, v in m.items()}
                 for p, m in meta.items()}
        log = []
        _, qm = jtq.reconstruct_block(
            jstage.apply, jbp, jnp.asarray(X), jnp.asarray(Y), None, jmeta,
            JQuantConfig(**QC),
            jtq.TesseraQConfig(par_iterations=3, steps_per_iteration=15),
            log=log)
        _BLOCK.update(stage=stage, bp=tbp, X=tX, Y=torch.from_numpy(Y),
                      caps=caps, jcaps=jcaps, meta=meta, qm=qm, log=log,
                      jY=np.asarray(jstage.apply(jbp, jnp.asarray(X), None)))
    return _BLOCK


def test_moe_block_capture_and_awq_match_reference():
    """The MoE block's forward, the captured inputs of every linear (the
    expert stacks' (E*C, d) rows, padding included), and AWQ on each
    leaf, expert stacks sharing one act_scale."""
    ref = _block_reference()
    np.testing.assert_allclose(ref["Y"].numpy(), ref["jY"], atol=1e-4,
                               rtol=0)
    assert set(ref["caps"]) == set(ref["jcaps"])
    for p, st in ref["caps"].items():
        jst = ref["jcaps"][p]
        assert st.count == jst.count
        np.testing.assert_allclose(st.sample.numpy(), jst.sample, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(st.mean_abs.numpy(), jst.mean_abs,
                                   rtol=1e-5)
    for p in (("moe", "w_gate"), ("moe", "w_down"), ("wq",)):
        w = tblocks.get_path(ref["bp"], p)
        _, m = tawq.awq_leaf(w, ref["caps"][p], QuantConfig(**QC))
        _, jm = jawq.awq_leaf(jnp.asarray(w.numpy()), ref["jcaps"][p],
                              JQuantConfig(**QC))
        assert (m["alpha"], m["clip"]) == (jm["alpha"], jm["clip"]), p
        assert tuple(m["act_scale"].shape) == (w.shape[-2],)
        np.testing.assert_array_equal(m["codes"].numpy(),
                                      np.asarray(jm["codes"]))
        np.testing.assert_allclose(m["scale"].numpy(), np.asarray(jm["scale"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_reconstruct_moe_block_matches_reference(backend):
    """TesseraQ on one MoE block: expert stacks go through the soft_round
    path as (E*ng, g, out) and harden jointly with the attention leaves;
    codes and hardened masks equal the reference's."""
    ref = _block_reference()
    log = []
    _, qm = ttq.reconstruct_block(
        ref["stage"].apply, ref["bp"], ref["X"], ref["Y"], None, ref["meta"],
        QuantConfig(**QC, kernel_backend=backend),
        ttq.TesseraQConfig(par_iterations=3, steps_per_iteration=15), log=log)
    assert set(qm) == set(ref["qm"])
    for p, m in qm.items():
        want = ref["qm"][p]
        assert m["codes"].shape == tuple(np.asarray(want["codes"]).shape)
        np.testing.assert_array_equal(m["codes"].numpy(),
                                      np.asarray(want["codes"]))
        np.testing.assert_array_equal(m["hard"].numpy(),
                                      np.asarray(want["hard"]))
        np.testing.assert_allclose(m["scale"].numpy(),
                                   np.asarray(want["scale"]), rtol=1e-4)
    np.testing.assert_allclose([e["loss"] for e in log],
                               [e["loss"] for e in ref["log"]], rtol=1e-3)
    assert log[-1]["soft_rate"] == 0.0


def test_expert_capture_records_padded_rows():
    """``capture_block_inputs`` records an expert stack's (E, C, d) input as
    E*C rows: the count is E*C per call, whatever the tokens."""
    cfg = get_reduced_config(ARCH).replace(dtype="float32")
    stage = tblocks.build_stages(cfg)[0]
    bp = params_to_torch(_block_params(cfg, 5))
    xs = [torch.randn(2, 6, cfg.d_model, generator=torch.Generator()
                      .manual_seed(i)) for i in range(2)]
    caps = tcap.capture_block_inputs(stage.apply, bp, xs)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C = tmoe._capacity(12, E, k, cfg.moe.capacity_factor)
    assert caps[("moe", "w_gate")].count == 2 * E * C
    assert caps[("moe", "w_down")].sample.shape[1] == cfg.d_ff
    assert caps[("wq",)].count == 2 * 12
    # the recording wrappers are gone afterwards
    assert tlayers.expert_matmul.__name__ == "expert_matmul"
