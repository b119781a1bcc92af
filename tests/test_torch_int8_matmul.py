"""The integer kernel's plain version and the weight-activation entry point
``ops.w4a8_matmul`` against the JAX reference on the same numpy inputs,
on the CPU (the wrapper runs ``int8_matmul_plain`` for a CPU tensor).

* ``int8_matmul_plain`` against the reference's Pallas kernel in interpret
  mode (its ``ops.int8_matmul_op``) at the reference test's shapes, and
  against its jnp oracle ``ref.int8_matmul_ref`` also at shapes the Pallas
  kernel's divisibility assert rejects (ROADMAP fault 3.4);
* ``quantize_per_token`` against ``ref.quantize_per_token_ref``;
* ``w4a8_matmul`` against the reference's, per-channel and grouped;
* the bridge carries a per-channel W4 QTensor with and without an AWQ
  ``act_scale``.

Tolerances: the integer accumulator is exact on both sides and the f32
epilogue ``(acc * x_scale) * w_scale`` runs in the same order (XLA keeps it,
measured here), so outputs are equal, in f32 and in bf16.  ``w4a8_matmul``
is equal in f32 and held within 1 bf16 ulp in bf16 (it is equal on these
inputs too: the rank-1 correction's products and sums are the same f32
operations in the same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.quantizer import make_qtensor as jmake_qtensor  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.int8_matmul import (int8_matmul,  # noqa: E402
                                             int8_matmul_plain)
from repro_torch.models import layers as TL  # noqa: E402
from _torch_parity import assert_within_bf16_ulps  # noqa: E402

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _int8_operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-128, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    sx = ((rng.random((M, 1)) + .1) * .01).astype(np.float32)
    sw = ((rng.random((1, N)) + .1) * .01).astype(np.float32)
    return xq, wq, sx, sw


def _f32(a):
    """A jax or numpy array as a writable float32 numpy array."""
    return np.array(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(32, 128, 64), (16, 256, 32), (8, 64, 8)])
def test_int8_matmul_plain_matches_reference_kernel(M, K, N, dt):
    """At the reference test's shapes, ``int8_matmul`` against the
    reference's ``int8_matmul_op``: equal to the Pallas kernel (interpret
    mode) and to its oracle."""
    jdt, tdt = _DTYPES[dt]
    ops = _int8_operands(M * 1000 + K + N, M, K, N)
    jargs = [jnp.asarray(a) for a in ops]
    want_kernel = jops.int8_matmul_op(*jargs, out_dtype=jdt)
    want_ref = jref.int8_matmul_ref(*jargs, out_dtype=jdt)
    before = dict(build.LAUNCHES)
    got = int8_matmul(*(torch.from_numpy(a) for a in ops), out_dtype=tdt)
    assert build.LAUNCHES == before      # a CPU tensor launches nothing
    assert got.dtype == tdt and got.shape == (M, N)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want_kernel))
    np.testing.assert_array_equal(got.float().numpy(), _f32(want_ref))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(13, 200, 300), (300, 64, 24),
                                   (4, 11008 // 16, 40)],
                         ids=["ragged", "M300", "K688"])
def test_int8_matmul_plain_matches_oracle_where_pallas_refuses(M, K, N, dt):
    """Shapes the Pallas kernel's divisibility assert rejects (K = 200,
    M = 13 and 300, N = 300; K = 688 = 512 + 176 like LLaMA-2-7B's
    11008 = 21 * 512 + 256): equal to ``ref.int8_matmul_ref``."""
    jdt, tdt = _DTYPES[dt]
    ops = _int8_operands(M + K + N, M, K, N)
    bm, bn, bk = min(256, M), min(256, N), min(512, K)
    assert M % bm or N % bn or K % bk     # the Pallas kernel refuses these
    want = jref.int8_matmul_ref(*(jnp.asarray(a) for a in ops),
                                out_dtype=jdt)
    got = int8_matmul(*(torch.from_numpy(a) for a in ops), out_dtype=tdt)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


# The CUDA kernel's plan edges (chip_smoke.py's INT8_PATHS), cut to shapes
# whose every dim the reference's blocks (256 x 512 x 256) divide: M = 16 /
# 17 (the decode / main plan boundary), 1 and 37 (a ragged m tile), K = 32,
# 200 (not a multiple of a 32-deep chunk) and 480 (a ragged last stage of
# 128), N = 48 (a ragged n tile) and 200 (N % 16 != 0: the kernel's plain-
# loaded weight), and a column slice (lda = 480 > K = 128).  M, K, N, lda
_PLAN_EDGES = [(1, 32, 48, 32), (16, 480, 48, 480), (17, 480, 200, 480),
               (37, 200, 200, 200), (16, 200, 200, 200), (37, 32, 48, 32),
               (17, 128, 48, 480), (4, 480, 200, 480)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,lda", _PLAN_EDGES,
                         ids=[f"M{m}-K{k}-N{n}-lda{a}"
                              for m, k, n, a in _PLAN_EDGES])
def test_int8_matmul_plain_matches_reference_at_plan_edges(M, K, N, lda, dt):
    """At the kernel's plan edges, ``int8_matmul`` (a CPU tensor: the plain
    version) equals the reference's Pallas kernel in interpret mode, x_q
    passed as a column slice of an (M, lda) matrix where lda > K."""
    jdt, tdt = _DTYPES[dt]
    xw, wq, sx, sw = _int8_operands(M * 7 + K + N + lda, M, lda, N)
    xq, wq = xw[:, :K], wq[:K]
    want = jops.int8_matmul_op(*(jnp.asarray(np.ascontiguousarray(a))
                                 for a in (xq, wq, sx, sw)), out_dtype=jdt)
    x_t = torch.from_numpy(xw)[:, :K]
    assert x_t.stride(0) == lda
    got = int8_matmul(x_t, torch.from_numpy(np.ascontiguousarray(wq)),
                      torch.from_numpy(sx), torch.from_numpy(sw),
                      out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_int8_matmul_takes_column_slices_and_checks_operands():
    """x_q may be a column slice of a wider matrix (row stride > K), as
    ``w4a8_matmul`` passes its groups; everything else is refused."""
    xq, wq, sx, sw = (torch.from_numpy(a)
                      for a in _int8_operands(5, 6, 96, 20))
    part = xq[:, 32:64]
    assert part.stride() == (96, 1)
    got = int8_matmul(part, wq[32:64], sx, sw, out_dtype=torch.float32)
    want = int8_matmul_plain(part.contiguous(), wq[32:64].contiguous(), sx,
                             sw, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(xq.to(torch.int16), wq, sx, sw)
    with pytest.raises(TypeError, match="float32"):
        int8_matmul(xq, wq, sx.double(), sw)
    with pytest.raises(TypeError, match="out_dtype"):
        int8_matmul(xq, wq, sx, sw, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="x_scale"):
        int8_matmul(xq, wq, sx[:3], sw)
    with pytest.raises(ValueError, match="w_q is"):
        int8_matmul(xq, wq[:50], sx, sw)
    with pytest.raises(ValueError, match="unit-stride"):
        int8_matmul(xq.t().contiguous().t(), wq, sx, sw)
    with pytest.raises(ValueError, match="overflow"):
        z = torch.zeros((1, 140000), dtype=torch.int8)
        int8_matmul(z, torch.zeros((140000, 1), dtype=torch.int8),
                    sx[:1], sw[:, :1])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_per_token_matches_reference(bits, dt):
    jdt, tdt = _DTYPES[dt]
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((3, 7, 64)) * 4).astype(np.float32)
    x[0, 0] = 0.0                                # an all-zero token
    x[1, 2, :5] = 9.0                            # ties at the max
    xj = jnp.asarray(x.copy(), jdt)
    q_want, s_want = jref.quantize_per_token_ref(xj, bits)
    q, s = tops.quantize_per_token(
        torch.from_numpy(_f32(xj)).to(tdt), bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_want))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_want))


def _qtensor(seed, K, N, bits, group_size, stacked=False):
    rng = np.random.default_rng(seed)
    shape = (2, K, N) if stacked else (K, N)
    w = rng.standard_normal(shape).astype(np.float32)
    jqt = jmake_qtensor(jnp.asarray(w),
                        JQuantConfig(bits=bits, group_size=group_size))
    tqt = params_to_torch(jax.tree_util.tree_map(np.asarray, {"w": jqt}))
    return jqt, tqt["w"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("act_bits", [8, 4])
@pytest.mark.parametrize("bits,group_size", [(4, None), (8, None), (4, 32),
                                             (8, 64)],
                         ids=["w4-per-channel", "w8-per-channel", "w4g32",
                              "w8g64"])
def test_w4a8_matmul_matches_reference(bits, group_size, act_bits, dt,
                                       monkeypatch):
    """Equal to the reference's ``w4a8_matmul`` (whose integer kernel runs
    in interpret mode), with exactly K / g ``int8_matmul`` calls."""
    jdt, tdt = _DTYPES[dt]
    K, N = 128, 48
    jqt, tqt = _qtensor(bits * 10 + act_bits, K, N, bits, group_size)
    rng = np.random.default_rng(act_bits)
    x = rng.standard_normal((2, 5, K)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    want = _f32(jops.w4a8_matmul(xj, jqt, act_bits))
    calls = []
    orig = tops.int8_matmul
    monkeypatch.setattr(tops, "int8_matmul",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = tops.w4a8_matmul(torch.from_numpy(_f32(xj)).to(tdt), tqt, act_bits)
    assert got.dtype == tdt and got.shape == (2, 5, N)
    assert len(calls) == K // (group_size or K)
    if dt == "f32":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert_within_bf16_ulps(got.float().numpy(), want, n=1)


def test_w4a8_matmul_refuses_stacked_and_act_scaled_weights():
    _, stacked = _qtensor(1, 64, 16, 8, None, stacked=True)
    x = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="non-stacked"):
        tops.w4a8_matmul(x, stacked)
    _, qt = _qtensor(2, 64, 16, 4, None)
    qt.act_scale = torch.ones(64)
    with pytest.raises(ValueError, match="act_scale"):
        tops.w4a8_matmul(x, qt)


@pytest.mark.parametrize("with_act_scale", [False, True],
                         ids=["no-act-scale", "act-scale"])
def test_bridge_carries_per_channel_w4_qtensor(with_act_scale):
    """A per-channel (group_size == K) W4 QTensor crosses the bridge field
    for field, so both packages' ``w4a8_matmul`` (without an act_scale) and
    act_bits forwards through ``layers.matmul`` see the same weights."""
    K, N = 96, 40
    rng = np.random.default_rng(3)
    act = (rng.uniform(0.5, 2.0, (K,)).astype(np.float32)
           if with_act_scale else None)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jqt = jmake_qtensor(jnp.asarray(w), JQuantConfig(bits=4,
                                                     group_size=None),
                        act_scale=None if act is None else jnp.asarray(act))
    tqt = params_to_torch(jax.tree_util.tree_map(np.asarray, {"w": jqt}))["w"]
    assert (tqt.bits, tqt.group_size, tqt.shape) == (4, K, (K, N))
    np.testing.assert_array_equal(tqt.packed.numpy(), np.asarray(jqt.packed))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
    np.testing.assert_array_equal(tqt.zero.numpy(), np.asarray(jqt.zero))
    if act is None:
        assert tqt.act_scale is None
    else:
        np.testing.assert_array_equal(tqt.act_scale.numpy(), act)
    x = rng.standard_normal((6, K)).astype(np.float32)
    # the act_bits forward's projection: fake-quant, then the "xla" matmul
    want = JL.matmul(JL.fake_quant_act(jnp.asarray(x), 4), jqt, "xla")
    got = TL.matmul(TL.fake_quant_act(torch.from_numpy(x), 4), tqt, "xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if act is None:
        np.testing.assert_array_equal(
            tops.w4a8_matmul(torch.from_numpy(x), tqt, 8).numpy(),
            np.asarray(jops.w4a8_matmul(jnp.asarray(x), jqt, 8)))
    else:
        with pytest.raises(ValueError, match="act_scale"):
            tops.w4a8_matmul(torch.from_numpy(x), tqt, 8)
