"""The kernels' plain PyTorch versions (what the wrappers run on a CPU
tensor) against the JAX reference on the same numpy inputs.

* quant_matmul: against the reference's Pallas kernel in interpret mode
  (``ops.quant_matmul_op``) and its jnp oracle (``ref.quant_matmul_ref``);
* quant_gemv: against ``ref.quant_matmul_ref`` only — the reference's
  Pallas GEMV does not run on the installed jax (ROADMAP fault 3.1);
* decode_attention: against ``ops.decode_attention_op`` in interpret mode,
  with ``chunk`` dividing S (ROADMAP fault 3.2).

Tolerances: atol 1e-5 in f32 (summation order only); within 1 bf16 ulp in
bf16 (f32 sums in another order may round to the neighbouring bf16 value);
the quant_matmul cases taken from chip_smoke.py's kernel paths also allow
the f32 reordering term chip_smoke.py allows (2^-16 x sum of |terms|),
since a cancelling sum can move by more than half a bf16 ulp of its result.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.quant_gemv import quant_gemv  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    dequantize_rows, quant_matmul)
from _torch_parity import assert_within_bf16_ulps, bf16_ulp  # noqa: E402

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _operands(seed, M, K, N, bits, group_size):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, (K, N)).astype(np.uint8)
    packed = np.array(jqt.pack(jnp.asarray(codes), bits))
    ng = K // group_size
    scale = rng.uniform(0.005, 0.05, (ng, N)).astype(np.float32)
    zero = rng.integers(0, 1 << bits, (ng, N)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, packed, scale, zero


def _compare(got, want, dt):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert_within_bf16_ulps(got, want, n=1)


def _torch_args(x, packed, scale, zero, tdt):
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(packed),
            torch.from_numpy(scale), torch.from_numpy(zero))


def _compare_reordered(got, want, dt, x, packed, scale, zero, bits,
                       group_size):
    """``_compare``, but in bf16 each element may also differ by the f32
    reordering allowance chip_smoke.py holds the kernel to, 2^-16 times the
    sum of |terms|: where a sum cancels, two f32 summation orders can differ
    by more than half a bf16 ulp of the (small) result."""
    if dt == "f32":
        return _compare(got, want, dt)
    w = dequantize_rows(torch.from_numpy(packed), torch.from_numpy(scale),
                        torch.from_numpy(zero), bits=bits,
                        group_size=group_size, dtype=torch.bfloat16)
    x_bf = torch.from_numpy(x).to(torch.bfloat16).double()
    slack = 2.0 ** -16 * (x_bf.abs() @ w.double().abs()).numpy()
    got = got.double().numpy()
    want = np.asarray(want).astype(np.float64)
    diff = np.abs(got - want)
    lim = bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + slack
    assert (diff <= lim).all(), float((diff - lim).max())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bits,group_size,K,N,M,reordered", [
    (2, 32, 128, 48, 40, False), (3, 32, 96, 40, 40, False),
    (4, 128, 256, 24, 40, False), (2, 64, 64, 20, 40, False),
    # chip_smoke.py's QM_PATHS, cut to size: an admission prefill of 33
    # rows, ragged M/N/K with one 200-row group at 3 bits, a per-channel
    # K of 100 (held with the reordering allowance: see _compare_reordered)
    (2, 32, 128, 48, 33, True), (3, 200, 200, 300, 100, True),
    (4, 100, 100, 72, 40, True),
    # QM_PATHS' groups of 32, 48 and 16 rows (several groups per 64-deep
    # stage of the kernel; at K = 48 fewer groups than a stage holds),
    # held to the 1-ulp bound
    (2, 32, 256, 64, 100, False), (3, 48, 192, 300, 64, False),
    (4, 16, 48, 40, 40, False)],
    ids=["w2g32", "w3g32", "w4g128", "w2-per-channel", "w2g32-m33",
         "w3-ragged-k200", "w4-per-channel-k100", "w2g32-k256-m100",
         "w3g48-n300", "w4g16-k48"])
def test_quant_matmul_plain_matches_reference(bits, group_size, K, N, M,
                                              reordered, dt):
    x, packed, scale, zero = _operands(bits * K + N, M, K, N, bits,
                                       group_size)
    jdt, tdt = _DTYPES[dt]
    xj = jnp.asarray(x, jdt)
    want_kernel = jops.quant_matmul_op(
        xj, jnp.asarray(packed), jnp.asarray(scale), jnp.asarray(zero),
        bits=bits, group_size=group_size)
    want_ref = jref.quant_matmul_ref(
        xj, jnp.asarray(packed), jnp.asarray(scale), jnp.asarray(zero),
        bits=bits, group_size=group_size)
    before = dict(build.LAUNCHES)
    got = quant_matmul(*_torch_args(x, packed, scale, zero, tdt), bits=bits,
                       group_size=group_size)
    assert got.dtype == tdt and got.shape == (M, N)
    assert build.LAUNCHES == before      # a CPU tensor launches nothing
    if reordered:
        args = (x, packed, scale, zero, bits, group_size)
        _compare_reordered(got, want_kernel, dt, *args)
        _compare_reordered(got, want_ref, dt, *args)
    else:
        _compare(got, want_kernel, dt)
        _compare(got, want_ref, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bits,M,K,N,g", [
    pytest.param(bits, M, 128, 72, 32, id=f"{bits}-{M}")
    for bits in (2, 3, 4) for M in (1, 4, 32)] + [
    # chip_smoke.py's GEMV_PATHS, cut to size: every other row template of
    # the kernel (M = 1..32 as 1..4 tiles of 8 rows), 8 bits, groups of 8
    # (per-element), 16 (per 16-deep chunk), 48 at ragged N = 300, 200 at
    # K = 400 (not a multiple of the kernel's 128-deep stage), per-channel
    # K = 100 and K = 256 at N = 512
    pytest.param(2, M, 128, 72, 32, id=f"2-{M}")
    for M in (2, 3, 5, 8, 16, 17, 24)] + [
    pytest.param(8, 4, 128, 72, 128, id="w8g128"),
    pytest.param(2, 4, 64, 40, 8, id="w2g8"),
    pytest.param(2, 8, 128, 48, 16, id="w2g16"),
    pytest.param(3, 4, 192, 300, 48, id="w3g48-n300"),
    pytest.param(4, 4, 400, 72, 200, id="w4g200-k400"),
    pytest.param(4, 4, 100, 72, 100, id="w4-per-channel-k100"),
    pytest.param(2, 32, 256, 512, 256, id="w2-per-channel-n512-m32")])
def test_quant_gemv_plain_matches_reference(bits, M, K, N, g, dt):
    x, packed, scale, zero = _operands(7 * bits + M, M, K, N, bits, g)
    jdt, tdt = _DTYPES[dt]
    want = jref.quant_matmul_ref(
        jnp.asarray(x, jdt), jnp.asarray(packed), jnp.asarray(scale),
        jnp.asarray(zero), bits=bits, group_size=g)
    got = quant_gemv(*_torch_args(x, packed, scale, zero, tdt), bits=bits,
                     group_size=g)
    _compare(got, want, dt)


@pytest.mark.parametrize("M,N", [(1, 72), (4, 300), (32, 512)])
def test_quant_gemv_empty_k_returns_zeros(M, N):
    """K = 0 passes the operand checks (any group size divides it) and is
    an empty sum: zeros of (M, N).  The CUDA wrapper returns them without a
    launch; the reference's reshape cannot take K = 0, so the expected value
    is the empty sum itself."""
    x = torch.zeros(M, 0, dtype=torch.bfloat16)
    packed = torch.zeros(0, N, dtype=torch.uint8)
    scale = torch.zeros(0, N)
    got = quant_gemv(x, packed, scale, scale.clone(), bits=2, group_size=32)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    assert torch.equal(got, torch.zeros(M, N, dtype=torch.bfloat16))


def test_qtensor_matmul_dispatch_and_act_scale():
    """M <= 32 rows take the GEMV, more rows the tiled matmul; both compute
    the same function, and ``act_scale`` is divided out of x first."""
    K, N, g, bits = 64, 16, 32, 4
    x, packed, scale, zero = _operands(3, 40, K, N, bits, g)
    act = np.random.default_rng(4).uniform(0.5, 2.0, (K,)).astype(np.float32)
    w = QTensor(torch.from_numpy(packed), torch.from_numpy(scale),
                torch.from_numpy(zero), bits, g, (K, N),
                act_scale=torch.from_numpy(act))
    want = jref.quant_matmul_ref(
        jnp.asarray(x / act), jnp.asarray(packed), jnp.asarray(scale),
        jnp.asarray(zero), bits=bits, group_size=g)
    for rows in (3, 32, 33, 40):
        got = tops.qtensor_matmul(torch.from_numpy(x[:rows]), w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:rows],
                                   rtol=1e-5, atol=1e-5)
    got3 = tops.qtensor_matmul(torch.from_numpy(x[:6]).reshape(2, 3, K), w)
    assert got3.shape == (2, 3, N)


def test_wrappers_validate_operands():
    x, packed, scale, zero = _operands(0, 4, 64, 16, 2, 32)
    args = _torch_args(x, packed, scale, zero, torch.float32)
    with pytest.raises(ValueError, match="packed rows"):
        quant_matmul(args[0], args[1][:-1], args[2], args[3], bits=2,
                     group_size=32)
    with pytest.raises(ValueError, match="scale/zero"):
        quant_gemv(args[0], args[1], args[2][:1], args[3], bits=2,
                   group_size=32)
    with pytest.raises(ValueError, match="rows"):
        quant_gemv(torch.zeros(33, 64), args[1], args[2], args[3], bits=2,
                   group_size=32)
    q = torch.zeros(2, 2, 1, 8)
    with pytest.raises(ValueError, match="layout"):
        decode_attention(q, torch.zeros(2, 5, 3, 8), torch.zeros(2, 5, 3, 8),
                         kv_len=torch.ones(2, dtype=torch.int32),
                         q_pos=torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,Hkv,G,D,chunk", [
    (4, 48, 2, 1, 16, 16), (3, 40, 2, 4, 32, 8), (2, 24, 1, 8, 16, 24)],
    ids=["mha", "gqa4", "mqa8-unchunked"])
def test_decode_attention_plain_matches_reference(B, S, Hkv, G, D, chunk, dt):
    rng = np.random.default_rng(B * S + G)
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kv_len = rng.integers(1, S + 1, (B,)).astype(np.int32)
    kv_len[0] = S                                   # one full lane
    q_pos = (kv_len - 1).astype(np.int32)
    q_pos[-1] = max(kv_len[-1] - 3, 0)              # causal cut inside kv_len
    active = np.ones((B,), np.int32)
    active[1] = 0                                   # one inactive slot
    jdt, tdt = _DTYPES[dt]
    want = jops.decode_attention_op(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        kv_len=jnp.asarray(kv_len.copy()), q_pos=jnp.asarray(q_pos.copy()),
        active=jnp.asarray(active.copy()), chunk=chunk)
    got = decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), kv_len=torch.from_numpy(kv_len),
        q_pos=torch.from_numpy(q_pos), active=torch.from_numpy(active))
    assert got.dtype == tdt
    assert torch.all(got[1] == 0)                   # exact zeros
    _compare(got, want, dt)


# The shapes chip_smoke.py's ATTN_PATHS hold the CUDA kernel to its plain
# version at, with a small D: G = 8 over one KV head, G = 12 (six of the
# kernel's 2-row query blocks), S not a multiple of 8, D not a multiple of
# 8; one launch covers n_b = 1, lengths at and past 8 and 16 positions
# (the edges of a warp's run at these widths), S - 1 and S, a causal cut
# (q_pos < kv_len - 1) and an inactive slot.  ``chunk`` divides S or is at
# least S (ROADMAP fault 3.2).  Tolerances as above.
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,Hkv,G,D,chunk", [
    (37, 1, 8, 16, 64), (36, 2, 4, 8, 12), (40, 2, 1, 24, 8),
    (33, 2, 12, 20, 33)],
    ids=["mqa8-s37", "gqa4-s36", "mha-d24", "g12-d20"])
def test_decode_attention_plain_matches_reference_at_plan_edges(
        S, Hkv, G, D, chunk, dt):
    rng = np.random.default_rng(S * G + D)
    lens = sorted({1, 8, 9, 16, 17, S - 1, S})
    kv_len = np.array(lens + [S, S], np.int32)
    q_pos = np.array([n - 1 for n in lens] + [S // 2, S - 1], np.int32)
    active = np.ones(len(kv_len), np.int32)
    active[-1] = 0                                  # one inactive slot
    B = len(kv_len)
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    jdt, tdt = _DTYPES[dt]
    want = jops.decode_attention_op(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        kv_len=jnp.asarray(kv_len.copy()), q_pos=jnp.asarray(q_pos.copy()),
        active=jnp.asarray(active.copy()), chunk=chunk)
    got = decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), kv_len=torch.from_numpy(kv_len),
        q_pos=torch.from_numpy(q_pos), active=torch.from_numpy(active))
    assert got.dtype == tdt
    assert torch.all(got[-1] == 0)                  # exact zeros
    _compare(got, want, dt)


def test_decode_attention_null_active_is_every_slot_live():
    """``active=None`` (the CUDA kernel's null pointer) is every slot live:
    bit for bit the all-ones result on the CPU path, without a launch."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(torch.bfloat16)
               for sh in ((3, 2, 4, 16), (3, 24, 2, 16), (3, 24, 2, 16)))
    kv_len = torch.tensor([24, 1, 13], dtype=torch.int32)
    q_pos = torch.tensor([23, 0, 9], dtype=torch.int32)
    before = dict(build.LAUNCHES)
    got = decode_attention(q, k, v, kv_len=kv_len, q_pos=q_pos)
    want = decode_attention(q, k, v, kv_len=kv_len, q_pos=q_pos,
                            active=torch.ones(3, dtype=torch.int32))
    assert torch.equal(got, want)
    assert dict(build.LAUNCHES) == before
