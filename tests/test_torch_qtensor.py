"""The port's QTensor packing and RTN quantizer against the JAX reference.

Inputs are made once with numpy from a seed and fed to both packages.
Integer artifacts (packed bytes, codes) must be equal; scale/zero agree to
1e-6 (both compute them in f32 with the same operations)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro.core import quantizer as jquant  # noqa: E402
from repro.core import rtn as jrtn  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import qtensor as tqt  # noqa: E402
from repro_torch.core import quantizer as tquant  # noqa: E402
from repro_torch.core import rtn as trtn  # noqa: E402
from _torch_parity import assert_within_bf16_ulps  # noqa: E402


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_bytes_equal_reference(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, (3, 64, 24)).astype(np.uint8)
    want = np.asarray(jqt.pack(jnp.asarray(codes), bits, axis=-2))
    got = tqt.pack(torch.from_numpy(codes), bits, axis=-2).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # and along another axis (the reference's transpose branch)
    want0 = np.asarray(jqt.pack(jnp.asarray(codes), bits, axis=-1))
    got0 = tqt.pack(torch.from_numpy(codes), bits, axis=-1).numpy()
    np.testing.assert_array_equal(got0, want0)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_unpack_and_dequantize_equal_reference(bits):
    rng = np.random.default_rng(10 + bits)
    K, N, g = 64, 40, 16
    codes = rng.integers(0, 1 << bits, (K, N)).astype(np.uint8)
    scale = rng.uniform(0.01, 0.1, (K // g, N)).astype(np.float32)
    zero = rng.integers(0, 1 << bits, (K // g, N)).astype(np.float32)
    packed = np.array(jqt.pack(jnp.asarray(codes), bits))
    tp = torch.from_numpy(packed)
    np.testing.assert_array_equal(tqt.unpack(tp, bits, K).numpy(), codes)
    np.testing.assert_array_equal(tqt.unpack(tp, bits, K).numpy(),
                                  np.asarray(jqt.unpack(jnp.asarray(packed),
                                                        bits, K)))
    jq = jqt.QTensor(jnp.asarray(packed), jnp.asarray(scale),
                     jnp.asarray(zero), bits, g, (K, N))
    tq = tqt.QTensor(tp, torch.from_numpy(scale), torch.from_numpy(zero),
                     bits, g, (K, N))
    want = np.asarray(jq.dequantize(jnp.float32))
    got = tq.dequantize(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    assert tq.memory_bytes() == jq.memory_bytes()


@pytest.mark.parametrize("group_size,K", [(32, 128), (128, 256), (48, 64)],
                         ids=["g32", "g128", "per-channel-fallback"])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_rtn_codes_equal_reference(bits, group_size, K):
    rng = np.random.default_rng(100 * bits + group_size)
    w = rng.standard_normal((K, 24)).astype(np.float32) * 0.05
    jq = JQuantConfig(bits=bits, group_size=group_size)
    tq = QuantConfig(bits=bits, group_size=group_size)
    js, jz = jquant.compute_scale_zero(jnp.asarray(w), jq)
    ts, tz = tquant.compute_scale_zero(torch.from_numpy(w), tq)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    jfq, jmeta = jrtn.rtn_leaf(jnp.asarray(w), jq)
    tfq, tmeta = trtn.rtn_leaf(torch.from_numpy(w), tq)
    np.testing.assert_array_equal(tmeta["codes"].numpy(),
                                  np.asarray(jmeta["codes"]))
    np.testing.assert_allclose(tfq.numpy(), np.asarray(jfq), atol=1e-6)
    jqtn = jquant.make_qtensor(jnp.asarray(w), jq)
    tqtn = tquant.make_qtensor(torch.from_numpy(w), tq)
    assert tqtn.group_size == jqtn.group_size
    np.testing.assert_array_equal(tqtn.packed.numpy(), np.asarray(jqtn.packed))


def test_qmatmul_xla_path_matches_reference_bf16():
    """The "xla" backend dequantizes in the activation dtype (scale/zero
    rounded to bf16 first); products differ only in summation order."""
    rng = np.random.default_rng(7)
    K, N, g, bits = 64, 32, 32, 2
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    x = rng.standard_normal((5, K)).astype(np.float32)
    jw = jquant.make_qtensor(jnp.asarray(w), JQuantConfig(bits=bits,
                                                          group_size=g))
    tw = tquant.make_qtensor(torch.from_numpy(w), QuantConfig(bits=bits,
                                                              group_size=g))
    np.testing.assert_array_equal(
        tw.dequantize(torch.bfloat16).float().numpy(),
        np.asarray(jw.dequantize(jnp.bfloat16)).astype(np.float32))
    want = np.asarray(jqt.qmatmul(jnp.asarray(x, jnp.bfloat16), jw)
                      ).astype(np.float32)
    got = tqt.qmatmul(torch.from_numpy(x).to(torch.bfloat16), tw
                      ).float().numpy()
    assert_within_bf16_ulps(got, want, n=1)
