"""The paged decode-attention kernel's plain version (what the wrapper runs
on a CPU tensor) against the JAX reference's Pallas kernel
``paged_decode_attention`` in interpret mode, on the same numpy inputs.

Every case walks a permuted, non-contiguous page table with ragged
``kv_len``, one inactive slot and one slot with ``kv_len = 0``.
Tolerances: atol 1e-5 in f32 (the reference runs an online softmax page by
page, the plain version one softmax over the gathered lane: summation order
only); within 1 bf16 ulp in bf16 (f32 sums in another order may round to
the neighbouring bf16 value).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention as jpaged)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain)
from repro_torch.models.common import gather_pages  # noqa: E402
from _torch_parity import assert_within_bf16_ulps  # noqa: E402

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
B, W, D = 4, 4, 16


def _operands(Hkv, G, psz, seed):
    """Pools of P = B*W + 3 pages; slot b owns a random permutation's slice,
    so logical pages are neither contiguous nor ordered."""
    rng = np.random.default_rng(seed)
    P = B * W + 3
    S = W * psz
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    kp = rng.standard_normal((P, psz, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, psz, Hkv, D)).astype(np.float32)
    ptab = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    kv_len = np.array([S, S - psz // 2 - 1, psz + 1, 0], np.int32)
    q_pos = np.maximum(kv_len - 1, 0).astype(np.int32)
    q_pos[0] = S - 3                                 # causal cut inside kv_len
    active = np.array([1, 0, 1, 1], np.int32)        # slot 1 inactive
    return q, kp, vp, ptab, kv_len, q_pos, active


def _torch(a, tdt=None):
    t = torch.from_numpy(np.array(a))
    return t.to(tdt) if tdt is not None else t


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("psz", [4, 8, 16, 64])
@pytest.mark.parametrize("Hkv,G", [(2, 1), (1, 4), (1, 8)],
                         ids=["mha", "gqa4", "mqa8"])
def test_paged_plain_matches_reference(Hkv, G, psz, dt):
    q, kp, vp, ptab, kv_len, q_pos, active = _operands(Hkv, G, psz, psz + G)
    jdt, tdt = _DTYPES[dt]
    want = jpaged(jnp.asarray(q, jdt), jnp.asarray(kp, jdt),
                  jnp.asarray(vp, jdt), jnp.asarray(ptab),
                  kv_len=jnp.asarray(kv_len), q_pos=jnp.asarray(q_pos),
                  active=jnp.asarray(active), interpret=True)
    got = paged_decode_attention(
        _torch(q, tdt), _torch(kp, tdt), _torch(vp, tdt), _torch(ptab),
        kv_len=_torch(kv_len), q_pos=_torch(q_pos), active=_torch(active))
    assert got.dtype == tdt
    assert torch.all(got[1] == 0) and torch.all(got[3] == 0)   # exact zeros
    want = np.asarray(want).astype(np.float32)
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert_within_bf16_ulps(got.float().numpy(), want, n=1)


@pytest.mark.parametrize("psz", [4, 16])
def test_paged_plain_equals_dense_plain_on_gathered_cache(psz):
    """Bit for bit: the paged version is the dense one on the gathered lane,
    whatever the unowned pages hold."""
    q, kp, vp, ptab, kv_len, q_pos, active = _operands(2, 2, psz, 7)
    args = [_torch(a, torch.bfloat16) for a in (q, kp, vp)]
    kw = dict(kv_len=_torch(kv_len), q_pos=_torch(q_pos),
              active=_torch(active))
    got = paged_decode_attention_plain(*args, _torch(ptab), **kw)
    pt = _torch(ptab)
    want = decode_attention_plain(args[0], gather_pages(args[1], pt),
                                  gather_pages(args[2], pt), **kw)
    assert torch.equal(got, want)
    assert gather_pages(args[1], pt).shape == (B, W * psz, 2, D)


def test_paged_wrapper_rejects_mismatches():
    q, kp, vp, ptab, kv_len, q_pos, active = _operands(2, 1, 4, 0)
    tq, tk, tv, tp = _torch(q), _torch(kp), _torch(vp), _torch(ptab)
    kw = dict(kv_len=_torch(kv_len), q_pos=_torch(q_pos))
    with pytest.raises(ValueError, match="layout"):
        paged_decode_attention(tq, tk[..., :1, :], tv[..., :1, :], tp, **kw)
    with pytest.raises(ValueError, match="layout"):
        paged_decode_attention(tq, tk, tv[:-1], tp, **kw)
    with pytest.raises(ValueError, match="ptab"):
        paged_decode_attention(tq, tk, tv, tp[:2], **kw)
    with pytest.raises(ValueError, match="ptab"):
        paged_decode_attention(tq, tk, tv, tp[:, 0], **kw)
    with pytest.raises(ValueError, match="kv_len"):
        paged_decode_attention(tq, tk, tv, tp, kv_len=_torch(kv_len[:2]),
                               q_pos=kw["q_pos"])


def test_cpu_path_adds_no_launch_count():
    q, kp, vp, ptab, kv_len, q_pos, active = _operands(1, 4, 8, 1)
    before = dict(build.LAUNCHES)
    paged_decode_attention(_torch(q), _torch(kp), _torch(vp), _torch(ptab),
                           kv_len=_torch(kv_len), q_pos=_torch(q_pos),
                           active=_torch(active))
    assert dict(build.LAUNCHES) == before
    assert "paged_decode_attention" in build.KERNELS
    assert build.SOURCES["paged_decode_attention"] == "decode_attention.cu"
