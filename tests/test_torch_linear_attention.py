"""The port's chunked linear-attention engine (``repro_torch.models.ssm``,
the Mamba2 / RWKV6 recurrence) against the JAX reference, on the CPU in
float32 from numpy-seeded inputs.

* ``chunked_linear_attention`` at chunk 4 / 8 / 32, inclusive (Mamba2) and
  exclusive (RWKV6) taps, a per-head (E = 1) and a per-key-dim (E = Dk)
  decay, with and without the bonus ``u``, from a zero and a given initial
  state: outputs and final state within 1e-5 relative of the reference's;
* ``step_linear_attention`` likewise;
* chunked == a loop of the port's own steps;
* decay strong enough to overflow the factored form stays finite;
* the gradients of a scalar loss with respect to q, k, v, the decay, u and
  the initial state within 1e-5 relative of the reference's ``jax.grad``.

Tolerance: elementwise ``rtol = 1e-5`` with an absolute floor of 1e-5 x
the largest reference magnitude (float32 summation order only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

REL = 1e-5
B, S, H, DK, DV = 2, 21, 3, 8, 5


def close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def operands(E, use_u, strength=2.0, state=False, seed=0, S_=S):
    rng = np.random.default_rng(seed)
    out = {
        "q": rng.normal(size=(B, S_, H, DK)).astype(np.float32),
        "k": rng.normal(size=(B, S_, H, DK)).astype(np.float32),
        "v": rng.normal(size=(B, S_, H, DV)).astype(np.float32),
        "ld": (-np.abs(rng.normal(size=(B, S_, H, E))) * strength
               ).astype(np.float32),
        "u": (rng.normal(size=(H, DK)).astype(np.float32) if use_u
              else None),
        "s0": (rng.normal(size=(B, H, DK, DV)).astype(np.float32) if state
               else None),
    }
    return out


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


CASES = [(inc, E, use_u) for inc in (True, False) for E in (1, DK)
         for use_u in (False, True)]


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("inclusive,E,use_u", CASES)
def test_chunked_matches_reference(inclusive, E, use_u, chunk):
    for state in (False, True):
        o = operands(E, use_u, state=state)
        yj, sj = jssm.chunked_linear_attention(
            _j(o["q"]), _j(o["k"]), _j(o["v"]), _j(o["ld"]),
            inclusive=inclusive, u=_j(o["u"]), chunk=chunk,
            initial_state=_j(o["s0"]))
        yt, st = tssm.chunked_linear_attention(
            _t(o["q"]), _t(o["k"]), _t(o["v"]), _t(o["ld"]),
            inclusive=inclusive, u=_t(o["u"]), chunk=chunk,
            initial_state=_t(o["s0"]))
        assert yt.dtype == torch.float32 and st.dtype == torch.float32
        close(yt.numpy(), np.asarray(yj))
        close(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("inclusive,E", [(True, 1), (True, DK), (False, 1),
                                         (False, DK)])
def test_step_matches_reference(inclusive, E):
    o = operands(E, not inclusive, state=True)
    args = lambda f: (f(o["s0"]), f(o["q"][:, 0]), f(o["k"][:, 0]),
                      f(o["v"][:, 0]), f(o["ld"][:, 0]))
    yj, sj = jssm.step_linear_attention(*args(_j), inclusive=inclusive,
                                        u=_j(o["u"]))
    yt, st = tssm.step_linear_attention(*args(_t), inclusive=inclusive,
                                        u=_t(o["u"]))
    close(yt.numpy(), np.asarray(yj))
    close(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("inclusive,E", [(True, 1), (False, DK)])
@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_chunked_equals_step_loop(inclusive, E, chunk):
    o = {k: _t(v) for k, v in operands(E, not inclusive).items()}
    y_c, s_c = tssm.chunked_linear_attention(
        o["q"], o["k"], o["v"], o["ld"], inclusive=inclusive, u=o["u"],
        chunk=chunk)
    state = torch.zeros((B, H, DK, DV))
    ys = []
    for t in range(S):
        y, state = tssm.step_linear_attention(
            state, o["q"][:, t], o["k"][:, t], o["v"][:, t], o["ld"][:, t],
            inclusive=inclusive, u=o["u"])
        ys.append(y)
    close(y_c.numpy(), torch.stack(ys, 1).numpy(), 1e-4)
    close(s_c.numpy(), state.numpy(), 1e-4)


@pytest.mark.parametrize("strength", [12.0, 80.0])
@pytest.mark.parametrize("inclusive,E", [(True, 1), (False, DK)])
def test_strong_decay_stays_finite(inclusive, E, strength):
    """exp(-a) of the factored form overflows f32 past a cumulative decay of
    ~88; the pairwise differences keep every kept exponent <= 0."""
    o = {k: _t(v) for k, v in operands(E, not inclusive,
                                       strength=strength).items()}
    y, st = tssm.chunked_linear_attention(
        o["q"], o["k"], o["v"], o["ld"], inclusive=inclusive, u=o["u"],
        chunk=8)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert float(o["ld"].sum(1).min()) < -88.0


@pytest.mark.parametrize("inclusive,E,use_u", [(True, 1, False),
                                               (False, DK, True),
                                               (True, DK, False)])
def test_gradients_match_reference(inclusive, E, use_u):
    o = operands(E, use_u, state=True, S_=13)
    rng = np.random.default_rng(7)
    wy = rng.normal(size=(B, 13, H, DV)).astype(np.float32)
    ws = rng.normal(size=(B, H, DK, DV)).astype(np.float32)
    names = ["q", "k", "v", "ld", "s0"] + (["u"] if use_u else [])

    def jloss(*args):
        a = dict(zip(names, args))
        y, st = jssm.chunked_linear_attention(
            a["q"], a["k"], a["v"], a["ld"], inclusive=inclusive,
            u=a.get("u"), chunk=4, initial_state=a["s0"])
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *[jnp.asarray(o[n]) for n in names])
    ts = [torch.from_numpy(o[n]).requires_grad_() for n in names]
    a = dict(zip(names, ts))
    y, st = tssm.chunked_linear_attention(
        a["q"], a["k"], a["v"], a["ld"], inclusive=inclusive, u=a.get("u"),
        chunk=4, initial_state=a["s0"])
    loss = (y * torch.from_numpy(wy)).sum() + (st * torch.from_numpy(ws)).sum()
    got = torch.autograd.grad(loss, ts)
    for n, g, w in zip(names, got, want):
        assert torch.isfinite(g).all(), n
        close(g.numpy(), np.asarray(w))
