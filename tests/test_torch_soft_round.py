"""The port's soft_round module (what its wrappers run on a CPU tensor)
against the JAX reference on the same numpy inputs.

* forward: ``soft_round_plain`` (and the ``soft_round`` wrapper on a CPU
  tensor) against the jnp oracle ``ref.soft_round_ref`` at aligned and
  ragged shapes, and against the Pallas kernel ``ops.soft_round_op`` in
  interpret mode at shapes its (8, 512) block grid accepts (ROADMAP fault
  3.3: it asserts ``ng % 8 == 0 and out % 512 == 0``);
* gradients: ``SoftRound`` (the autograd Function over the plain forward
  and backward) and the ``"xla"`` path (autograd through the plain
  forward) against ``jax.grad`` of the reference's ``soft_weight`` under a
  fixed random cotangent, for ν and v, with frozen entries and with u on
  the clip's bounds (jnp.clip passes 1/2 there);
* ``torch.autograd.gradcheck`` of the plain backward in float64;
* AWQ's ``act_scale`` folded into the launch: the plain forward and
  backward with it are bit-identical to the plain function followed
  (forward) or preceded (backward) by the outside division, for one leaf
  and for an expert fold sharing one vector; the port's ``soft_weight``
  under ``"pallas"`` on an expert stack against the reference's value and
  ``jax.grad``; the wrapper's refusals (act_scale length, dtype, device;
  the launch's grid limits).

Tolerances (σ is computed by different code in the two packages and
differs by up to an ulp): forward |diff| <= 4 ulps of the output plus
4 ulps of (qmax + 1) times the effective scale (σ's ulp moves u = base +
zero + α by up to one ulp of u before the product); dν <= 4 ulps of dν
plus 4·2^-24·|dout·s_eff| (σ' = σ(1 − σ) carries σ's absolute rounding);
dv <= 4 ulps of dv plus 2^-16 times the sum of |terms| (reduction order)
plus the u-rounding term summed over the group.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import tesseraq as jtq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import tesseraq as ttq  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.soft_round import (SoftRound, check_grid,  # noqa: E402
                                            soft_round, soft_round_bwd,
                                            soft_round_bwd_plain,
                                            soft_round_plain)

def _ulp(a):
    a = np.maximum(np.abs(np.asarray(a, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 23)


def _state(seed, ng, g, n, bits, frozen=0.5):
    """Random TesseraQ leaf state in the grouped layout: about ``frozen``
    of the entries hardened, with both signs."""
    rng = np.random.default_rng(seed)
    qmax = (1 << bits) - 1
    zero = rng.integers(0, qmax + 1, (ng, n)).astype(np.float32)
    base = (rng.integers(-2, qmax + 2, (ng, g, n)) - zero[:, None, :]
            ).astype(np.float32)
    nu = (rng.standard_normal((ng, g, n)) * 3).astype(np.float32)
    hard = np.where(rng.random((ng, g, n)) < frozen,
                    rng.choice([-1, 1], (ng, g, n)), 0).astype(np.int8)
    v = (rng.standard_normal((ng, n)) * 0.3).astype(np.float32)
    scale = (rng.random((ng, n)) * 0.02 + 0.005).astype(np.float32)
    return dict(base=base, nu=nu, hard=hard, v=v, scale=scale, zero=zero)


def _t(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


ORDER = ("base", "nu", "hard", "v", "scale", "zero")


def _s_eff(st, dst):
    s = st["scale"].astype(np.float64)
    if dst:
        s = s * 2.0 / (1.0 + np.exp(-st["v"].astype(np.float64)))
    return s[:, None, :]


def _assert_fwd(got, want, st, qmax, dst):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    lim = (4 * _ulp(np.maximum(np.abs(got), np.abs(want)))
           + 4 * _ulp(qmax + 1) * np.abs(_s_eff(st, dst)))
    bad = np.abs(got - want) > lim
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


# (ng, g, out), bits, dst: two shapes aligned to the Pallas grid, then
# ragged ones (w_down-like ng = 86, odd widths); every bit width and both
# DST settings appear with both kinds
FWD_CASES = [
    ((8, 4, 512), 2, True), ((8, 4, 512), 3, False),
    ((16, 8, 1024), 4, True), ((16, 8, 1024), 2, False),
    ((3, 5, 17), 2, True), ((3, 5, 17), 4, False),
    ((86, 4, 40), 3, True), ((86, 4, 40), 2, False),
    ((2, 128, 6), 4, True), ((2, 128, 6), 3, False),
]


@pytest.mark.parametrize("shape,bits,dst", FWD_CASES,
                         ids=lambda c: "x".join(map(str, c))
                         if isinstance(c, tuple) else str(c))
def test_forward_matches_reference(shape, bits, dst):
    st = _state(100 * bits + shape[0], *shape, bits)
    qmax = (1 << bits) - 1
    ts = _t(st)
    got = soft_round_plain(*(ts[k] for k in ORDER), qmax=qmax, dst=dst)
    before = dict(build.LAUNCHES)
    wrapped = soft_round(*(ts[k] for k in ORDER), qmax=qmax, dst=dst)
    assert build.LAUNCHES == before          # a CPU tensor launches nothing
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    want = jref.soft_round_ref(*(js[k] for k in ORDER), qmax=qmax, dst=dst)
    _assert_fwd(got.numpy(), want, st, qmax, dst)
    ng, _, n = shape
    if ng % 8 == 0 and n % 512 == 0:
        want_k = jops.soft_round_op(*(js[k] for k in ORDER), qmax=qmax,
                                    dst=dst)
        _assert_fwd(got.numpy(), want_k, st, qmax, dst)


def _grads_jax(st, act, cot, bits, dst):
    qc = JQuantConfig(bits=bits, group_size=st["nu"].shape[1])
    base = {k: jnp.asarray(st[k]) for k in ("base", "hard", "scale", "zero")}
    base["act_scale"] = None if act is None else jnp.asarray(act)

    def f(nu, v):
        w = jtq.soft_weight({**base, "nu": nu, "v": v}, qc, dst)
        return jnp.sum(w * jnp.asarray(cot))
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(st["nu"]),
                                       jnp.asarray(st["v"]))


def _grads_port(st, act, cot, bits, dst, backend):
    qc = QuantConfig(bits=bits, group_size=st["nu"].shape[1],
                     kernel_backend=backend)
    ts = _t(st)
    ts["nu"].requires_grad_(True)
    ts["v"].requires_grad_(True)
    ts["act_scale"] = None if act is None else torch.from_numpy(act)
    w = ttq.soft_weight(ts, qc, dst)
    (w * torch.from_numpy(cot)).sum().backward()
    return ts["nu"].grad, ts["v"].grad


def _boundary_state(bits):
    """Soft entries with u exactly on 0 and on qmax (α = σ(0) = 1/2 with a
    half-integer base), beside ordinary and frozen ones."""
    st = _state(7, 4, 8, 24, bits)
    qmax = (1 << bits) - 1
    st["nu"][:, 0, :] = 0.0
    st["hard"][:, 0:2, :] = 0
    st["base"][:, 0, :12] = -0.5 - st["zero"][:, :12]
    st["base"][:, 0, 12:] = qmax - 0.5 - st["zero"][:, 12:]
    return st


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("dst", [True, False])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_gradients_match_jax_grad(bits, dst, backend):
    st = _boundary_state(bits)
    ng, g, n = st["nu"].shape
    rng = np.random.default_rng(bits)
    act = (rng.random(ng * g) + 0.5).astype(np.float32)
    cot = rng.standard_normal((ng * g, n)).astype(np.float32)
    jnu, jv = _grads_jax(st, act, cot, bits, dst)
    tnu, tv = _grads_port(st, act, cot, bits, dst, backend)
    jnu = np.asarray(jnu, np.float64)
    # the cotangent reaching θ̂ in the grouped layout, and |dout·s_eff|
    dout = (cot / act[:, None]).reshape(ng, g, n).astype(np.float64)
    chain = np.abs(dout * _s_eff(st, dst))
    lim = 4 * _ulp(jnu) + 4 * 2.0 ** -24 * chain
    assert (np.abs(tnu.numpy() - jnu) <= lim).all()
    # frozen entries get exactly zero, and the bound cases 1/2 of the
    # interior chain: dν = dout·s_eff·(1/2)·σ'(0) with σ'(0) = 1/4
    assert (tnu.numpy()[st["hard"] != 0] == 0).all()
    want_edge = (np.asarray(dout[:, 0, :], np.float32)
                 * np.asarray(_s_eff(st, dst)[:, 0, :], np.float32)
                 * 0.5 * 0.25)
    np.testing.assert_allclose(tnu.numpy()[:, 0, :], want_edge, rtol=1e-6)
    np.testing.assert_allclose(jnu[:, 0, :], want_edge, rtol=1e-6)
    if not dst:
        assert tv is None or not tv.any()
        return
    jv = np.asarray(jv, np.float64)
    alpha = np.where(st["hard"] == 0, 1 / (1 + np.exp(-st["nu"].astype(
        np.float64))), st["hard"] > 0)
    z = st["zero"][:, None, :]
    q = np.clip(st["base"] + z + alpha, 0, (1 << bits) - 1)
    terms = np.abs(dout * (q - z) * _s_eff(st, dst))
    lim_v = (4 * _ulp(jv) + 2.0 ** -16 * terms.sum(1)
             + 4 * _ulp((1 << bits)) * chain.sum(1))
    assert (np.abs(tv.numpy() - jv) <= lim_v).all()


def test_wrapper_backward_matches_autograd_of_plain():
    """``soft_round_bwd`` on a CPU tensor is the plain backward, and it is
    what autograd of the plain forward gives (ties included)."""
    st = _boundary_state(3)
    ts = _t(st)
    dout = torch.from_numpy(
        np.random.default_rng(3).standard_normal(st["nu"].shape)
        .astype(np.float32))
    dnu, dv = soft_round_bwd(dout, *(ts[k] for k in ORDER), qmax=7)
    pnu, pv = soft_round_bwd_plain(dout, *(ts[k] for k in ORDER), qmax=7)
    torch.testing.assert_close(dnu, pnu, rtol=0, atol=0)
    torch.testing.assert_close(dv, pv, rtol=0, atol=0)
    nu = ts["nu"].clone().requires_grad_(True)
    v = ts["v"].clone().requires_grad_(True)
    out = soft_round_plain(ts["base"], nu, ts["hard"], v, ts["scale"],
                           ts["zero"], qmax=7)
    (out * dout).sum().backward()
    torch.testing.assert_close(dnu, nu.grad, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(dv, v.grad, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("dst", [True, False])
def test_soft_round_gradcheck_f64(dst):
    st = _state(11, 3, 4, 5, 3)
    ts = {k: (v.to(torch.float64) if v.dtype == torch.float32 else v)
          for k, v in _t(st).items()}
    nu = ts["nu"].clone().requires_grad_(True)
    v = ts["v"].clone().requires_grad_(True)

    def f(nu, v):
        return SoftRound.apply(ts["base"], nu, ts["hard"], v, ts["scale"],
                               ts["zero"], 7, dst)
    assert torch.autograd.gradcheck(f, (nu, v), eps=1e-6, atol=1e-8)


def test_wrapper_rejects_bad_shapes():
    st = _t(_state(0, 2, 4, 8, 2))
    with pytest.raises(ValueError, match="v shape"):
        soft_round(st["base"], st["nu"], st["hard"], st["v"][:, :4],
                   st["scale"], st["zero"], qmax=3)
    with pytest.raises(ValueError, match="base must be"):
        soft_round(st["base"][0], st["nu"], st["hard"], st["v"],
                   st["scale"], st["zero"], qmax=3)


# (E, ng_e, g, out): one leaf (E = 1) and an expert fold of 4 sharing one
# act_scale of length ng_e * g
ACT_CASES = [(1, 3, 8, 20), (4, 2, 8, 12)]


@pytest.mark.parametrize("dst", [True, False])
@pytest.mark.parametrize("shape", ACT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_act_scale_fused_plain_is_bit_identical(shape, dst):
    """With act_scale the plain forward is the plain function, then the
    division of the flat (E, in, out) weight by act_scale[:, None]; the
    plain backward is that division of the cotangent, then the plain
    backward: bit for bit, as the fused launch must be on the card."""
    E, ng_e, g, n = shape
    st = _t(_state(21 + E, E * ng_e, g, n, 3))
    rng = np.random.default_rng(E)
    act = torch.from_numpy((rng.random(ng_e * g) + 0.5).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal(
        (E * ng_e, g, n)).astype(np.float32))
    args = [st[k] for k in ORDER]
    flat = (E, ng_e * g, n)
    fused = soft_round(*args, qmax=7, dst=dst, act_scale=act)
    outside = (soft_round_plain(*args, qmax=7, dst=dst).reshape(flat)
               / act[:, None]).reshape(fused.shape)
    assert torch.equal(fused, outside)
    dnu, dv = soft_round_bwd(dout, *args, qmax=7, dst=dst, act_scale=act)
    pre = (dout.reshape(flat) / act[:, None]).reshape(dout.shape)
    wnu, wv = soft_round_bwd_plain(pre, *args, qmax=7, dst=dst)
    assert torch.equal(dnu, wnu)
    assert (dv is None and wv is None) or torch.equal(dv, wv)


@pytest.mark.parametrize("dst", [True, False])
def test_soft_weight_expert_stack_act_scale_matches_jax(dst):
    """The port's soft_weight under "pallas" (on the CPU: SoftRound over the
    plain versions, act_scale folded in) on an (E, in, out) expert stack
    with one shared act_scale, against the reference's soft_weight and
    jax.grad for ν and v, at the file's tolerances."""
    E, ng_e, g, n, bits = 4, 2, 8, 24, 2
    flat = _state(5, E * ng_e, g, n, bits)
    st = {k: (v.reshape((E, ng_e) + v.shape[1:]) if k not in ("v", "scale",
                                                               "zero")
              else v.reshape(E, ng_e, n)) for k, v in flat.items()}
    rng = np.random.default_rng(9)
    act = (rng.random(ng_e * g) + 0.5).astype(np.float32)
    cot = rng.standard_normal((E, ng_e * g, n)).astype(np.float32)
    qc_j = JQuantConfig(bits=bits, group_size=g)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    js["act_scale"] = jnp.asarray(act)

    def f(nu, v):
        w = jtq.soft_weight({**js, "nu": nu, "v": v}, qc_j, dst)
        return jnp.sum(w * jnp.asarray(cot)), w
    (_, jw), (jnu, jv) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        js["nu"], js["v"])
    qc = QuantConfig(bits=bits, group_size=g, kernel_backend="pallas")
    ts = _t(st)
    ts["nu"].requires_grad_(True)
    ts["v"].requires_grad_(True)
    ts["act_scale"] = torch.from_numpy(act)
    before = dict(build.LAUNCHES)
    w = ttq.soft_weight(ts, qc, dst)
    (w * torch.from_numpy(cot)).sum().backward()
    assert build.LAUNCHES == before          # a CPU tensor launches nothing
    assert tuple(w.shape) == (E, ng_e * g, n)
    qmax = (1 << bits) - 1
    s_eff = _s_eff(flat, dst)
    # θ̂ before the division: the forward tolerance, then one more rounding
    got = w.detach().numpy().astype(np.float64)
    want = np.asarray(jw, np.float64)
    lim = (4 * _ulp(np.maximum(np.abs(got), np.abs(want)))
           + 4 * _ulp(qmax + 1) * np.abs(s_eff).reshape(E, ng_e, 1, n)
           .repeat(g, 2).reshape(E, ng_e * g, n) / act[:, None])
    assert (np.abs(got - want) <= lim).all()
    dout = (cot / act[:, None]).reshape(E * ng_e, g, n).astype(np.float64)
    chain = np.abs(dout * s_eff)
    jnu = np.asarray(jnu, np.float64).reshape(E * ng_e, g, n)
    tnu = ts["nu"].grad.numpy().reshape(E * ng_e, g, n)
    assert (np.abs(tnu - jnu) <= 4 * _ulp(jnu) + 4 * 2.0 ** -24 * chain).all()
    if not dst:
        assert ts["v"].grad is None or not ts["v"].grad.any()
        return
    jv = np.asarray(jv, np.float64).reshape(E * ng_e, n)
    tv = ts["v"].grad.numpy().reshape(E * ng_e, n)
    alpha = np.where(flat["hard"] == 0, 1 / (1 + np.exp(-flat["nu"].astype(
        np.float64))), flat["hard"] > 0)
    z = flat["zero"][:, None, :]
    q = np.clip(flat["base"] + z + alpha, 0, qmax)
    terms = np.abs(dout * (q - z) * s_eff)
    lim_v = (4 * _ulp(jv) + 2.0 ** -16 * terms.sum(1)
             + 4 * _ulp(qmax + 1) * chain.sum(1))
    assert (np.abs(tv - jv) <= lim_v).all()


BAD_ACT = {
    "length": (lambda g: torch.ones(3 * g + 1), ValueError, "length"),
    "not_dividing": (lambda g: torch.ones(3 * g), ValueError, "length"),
    "2d": (lambda g: torch.ones(2, g), ValueError, "1-D"),
    "dtype": (lambda g: torch.ones(2 * g, dtype=torch.float64), TypeError,
              "act_scale must be"),
    "device": (lambda g: torch.ones(2 * g, device="meta"), ValueError,
               "act_scale is on"),
}


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("case", sorted(BAD_ACT))
def test_wrapper_rejects_bad_act_scale(case, bwd):
    st = _t(_state(0, 4, 4, 8, 2))
    make, err, match = BAD_ACT[case]
    args = [st[k] for k in ORDER]
    with pytest.raises(err, match=match):
        if bwd:
            soft_round_bwd(st["nu"], *args, qmax=3, act_scale=make(4))
        else:
            soft_round(*args, qmax=3, act_scale=make(4))


def test_launch_limits():
    """The grid is one-dimensional: ng is no longer held to 65535; the
    limits are C ints for ng, g, out and 2^31 - 1 blocks."""
    check_grid("t", 65536, 128, 4096)          # 2^21 blocks: accepted
    check_grid("t", 1, 11008, 4096)
    with pytest.raises(ValueError, match="limits"):
        check_grid("t", 2 ** 24, 1, 128 * 2 ** 7)   # 2^31 blocks
    with pytest.raises(ValueError, match="limits"):
        check_grid("t", 1, 2 ** 31, 4)
