"""The port's comparison methods (GPTQ with its Hessian capture, OmniQuant's
learnable weight clipping, SignRound with ``SignSGD``, QuaRot rotation)
against the JAX reference on the same numpy inputs, all on the CPU, plus
the reference's own contracts re-proved between port runs.

Tolerances, and why:
* Hessian: ``LinearStats`` fed the same rows, rtol 1e-6 (the same f32
  products, summed in another order); captured on one reduced f32 block,
  rtol 1e-5 of the largest entry (the block's f32 forward rounds
  differently in each package);
* ``_gptq_matrix`` at weights of the model's scale (d^-0.5): codes EQUAL,
  scales, zeros and the fake-quant weight within 1e-6 (the damped
  inverse and its Cholesky factor come from different LAPACK builds and
  differ by ~1e-6 relative; the walk carries that into the compensated
  rows; measured |Δfq| <= 2.1e-7).  The walk runs at torch's own
  intra-op thread count: MKL's single-threaded 512 x 512 inverse rounds
  differently, and there 6 of the 512 x 256 W4 case's 131,072 codes
  (0.005%) sit close enough to a rounding boundary to flip (equal at 2, 4
  and 8 threads).  A Hessian of rank below ``in`` makes the damped
  inverse ill-conditioned, so these inputs keep it full rank;
* ``_lwc_weight`` / ``_sr_weight``: values atol 1e-6, gradients (autograd
  against ``jax.grad``) rtol 1e-5 / atol 1e-6: the same f32 operations,
  ties on the clip bounds passing half the gradient in both;
* ``SignSGD.update``: equal (signs and a clip of the same f32 values);
* OmniQuant and SignRound ``reconstruct_block`` on one reduced f32 block,
  both packages handed the same initialization: codes equal, log losses
  rtol 1e-4 (f32 summation order in the block's forward and backward).
  OmniQuant runs at its default lr 1e-2: at the reference's test lr of
  5e-2 the loss oscillates past step ~100 and the two trajectories part
  (equal codes through step 100; 9.6% of w_down's codes apart at 150);
* ``hadamard`` bit-equal (the same numpy draws); ``rotate_params`` atol
  1e-6 (f32 matmuls in another order);
* ``quantize_model`` + ``pack_model`` on the reduced llama2 in f32: packed
  bytes equal for (none, gptq), (omniquant, rtn) and (tesseraq, gptq);
  for (signround, awq) at least 95% of the bytes (measured 97.7%): the
  packages' AWQ walks choose the same grid points, but their
  ``act_scale``s differ by an f32 ulp, and sign-SGD takes the sign of
  near-zero gradients, so a few perturbations move apart.  From one
  shared AWQ initialization the block test above holds SignRound's codes
  equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import blocks as jblocks  # noqa: E402
from repro.core import capture as jcap  # noqa: E402
from repro.core import gptq as jgptq  # noqa: E402
from repro.core import omniquant as jomni  # noqa: E402
from repro.core import pack_model as jpack_model  # noqa: E402
from repro.core import quantize_model as jquantize_model  # noqa: E402
from repro.core import recon_engine as JRE  # noqa: E402
from repro.core import rotation as jrot  # noqa: E402
from repro.core import signround as jsr  # noqa: E402
from repro.core.tesseraq import TesseraQConfig as JTCfg  # noqa: E402
from repro.data.pipeline import DataConfig, calibration_batches  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import awq as tawq  # noqa: E402
from repro_torch.core import blocks as tblocks  # noqa: E402
from repro_torch.core import capture as tcap  # noqa: E402
from repro_torch.core import gptq as tgptq  # noqa: E402
from repro_torch.core import omniquant as tomni  # noqa: E402
from repro_torch.core import quantizer as TQ  # noqa: E402
from repro_torch.core import recon_engine as TRE  # noqa: E402
from repro_torch.core import rotation as trot  # noqa: E402
from repro_torch.core import signround as tsr  # noqa: E402
from repro_torch.core.pipeline import pack_model, quantize_model  # noqa: E402
from repro_torch.core.rtn import quantize_block_rtn, rtn_leaf  # noqa: E402
from repro_torch.core.tesseraq import TesseraQConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


_THREADS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of tiny ops: one intra-op thread is faster for them and
    leaves the cores to the parallel test workers.  Restored after."""
    _THREADS["default"] = n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def default_threads():
    """torch's own intra-op thread count for one test (see the GPTQ
    note in the module docstring)."""
    torch.set_num_threads(_THREADS["default"])
    yield
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(seed, n_in, n_out, n=512, dead=False):
    """Inputs with a few dominant channels (GPTQ's regime) and a weight at
    the model's scale; ``dead`` zeroes one input channel."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, n_in)).astype(np.float32)
    X[:, :8] *= 15.0
    if dead:
        X[:, 5] = 0.0
    W = (rng.normal(size=(n_in, n_out)) * n_in ** -0.5).astype(np.float32)
    return X, W


def _stats(X):
    st = tcap.LinearStats()
    st.update(_t(X), want_hessian=True)
    return st


# -- Hessian capture -----------------------------------------------------------

def test_linear_stats_hessian_matches_reference():
    X, _ = _problem(0, 96, 8, n=900)
    js, ts = jcap.LinearStats(), tcap.LinearStats()
    for part in np.array_split(X.reshape(3, 300, -1), 3):
        js.update(part, True)
        ts.update(_t(part), want_hessian=True)
    np.testing.assert_allclose(ts.hessian.numpy(), js.hessian, rtol=1e-6,
                               atol=1e-6 * np.abs(js.hessian).max())
    assert tcap.LinearStats().hessian is None
    plain = tcap.LinearStats()
    plain.update(_t(X))
    assert plain.hessian is None


def _block_np(arch, seed=0):
    """Block 0 of the reduced ``arch`` in f32 from the reference's init, as
    numpy, and the (reference, port) stages."""
    jcfg = jget_reduced(arch).replace(dtype="float32")
    params = jget_model(jcfg).init_params(jax.random.PRNGKey(seed))
    jstage = jblocks.build_stages(jcfg)[0]
    bp = jax.tree_util.tree_map(np.asarray, jstage.get_block(params, 0))
    tstage = tblocks.build_stages(
        get_reduced_config(arch).replace(dtype="float32"))[0]
    return bp, jstage, tstage


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-moe-30b-a3b"])
def test_captured_hessians_match_reference(arch):
    bp, jstage, tstage = _block_np(arch)
    d = next(v for k, v in bp.items() if k == "wq").shape[0]
    X = np.random.default_rng(1).standard_normal((8, 16, d)).astype(
        np.float32)
    jcaps = jcap.capture_block_inputs(
        jstage.apply, jax.tree_util.tree_map(jnp.asarray, bp),
        [jnp.asarray(X[j:j + 4]) for j in (0, 4)], None, want_hessian=True)
    tcaps = tcap.capture_block_inputs(tstage.apply, params_to_torch(bp),
                                      list(torch.split(_t(X), 4)),
                                      want_hessian=True)
    assert set(tcaps) == set(jcaps)
    for p, js in jcaps.items():
        h = tcaps[p].hessian.numpy()
        assert h.shape == js.hessian.shape
        np.testing.assert_allclose(h, js.hessian, rtol=0,
                                   atol=1e-5 * np.abs(js.hessian).max())


# -- GPTQ ------------------------------------------------------------------------

GPTQ_CASES = {
    "256x128-W2-g32": (256, 128, 2, 32, False),
    "512x256-W4-g128": (512, 256, 4, 128, False),
    "256x128-W3-per-channel": (256, 128, 3, None, False),
    "256x128-W2-g32-dead-column": (256, 128, 2, 32, True),
    "384x96-W3-g48": (384, 96, 3, 48, False),       # groups start mid-block
}


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("case", list(GPTQ_CASES))
def test_gptq_matrix_matches_reference(case, stale, default_threads):
    n_in, n_out, bits, g, dead = GPTQ_CASES[case]
    X, W = _problem(0, n_in, n_out, dead=dead)
    H = X.T @ X
    want = jgptq._gptq_matrix(W, H, JQuantConfig(bits=bits, group_size=g),
                              stale_group_scales=stale)
    got = tgptq._gptq_matrix(_t(W), _t(H),
                             QuantConfig(bits=bits, group_size=g),
                             stale_group_scales=stale)
    assert got[3].dtype == torch.uint8
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    if dead:
        np.testing.assert_array_equal(got[0].numpy()[5], 0.0)


def test_gptq_leaf_expert_stack_matches_reference():
    """A reduced qwen3 expert leaf (E, in, out): every expert is walked with
    the stack's one Hessian (all experts' capacity rows, padding
    included).  Both packages take the reference's captured Hessian."""
    bp, jstage, tstage = _block_np("qwen3-moe-30b-a3b")
    X = np.random.default_rng(1).standard_normal((16, 32, 64)).astype(
        np.float32)
    jcaps = jcap.capture_block_inputs(
        jstage.apply, jax.tree_util.tree_map(jnp.asarray, bp),
        [jnp.asarray(X[j:j + 4]) for j in range(0, 16, 4)], None,
        want_hessian=True)
    path = ("moe", "w_gate")
    w = bp["moe"]["w_gate"]
    assert w.ndim == 3
    qc = dict(bits=2, group_size=32)
    fq_want, meta_want = jgptq.gptq_leaf(jnp.asarray(w), jcaps[path],
                                         JQuantConfig(**qc))
    st = tcap.LinearStats()
    st.hessian = _t(jcaps[path].hessian)
    fq, meta = tgptq.gptq_leaf(_t(w), st, QuantConfig(**qc))
    assert meta["codes"].shape == w.shape
    np.testing.assert_array_equal(meta["codes"].numpy(),
                                  np.asarray(meta_want["codes"]))
    np.testing.assert_allclose(fq.numpy(), np.asarray(fq_want), atol=1e-6)
    for k in ("scale", "zero"):
        np.testing.assert_allclose(meta[k].numpy(), np.asarray(meta_want[k]),
                                   atol=1e-6)
    assert meta["act_scale"] is None and meta["dst"] is None


def test_gptq_beats_rtn():
    """The reference's ``test_gptq_beats_rtn``, between two port runs."""
    X, W = _problem(0, 64, 32, n=256)
    X[:, :4] *= 20.0 / 15.0
    qcfg = QuantConfig(bits=3, group_size=None)
    y_ref = X @ W
    fq_rtn = TQ.fake_quantize(_t(W), qcfg).numpy()
    fq_gptq, _ = tgptq.gptq_leaf(_t(W), _stats(X), qcfg)
    e_rtn = np.mean((X @ fq_rtn - y_ref) ** 2)
    e_gptq = np.mean((X @ fq_gptq.numpy() - y_ref) ** 2)
    assert e_gptq < e_rtn


def test_gptq_group_scales_use_compensated_rows():
    """The reference's regression test: groups starting mid-block take
    their scale/zero from the compensated working rows, which moves the
    codes and reconstructs no worse than the stale rows."""
    g = 32
    assert g < tgptq.BLOCK
    qcfg = QuantConfig(bits=3, group_size=g)
    err_fixed = err_stale = 0.0
    codes_changed = False
    for seed in range(3):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(512, 2 * tgptq.BLOCK)).astype(np.float32)
        X[:, :8] *= 15.0
        W = rng.normal(size=(2 * tgptq.BLOCK, 48)).astype(np.float32)
        H = X.T @ X
        fq_f, _, _, codes_f = tgptq._gptq_matrix(_t(W), _t(H), qcfg)
        fq_s, _, _, codes_s = tgptq._gptq_matrix(_t(W), _t(H), qcfg,
                                                 stale_group_scales=True)
        err_fixed += np.mean((X @ fq_f.numpy() - X @ W) ** 2)
        err_stale += np.mean((X @ fq_s.numpy() - X @ W) ** 2)
        codes_changed |= not torch.equal(codes_f, codes_s)
    assert codes_changed
    assert err_fixed <= err_stale


def test_gptq_codes_reconstruct_weights():
    X, W = _problem(0, 64, 32, n=256)
    qcfg = QuantConfig(bits=4, group_size=16)
    fq, meta = tgptq.gptq_leaf(_t(W), _stats(X), qcfg)
    deq = TQ.dequantize_codes(meta["codes"].float(), meta["scale"],
                              meta["zero"], qcfg)
    np.testing.assert_allclose(deq.numpy(), fq.numpy(), rtol=1e-4, atol=1e-4)


def test_gptq_leaf_without_hessian_uses_the_row_sample():
    X, W = _problem(2, 64, 16, n=200)
    st = tcap.LinearStats()
    st.update(_t(X))                                # no Hessian
    fq, meta = tgptq.gptq_leaf(_t(W), st, QuantConfig(bits=3, group_size=16))
    fq2, meta2 = tgptq.gptq_leaf(_t(W), _stats(X),
                                 QuantConfig(bits=3, group_size=16))
    assert torch.equal(meta["codes"], meta2["codes"])
    fq3, _ = tgptq.gptq_leaf(_t(W), tcap.LinearStats(),
                             QuantConfig(bits=3, group_size=16))
    assert torch.isfinite(fq3).all()


# -- OmniQuant LWC and SignRound: the differentiable weights ----------------------

QC2 = dict(bits=2, group_size=16)


def _grads_jax(fn, args, R):
    return jax.grad(lambda *a: jnp.sum(fn(*a) * R),
                    argnums=tuple(range(len(args))))(*args)


def _grads_torch(fn, args, R):
    ts = [_t(a).requires_grad_() for a in args]
    (fn(*ts) * _t(R)).sum().backward()
    return [t.grad.numpy() for t in ts]


def test_lwc_weight_and_gradient_match_reference():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(64, 48)) * 0.125).astype(np.float32)
    g = rng.normal(3.0, 1.0, (4, 48)).astype(np.float32)
    b = rng.normal(3.0, 1.0, (4, 48)).astype(np.float32)
    R = rng.normal(size=w.shape).astype(np.float32)
    jq, tq = JQuantConfig(**QC2), QuantConfig(**QC2)
    want = jomni._lwc_weight(jnp.asarray(w), jnp.asarray(g), jnp.asarray(b),
                             jq)
    got = tomni._lwc_weight(_t(w), _t(g), _t(b), tq)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   atol=1e-6)
    jg = _grads_jax(lambda gg, bb: jomni._lwc_weight(jnp.asarray(w), gg, bb,
                                                     jq)[0],
                    (jnp.asarray(g), jnp.asarray(b)), R)
    tg = _grads_torch(lambda gg, bb: tomni._lwc_weight(_t(w), gg, bb, tq)[0],
                      (g, b), R)
    for a, e in zip(tg, jg):
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(a, np.asarray(e), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", [False, True], ids=["plain", "act_scale"])
def test_sr_weight_and_gradient_match_reference(act):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(64, 24)) * 0.125).astype(np.float32)
    jq, tq = JQuantConfig(bits=3, group_size=16), QuantConfig(bits=3,
                                                               group_size=16)
    _, meta = rtn_leaf(_t(w), tq)
    scale, zero = meta["scale"].numpy(), meta["zero"].numpy()
    a_s = (rng.uniform(0.5, 2.0, 64).astype(np.float32) if act else None)
    # some perturbations on and past the +-0.5 clip, as sign-SGD leaves them
    v = rng.uniform(-0.6, 0.6, (4, 16, 24)).astype(np.float32)
    on_clip = np.zeros(v.shape, bool)
    on_clip[0, 0, :4] = True
    v = np.where(on_clip, np.float32(0.5), v)
    R = rng.normal(size=w.shape).astype(np.float32)
    ja = None if a_s is None else jnp.asarray(a_s)
    ta = None if a_s is None else _t(a_s)
    want = jsr._sr_weight(jnp.asarray(w), jnp.asarray(v), jnp.asarray(scale),
                          jnp.asarray(zero), jq, ja)
    got = tsr._sr_weight(_t(w), _t(v), _t(scale), _t(zero), tq, ta)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   atol=1e-6)
    (jg,) = _grads_jax(lambda vv: jsr._sr_weight(
        jnp.asarray(w), vv, jnp.asarray(scale), jnp.asarray(zero), jq,
        ja)[0], (jnp.asarray(v),), R)
    (tg,) = _grads_torch(lambda vv: tsr._sr_weight(
        _t(w), vv, _t(scale), _t(zero), tq, ta)[0], (v,), R)
    assert np.abs(tg).max() > 0
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_clip_passes_half_the_gradient_on_its_bounds():
    x = torch.tensor([-1.0, 0.0, 1.5, 3.0, 4.0], requires_grad=True)
    TQ.clip(x, 0.0, 3.0).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 3.0)))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]


def test_signsgd_update_matches_reference():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.uniform(-0.5, 0.5, (5, 7)).astype(np.float32),
          "b": {"c": rng.uniform(-0.5, 0.5, 9).astype(np.float32)}}
    grads = [{"a": rng.normal(size=(5, 7)).astype(np.float32),
              "b": {"c": rng.normal(size=9).astype(np.float32)}}
             for _ in range(6)]
    grads[0]["a"][0, :3] = 0.0                      # sign 0: no move
    jopt = JRE.SignSGD(lr=0.2, total_steps=6, clip=0.5)
    topt = TRE.SignSGD(lr=0.2, total_steps=6, clip=0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = jax.tree_util.tree_map(_t, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(jax.tree_util.tree_map(_t, g), ts, tp)
    assert ts.dtype == torch.int32 and int(ts) == int(js) == 6
    np.testing.assert_array_equal(tp["a"].numpy(), np.asarray(jp["a"]))
    np.testing.assert_array_equal(tp["b"]["c"].numpy(),
                                  np.asarray(jp["b"]["c"]))
    assert float(tp["a"].abs().max()) <= 0.5


# -- OmniQuant and SignRound: one reduced block ---------------------------------------

_BLOCK = {}


def _block():
    """A reduced llama2 block (f32, random numpy weights at the model's
    scale), its calibration streams, and RTN / AWQ initializations made by
    the port (RTN and AWQ parity are tested elsewhere), handed to both
    packages.  Memoized."""
    if not _BLOCK:
        rng = np.random.default_rng(0)
        d, f = 64, 176
        w = lambda i, o: (rng.standard_normal((i, o)) * i ** -0.5).astype(
            np.float32)
        bp = {"ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32),
              "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
              "w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}
        X = np.random.default_rng(1).standard_normal((8, 16, d)).astype(
            np.float32)
        cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
        tstage = tblocks.build_stages(cfg)[0]
        jstage = jblocks.build_stages(
            jget_reduced("llama2-7b").replace(dtype="float32"))[0]
        tbp = params_to_torch(bp)
        with torch.no_grad():
            Y = tstage.apply(tbp, _t(X)).numpy()
        caps = tcap.capture_block_inputs(tstage.apply, tbp,
                                         list(torch.split(_t(X), 4)))
        metas = {"rtn": quantize_block_rtn(tbp, QuantConfig(**QC2))[1],
                 "awq": tawq.quantize_block_awq(tbp, caps,
                                                QuantConfig(**QC2))[1]}
        _BLOCK.update(bp=bp, tbp=tbp, X=X, Y=Y, tstage=tstage,
                      jstage=jstage, metas=metas)
    return _BLOCK


def _jmeta(meta):
    return {p: {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
                for k, v in m.items()} for p, m in meta.items()}


def _codes_equal(got, want):
    assert set(got) == set(want)
    for p in want:
        assert got[p]["codes"].dtype == torch.uint8
        np.testing.assert_array_equal(got[p]["codes"].numpy(),
                                      np.asarray(want[p]["codes"]))


def test_omniquant_block_matches_reference():
    b = _block()
    jlog, tlog = [], []
    jbp, jm = jomni.reconstruct_block(
        b["jstage"].apply, jax.tree_util.tree_map(jnp.asarray, b["bp"]),
        jnp.asarray(b["X"]), jnp.asarray(b["Y"]), None, JQuantConfig(**QC2),
        steps=150, log=jlog)
    tbp, tm = tomni.reconstruct_block(
        b["tstage"].apply, b["tbp"], _t(b["X"]), _t(b["Y"]), None,
        QuantConfig(**QC2), steps=150, log=tlog)
    _codes_equal(tm, jm)
    for p in jm:
        for k in ("scale", "zero"):
            np.testing.assert_allclose(tm[p][k].numpy(), np.asarray(jm[p][k]),
                                       rtol=1e-4, atol=1e-6)
        assert tm[p]["act_scale"] is None and tm[p]["dst"] is None
        np.testing.assert_allclose(tblocks.get_path(tbp, p).numpy(),
                                   np.asarray(jblocks.get_path(jbp, p)),
                                   rtol=0, atol=1e-5)
    assert [e["step"] for e in tlog] == [e["step"] for e in jlog] == [99, 149]
    np.testing.assert_allclose([e["loss"] for e in tlog],
                               [e["loss"] for e in jlog], rtol=1e-4)


@pytest.mark.parametrize("init", ["rtn", "awq"])
def test_signround_block_matches_reference(init):
    b = _block()
    meta = b["metas"][init]
    jlog, tlog = [], []
    _, jm = jsr.reconstruct_block(
        b["jstage"].apply, jax.tree_util.tree_map(jnp.asarray, b["bp"]),
        jnp.asarray(b["X"]), jnp.asarray(b["Y"]), None, _jmeta(meta),
        JQuantConfig(**QC2), steps=60, log=jlog)
    _, tm = tsr.reconstruct_block(
        b["tstage"].apply, b["tbp"], _t(b["X"]), _t(b["Y"]), None, meta,
        QuantConfig(**QC2), steps=60, log=tlog)
    _codes_equal(tm, jm)
    assert [e["step"] for e in tlog] == [e["step"] for e in jlog] == [49, 59]
    np.testing.assert_allclose([e["loss"] for e in tlog],
                               [e["loss"] for e in jlog], rtol=1e-4)
    for p in tm:
        assert tm[p]["act_scale"] is meta[p]["act_scale"]


def test_omniquant_lwc_improves_block():
    """The reference's ``test_omniquant_lwc_improves_block``, in the port."""
    rng = np.random.default_rng(0)
    d = 32
    bp = {"wq": _t(rng.normal(size=(d, d)).astype(np.float32))}
    X = rng.normal(size=(8, 6, d)).astype(np.float32)
    X[:, :, :2] *= 10

    def apply(b, x, aux=None):
        return x @ b["wq"]

    Y = np.einsum("nsd,df->nsf", X, bp["wq"].numpy())
    qcfg = QuantConfig(bits=2, group_size=16)
    bp_rtn, _ = quantize_block_rtn(bp, qcfg)
    e_rtn = np.mean((np.einsum("nsd,df->nsf", X, bp_rtn["wq"].numpy())
                     - Y) ** 2)
    bp_lwc, _ = tomni.reconstruct_block(apply, bp, _t(X), _t(Y), None, qcfg,
                                        steps=150, lr=5e-2, batch_size=4)
    e_lwc = np.mean((np.einsum("nsd,df->nsf", X, bp_lwc["wq"].numpy())
                     - Y) ** 2)
    assert e_lwc < e_rtn


def test_signround_codes_consistent():
    """The reference's ``test_signround_codes_consistent``, in the port."""
    rng = np.random.default_rng(1)
    w = _t(rng.normal(size=(32, 8)).astype(np.float32))
    qcfg = QuantConfig(bits=3, group_size=16)
    _, meta = rtn_leaf(w, qcfg)
    v = _t(rng.uniform(-0.4, 0.4, (2, 16, 8)).astype(np.float32))
    wq, q = tsr._sr_weight(w, v, meta["scale"], meta["zero"], qcfg)
    deq = TQ.dequantize_codes(q.reshape(32, 8), meta["scale"], meta["zero"],
                              qcfg)
    np.testing.assert_allclose(deq.numpy(), wq.numpy(), atol=1e-5)


def test_signround_improves_over_init():
    """The reference's ``test_signround_improves_over_init``, in the port
    (random weights from the port's own init)."""
    cfg = get_reduced_config("llama2-7b").replace(num_layers=2)
    params = get_model(cfg).init_params(0, "cpu")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                       (4, 24)))}]
    qcfg = QuantConfig(bits=2, group_size=32)
    tcfg = TesseraQConfig(par_iterations=2, steps_per_iteration=20)
    _, _, rep_awq = quantize_model(cfg, params, batches, qcfg,
                                   method="none", init="awq", tcfg=tcfg)
    _, _, rep_sr = quantize_model(cfg, params, batches, qcfg,
                                  method="signround", init="awq", tcfg=tcfg)
    e_awq = np.mean([b["recon_mse"] for b in rep_awq["blocks"]])
    e_sr = np.mean([b["recon_mse"] for b in rep_sr["blocks"]])
    assert e_sr < e_awq
    assert all(len(b["flips"]) == 7 for b in rep_sr["blocks"])
    assert [e["step"] for e in rep_sr["blocks"][0]["log"]] == [49]


# -- rotation ------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 48])
def test_hadamard_bit_equal(n):
    got = trot.hadamard(n, np.random.default_rng(3))
    want = jrot.hadamard(n, np.random.default_rng(3))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got @ got.T, np.eye(n), atol=1e-5)


def _f32_params(seed=0):
    jcfg = jget_reduced("llama2-7b").replace(dtype="float32")
    return jcfg, jget_model(jcfg).init_params(jax.random.PRNGKey(seed))


def test_rotate_params_matches_reference():
    jcfg, jp = _f32_params()
    cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
    want = jax.tree_util.tree_map(np.asarray, jrot.rotate_params(jp, jcfg, 1))
    got = trot.rotate_params(params_to_torch(
        jax.tree_util.tree_map(np.asarray, jp)), cfg, seed=1)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), got)))
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)


def test_rotate_params_refuses_other_families():
    cfg = get_reduced_config("qwen3-moe-30b-a3b")
    with pytest.raises(ValueError, match="dense"):
        trot.rotate_params({}, cfg)
    tied = get_reduced_config("llama2-7b").replace(tie_embeddings=True)
    with pytest.raises(ValueError, match="untied"):
        trot.rotate_params({}, tied)


def test_rotation_preserves_model_outputs():
    """The reference's ``test_rotation_preserves_model_outputs``, in the
    port."""
    cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
    m = get_model(cfg)
    p = m.init_params(0, "cpu")
    rp = trot.rotate_params(p, cfg, seed=0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        l0 = float(m.loss_fn(p, {"tokens": toks}))
        l1 = float(m.loss_fn(rp, {"tokens": toks}))
    assert abs(l0 - l1) < 1e-4
    assert not torch.equal(rp["blocks"]["wq"], p["blocks"]["wq"])


def test_rotation_reduces_weight_outliers():
    """The reference's ``test_rotation_reduces_weight_outliers``, in the
    port."""
    cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
    p = get_model(cfg).init_params(0, "cpu")
    blocks = dict(p["blocks"])
    wq = blocks["wq"].clone()
    wq[:, 3, :] *= 30.0
    blocks["wq"] = wq
    p = dict(p, blocks=blocks)
    rp = trot.rotate_params(p, cfg, seed=0)

    def kurt(a):
        a = a.reshape(-1)
        return float(a.abs().max() / a.std())

    assert kurt(rp["blocks"]["wq"]) < kurt(p["blocks"]["wq"])


# -- the walk + pack on the reduced llama2, against the reference ---------------------

WALKS = {"none-gptq": ("none", "gptq", 1.0),
         "omniquant-rtn": ("omniquant", "rtn", 1.0),
         "signround-awq": ("signround", "awq", 0.95),
         "tesseraq-gptq": ("tesseraq", "gptq", 1.0)}
WALK_QC = dict(bits=2, group_size=16)
WALK_T = dict(par_iterations=2, steps_per_iteration=10)
_WALK = {}


def _walk_inputs():
    """f32 reduced llama2 params (the reference's init) and 16 x 31-token
    calibration samples: 496 rows, so every linear's Hessian (w_down's
    176 inputs included) has full rank."""
    if not _WALK:
        jcfg, jp = _f32_params()
        dc = DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                        global_batch=4, seed=0)
        calib = [b["tokens"][:, :-1] for b in calibration_batches(dc, 4, 4)]
        _WALK.update(jcfg=jcfg, jp=jp, calib=calib,
                     np=jax.tree_util.tree_map(np.asarray, jp))
    return _WALK


@pytest.mark.parametrize("walk", list(WALKS))
def test_walk_and_pack_match_reference(walk):
    method, init, share = WALKS[walk]
    w = _walk_inputs()
    jq = JQuantConfig(**WALK_QC)
    jpq, jqm, jrep = jquantize_model(
        w["jcfg"], w["jp"], [{"tokens": jnp.asarray(c)} for c in w["calib"]],
        jq, method=method, init=init, tcfg=JTCfg(**WALK_T), omni_steps=40)
    want = jpack_model(w["jcfg"], jpq, jqm, jq)
    cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
    qc = QuantConfig(**WALK_QC)
    pq, qm, rep = quantize_model(
        cfg, params_to_torch(w["np"]),
        [{"tokens": _t(c.astype(np.int64))} for c in w["calib"]], qc,
        method=method, init=init, tcfg=TesseraQConfig(**WALK_T),
        omni_steps=40)
    got = pack_model(cfg, pq, qm, qc)
    same = total = 0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        a, b = got["blocks"][k], want["blocks"][k]
        np.testing.assert_array_equal(a.zero.numpy(), np.asarray(b.zero))
        same += int((a.packed.numpy() == np.asarray(b.packed)).sum())
        total += a.packed.numel()
        if share == 1.0:
            np.testing.assert_allclose(a.scale.numpy(), np.asarray(b.scale),
                                       rtol=1e-4)
    assert same / total >= share, f"{same}/{total} packed bytes equal"
    assert [(e["stage"], e["block"]) for e in rep["blocks"]] == [
        (e["stage"], e["block"]) for e in jrep["blocks"]]
    tol = 1e-4 if share == 1.0 else 5e-2
    np.testing.assert_allclose([e["recon_mse"] for e in rep["blocks"]],
                               [e["recon_mse"] for e in jrep["blocks"]],
                               rtol=tol)
    for e, je in zip(rep["blocks"], jrep["blocks"]):
        key = "iter" if method == "tesseraq" else "step"
        assert [x[key] for x in e["log"]] == [x[key] for x in je["log"]]
