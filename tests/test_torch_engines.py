"""The port's host-loop reconstruction engines (``"reference"`` and
``"legacy"``) against its device engine and against the JAX reference, all
on the CPU (the soft_round kernels' plain versions).

* ``"reference"`` against ``"device"`` on one reduced float32 llama block
  (AWQ initialization, K=3, T=10), under both backends: codes, hardened
  masks and DST-folded scales equal bit for bit, and the log equal (the
  same minibatches, threshold and step arithmetic; only where they are
  gathered and how the threshold is found differ).
* ``"legacy"`` against ``"device"``: codes and masks equal, folded scales
  within rtol 1e-5 (the reference's own bound between its legacy and
  device engines: one batch-mean backward against the canonical per-sample
  reduction changes the f32 rounding of the gradient only).
* The host syncs each engine makes, counted by ``host_read``,
  ``host_stage`` and ``host_push``: one per PAR iteration on the device
  engine; the host loop's reads and pushes, exactly.
* The port's NumPy ``harden`` against the reference's and the port's
  device sort, ties and ``use_inf_freeze`` included: masks and ν equal.
* The port's ``"reference"`` engine against the JAX ``"reference"`` engine
  on a two-linear block from one RTN initialization: codes and masks
  equal, folded scales rtol 1e-4 (the two packages' f32 arithmetic differs
  in summation order).
* OmniQuant and SignRound on the host loop against ``"device"``: codes
  equal; OmniQuant's scales rtol 1e-5, SignRound's (its initialization's)
  equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import tesseraq as jtq  # noqa: E402
from repro.core.rtn import rtn_leaf as jrtn_leaf  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import awq as tawq  # noqa: E402
from repro_torch.core import blocks as tblocks  # noqa: E402
from repro_torch.core import capture as tcap  # noqa: E402
from repro_torch.core import omniquant as tomni  # noqa: E402
from repro_torch.core import recon_engine as TRE  # noqa: E402
from repro_torch.core import signround as tsr  # noqa: E402
from repro_torch.core import tesseraq as ttq  # noqa: E402
from repro_torch.core.rtn import rtn_leaf  # noqa: E402

QC = dict(bits=2, group_size=32)
K, T = 3, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_params(cfg, seed=0):
    """One decoder block of ``cfg`` as numpy arrays (random weights)."""
    rng = np.random.default_rng(seed)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.d_model // cfg.num_heads
    w = lambda i, o: (rng.standard_normal((i, o)) * i ** -0.5).astype(
        np.float32)
    return {"ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32),
            "wq": w(d, cfg.num_heads * hd), "wk": w(d, cfg.num_kv_heads * hd),
            "wv": w(d, cfg.num_kv_heads * hd), "wo": w(cfg.num_heads * hd, d),
            "w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}


_BLOCK = {}


def _block():
    """The reduced llama2 block (f32), its streams and its AWQ
    initialization by the port.  Memoized."""
    if not _BLOCK:
        cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
        stage = tblocks.build_stages(cfg)[0]
        bp = params_to_torch(_block_params(cfg))
        X = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (8, 16, cfg.d_model)).astype(np.float32))
        with torch.no_grad():
            Y = stage.apply(bp, X)
        caps = tcap.capture_block_inputs(stage.apply, bp,
                                         list(torch.split(X, 4)))
        _, meta = tawq.quantize_block_awq(bp, caps, QuantConfig(**QC))
        _BLOCK.update(stage=stage, bp=bp, X=X, Y=Y, meta=meta)
    return _BLOCK


_RUNS = {}


def _run(engine, backend):
    """``reconstruct_block`` on the block with ``engine``: (qmeta, log,
    host syncs).  Memoized."""
    key = (engine, backend)
    if key not in _RUNS:
        b = _block()
        log = []
        TRE.reset_sync_count()
        _, qm = ttq.reconstruct_block(
            b["stage"].apply, b["bp"], b["X"], b["Y"], None, b["meta"],
            QuantConfig(**QC, kernel_backend=backend),
            ttq.TesseraQConfig(par_iterations=K, steps_per_iteration=T,
                               engine=engine), log=log)
        _RUNS[key] = (qm, log, TRE.sync_count())
    return _RUNS[key]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_reference_engine_equals_device_bit_for_bit(backend):
    dev, dlog, _ = _run("device", backend)
    ref, rlog, _ = _run("reference", backend)
    assert set(ref) == set(dev)
    for p in dev:
        for key in ("codes", "hard", "scale", "dst"):
            assert torch.equal(ref[p][key], dev[p][key]), (p, key)
    # the losses bit for bit; the soft rate is an f32 division on the
    # device engine and a Python one on the host loop
    assert [(e["iter"], e["loss"]) for e in rlog] == \
        [(e["iter"], e["loss"]) for e in dlog]
    np.testing.assert_allclose([e["soft_rate"] for e in rlog],
                               [e["soft_rate"] for e in dlog], rtol=1e-6)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_legacy_engine_codes_equal_device(backend):
    dev, dlog, _ = _run("device", backend)
    leg, llog, _ = _run("legacy", backend)
    for p in dev:
        for key in ("codes", "hard"):
            assert torch.equal(leg[p][key], dev[p][key]), (p, key)
        np.testing.assert_allclose(leg[p]["scale"].numpy(),
                                   dev[p]["scale"].numpy(), rtol=1e-5)
    np.testing.assert_allclose([e["soft_rate"] for e in llog],
                               [e["soft_rate"] for e in dlog], rtol=1e-6)
    np.testing.assert_allclose([e["loss"] for e in llog],
                               [e["loss"] for e in dlog], rtol=1e-4)


def test_host_syncs_per_engine():
    """Device: the log line alone.  Host loop: the streams once; per PAR
    iteration the harden's three reads and one push a linear, two pushes a
    step, the log's loss and one read of each mask."""
    n = len(_block()["meta"])
    assert _run("device", "xla")[2] == K
    want = 2 + K * (3 * n + n + 2 * T + 1 + n)
    assert _run("reference", "xla")[2] == want
    assert _run("legacy", "xla")[2] == want


def _leaf_states(seed, shape, tie_fraction):
    """One leaf's TesseraQ state in both packages from the same ν (a share
    of ties copied in), after RTN."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    if tie_fraction:
        flat = w.reshape(-1)
        n = int(flat.size * tie_fraction)
        flat[n:2 * n] = flat[:n]
    qc = JQuantConfig(bits=2, group_size=16)
    _, meta = jrtn_leaf(jnp.asarray(w), qc)
    jst = jtq._leaf_state(jnp.asarray(w), meta, qc)
    tst = {k: (None if v is None else torch.from_numpy(np.array(v)))
           for k, v in jst.items()}
    return jst, tst


@pytest.mark.parametrize("use_inf", [False, True])
@pytest.mark.parametrize("tie_fraction", [0.0, 0.25])
def test_numpy_harden_matches_reference_and_device(use_inf, tie_fraction):
    """The port's NumPy ``harden`` against the reference's and against the
    port's device sort, over a schedule down to 0, ties included."""
    ja, ta = _leaf_states(0, (32, 8), tie_fraction)
    jb, tb = _leaf_states(1, (16, 12), tie_fraction)
    jst = {("a",): ja, ("b",): jb}
    tst = {("a",): ta, ("b",): tb}
    dst = {p: dict(s) for p, s in tst.items()}
    for rate in (0.9, 0.5, 0.2, 0.05, 0.0):
        jst = jtq.harden(jst, rate, use_inf=use_inf)
        tst = ttq.harden(tst, rate, use_inf=use_inf)
        dst = TRE.harden_device(dst, rate, use_inf=use_inf)
        for p in tst:
            assert tst[p]["hard"].dtype == torch.int8
            np.testing.assert_array_equal(tst[p]["hard"].numpy(),
                                          np.asarray(jst[p]["hard"]))
            assert torch.equal(tst[p]["hard"], dst[p]["hard"])
            np.testing.assert_array_equal(tst[p]["nu"].numpy(),
                                          np.asarray(jst[p]["nu"]))
            assert torch.equal(tst[p]["nu"], dst[p]["nu"])


def _two_linear_apply_jax(bp, x, aux=None):
    return jax.nn.silu(x @ bp["w_up"]) @ bp["w_down"]


def _two_linear_apply(bp, x, aux=None):
    return torch.nn.functional.silu(x @ bp["w_up"]) @ bp["w_down"]


def test_reference_engine_matches_jax_reference_engine():
    rng = np.random.default_rng(5)
    d, f = 64, 96
    bp = {"w_up": (rng.standard_normal((d, f)) * d ** -0.5).astype(
              np.float32),
          "w_down": (rng.standard_normal((f, d)) * f ** -0.5).astype(
              np.float32)}
    X = rng.standard_normal((8, 12, d)).astype(np.float32)
    tbp = params_to_torch(bp)
    tX = torch.from_numpy(X)
    with torch.no_grad():
        Y = _two_linear_apply(tbp, tX)
    qc = QuantConfig(**QC)
    meta = {(k,): rtn_leaf(tbp[k], qc)[1] for k in bp}
    jmeta = {p: {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
                 for k, v in m.items()} for p, m in meta.items()}
    tcfg = dict(par_iterations=K, steps_per_iteration=T, engine="reference")
    _, want = jtq.reconstruct_block(
        _two_linear_apply_jax, jax.tree_util.tree_map(jnp.asarray, bp),
        jnp.asarray(X), jnp.asarray(Y.numpy()), None, jmeta,
        JQuantConfig(**QC), jtq.TesseraQConfig(**tcfg))
    _, got = ttq.reconstruct_block(_two_linear_apply, tbp, tX, Y, None, meta,
                                   qc, ttq.TesseraQConfig(**tcfg))
    for p in got:
        for key in ("codes", "hard"):
            np.testing.assert_array_equal(got[p][key].numpy(),
                                          np.asarray(want[p][key]))
        np.testing.assert_allclose(got[p]["scale"].numpy(),
                                   np.asarray(want[p]["scale"]), rtol=1e-4)


@pytest.mark.parametrize("engine", ["reference", "legacy"])
def test_omniquant_and_signround_host_loop_match_device(engine):
    b = _block()
    qc = QuantConfig(**QC)
    for name, run in (
            ("omniquant", lambda e, log: tomni.reconstruct_block(
                b["stage"].apply, b["bp"], b["X"], b["Y"], None, qc,
                steps=20, engine=e, log=log)),
            ("signround", lambda e, log: tsr.reconstruct_block(
                b["stage"].apply, b["bp"], b["X"], b["Y"], None, b["meta"],
                qc, steps=20, engine=e, log=log))):
        dlog, hlog = [], []
        _, dev = run("device", dlog)
        _, host = run(engine, hlog)
        for p in dev:
            assert torch.equal(host[p]["codes"], dev[p]["codes"]), (name, p)
            np.testing.assert_allclose(host[p]["scale"].numpy(),
                                       dev[p]["scale"].numpy(), rtol=1e-5)
        # the device engine logs each chunk's last step, the host loop
        # steps 0, 100, ... (OmniQuant) or 0, 50, ... (SignRound)
        assert [e["step"] for e in dlog] == [19]
        assert [e["step"] for e in hlog] == [0]
