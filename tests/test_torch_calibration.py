"""The port's calibration slice (AdamW, capture, AWQ, the reconstruction
engine, TesseraQ, the walk, perplexity) against the JAX reference on the
same inputs, all on the CPU (the soft_round kernels' plain versions).

Tolerances, and why:
* AdamW: rtol 1e-6 over 5 steps (the same float32 operations in the same
  order; libraries may differ by an ulp in sqrt and division);
* ``LinearStats``: sample rows equal; mean |x| rtol 1e-6 (sum order);
* AWQ: alpha and clip choices equal, codes equal, scales rtol 1e-6;
* hardening: masks bit-equal to the reference's ``harden_device`` and
  ``harden`` given the same ν and hard (ties included); ν under
  ``use_inf_freeze`` equal;
* index plan and chunk count: equal;
* ``reconstruct_block`` on one reduced float32 block, K=3, T=15, from one
  AWQ initialization handed to both packages: codes and
  hardened masks agree on >= 99.9% of elements and are asserted equal
  (they are on this input: the two trajectories differ only by float32
  rounding); DST-folded scales rtol 1e-4; the log's losses rtol 1e-3;
* the TesseraQ walk on the quickstart's toy model (trained briefly in JAX,
  carried over with ``bridge.params_to_torch``), from AWQ with
  ``input_source="fp"`` and from RTN with ``input_source="quant"``:
  per-block ``recon_mse`` rtol 1e-2, fake-quant and packed perplexity rtol
  1e-3; and the paper's ordering rtn > awq > tesseraq in the port.
"""
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
from repro.core import recon_engine as JRE  # noqa: E402
from repro.core import tesseraq as jtq  # noqa: E402
from repro.core.rtn import rtn_leaf as jrtn_leaf  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.eval.ppl import perplexity as jperplexity  # noqa: E402
from repro.launch.steps import make_train_harness  # noqa: E402
from repro.optim.adam import AdamW as JAdamW  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import awq as tawq  # noqa: E402
from repro_torch.core import blocks as tblocks  # noqa: E402
from repro_torch.core import capture as tcap  # noqa: E402
from repro_torch.core import recon_engine as TRE  # noqa: E402
from repro_torch.core import tesseraq as ttq  # noqa: E402
from repro_torch.core.pipeline import pack_model, quantize_model  # noqa: E402
from repro_torch.eval.ppl import perplexity  # noqa: E402
from repro_torch.optim.adam import AdamW  # noqa: E402

QC = dict(bits=2, group_size=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs thousands of tiny ops here; one intra-op thread is
    faster for them and does not oversubscribe the cores that parallel test
    workers and XLA share.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- AdamW -------------------------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adamw_matches_reference(wd):
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": {"c": rng.standard_normal(9).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": {"c": rng.standard_normal(9).astype(np.float32)}}
             for _ in range(5)]
    jopt, topt = JAdamW(lr=1e-2, weight_decay=wd), AdamW(lr=1e-2,
                                                         weight_decay=wd)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = jax.tree_util.tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(jax.tree_util.tree_map(torch.from_numpy, g), ts,
                             tp)
    assert int(ts.step) == int(js.step) == 5
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["b"]["c"].numpy(),
                                   np.asarray(want["b"]["c"]), rtol=1e-6)


# -- capture + AWQ -------------------------------------------------------------

def _skewed(seed=0, n_in=64, n_out=32, n=600):
    """Inputs with a few dominant channels, the regime AWQ exists for;
    600 rows in three updates exercise the 1024-row subsample cap."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, n_in)).astype(np.float32)
    X[:, :4] *= 20.0
    W = rng.normal(size=(n_in, n_out)).astype(np.float32)
    return X, W


def _stats_pair(X, parts=3):
    js, ts = jcap.LinearStats(), tcap.LinearStats()
    for chunk in np.array_split(X, parts):
        js.update(chunk, False)
        ts.update(torch.from_numpy(chunk))
    return js, ts


def test_linear_stats_match_reference():
    X, _ = _skewed(n=1500)
    js, ts = _stats_pair(X.reshape(3, 500, -1), parts=3)
    assert ts.count == js.count and ts.row_count == js.row_count == 1024
    np.testing.assert_array_equal(ts.sample.numpy(), js.sample)
    np.testing.assert_allclose(ts.mean_abs.numpy(), js.mean_abs, rtol=1e-6)


@pytest.mark.parametrize("bits,group", [(2, 16), (3, 32), (4, None)])
def test_awq_leaf_matches_reference(bits, group):
    X, W = _skewed(seed=bits)
    js, ts = _stats_pair(X)
    jfq, jm = jawq.awq_leaf(jnp.asarray(W), js,
                            JQuantConfig(bits=bits, group_size=group))
    tfq, tm = tawq.awq_leaf(torch.from_numpy(W), ts,
                            QuantConfig(bits=bits, group_size=group))
    assert (tm["alpha"], tm["clip"]) == (jm["alpha"], jm["clip"])
    np.testing.assert_array_equal(tm["codes"].numpy(), np.asarray(jm["codes"]))
    np.testing.assert_allclose(tm["scale"].numpy(), np.asarray(jm["scale"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(tm["zero"].numpy(), np.asarray(jm["zero"]))
    np.testing.assert_allclose(tm["act_scale"].numpy(),
                               np.asarray(jm["act_scale"]), rtol=1e-6)
    np.testing.assert_allclose(tfq.numpy(), np.asarray(jfq), rtol=1e-5,
                               atol=1e-6)


def test_awq_degenerate_stats_fall_back():
    """Every grid candidate scores NaN: the identity transform (alpha 0,
    clip 1) with a warning, as the reference does."""
    _, W = _skewed()
    qcfg = QuantConfig(bits=4, group_size=16)
    st = tcap.LinearStats()
    st.update(torch.full((8, W.shape[0]), float("nan")))
    with pytest.warns(UserWarning, match="no finite candidate"):
        fq, meta = tawq.awq_leaf(torch.from_numpy(W), st, qcfg)
    assert torch.isfinite(fq).all()
    assert (meta["alpha"], meta["clip"]) == (0.0, 1.0)
    np.testing.assert_allclose(meta["act_scale"].numpy(), 1.0)


# -- hardening, index plan ---------------------------------------------------------

def _leaf_states(seed, shape, tie_fraction):
    """The same leaf state in both packages (the port's carries the
    reference's ν, so the test isolates the hardening)."""
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
def test_harden_device_matches_reference(use_inf, tie_fraction):
    ja, ta = _leaf_states(0, (32, 8), tie_fraction)
    jb, tb = _leaf_states(1, (16, 12), tie_fraction)
    jdev = {("a",): ja, ("b",): jb}
    jnp_ = {p: dict(s) for p, s in jdev.items()}
    tdev = {("a",): ta, ("b",): tb}
    for rate in (0.9, 0.5, 0.2, 0.05, 0.0):
        jdev = JRE.harden_device(jdev, rate, use_inf=use_inf)
        jnp_ = jtq.harden(jnp_, rate, use_inf=use_inf)
        tdev = TRE.harden_device(tdev, rate, use_inf=use_inf)
        for p in tdev:
            got = tdev[p]["hard"].numpy()
            np.testing.assert_array_equal(got, np.asarray(jdev[p]["hard"]))
            np.testing.assert_array_equal(got, np.asarray(jnp_[p]["hard"]))
            np.testing.assert_array_equal(tdev[p]["nu"].numpy(),
                                          np.asarray(jdev[p]["nu"]))


def test_harden_device_noop_and_full_freeze():
    _, ts = _leaf_states(4, (32, 8), 0.0)
    once = TRE.harden_device({("w",): ts}, 0.5, use_inf=False)
    again = TRE.harden_device(once, 0.9, use_inf=False)      # nothing to do
    assert torch.equal(again[("w",)]["hard"], once[("w",)]["hard"])
    done = TRE.harden_device(once, 0.0, use_inf=False)
    assert (done[("w",)]["hard"] != 0).all()


@pytest.mark.parametrize("N,bs,steps,seed", [(32, 4, 7, 0), (12, 8, 5, 3),
                                             (7, 4, 3, 1), (16, 16, 2, 2)])
def test_index_plan_and_chunks_match_reference(N, bs, steps, seed):
    np.testing.assert_array_equal(TRE.draw_index_plan(N, bs, steps, seed),
                                  JRE.draw_index_plan(N, bs, steps, seed))
    assert TRE.grad_chunk_count(bs, N) == JRE.grad_chunk_count(bs, N)
    assert TRE.CANONICAL_LANE_CHUNKS == JRE.CANONICAL_LANE_CHUNKS


# -- reconstruct_block on one reduced block ----------------------------------------

_BLOCK = {}


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


def _block_reference():
    """The reduced llama2 block (f32) from numpy, its AWQ initialization by
    the port (AWQ parity is ``test_awq_leaf_matches_reference``), and the
    reference's TesseraQ K=3 / T=15 on the device engine from that same
    initialization.  Memoized."""
    if not _BLOCK:
        tcfg = get_reduced_config("llama2-7b").replace(dtype="float32")
        bp = _block_params(tcfg)
        X = np.random.default_rng(1).standard_normal(
            (8, 16, tcfg.d_model)).astype(np.float32)
        stage = tblocks.build_stages(tcfg)[0]
        tbp = params_to_torch(bp)
        tX = torch.from_numpy(X)
        with torch.no_grad():
            Y = stage.apply(tbp, tX).numpy()
        caps = tcap.capture_block_inputs(stage.apply, tbp,
                                         list(torch.split(tX, 4)))
        _, meta = tawq.quantize_block_awq(tbp, caps, QuantConfig(**QC))
        jstage = jblocks.build_stages(
            jget_reduced("llama2-7b").replace(dtype="float32"))[0]
        jmeta = {p: {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v)
                         else v) for k, v in m.items()}
                 for p, m in meta.items()}
        log = []
        _, qm = jtq.reconstruct_block(
            jstage.apply, jax.tree_util.tree_map(jnp.asarray, bp),
            jnp.asarray(X), jnp.asarray(Y), None, jmeta, JQuantConfig(**QC),
            jtq.TesseraQConfig(par_iterations=3, steps_per_iteration=15),
            log=log)
        _BLOCK.update(stage=stage, bp=tbp, X=tX, Y=torch.from_numpy(Y),
                      meta=meta, qm=qm, log=log)
    return _BLOCK


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_reconstruct_block_matches_reference(backend):
    ref = _block_reference()
    log = []
    TRE.reset_sync_count()
    _, qm = ttq.reconstruct_block(
        ref["stage"].apply, ref["bp"], ref["X"], ref["Y"], None, ref["meta"],
        QuantConfig(**QC, kernel_backend=backend),
        ttq.TesseraQConfig(par_iterations=3, steps_per_iteration=15), log=log)
    assert TRE.sync_count() == 3          # one host read per PAR iteration
    agree = total = 0
    for p, m in qm.items():
        want = ref["qm"][p]
        for key in ("codes", "hard"):
            agree += int((m[key].numpy() == np.asarray(want[key])).sum())
            total += m[key].numel()
        np.testing.assert_allclose(m["scale"].numpy(),
                                   np.asarray(want["scale"]), rtol=1e-4)
    assert agree / total >= 0.999
    for p, m in qm.items():
        np.testing.assert_array_equal(m["codes"].numpy(),
                                      np.asarray(ref["qm"][p]["codes"]))
        np.testing.assert_array_equal(m["hard"].numpy(),
                                      np.asarray(ref["qm"][p]["hard"]))
    assert [e["iter"] for e in log] == [0, 1, 2]
    np.testing.assert_allclose([e["loss"] for e in log],
                               [e["loss"] for e in ref["log"]], rtol=1e-3)
    np.testing.assert_allclose([e["soft_rate"] for e in log],
                               [e["soft_rate"] for e in ref["log"]],
                               rtol=1e-6)
    assert log[-1]["soft_rate"] == 0.0


def test_flip_stats_counts_changed_codes():
    before = {("w",): {"codes": torch.tensor([[0, 1], [2, 3]],
                                             dtype=torch.uint8)}}
    after = {("w",): {"codes": torch.tensor([[0, 2], [2, 0]],
                                            dtype=torch.uint8)}}
    assert ttq.flip_stats(before, after) == {
        ("w",): {"flipped": 2, "total": 4, "pct": 50.0}}


# -- the walk on the quickstart's toy model ----------------------------------------

_TOY = {}
# T is cut from the paper's 250 to 8 steps, so the learning rate is raised
# tenfold from its 1e-3 to let ν move further
TCFG = dict(par_iterations=3, steps_per_iteration=8, batch_size=4, lr=1e-2)
TOY = dict(num_layers=4, d_model=96, d_ff=256, vocab_size=512,
           dtype="float32")
# the fp walk starts from AWQ (the paper's path); the quant walk, which
# checks the compounding streams, starts from RTN to keep the reference's
# host-side AWQ search out of the test's time
WALKS = {"fp": "awq", "quant": "rtn"}


def _toy():
    """The quickstart's llama-family toy model, trained 60 steps in JAX (the
    quickstart's 120 at twice its learning rate), and the reference's
    TesseraQ walks on it (``WALKS``).  Memoized."""
    if not _TOY:
        cfg = jget_reduced("llama2-7b").replace(**TOY)
        data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=64, global_batch=8))
        harness = make_train_harness(cfg, None, lr=4e-3)
        params = harness.init_params(jax.random.PRNGKey(0))
        opt = harness.init_opt(params)
        step = jax.jit(harness.step_fn)  # reprolint: ok[jit-cache] — memoized fixture; compiled once
        for s in range(60):
            batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
            params, opt, _ = step(params, opt, batch)
        calib = [data.batch(10_000 + i)["tokens"][:4, :-1] for i in range(2)]
        evalb = [{"tokens": data.batch(20_000 + i)["tokens"]}
                 for i in range(2)]
        qc = JQuantConfig(bits=2, group_size=16)
        walks = {}
        for src, init in WALKS.items():
            pq, qmeta, rep = jquantize_model(
                cfg, params, [{"tokens": jnp.asarray(c)} for c in calib], qc,
                method="tesseraq", init=init, input_source=src,
                tcfg=jtq.TesseraQConfig(**TCFG))
            packed = jpack_model(cfg, pq, qmeta, qc)
            walks[src] = dict(
                mse=[b["recon_mse"] for b in rep["blocks"]],
                ppl=jperplexity(cfg, pq, evalb),
                ppl_packed=jperplexity(cfg, packed, evalb))
        _TOY.update(params=_np(params), calib=calib, evalb=evalb,
                    walks=walks, fp=jperplexity(cfg, params, evalb), port={})
    return _TOY


def _port_walk(method, init, src):
    """The port's walk on the bridged toy params, memoized per walk."""
    ref = _toy()
    key = (method, init, src)
    if key not in ref["port"]:
        cfg = get_reduced_config("llama2-7b").replace(**TOY)
        params = params_to_torch(ref["params"])
        qc = QuantConfig(bits=2, group_size=16, kernel_backend="pallas")
        calib = [{"tokens": torch.from_numpy(c.astype(np.int64))}
                 for c in ref["calib"]]
        pq, qmeta, rep = quantize_model(cfg, params, calib, qc,
                                        method=method, init=init,
                                        input_source=src,
                                        tcfg=ttq.TesseraQConfig(**TCFG))
        packed = pack_model(cfg, pq, qmeta, qc)
        ref["port"][key] = dict(
            mse=[b["recon_mse"] for b in rep["blocks"]],
            ppl=perplexity(cfg, pq, ref["evalb"]),
            ppl_packed=perplexity(cfg, packed, ref["evalb"],
                                  backend="pallas"),
            report=rep)
    return ref["port"][key]


@pytest.mark.parametrize("src", list(WALKS))
def test_tesseraq_walk_on_trained_toy_matches_reference(src):
    ref = _toy()["walks"][src]
    got = _port_walk("tesseraq", WALKS[src], src)
    np.testing.assert_allclose(got["mse"], ref["mse"], rtol=1e-2)
    np.testing.assert_allclose(got["ppl"], ref["ppl"], rtol=1e-3)
    np.testing.assert_allclose(got["ppl_packed"], ref["ppl_packed"],
                               rtol=1e-3)
    np.testing.assert_allclose(got["ppl_packed"], got["ppl"], rtol=1e-3)
    rep = got["report"]
    assert [(b["stage"], b["block"]) for b in rep["blocks"]] == [
        ("decoder", i) for i in range(4)]
    for b in rep["blocks"]:
        assert [e["iter"] for e in b["log"]] == [0, 1, 2]
        assert b["log"][-1]["soft_rate"] == 0.0
        assert len(b["flips"]) == 7
        assert set(b.get("awq", b["flips"])) == set(b["flips"])


def test_port_orders_ptq_methods_on_trained_toy():
    """The paper's ordering, in the port: rtn > awq > tesseraq perplexity
    at W2 g16, all above the FP model's."""
    rtn = _port_walk("none", "rtn", "fp")["ppl"]
    awq = _port_walk("none", "awq", "fp")["ppl"]
    tq = _port_walk("tesseraq", "awq", "fp")["ppl"]
    assert _toy()["fp"] <= tq < awq < rtn


def test_choice_accuracy_matches_reference():
    """The synthetic multiple-choice tasks are the same numpy draws in both
    packages, and the trained toy's accuracy on them is equal."""
    from repro.eval.ppl import choice_accuracy as jchoice
    from repro.eval.ppl import make_choice_tasks as jtasks
    from repro_torch.eval.ppl import choice_accuracy, make_choice_tasks
    ref = _toy()
    cfg = get_reduced_config("llama2-7b").replace(**TOY)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                        global_batch=1))
    tasks = make_choice_tasks(corpus, 6, 32)
    want = jtasks(corpus, 6, 32)
    for a, b in zip(tasks, want, strict=True):
        assert a["answer"] == b["answer"]
        for x, y in zip(a["choices"], b["choices"], strict=True):
            np.testing.assert_array_equal(x, y)
    jparams = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    acc = choice_accuracy(cfg, params_to_torch(ref["params"]), tasks)
    assert acc == jchoice(jget_reduced("llama2-7b").replace(**TOY), jparams,
                          want)


def test_loss_fn_matches_reference_with_loss_mask():
    """The training loss (next-token cross entropy in f32) with and without
    a loss mask, on the trained toy: rtol 1e-5 (f32 sums in another
    order)."""
    from repro.models import get_model as jget_model
    from repro_torch.models import get_model
    ref = _toy()
    jcfg = jget_reduced("llama2-7b").replace(**TOY)
    tokens = ref["evalb"][0]["tokens"][:3]
    mask = (np.random.default_rng(5).random(tokens.shape) < 0.6).astype(
        np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    tparams = params_to_torch(ref["params"])
    model = get_model(get_reduced_config("llama2-7b").replace(**TOY))
    for batch in ({"tokens": tokens}, {"tokens": tokens, "loss_mask": mask}):
        want = float(jget_model(jcfg).loss_fn(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
        with torch.no_grad():
            got = float(model.loss_fn(
                tparams, {k: torch.from_numpy(np.array(v))
                          for k, v in batch.items()}))
        np.testing.assert_allclose(got, want, rtol=1e-5)
