"""The port's weight-activation path (``act_bits``: per-token activation
fake-quant in the dense and MoE forwards, calibration, perplexity and
serving) against the JAX reference on the same numpy inputs, on the CPU.

Against the reference:
* ``layers.fake_quant_act``: values equal, symmetric and asymmetric, f32 and
  bf16, all-zero tokens and tied extremes included; ``torch.autograd``
  equal to ``jax.grad`` of a scalar loss through it in f32.  The loss
  weights are small integers, so the backward's row sums are exact in any
  order (with real weights XLA and torch sum a row in different orders and
  differ by an f32 ulp);
* serving the reduced llama2 and qwen3 (f32, RTN W4 per-channel + pack)
  with ``act_bits`` 8 and 4 against the reference's ``"xla"`` backend (its
  ``"pallas"`` decode path cannot run on the installed jax, ROADMAP fault
  3.1), with an f32 KV cache in both packages: tokens equal, logits atol
  1e-4 (summation order only).  With the bf16 cache a k/v value that
  rounds to the neighbouring bf16 in one package moves an attention output
  by an ulp, and the A4 fake-quant can turn that into one quantization
  step: measured 0.67 on one request's logits of the reduced qwen3 with
  equal tokens, so the comparison uses the f32 cache (as the scheduled
  cross-package tests do);
* perplexity under ``Ctx(act_bits=4)``: rtol 1e-4; choice accuracy equal;
* one reduced f32 dense block at W4 per-channel under ``act_bits=4``: the
  captured linear inputs (fake-quantized where the reference's are), and
  TesseraQ K=3 / T=15 from one AWQ initialization: codes and hardened masks
  equal, as ``test_torch_calibration.py`` holds them at A16.

Within the port: scheduled serving (dense and paged) with ``act_bits``
equals serving each request alone, lock-step, with ``act_bits``; the CLI
passes ``A<act_bits>`` of ``--quant`` to both serve loops.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import blocks as jblocks  # noqa: E402
from repro.core import capture as jcap  # noqa: E402
from repro.core import pack_model as jpack_model  # noqa: E402
from repro.core import quantize_model as jquantize_model  # noqa: E402
from repro.core import tesseraq as jtq  # noqa: E402
from repro.data.pipeline import (DataConfig, SyntheticCorpus,  # noqa: E402
                                 calibration_batches, eval_batches)
from repro.eval.ppl import choice_accuracy as jchoice_accuracy  # noqa: E402
from repro.eval.ppl import perplexity as jperplexity  # noqa: E402
from repro.launch.serve import serve_requests as jserve  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.common import Ctx as JCtx  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import awq as tawq  # noqa: E402
from repro_torch.core import blocks as tblocks  # noqa: E402
from repro_torch.core import capture as tcap  # noqa: E402
from repro_torch.core import tesseraq as ttq  # noqa: E402
from repro_torch.eval.ppl import (choice_accuracy,  # noqa: E402
                                  make_choice_tasks, perplexity)
from repro_torch.launch import scheduler as tsched  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.scheduler import (make_workload,  # noqa: E402
                                          serve_scheduled)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.common import Ctx, make_ctx  # noqa: E402

CPU = dict(device="cpu")
QC = dict(bits=4, group_size=None)          # W4 per-channel, as Tables 3/10
B, PROMPT, GEN = 3, 12, 5
_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: faster for the thousands of tiny ops here, and
    no oversubscription of the cores parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------------
# fake_quant_act
# --------------------------------------------------------------------------

def _activations(seed):
    """(2, 7, 33) activations with an all-zero token, tied maxima, tied
    |x| maxima of both signs and tied minima."""
    x = (np.random.default_rng(seed).standard_normal((2, 7, 33)) * 3
         ).astype(np.float32)
    x[0, 2] = 0.0
    x[0, 3, :5] = x[0, 3].max()
    x[0, 4, :3] = -np.abs(x[0, 4]).max() - 1.0
    x[1, 1, :2] = np.abs(x[1, 1]).max() + 1.0
    x[1, 1, 2:4] = -x[1, 1, 0]
    x[1, 5, :4] = x[1, 5].min()
    return x


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_act_matches_reference(bits, symmetric, dt):
    jdt, tdt = _DTYPES[dt]
    xj = jnp.asarray(_activations(bits), jdt)
    want = np.array(JL.fake_quant_act(xj, bits, symmetric).astype(
        jnp.float32))
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = TL.fake_quant_act(x, bits, symmetric)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got[0, 2].float().numpy(), 0.0)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_act_gradient_matches_reference(bits, symmetric):
    """The gradient reaches x only through the scale, split evenly among
    tied extremes in both frameworks."""
    x = _activations(10 + bits)
    w = np.random.default_rng(bits).integers(-4, 5, x.shape).astype(
        np.float32)
    want = np.asarray(jax.grad(lambda z: jnp.sum(
        JL.fake_quant_act(z, bits, symmetric) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    torch.sum(TL.fake_quant_act(xt, bits, symmetric)
              * torch.from_numpy(w)).backward()
    assert np.count_nonzero(want) > 0
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_make_ctx_takes_act_bits():
    assert make_ctx(act_bits=4).act_bits == 4
    assert make_ctx().act_bits is None


# --------------------------------------------------------------------------
# serving and perplexity of the reduced configs, against the reference
# --------------------------------------------------------------------------

_REF = {}


def _calib(vocab):
    dc = DataConfig(vocab_size=vocab, seq_len=16, global_batch=2, seed=0)
    return [b["tokens"][:, :-1] for b in calibration_batches(dc, 2, 2)]


def _prompts(vocab):
    dc = DataConfig(vocab_size=vocab, seq_len=PROMPT, global_batch=B, seed=1)
    return SyntheticCorpus(dc).batch(0)["tokens"][:, :PROMPT]


def _reference(arch):
    """JAX f32 params, RTN W4 per-channel + pack, memoized."""
    if arch not in _REF:
        cfg = jget_reduced(arch).replace(dtype="float32")
        model = jget_model(cfg)
        params = model.init_params(jax.random.PRNGKey(0))
        calib = [{"tokens": jnp.asarray(t)} for t in _calib(cfg.vocab_size)]
        qcfg = JQuantConfig(**QC)
        pfq, qmeta, _ = jquantize_model(cfg, params, calib, qcfg,
                                        method="none", init="rtn")
        packed = jpack_model(cfg, pfq, qmeta, qcfg)
        _REF[arch] = dict(cfg=cfg, model=model, packed_j=packed,
                          packed=_np(packed), prompts=_prompts(cfg.vocab_size))
    return _REF[arch]


def _reference_serve(arch, act_bits):
    """The reference's ``"xla"`` lock-step serve on an f32 KV cache."""
    key = (arch, act_bits)
    if key not in _REF:
        ref = _reference(arch)
        jm = ref["model"]
        model = dataclasses.replace(
            jm, init_cache=lambda b, s, dtype=None: jm.init_cache(
                b, s, jnp.float32))
        res = jserve(ref["cfg"], model, ref["packed_j"], ref["prompts"],
                     gen=GEN, kernel_backend="xla", act_bits=act_bits)
        _REF[key] = (res.tokens, res.logits)
    return _REF[key]


def _f32_cache_model(cfg):
    m = get_model(cfg)
    return dataclasses.replace(
        m, init_cache=lambda b, s, dtype=None, device="cuda": m.init_cache(
            b, s, torch.float32, device))


ARCHS = ["llama2-7b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("act_bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_with_act_bits_matches_reference(arch, act_bits, backend):
    tokens, logits = _reference_serve(arch, act_bits)
    ref = _reference(arch)
    cfg = get_reduced_config(arch).replace(dtype="float32")
    model = _f32_cache_model(cfg)
    packed = params_to_torch(ref["packed"])
    res = tserve.serve_requests(cfg, model, packed, ref["prompts"], gen=GEN,
                                kernel_backend=backend, act_bits=act_bits,
                                **CPU)
    np.testing.assert_array_equal(res.tokens, tokens)
    np.testing.assert_allclose(res.logits, logits, atol=1e-4, rtol=0)
    # act_bits reached the forward: the logits move off A16's
    a16 = tserve.serve_requests(cfg, model, packed, ref["prompts"], gen=1,
                                kernel_backend=backend, **CPU)
    assert np.abs(a16.logits[:, 0] - res.logits[:, 0]).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_perplexity_with_act_bits_matches_reference(arch):
    """Perplexity (rtol 1e-4) and synthetic choice accuracy (equal) under
    ``Ctx(act_bits=4)``: the paper's W4A4 metrics."""
    ref = _reference(arch)
    dc = DataConfig(vocab_size=ref["cfg"].vocab_size, seq_len=16,
                    global_batch=2, seed=3)
    batches = eval_batches(dc, 2, 2)
    want = jperplexity(ref["cfg"], ref["packed_j"], batches,
                       JCtx(act_bits=4), backend="xla")
    cfg = get_reduced_config(arch).replace(dtype="float32")
    got = perplexity(cfg, params_to_torch(ref["packed"]), batches,
                     Ctx(act_bits=4), backend="pallas")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    a16 = perplexity(cfg, params_to_torch(ref["packed"]), batches,
                     backend="pallas")
    assert got != a16
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=1))
    tasks = make_choice_tasks(corpus, 6, 16)
    assert choice_accuracy(cfg, params_to_torch(ref["packed"]), tasks,
                           Ctx(act_bits=4), backend="pallas") == \
        jchoice_accuracy(ref["cfg"], ref["packed_j"], tasks,
                         JCtx(act_bits=4), backend="xla")


@pytest.mark.parametrize("act_bits", [8, 4])
@pytest.mark.parametrize("store", ["dense", "paged"])
def test_scheduled_with_act_bits_equals_serving_alone(store, act_bits):
    """Per-token quantization does not mix rows, so scheduled serving with
    act_bits (staggered arrivals, inactive slots) equals serving each
    request alone, lock-step, with the same act_bits."""
    ref = _reference("llama2-7b")
    cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
    m = get_model(cfg)
    packed = params_to_torch(ref["packed"])
    reqs = make_workload(cfg.vocab_size, n_requests=5, seed=3,
                         prompt_lens=(4, 10), budgets=(2, 7))
    sched = serve_scheduled(cfg, packed, reqs, slots=2, max_seq=24,
                            kernel_backend="pallas", act_bits=act_bits,
                            store=store, page_size=4, **CPU)
    for q in reqs:
        alone = tserve.serve_requests(
            cfg, m, packed, q.prompt[None], gen=q.max_new_tokens,
            max_seq=sched.max_seq, kernel_backend="pallas",
            act_bits=act_bits, collect_logits=False, **CPU)
        np.testing.assert_array_equal(
            alone.tokens[0], sched.requests[q.rid]["tokens"],
            err_msg=f"rid {q.rid} diverged from serving alone")


# --------------------------------------------------------------------------
# calibration of one reduced dense block under act_bits=4
# --------------------------------------------------------------------------

_BLOCK = {}


def _block_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.d_model // cfg.num_heads
    w = lambda i, o: (rng.standard_normal((i, o)) * i ** -0.5).astype(
        np.float32)
    return {"ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32),
            "wq": w(d, cfg.num_heads * hd), "wk": w(d, cfg.num_kv_heads * hd),
            "wv": w(d, cfg.num_kv_heads * hd), "wo": w(cfg.num_heads * hd, d),
            "w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}


def _block_reference():
    """The reduced llama2 block (f32) under ``act_bits=4``: both packages'
    captures, the port's AWQ initialization (W4 per-channel), and the
    reference's TesseraQ K=3 / T=15 from it.  Memoized."""
    if not _BLOCK:
        cfg = get_reduced_config("llama2-7b").replace(dtype="float32")
        jcfg = jget_reduced("llama2-7b").replace(dtype="float32")
        bp = _block_params(cfg)
        X = np.random.default_rng(1).standard_normal(
            (8, 16, cfg.d_model)).astype(np.float32)
        stage = tblocks.build_stages(cfg, Ctx(act_bits=4))[0]
        jstage = jblocks.build_stages(jcfg, JCtx(act_bits=4))[0]
        tbp = params_to_torch(bp)
        jbp = jax.tree_util.tree_map(jnp.asarray, bp)
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
            JQuantConfig(**QC, act_bits=4),
            jtq.TesseraQConfig(par_iterations=3, steps_per_iteration=15),
            log=log)
        _BLOCK.update(stage=stage, bp=tbp, X=tX, Y=torch.from_numpy(Y),
                      jY=np.asarray(jstage.apply(jbp, jnp.asarray(X), None)),
                      caps=caps, jcaps=jcaps, meta=meta, qm=qm, log=log)
    return _BLOCK


def test_block_forward_and_capture_under_act_bits_match_reference():
    """The A4 block forward, and every linear's captured input: the
    fake-quantized activations, grid values included (a sample row of
    ``wq``'s input takes at most 16 distinct values)."""
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
    assert len(np.unique(ref["caps"][("wq",)].sample[0].numpy())) <= 16


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_reconstruct_block_with_act_bits_matches_reference(backend):
    ref = _block_reference()
    log = []
    _, qm = ttq.reconstruct_block(
        ref["stage"].apply, ref["bp"], ref["X"], ref["Y"], None, ref["meta"],
        QuantConfig(**QC, act_bits=4, kernel_backend=backend),
        ttq.TesseraQConfig(par_iterations=3, steps_per_iteration=15), log=log)
    assert set(qm) == set(ref["qm"])
    for p, m in qm.items():
        want = ref["qm"][p]
        np.testing.assert_array_equal(m["codes"].numpy(),
                                      np.asarray(want["codes"]))
        np.testing.assert_array_equal(m["hard"].numpy(),
                                      np.asarray(want["hard"]))
        np.testing.assert_allclose(m["scale"].numpy(),
                                   np.asarray(want["scale"]), rtol=1e-4)
    np.testing.assert_allclose([e["loss"] for e in log],
                               [e["loss"] for e in ref["log"]], rtol=1e-3)
    assert log[-1]["soft_rate"] == 0.0


# --------------------------------------------------------------------------
# the CLI forwards act_bits to both serve loops
# --------------------------------------------------------------------------

_CLI = ["--arch", "llama2-7b", "--reduced", "--quant", "W4A8", "--method",
        "tesseraq", "--init", "awq", "--par-iters", "2", "--par-steps", "3",
        "--device", "cpu", "--requests", "3", "--prompt-len", "8", "--gen",
        "8"]


def _spy(monkeypatch, name):
    """Record ``tserve.<name>``'s arguments and result on each call."""
    calls = []
    orig = getattr(tserve, name)

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out))
        return out
    monkeypatch.setattr(tserve, name, spy)
    return calls


def test_cli_serves_w4a8_with_act_bits(monkeypatch, capsys):
    """``--quant W4A8 --method tesseraq`` serves with act_bits=8: its tokens
    and logits equal ``serve_requests(act_bits=8)`` on the packed params it
    built, and its logits differ from act_bits=None on them.  (The greedy
    tokens of this reduced random model are the same at A8 and A16 for the
    requests served here, 3 x 8 and also 4 x 16 tokens, so the A16 check
    reads the logits.)"""
    built = _spy(monkeypatch, "build_params")
    served = _spy(monkeypatch, "serve_requests")
    assert tserve.main(_CLI) == 0
    assert "calibrating llama2-smoke to W4A8" in capsys.readouterr().out
    (args, kw, res), = served
    assert kw["act_bits"] == 8
    packed = built[0][2][0]
    cfg, model, _, prompts = args
    again = tserve.serve_requests(cfg, model, packed, prompts, gen=8,
                                  kernel_backend="xla", act_bits=8, **CPU)
    a16 = tserve.serve_requests(cfg, model, packed, prompts, gen=8,
                                kernel_backend="xla", **CPU)
    np.testing.assert_array_equal(res.tokens, again.tokens)
    np.testing.assert_array_equal(res.logits, again.logits)
    assert np.abs(res.logits - a16.logits).max() > 1e-2


def test_cli_schedules_w4a8_with_act_bits(monkeypatch, capsys):
    calls = []
    orig = tsched.serve_scheduled

    def spy(*a, **k):
        calls.append(k)
        return orig(*a, **k)
    monkeypatch.setattr(tsched, "serve_scheduled", spy)
    assert tserve.main(_CLI + ["--slots", "2"]) == 0
    assert "scheduled 3 requests over 2 slots" in capsys.readouterr().out
    assert [k["act_bits"] for k in calls] == [8]
