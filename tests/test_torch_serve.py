"""The port's serving slice end to end against the JAX reference.

For each reduced dense config: JAX ``init_params`` -> JAX
``quantize_model(method="none", init="rtn")`` -> ``pack_model`` (the eval
harness's ``rtn`` row), bridged into the port; both packages then serve the
same prompts with ``serve_requests``.  The reference runs its ``"xla"``
backend: its ``"pallas"`` decode path cannot run on the installed jax
(ROADMAP fault 3.1).

Tolerances:
* f32 model, port ``"pallas"`` (plain versions): atol 1e-4 on logits
  (summation order only; the KV cache is bf16 in both packages) and equal
  tokens;
* f32 model, port ``"xla"``: atol 1e-4, as above;
* bf16 model, port ``"xla"``: the same operations as the reference in the
  same dtype, but XLA's CPU backend fuses bf16 elementwise chains in f32
  and computes ``silu`` its own way, so rounding points differ by an ulp
  per op (the matmuls, norms and RoPE agree bit for bit).  Measured up to
  0.039 on logits of magnitude ~1 (about 5 bf16 ulps); held to atol 4e-2 /
  rtol 1e-2 with equal tokens;
* bf16 model, port ``"pallas"``: the kernels round the f32-dequantized
  weight to bf16 where the ``"xla"`` path dequantizes in bf16, so the
  reference's own cross-backend gate applies (``parity_gate`` atol 5e-2 /
  rtol 2e-2), with equal tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import pack_model as jpack_model  # noqa: E402
from repro.core import quantize_model as jquantize_model  # noqa: E402
from repro.data.pipeline import (DataConfig, SyntheticCorpus,  # noqa: E402
                                 calibration_batches)
from repro.eval.harness import parity_gate as jparity_gate  # noqa: E402
from repro.launch.serve import serve_requests as jserve  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core.pipeline import pack_model, quantize_model  # noqa: E402
from repro_torch.core.tesseraq import TesseraQConfig  # noqa: E402
from repro_torch.eval.harness import parity_gate  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

ARCHS = ["llama2-7b", "tinyllama-1.1b"]
QTAG = dict(bits=2, group_size=32)
B, PROMPT, GEN = 3, 12, 5


def _calib(vocab):
    dc = DataConfig(vocab_size=vocab, seq_len=16, global_batch=2, seed=0)
    return [b["tokens"][:, :-1] for b in calibration_batches(dc, 2, 2)]


def _prompts(vocab):
    dc = DataConfig(vocab_size=vocab, seq_len=PROMPT, global_batch=B, seed=1)
    return SyntheticCorpus(dc).batch(0)["tokens"][:, :PROMPT]


_CACHE = {}


def _reference(arch, dtype):
    """JAX params, RTN+pack artifacts and xla-backend serve, memoized."""
    key = (arch, dtype)
    if key not in _CACHE:
        cfg = jget_reduced(arch).replace(dtype=dtype)
        model = jget_model(cfg)
        params = model.init_params(jax.random.PRNGKey(0))
        calib = [{"tokens": jax.numpy.asarray(t)} for t in _calib(cfg.vocab_size)]
        qcfg = JQuantConfig(**QTAG)
        pfq, qmeta, report = jquantize_model(cfg, params, calib, qcfg,
                                             method="none", init="rtn")
        packed = jpack_model(cfg, pfq, qmeta, qcfg)
        prompts = _prompts(cfg.vocab_size)
        res = jserve(cfg, model, packed, prompts, gen=GEN,
                     kernel_backend="xla")
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        _CACHE[key] = dict(params=to_np(params), packed=to_np(packed),
                           report=report, prompts=prompts,
                           logits=res.logits, tokens=res.tokens)
    return _CACHE[key]


def _port_serve(arch, dtype, backend):
    ref = _reference(arch, dtype)
    cfg = get_reduced_config(arch).replace(dtype=dtype)
    packed = params_to_torch(ref["packed"], "cpu")
    res = tserve.serve_requests(cfg, get_model(cfg), packed, ref["prompts"],
                                gen=GEN, kernel_backend=backend,
                                device="cpu")
    return ref, res


@pytest.mark.parametrize("arch", ARCHS)
def test_port_rtn_and_pack_match_reference(arch):
    """The port's own RTN walk + pack on the bridged FP params gives the
    reference's packed bytes, scale/zero and per-block recon error."""
    ref = _reference(arch, "bfloat16")
    cfg = get_reduced_config(arch)
    params = params_to_torch(ref["params"], "cpu")
    calib = [{"tokens": torch.from_numpy(t.astype(np.int64))}
             for t in _calib(cfg.vocab_size)]
    qcfg = QuantConfig(**QTAG)
    pfq, qmeta, report = quantize_model(cfg, params, calib, qcfg,
                                        method="none", init="rtn")
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        got, want = packed["blocks"][name], ref["packed"]["blocks"][name]
        assert got.group_size == want.group_size and got.bits == want.bits
        np.testing.assert_array_equal(got.packed.numpy(), want.packed)
        np.testing.assert_allclose(got.scale.numpy(), want.scale, rtol=1e-6)
        np.testing.assert_array_equal(got.zero.numpy(), want.zero)
    # the FP block stack of the caller is untouched
    np.testing.assert_array_equal(
        params["blocks"]["wq"].float().numpy(),
        np.asarray(ref["params"]["blocks"]["wq"], np.float32))
    assert set(report) == set(ref["report"])
    got_mse = [b["recon_mse"] for b in report["blocks"]]
    want_mse = [b["recon_mse"] for b in ref["report"]["blocks"]]
    np.testing.assert_allclose(got_mse, want_mse, rtol=5e-2)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_f32_matches_reference(arch, backend):
    ref, res = _port_serve(arch, "float32", backend)
    np.testing.assert_allclose(res.logits, ref["logits"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(res.tokens, ref["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_xla_bf16_matches_reference(arch):
    ref, res = _port_serve(arch, "bfloat16", "xla")
    np.testing.assert_allclose(res.logits, ref["logits"], atol=4e-2,
                               rtol=1e-2)
    np.testing.assert_array_equal(res.tokens, ref["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_pallas_bf16_passes_parity_gate(arch):
    ref, res = _port_serve(arch, "bfloat16", "pallas")
    gate = parity_gate(res.logits, ref["logits"], atol=5e-2, rtol=2e-2)
    assert gate == jparity_gate(res.logits, ref["logits"], atol=5e-2,
                                rtol=2e-2)
    assert gate["ok"], gate
    np.testing.assert_array_equal(res.tokens, ref["tokens"])


def test_cli_serves_on_cpu(capsys):
    assert tserve.main(["--arch", "llama2-7b", "--reduced", "--method",
                        "none", "--device", "cpu", "--requests", "2",
                        "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "2 requests x 3 tokens" in out and "req1:" in out


@pytest.mark.parametrize("store", ["dense", "paged"])
def test_cli_schedules_on_cpu(capsys, store):
    assert tserve.main(["--arch", "tinyllama-1.1b", "--reduced", "--method",
                        "none", "--device", "cpu", "--requests", "4",
                        "--prompt-len", "12", "--gen", "5", "--slots", "2",
                        "--store", store, "--page-size", "4"]) == 0
    out = capsys.readouterr().out
    assert "scheduled 4 requests over 2 slots" in out and "req3:" in out
    assert f"{store} cache:" in out
    if store == "paged":
        assert "pages x 4 tokens" in out and "refused 0" in out


@pytest.mark.parametrize("argv", [["--method", "none", "--tp", "2"]],
                         ids=["tp"])
def test_cli_refuses_paths_not_ported(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.main(["--reduced", "--device", "cpu"] + argv)


@pytest.mark.parametrize("argv", [
    ["--method", "tesseraq", "--init", "gptq", "--par-iters", "2",
     "--par-steps", "3"],
    ["--method", "omniquant", "--init", "rtn"]],
    ids=["gptq", "omniquant"])
def test_cli_runs_gptq_and_omniquant_on_cpu(capsys, argv):
    """``--init gptq`` and ``--method omniquant`` calibrate, pack and serve
    (OmniQuant at the CLI's 500 steps a block, as in the reference: ~20 s
    on one CPU thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tserve.main(["--arch", "llama2-7b", "--reduced", "--quant",
                            "W2A16g32", "--device", "cpu", "--requests",
                            "2", "--prompt-len", "8", "--gen", "3"]
                           + argv) == 0
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    assert f"with {argv[1]}+{argv[3]}" in out and "calibration done" in out
    assert "2 requests x 3 tokens" in out


def test_cli_calibrates_with_tesseraq_on_cpu(capsys):
    assert tserve.main(["--arch", "llama2-7b", "--reduced", "--quant",
                        "W2A16g32", "--method", "tesseraq", "--init", "awq",
                        "--par-iters", "2", "--par-steps", "3", "--device",
                        "cpu", "--requests", "2", "--prompt-len", "8",
                        "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "with tesseraq+awq" in out and "calibration done" in out
    assert "2 requests x 3 tokens" in out


def test_quantize_model_refuses_engines_not_ported():
    """Every reconstruction method runs on the ``"device"`` engine only;
    the reference's other engines raise naming their ROADMAP item, and an
    unknown engine, method or init is refused."""
    cfg = get_reduced_config("llama2-7b")
    params = get_model(cfg).init_params(0, "cpu")
    batches = [{"tokens": torch.zeros(1, 4, dtype=torch.long)}]
    for method in ("tesseraq", "omniquant", "signround"):
        for engine in ("reference", "legacy", "sharded"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                quantize_model(cfg, params, batches, QuantConfig(),
                               method=method, init="rtn",
                               tcfg=TesseraQConfig(par_iterations=1,
                                                   steps_per_iteration=1,
                                                   engine=engine))
        with pytest.raises(ValueError, match="unknown engine"):
            quantize_model(cfg, params, batches, QuantConfig(),
                           method=method, init="rtn",
                           tcfg=TesseraQConfig(engine="tpu"))
    for kw in ({"method": "adaround"}, {"init": "smoothquant"}):
        with pytest.raises(ValueError, match="unknown"):
            quantize_model(cfg, params, batches, QuantConfig(), **kw)


def test_cuda_entry_points_refuse_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    cfg = get_reduced_config("llama2-7b")
    model = get_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(0)
    params = model.init_params(0, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_requests(cfg, model, params,
                              np.zeros((1, 4), np.int64), gen=2)
