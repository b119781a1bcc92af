"""The port's copies of the reference's remaining dense and MoE configs
(mistral-7b, command-r-35b, llama3-405b, moonshot-v1-16b-a3b) against the
JAX reference, all on the CPU.

For each of the four archs:
* ``CONFIG`` and ``reduced()`` equal to the reference's, field for field;
* the reference's reduced params, RTN-packed by the reference, bridged into
  the port and served lock-step under ``"xla"`` and ``"pallas"`` (the
  kernels' plain versions) against the reference's ``"xla"`` logits: the
  reference's ``parity_gate`` (atol 5e-2 / rtol 2e-2) passes, logits are
  within atol 1e-4 (f32 model and f32 KV caches in both packages:
  summation order only) and the greedy tokens are equal;
* the port's own RTN and AWQ walks + ``pack_model`` on the bridged FP
  params (f32) give the reference's packed bytes and zero points, scales
  within rtol 1e-6, and an equal ``quantized_memory_report``;
* the serve CLI runs the reduced arch on the CPU and exits 0.

And the port's ``ARCH_IDS`` are exactly the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import pack_model as jpack_model  # noqa: E402
from repro.core import quantize_model as jquantize_model  # noqa: E402
from repro.core.pipeline import \
    quantized_memory_report as jmemory_report  # noqa: E402
from repro.data.pipeline import (DataConfig, SyntheticCorpus,  # noqa: E402
                                 calibration_batches)
from repro.eval.harness import parity_gate as jparity_gate  # noqa: E402
from repro.launch.serve import serve_requests as jserve  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_reduced_config)
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core.pipeline import (pack_model,  # noqa: E402
                                       quantize_model,
                                       quantized_memory_report)
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.eval.harness import parity_gate  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

NEW_ARCHS = ["mistral-7b", "command-r-35b", "llama3-405b",
             "moonshot-v1-16b-a3b"]
QTAG = dict(bits=2, group_size=32)
B, PROMPT, GEN = 2, 10, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: one intra-op thread is faster for them and does not
    oversubscribe the cores that parallel test workers and XLA share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calib(vocab):
    dc = DataConfig(vocab_size=vocab, seq_len=16, global_batch=2, seed=0)
    return [b["tokens"][:, :-1] for b in calibration_batches(dc, 2, 2)]


def _prompts(vocab):
    dc = DataConfig(vocab_size=vocab, seq_len=PROMPT, global_batch=B, seed=1)
    return SyntheticCorpus(dc).batch(0)["tokens"][:, :PROMPT]


def _f32_cache(model, dtype):
    """``model`` with its caches allocated in ``dtype`` (either package)."""
    init = model.init_cache
    return dataclasses.replace(
        model, init_cache=lambda b, s, _=None, *a, **kw: init(b, s, dtype,
                                                             *a, **kw))


_CACHE = {}


def _reference(arch):
    """The reference's f32 reduced params, its RTN and AWQ packs with their
    memory reports, and its ``"xla"`` lock-step serve of the RTN pack,
    memoized."""
    if arch not in _CACHE:
        cfg = jget_reduced(arch).replace(dtype="float32")
        model = jget_model(cfg)
        params = model.init_params(jax.random.PRNGKey(0))
        calib = [{"tokens": jax.numpy.asarray(t)}
                 for t in _calib(cfg.vocab_size)]
        qcfg = JQuantConfig(**QTAG)
        packs = {}
        for init in ("rtn", "awq"):
            pfq, qmeta, _ = jquantize_model(cfg, params, calib, qcfg,
                                            method="none", init=init)
            packs[init] = jpack_model(cfg, pfq, qmeta, qcfg)
        prompts = _prompts(cfg.vocab_size)
        res = jserve(cfg, _f32_cache(model, jax.numpy.float32), packs["rtn"],
                     prompts, gen=GEN, kernel_backend="xla")
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        _CACHE[arch] = dict(
            params=to_np(params),
            packs={k: to_np(v) for k, v in packs.items()},
            reports={k: jmemory_report(v) for k, v in packs.items()},
            prompts=prompts, logits=res.logits, tokens=res.tokens)
    return _CACHE[arch]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_reference(arch):
    for got, want in ((get_config(arch), jget_config(arch)),
                      (get_reduced_config(arch), jget_reduced(arch))):
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_arch_ids_are_the_references_dense_and_moe_archs():
    """The port's ARCH_IDS are exactly the reference's whole ARCH_IDS:
    dense and MoE, the VLM, RWKV and hybrid families and, since the
    encoder-decoder slice, whisper-small; each config equal to the
    reference's."""
    assert set(ARCH_IDS) == set(JARCH_IDS) and len(ARCH_IDS) == len(JARCH_IDS)
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert dataclasses.asdict(get_reduced_config(arch)) == \
            dataclasses.asdict(jget_reduced(arch))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_bridged_params_matches_reference(arch, backend):
    ref = _reference(arch)
    cfg = get_reduced_config(arch).replace(dtype="float32")
    packed = params_to_torch(ref["packs"]["rtn"], "cpu")
    res = tserve.serve_requests(cfg, _f32_cache(get_model(cfg), torch.float32),
                                packed, ref["prompts"], gen=GEN,
                                kernel_backend=backend, device="cpu")
    gate = parity_gate(res.logits, ref["logits"], atol=5e-2, rtol=2e-2)
    assert gate == jparity_gate(res.logits, ref["logits"], atol=5e-2,
                                rtol=2e-2)
    assert gate["ok"], gate
    np.testing.assert_allclose(res.logits, ref["logits"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(res.tokens, ref["tokens"])


@pytest.mark.parametrize("init", ["rtn", "awq"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_walks_and_pack_match_reference(arch, init):
    ref = _reference(arch)
    cfg = get_reduced_config(arch).replace(dtype="float32")
    params = params_to_torch(ref["params"], "cpu")
    calib = [{"tokens": torch.from_numpy(t.astype(np.int64))}
             for t in _calib(cfg.vocab_size)]
    qcfg = QuantConfig(**QTAG)
    pfq, qmeta, _ = quantize_model(cfg, params, calib, qcfg, method="none",
                                   init=init)
    packed = pack_model(cfg, pfq, qmeta, qcfg)
    want = dict(_leaves(ref["packs"][init]))
    got = dict(_leaves(packed))
    assert set(got) == set(want)
    n_q = 0
    for path, g in got.items():
        w = want[path]
        if isinstance(g, QTensor):
            n_q += 1
            assert (g.bits, g.group_size, tuple(g.shape)) == \
                (w.bits, w.group_size, tuple(w.shape)), path
            np.testing.assert_array_equal(g.packed.numpy(), w.packed,
                                          err_msg=str(path))
            np.testing.assert_array_equal(g.zero.numpy(), w.zero,
                                          err_msg=str(path))
            np.testing.assert_allclose(g.scale.numpy(), w.scale, rtol=1e-6,
                                       err_msg=str(path))
            if w.act_scale is None:
                assert g.act_scale is None, path
            else:
                np.testing.assert_allclose(g.act_scale.numpy(), w.act_scale,
                                           rtol=1e-6, err_msg=str(path))
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    assert n_q == 7
    assert quantized_memory_report(packed) == ref["reports"][init]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_serves_reduced_arch_on_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--par-iters", "1", "--par-steps", "2",
                        "--calib-samples", "2", "--requests", "2",
                        "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "2 requests x 3 tokens" in out
