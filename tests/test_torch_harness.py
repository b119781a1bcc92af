"""The port's EVAL harness (``repro_torch.eval.harness``) and its data
pipeline against the JAX reference, on the CPU.

* ``--smoke --device cpu`` writes a JSON with the reference's keys (plus
  ``device``) and ``main`` returns 0; ``python -m repro_torch.eval.harness``
  runs the same;
* the CLI's flags and defaults are the reference's plus ``--device``;
* the rows match the reference's when both start from the reference's
  params (bridged into the port's run), both with ``--parity-method none``
  (the reference's Pallas GEMV cannot run on the installed jax, ROADMAP
  fault 3.1).  The smoke model is bf16: XLA's CPU backend computes some
  bf16 elementwise chains (``silu``) its own way where the port rounds
  each op (the dequantization rounds alike in both,
  ``tests/test_torch_qtensor.py``), and an AWQ grid choice can flip on
  that, so perplexities are held to rtol 1e-2
  (measured <= 0.3%); the multiple-choice accuracies are equal;
* ``calibration_batches``, ``eval_batches`` and ``SyntheticCorpus.batch``
  give the reference's tokens at two configs (the port keeps its own copy
  of the jax-free module).
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.eval import harness as jharness  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.bridge import params_to_torch  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.eval import harness  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ROW_KEYS = {"fp": {"ppl", "choice_acc", "secs"}}
ROW_KEYS.update({m: {"ppl", "choice_acc", "ppl_packed_xla", "secs"}
                 for m, _, _ in jharness.METHODS})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops: one intra-op thread is faster for them and leaves the
    cores to the parallel test workers.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_keys(out):
    assert set(out) == {"arch", "qcfg", "rows", "parity", "parity_ok",
                        "device"}
    assert {k: set(v) for k, v in out["rows"].items()} == ROW_KEYS
    for row in out["rows"].values():
        assert all(np.isfinite(v) for v in row.values())


def test_harness_smoke_writes_reference_keys(tmp_path, capsys):
    path = tmp_path / "EVAL.json"
    assert harness.main(["--smoke", "--device", "cpu", "--json",
                         str(path)]) == 0
    out = json.loads(path.read_text())
    _check_keys(out)
    assert out["arch"] == "tinyllama-smoke" and out["qcfg"] == "W4A16g32"
    assert out["device"] == "cpu" and out["parity_ok"] is True
    gate = out["parity"]["tesseraq"]
    assert gate["ok"] and gate["steps_compared"] == 4
    assert (gate["atol"], gate["rtol"]) == (5e-2, 2e-2)
    printed = capsys.readouterr().out
    assert "parity tesseraq (xla vs pallas" in printed and "PASS" in printed


def test_harness_module_runs(tmp_path):
    path = tmp_path / "EVAL.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.eval.harness", "--smoke",
         "--device", "cpu", "--json", str(path)],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    _check_keys(json.loads(path.read_text()))


def test_harness_exits_one_when_the_gate_fails(tmp_path):
    """A gate that cannot pass (atol and rtol below zero) makes ``main``
    return 1, with the JSON written."""
    path = tmp_path / "EVAL.json"
    assert harness.main(["--smoke", "--device", "cpu", "--json", str(path),
                         "--parity-atol", "-1", "--parity-rtol", "0"]) == 1
    out = json.loads(path.read_text())
    assert out["parity_ok"] is False and not out["parity"]["tesseraq"]["ok"]


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _reference_parser(monkeypatch):
    """The ArgumentParser the reference's ``main`` builds, caught at its
    ``parse_args``."""
    def grab(self, *a, **k):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as caught:
        jharness.main([])
    monkeypatch.undo()
    return caught.value.parser


def _flags(parser):
    return {a.option_strings[0]: (a.default, a.type, a.const)
            for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def test_harness_flags_are_the_reference_plus_device(monkeypatch):
    ref = _flags(_reference_parser(monkeypatch))
    port = _flags(harness.build_parser())
    assert port.pop("--device") == ("cuda", None, None)
    assert port == ref
    assert [m for m, _, _ in harness.METHODS] == [
        m for m, _, _ in jharness.METHODS]
    assert harness.METHODS == jharness.METHODS


def test_harness_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.main(["--smoke", "--json", str(tmp_path / "x.json")])


def test_harness_rows_match_reference(tmp_path):
    jpath, tpath = tmp_path / "ref.json", tmp_path / "port.json"
    argv = ["--smoke", "--parity-method", "none"]
    assert jharness.main(argv + ["--json", str(jpath)]) == 0
    # the reference's run builds its params from PRNGKey(--seed): the same
    # params, bridged, go into the port's run
    cfg = jget_reduced("tinyllama-1.1b")
    params = jget_model(cfg).init_params(jax.random.PRNGKey(0))
    tparams = params_to_torch(jax.tree_util.tree_map(np.asarray, params))
    assert harness.main(argv + ["--device", "cpu", "--json", str(tpath)],
                        params=tparams) == 0
    ref, got = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    _check_keys(got)
    assert set(ref) == set(got) - {"device"}
    assert (got["arch"], got["qcfg"]) == (ref["arch"], ref["qcfg"])
    assert got["parity"] == ref["parity"] == {}
    for label, row in ref["rows"].items():
        for k in ("ppl", "ppl_packed_xla"):
            if k in row:
                np.testing.assert_allclose(got["rows"][label][k], row[k],
                                           rtol=1e-2, err_msg=f"{label} {k}")
        assert got["rows"][label]["choice_acc"] == row["choice_acc"]


DATA_CONFIGS = {"vocab256-seq16": dict(vocab_size=256, seq_len=16,
                                       global_batch=4, seed=0),
                "vocab32000-seq65": dict(vocab_size=32000, seq_len=65,
                                         global_batch=3, seed=7)}


@pytest.mark.parametrize("name", list(DATA_CONFIGS))
def test_data_pipeline_matches_reference(name):
    kw = DATA_CONFIGS[name]
    jdc, tdc = jdata.DataConfig(**kw), tdata.DataConfig(**kw)
    for want, got in zip(jdata.calibration_batches(jdc, 3, 2),
                         tdata.calibration_batches(tdc, 3, 2), strict=True):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
    for want, got in zip(jdata.eval_batches(jdc, 2, 2),
                         tdata.eval_batches(tdc, 2, 2), strict=True):
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
    jc, tc = jdata.SyntheticCorpus(jdc), tdata.SyntheticCorpus(tdc)
    for step in (0, 5, 90_001):
        want, got = jc.batch(step), tc.batch(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
