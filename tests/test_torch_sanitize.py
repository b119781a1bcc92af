"""``repro_torch.debug.sanitize``: ``tests/test_sanitize.py``'s contracts on
the port.

``assert_no_recompiles`` must fire when a region builds a new scheduler
step set or serve pair (the executable cache's part here) and stay quiet
on a cache hit; ``sanitized`` composes the guards and restores what it
replaced.  This machine has no CUDA: the transfer guard raises as torch's
``set_sync_debug_mode`` does without it (its clean and planted runs are
on the card, ``chip_smoke.py``), while ``debug_nans`` runs here, and the
scheduler and the recon engine run clean under it, equal to their
unguarded runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.debug import (RecompileError, allowed_transfer,  # noqa: E402
                               assert_no_recompiles, sanitized)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.scheduler import (Request,  # noqa: E402
                                          compile_sched_steps,
                                          serve_scheduled)
from repro_torch.launch.serve import compile_serve_steps  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


@pytest.fixture(scope="module")
def sched_setup():
    cfg = get_reduced_config("smollm-135m")
    model = get_model(cfg)
    return cfg, model, model.init_params(0, "cpu")


def _requests(cfg):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (6,))
                    .astype(np.int32), max_new_tokens=4, arrival=0)
            for i in range(3)]


# -- assert_no_recompiles ----------------------------------------------------

def test_recompile_detector_fires_on_cache_buster(sched_setup):
    cfg = sched_setup[0]
    compile_sched_steps(cfg, max_seq=16)            # warm at one width
    with pytest.raises(RecompileError, match="compile_sched_steps"):
        with assert_no_recompiles(compile_sched_steps):
            compile_sched_steps(cfg, max_seq=17)    # new width -> new set


def test_recompile_detector_quiet_on_cache_hit(sched_setup):
    cfg = sched_setup[0]
    compile_serve_steps(cfg, kernel_backend="xla")
    with assert_no_recompiles(compile_serve_steps, compile_sched_steps,
                              build.build_library):
        for _ in range(3):
            compile_serve_steps(cfg, kernel_backend="xla")
            compile_sched_steps(cfg, max_seq=16)


def test_recompile_detector_allowed_budget(sched_setup):
    cfg = sched_setup[0]
    with assert_no_recompiles(compile_serve_steps, allowed=1):
        compile_serve_steps(cfg, kernel_backend="xla", act_bits=8)
    with pytest.raises(RecompileError):
        with assert_no_recompiles(compile_serve_steps, allowed=1):
            compile_serve_steps(cfg, kernel_backend="xla", act_bits=4)
            compile_serve_steps(cfg, kernel_backend="pallas", act_bits=4)


def test_recompile_detector_tolerates_plain_callables():
    with assert_no_recompiles(lambda x: x):
        pass
    assert build.build_library._cache_size() >= 0   # nvcc builds, probed


# -- sanitized() -------------------------------------------------------------

def test_transfer_guard_needs_cuda():
    """Torch's sync debug mode needs CUDA: without it the guard raises as
    ``set_sync_debug_mode`` does, instead of guarding nothing."""
    if torch.cuda.is_available():
        pytest.skip("the guard's CPU refusal; this torch has CUDA")
    with pytest.raises(AssertionError, match="CUDA"):
        with sanitized(transfer_guard=True):
            pass
    with allowed_transfer():      # outside a guard: nothing, no CUDA call
        assert torch.ones(2).sum().item() == 2.0


def test_debug_nans_names_the_op():
    x = torch.tensor([1.0, -1.0])
    with pytest.raises(FloatingPointError, match="sqrt"):
        with sanitized(transfer_guard=False, debug_nans=True):
            torch.sqrt(x)
    with sanitized(transfer_guard=False, debug_nans=True):
        assert torch.sqrt(x.abs()).sum().item() == 2.0


def test_sanitized_restores_previous_config():
    with sanitized(transfer_guard=False, debug_nans=True):
        pass
    assert torch.isnan(torch.sqrt(torch.tensor(-1.0)))   # guard lifted
    with pytest.raises(ValueError, match="transfer_guard"):
        with sanitized(transfer_guard=True, debug_nans=True):
            pass


def test_check_leaks_changes_nothing(sched_setup):
    """Eager PyTorch has no tracers: ``check_leaks`` guards nothing and
    leaves a serve run's bits as they are."""
    cfg, _, params = sched_setup
    kw = dict(slots=2, max_seq=16, device="cpu", collect_logits=True)
    want = serve_scheduled(cfg, params, _requests(cfg), **kw)
    with sanitized(transfer_guard=False, check_leaks=True):
        got = serve_scheduled(cfg, params, _requests(cfg), **kw)
    for rid in want.requests:
        np.testing.assert_array_equal(want.requests[rid]["logits"],
                                      got.requests[rid]["logits"])


# -- the hot loops under the guards -------------------------------------------

def test_sched_decode_clean_under_debug_nans(sched_setup):
    cfg, _, params = sched_setup
    steps = compile_sched_steps(cfg, max_seq=16)
    kw = dict(slots=2, max_seq=16, compiled=steps, collect_logits=False,
              device="cpu")
    warm = serve_scheduled(cfg, params, _requests(cfg), **kw)
    with sanitized(transfer_guard=False, debug_nans=True):
        with assert_no_recompiles(compile_sched_steps, compile_serve_steps):
            guarded = serve_scheduled(cfg, params, _requests(cfg), **kw)
    for rid in warm.requests:
        np.testing.assert_array_equal(warm.requests[rid]["tokens"],
                                      guarded.requests[rid]["tokens"])


def test_recon_engine_clean_under_debug_nans():
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import quantizer as Q
    from repro_torch.core import tesseraq as TQ
    rng = np.random.default_rng(0)
    W = torch.as_tensor(rng.normal(size=(32, 32)).astype(np.float32))
    X = torch.as_tensor(rng.normal(size=(8, 4, 32)).astype(np.float32))
    Y = X @ W
    qcfg = QuantConfig(bits=2, group_size=16)
    s, z = Q.compute_scale_zero(W, qcfg)
    tcfg = TQ.TesseraQConfig(par_iterations=2, steps_per_iteration=2,
                             batch_size=4, engine="device")

    def apply(p, x, aux=None):
        return x @ p["wq"]

    def run():
        return TQ.reconstruct_block(
            apply, {"wq": W.clone()}, X, Y, None,
            {("wq",): {"scale": s.clone(), "zero": z.clone()}}, qcfg, tcfg)
    want = run()
    with sanitized(transfer_guard=False, debug_nans=True):
        got = run()
    for key in ("codes", "hard", "scale"):
        assert torch.equal(want[1][("wq",)][key], got[1][("wq",)][key])
