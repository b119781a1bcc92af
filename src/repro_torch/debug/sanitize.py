"""Runtime sanitizer harness: the dynamic half of the repo contracts that
``tools/reprolint`` checks statically.

``sanitized()`` composes the guards into one context manager:

  * ``transfer_guard`` — a host sync raises: ``torch.cuda.set_sync_debug_mode
    ("error")`` for the block, the previous mode restored on exit and on an
    exception.  Torch's mode cannot tell an explicit transfer from an
    implicit one, unlike ``jax.transfer_guard("disallow")``, which lets
    ``device_put`` / ``device_get`` through: every synchronizing call
    raises (``.item()``, a copy to pageable host memory, a
    ``nonzero``).  So the port's explicit transfer points — the
    scheduler's one counted sync per admission, its off-clock fetches,
    the recon engine's counted host reads and pushes — run under
    :func:`allowed_transfer`, which lifts the guard for their one call.
    It needs CUDA: on a torch built without it, it raises as
    ``set_sync_debug_mode`` itself does.
  * ``check_leaks`` — jax's tracer-leak check.  Eager PyTorch traces
    nothing, so no tracer can leak out of a step, and the flag guards
    nothing: it is accepted, and changes nothing.
  * ``debug_nans`` (opt-in) — a dispatch mode that raises
    ``FloatingPointError`` at the first op whose floating output holds a
    NaN, naming the op.  It reads every output on the host, so it syncs at
    each op and refuses to combine with ``transfer_guard``.

``assert_no_recompiles`` pins the build-once contract of the hot paths: a
function whose ``_cache_size()`` grows by more than ``allowed`` inside the
block raises ``RecompileError``.  What plays the executable cache's part
here: ``launch.scheduler.compile_sched_steps`` (its step sets),
``launch.serve.compile_serve_steps`` (its step pairs) and
``kernels.build.build_library`` (its ``nvcc`` builds).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_GUARDED = []           # the sync debug modes the open guards replaced


class RecompileError(AssertionError):
    """A step set was built, or a kernel compiled, inside an
    ``assert_no_recompiles`` region."""


def _cache_size(fn) -> int:
    # tolerate plain callables so the guard can wrap a mixed list
    # (untracked fns contribute 0 growth)
    probe = getattr(fn, "_cache_size", None)
    return int(probe()) if callable(probe) else 0


@contextlib.contextmanager
def assert_no_recompiles(*fns, allowed: int = 0) -> Iterator[None]:
    """Fail if any ``fn``'s cache grows by more than ``allowed`` entries
    inside the block.

    Use ``allowed=1`` around a region that includes the FIRST call (one
    build is the contract), ``allowed=0`` around steady state.
    """
    before = [_cache_size(f) for f in fns]
    yield
    for f, b in zip(fns, before, strict=True):
        grew = _cache_size(f) - b
        if grew > allowed:
            name = getattr(f, "__name__", repr(f))
            raise RecompileError(
                f"{name} built {grew} new entr(y/ies) inside an "
                f"assert_no_recompiles(allowed={allowed}) region — an "
                f"argument changed a shape or a key of the cache")


@contextlib.contextmanager
def _sync_guard() -> Iterator[None]:
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    _GUARDED.append(prev)
    try:
        yield
    finally:
        _GUARDED.pop()
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def allowed_transfer() -> Iterator[None]:
    """An explicit host transfer: inside a ``sanitized(transfer_guard=
    True)`` block the sync guard is lifted for this block (the mode the
    guard replaced comes back); outside one it does nothing and touches no
    CUDA state."""
    if not _GUARDED:
        yield
        return
    torch.cuda.set_sync_debug_mode(_GUARDED[-1])
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("error")


class _NanGuard(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first op whose floating output
    holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape {tuple(t.shape)})")
        return out


@contextlib.contextmanager
def sanitized(*, transfer_guard: bool = True, check_leaks: bool = True,
              debug_nans: bool = False) -> Iterator[None]:
    """Run a block under the composed sanitizers (see the module
    docstring).  Every guard restores what it replaced, so nesting and use
    inside test fixtures is safe."""
    if transfer_guard and debug_nans:
        raise ValueError("sanitized: debug_nans reads every op's output on "
                         "the host, which transfer_guard forbids")
    with contextlib.ExitStack() as stack:
        if transfer_guard:
            stack.enter_context(_sync_guard())
        if debug_nans:
            stack.enter_context(_NanGuard())
        yield
