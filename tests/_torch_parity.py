"""Shared comparison helpers for the port's parity tests."""
import numpy as np


def bf16_ulp(a):
    """Spacing of bf16 values at |a| (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(a, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_within_bf16_ulps(got, want, n=1):
    """|got - want| <= n bf16 ulps of the larger magnitude, elementwise."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    lim = n * bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    bad = diff > lim
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} elements differ by more than {n} "
        f"bf16 ulp(s); worst {diff[bad].max()} at limit {lim[bad].min()}")
