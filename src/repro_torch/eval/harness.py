"""Evaluation helpers.  This slice ports only the logits comparator; the
EVAL harness itself arrives later (ROADMAP queue 1, "Harness + benches")."""
from __future__ import annotations

import numpy as np


def parity_gate(a: np.ndarray, b: np.ndarray, *, atol: float,
                rtol: float) -> dict:
    """THE cross-backend logits comparison — symmetric rtol reference
    (max of both magnitudes); a copy of the reference's gate, so both
    packages hold logits to the same rule."""
    diff = np.abs(a - b)
    scale = np.maximum(np.abs(a), np.abs(b))
    ok = bool(np.all(diff <= atol + rtol * scale))
    return {"ok": ok, "max_abs_diff": float(diff.max()),
            "steps_compared": int(a.shape[1]), "atol": atol, "rtol": rtol}
