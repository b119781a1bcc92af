"""The serve result surface (``ServeResult``) and its latency statistics.

The continuous-batching scheduler itself is not ported yet (ROADMAP queue
1, "Continuous batching"); ``serve_requests`` already returns this type.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """The one result surface every serve entry point returns.

    ``requests`` maps rid -> per-request record (``tokens`` (gen,) int,
    ``logits`` (gen, V) or None, admission/finish bookkeeping).
    ``latency_steps`` holds mean/p50/p90/p99 in decode-step units;
    ``cache_stats`` the cache store's accounting."""
    mode: str                               # "uniform"
    store: str                              # "dense"
    requests: Dict[int, Dict[str, Any]]
    slots: int
    max_seq: int
    steps: int
    useful_tokens: int
    decode_tokens: int
    prefill_secs: float
    decode_secs: float
    prefill_tok_s: float
    decode_tok_s: float
    occupancy: float
    latency_steps: Dict[str, float]
    cache_stats: Dict[str, Any]

    @property
    def tokens(self) -> np.ndarray:
        """(B, gen) token ids, rids in sorted order."""
        rids = sorted(self.requests)
        return np.stack([np.asarray(self.requests[r]["tokens"], np.int32)
                         for r in rids], 0)

    @property
    def logits(self) -> Optional[np.ndarray]:
        """(B, gen, V) float32 logits, or None when not collected."""
        rids = sorted(self.requests)
        if not rids or self.requests[rids[0]].get("logits") is None:
            return None
        return np.stack([np.asarray(self.requests[r]["logits"], np.float32)
                         for r in rids], 0)


def _latency_stats(latencies) -> Dict[str, float]:
    lat = np.asarray(latencies, np.float64)
    return {"mean": float(lat.mean()), "p50": float(np.percentile(lat, 50)),
            "p90": float(np.percentile(lat, 90)),
            "p99": float(np.percentile(lat, 99))}
