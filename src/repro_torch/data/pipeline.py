"""Deterministic synthetic-corpus data pipeline (numpy only; a copy of the
reference package's ``data/pipeline.py``, so the same seed gives the same
tokens in both packages).

No external datasets exist in this container, so the pipeline generates a
structured synthetic corpus (Zipfian unigrams + Markov bigram structure +
repeated n-gram motifs) that a small LM can measurably learn — enough to
reproduce the paper's *orderings* (PPL deltas between PTQ methods).

Properties needed at 1000-node scale and provided here:
  * stateless addressing: ``batch(step)`` is a pure function of (seed, step,
    host_id) — restart-exact resume, no shared reader state;
  * sequence packing into fixed (B, S+1) token blocks;
  * per-host sharding by range partitioning of the batch dim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticCorpus:
    """Markov-ish token stream; the same (cfg, step) always yields the same
    batch on every host."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipf unigram over vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** -cfg.zipf_a
        self.unigram = probs / probs.sum()
        # low-rank bigram structure: next ~ mix(unigram, class transition)
        self.n_classes = c = min(64, v)
        self.tok_class = root.integers(0, c, v)
        self.class_next = root.dirichlet(np.ones(c) * 0.3, size=c)
        # class -> preferred tokens
        perm = root.permutation(v)
        self.class_tokens = np.array_split(perm, c)
        self.motifs = [root.integers(0, v, cfg.motif_len)
                       for _ in range(cfg.n_motifs)]

    def _sample_seq(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        t = int(rng.choice(self.cfg.vocab_size, p=self.unigram))
        i = 0
        while i < n:
            if rng.random() < 0.15:                       # drop in a motif
                m = self.motifs[int(rng.integers(len(self.motifs)))]
                k = min(len(m), n - i)
                out[i:i + k] = m[:k]
                i += k
                t = int(out[i - 1])
                continue
            c = self.tok_class[t]
            nc = int(rng.choice(self.n_classes, p=self.class_next[c]))
            cand = self.class_tokens[nc]
            t = int(cand[rng.integers(len(cand))]) if rng.random() < 0.7 \
                else int(rng.choice(self.cfg.vocab_size, p=self.unigram))
            out[i] = t
            i += 1
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """(local_batch, seq_len + 1) int32 tokens for this host at ``step``."""
        cfg = self.cfg
        local = cfg.global_batch // cfg.n_hosts
        rows = []
        for b in range(local):
            gidx = step * cfg.global_batch + cfg.host_id * local + b
            rng = np.random.default_rng((cfg.seed, gidx))
            rows.append(self._sample_seq(rng, cfg.seq_len + 1))
        return {"tokens": np.stack(rows).astype(np.int32)}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def calibration_batches(cfg: DataConfig, n_batches: int, batch_size: int,
                        *, offset: int = 10_000):
    """Held-out calibration segments (paper Sec. 4.1: 512 2048-token
    segments from the training distribution)."""
    corpus = SyntheticCorpus(dataclasses.replace(cfg, global_batch=batch_size))
    return [corpus.batch(offset + i) for i in range(n_batches)]


def eval_batches(cfg: DataConfig, n_batches: int, batch_size: int,
                 *, offset: int = 50_000):
    corpus = SyntheticCorpus(dataclasses.replace(cfg, global_batch=batch_size))
    return [corpus.batch(offset + i) for i in range(n_batches)]
