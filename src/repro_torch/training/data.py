"""Deterministic, resumable synthetic data pipeline: the port's own copy
of ``repro/training/data.py`` (numpy only; its batches are bitwise the
reference's).

Stateless by construction: batch ``i`` is a pure function of
(seed, step, host_shard), so resume-after-preemption and elastic re-sharding
need no iterator state — the checkpointed step counter alone restores the
exact data order.  Tokens follow a fixed random first-order Markov chain
(Zipf-ish stationary distribution), which gives the CE loss real learnable
structure for the end-to-end training examples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    order: int = 1                 # markov order

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse-ish transition table: each token has k likely successors
        k = min(16, v)
        self._succ = rng.integers(0, v, size=(v, k)).astype(np.int32)
        logits = rng.gumbel(size=(v, k)).astype(np.float64)
        p = np.exp(logits - logits.max(1, keepdims=True))
        self._p = (p / p.sum(1, keepdims=True)).astype(np.float64)

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """(tokens, labels) for this host at ``step`` — pure function."""
        rng = np.random.default_rng(
            (self.seed, 0x5EED, step, self.host_id))
        b, s, v = self.host_batch, self.seq_len, self.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        k = self._succ.shape[1]
        choices = rng.random((b, s))
        for t in range(s):
            cum = np.cumsum(self._p[toks[:, t]], axis=1)
            idx = (choices[:, t, None] > cum).sum(1)
            toks[:, t + 1] = self._succ[toks[:, t], np.minimum(idx, k - 1)]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def reshard(self, n_hosts: int, host_id: int) -> "SyntheticLMData":
        """Elastic re-sharding: same stream, new host split."""
        return dataclasses.replace(self, n_hosts=n_hosts, host_id=host_id)


__all__ = ["SyntheticLMData"]
