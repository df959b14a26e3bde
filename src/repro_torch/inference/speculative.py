"""Speculative decoding, the host side: the port's own copy of
``repro/inference/speculative.py`` (drafters and the adaptive speculation
length).

Multi-node decode is latency-bound on the per-token TP all-reduce: every
decoded token pays one small-message all-reduce a layer.  A drafter
proposes ``k`` cheap tokens and the target model verifies all of them in
one pass (``parallel.steps.build_spec_verify_step``), so the per-layer
all-reduce is amortized over up to ``k + 1`` tokens and its message widens
by the same factor.  Drafters keep per-slot token histories and propose
continuations; correctness never depends on draft quality: the verify
step's rejection rule keeps the emitted stream the target model's (greedy:
the plain decode stream), a bad drafter only costs speed.

Drafters (:func:`make_drafter`):

* ``ngram``: prompt lookup, the continuation of the most recent earlier
  occurrence of the current suffix (longest n-gram first), else the last
  token repeated.
* ``draft``: a small draft model, the port's seeded smoke model of
  ``draft_arch``, greedily continuing a fixed window of the history on
  the local path (window-relative positions: a proposal, not the target).
* ``replay``: replays precomputed target streams (tests and an upper
  bound: every draft is accepted).

All drafters are deterministic (a delta proposal), which is what makes the
sampled-mode rejection rule of ``steps._spec_targets`` exact.  The batcher
may degrade a slot to plain decode (``spec_autodisable_after``
consecutive zero-accept passes, or a quarantine of its request after a
non-finite verify step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPEC_MODES = ("ngram", "draft", "replay")


class Drafter:
    """Per-slot draft proposer.  Subclasses implement ``_propose``.

    ``hits``/``calls`` track how often the drafter produced a real
    candidate (vs falling back) — reported as ``drafter_hit_rate`` in
    :class:`~repro_torch.inference.scheduler.ServeMetrics`.
    """

    def __init__(self):
        self._hist: Dict[int, List[int]] = {}
        self.calls = 0
        self.hits = 0

    # -- lifecycle ---------------------------------------------------------

    def reset(self, slot: int, tokens: Sequence[int]) -> None:
        """(Re)seed ``slot``'s history: prompt + tokens emitted so far."""
        self._hist[slot] = [int(t) for t in tokens]

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        """Append tokens the target model actually emitted for ``slot``."""
        self._hist[slot].extend(int(t) for t in tokens)

    def drop(self, slot: int) -> None:
        self._hist.pop(slot, None)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.calls if self.calls else 0.0

    # -- drafting ----------------------------------------------------------

    def draft(self, slot: int, k: int) -> np.ndarray:
        """Propose ``k`` continuation tokens for ``slot`` (always exactly
        k — the verify executable has a static chunk length)."""
        hist = self._hist[slot]
        self.calls += 1
        cand = self._propose(slot, hist, k)
        if cand:
            self.hits += 1
        out = list(cand[:k])
        fill = out[-1] if out else (hist[-1] if hist else 0)
        out.extend([fill] * (k - len(out)))
        return np.asarray(out, np.int32)

    def _propose(self, slot: int, hist: List[int], k: int) -> List[int]:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup decoding: longest-suffix n-gram match in the history.

    For n from ``max_n`` down to 1: find the most recent earlier
    occurrence of the last n tokens and propose what followed it.  The
    lookup is O(max_n) per draft — per slot and per n, a dict maps each
    n-gram to the end positions of its last two occurrences (the final
    one is the current suffix itself), maintained incrementally as tokens
    are observed; this is host code on the serving hot loop.
    """

    def __init__(self, max_n: int = 3, max_hist: int = 4096):
        super().__init__()
        self.max_n = max_n
        self.max_hist = max_hist
        # slot -> per-n ({gram: last end pos}, {gram: previous end pos})
        self._idx: Dict[int, List[tuple]] = {}

    def _register(self, slot: int, end: int) -> None:
        h = self._hist[slot]
        for n in range(1, self.max_n + 1):
            if end >= n:
                last, prev = self._idx[slot][n - 1]
                g = tuple(h[end - n:end])
                if g in last:
                    prev[g] = last[g]
                last[g] = end

    def _rebuild(self, slot: int) -> None:
        self._idx[slot] = [({}, {}) for _ in range(self.max_n)]
        for end in range(1, len(self._hist[slot]) + 1):
            self._register(slot, end)

    def reset(self, slot, tokens):
        super().reset(slot, tokens)
        self._rebuild(slot)

    def drop(self, slot):
        super().drop(slot)
        self._idx.pop(slot, None)

    def observe(self, slot, tokens):
        h = self._hist[slot]
        for t in tokens:
            h.append(int(t))
            self._register(slot, len(h))
        if len(h) > self.max_hist:
            # trim to half so index rebuilds amortize to O(1)/token
            del h[: len(h) - self.max_hist // 2]
            self._rebuild(slot)

    def _propose(self, slot, hist, k):
        L = len(hist)
        for n in range(min(self.max_n, L - 1), 0, -1):
            last, prev = self._idx[slot][n - 1]
            g = tuple(hist[L - n:])
            end = last.get(g)
            if end == L:                 # that's the suffix itself
                end = prev.get(g)
            if end is not None and end < L:
                return hist[end: end + k]
        return []


class ModelDrafter(Drafter):
    """A small draft model proposing greedy continuations of a fixed
    window: the last ``window`` history tokens (left-padded with 0) are
    re-scored for each drafted token by ``transformer.forward_lm`` on the
    local path, one (1, window) forward a token (its attention through
    kernel 3 on the card), so no draft-side cache needs rolling back.
    Window-relative positions are fine: this is a proposal, not the target
    distribution.  The draft model may have a smaller vocabulary than the
    target (``make_drafter`` builds a smoke model): a history token past
    it is read as the draft's last id, as the reference's embedding gather
    clamps it."""

    def __init__(self, ap, model, *, window: int = 32, device=None):
        super().__init__()
        self.ap = ap
        self.model = model
        self.window = window
        self.device = device if device is not None \
            else model.embed["tok"].device

    def _next(self, win: List[int]) -> int:
        import torch
        from ..models.transformer import forward_lm
        top = self.ap.cfg.vocab_size - 1
        with torch.inference_mode():
            logits, _ = forward_lm(self.model, torch.as_tensor(
                [[min(t, top) for t in win]], dtype=torch.int64,
                device=self.device), self.ap)
            return int(torch.argmax(
                logits[0, -1, :self.ap.cfg.vocab_size].float()))

    def _propose(self, slot, hist, k):
        W = self.window
        win = hist[-W:]
        win = [0] * (W - len(win)) + win
        out: List[int] = []
        for _ in range(k):
            out.append(self._next(win))
            win = win[1:] + out[-1:]
        return out


class ReplayDrafter(Drafter):
    """Oracle drafter replaying precomputed target streams, keyed by the
    request prompt.  Testing / benchmark upper bound: every draft is the
    token the target will emit, so acceptance is 1.0 and a trace completes
    in ~1/(k+1) of the decode steps."""

    def __init__(self, streams: Dict[Tuple[int, ...], Sequence[int]]):
        super().__init__()
        self.streams = {k: [int(t) for t in v] for k, v in streams.items()}
        self._cursor: Dict[int, Tuple[Tuple[int, ...], int]] = {}

    def reset(self, slot, tokens):
        super().reset(slot, tokens)
        toks = [int(t) for t in tokens]
        # longest prompt key that prefixes the history wins (prompts can
        # share prefixes); cursor = tokens already emitted beyond it
        best = None
        for key in self.streams:
            if len(key) < len(toks) and toks[: len(key)] == list(key) \
                    and (best is None or len(key) > len(best)):
                best = key
        self._cursor[slot] = (best, len(toks) - len(best)) \
            if best is not None else ((), 0)

    def observe(self, slot, tokens):
        super().observe(slot, tokens)
        key, cur = self._cursor.get(slot, ((), 0))
        self._cursor[slot] = (key, cur + len(tokens))

    def draft(self, slot, k):
        self.calls += 1
        key, cur = self._cursor.get(slot, ((), 0))
        stream = self.streams.get(key, [])
        cand = stream[cur: cur + k]
        if cand:
            self.hits += 1
        fill = cand[-1] if cand else (self._hist[slot][-1]
                                      if self._hist.get(slot) else 0)
        cand = list(cand) + [fill] * (k - len(cand))
        return np.asarray(cand, np.int32)


@dataclasses.dataclass
class AdaptiveK:
    """Acceptance-rate-adaptive speculation length.

    Tracks an EWMA of the per-step draft acceptance ratio and walks the
    current k up/down a ladder of candidate lengths: consistently high
    acceptance buys longer speculation (bigger AR messages, fewer steps),
    consistently low acceptance backs off toward plain decode.  Each k is
    its own verify executable, so the ladder is small by design.
    """

    ks: Tuple[int, ...] = (2, 4, 8)
    hi: float = 0.75
    lo: float = 0.30
    ewma: float = 0.5
    _idx: int = 0
    _rate: float = 0.5

    def __post_init__(self):
        self.ks = tuple(sorted(set(int(k) for k in self.ks)))
        if not self.ks or self.ks[0] < 1:
            raise ValueError(f"bad adaptive-k ladder {self.ks}")

    @property
    def k(self) -> int:
        return self.ks[self._idx]

    def update(self, accepted: float, k: int) -> int:
        """Feed one step's mean accepted-draft count at length ``k``;
        returns the k to use next step."""
        self._rate = (1 - self.ewma) * self._rate \
            + self.ewma * (accepted / max(k, 1))
        if self._rate > self.hi and self._idx < len(self.ks) - 1:
            self._idx += 1
            self._rate = 0.5  # re-center after a ladder move
        elif self._rate < self.lo and self._idx > 0:
            self._idx -= 1
            self._rate = 0.5
        return self.k


def make_drafter(mode: str, *, draft_arch: str = "llama3.2-1b",
                 window: int = 32, max_n: int = 3, seed: int = 0,
                 streams: Optional[Dict] = None, device=None) -> Drafter:
    """Drafter factory behind ``--spec-mode``; ``draft`` builds the port's
    seeded smoke model of ``draft_arch`` on ``device`` (tp=1; ``None`` is
    the card, as everywhere in the port)."""
    if mode == "ngram":
        return NGramDrafter(max_n=max_n)
    if mode == "draft":
        from ..configs import get_smoke
        from ..models.transformer import init_params, make_plan
        from .engine import resolve_device
        dev = resolve_device(device)
        ap = make_plan(get_smoke(draft_arch), 1)
        model = init_params(ap, seed=seed, device=dev)
        return ModelDrafter(ap, model, window=window, device=dev)
    if mode == "replay":
        return ReplayDrafter(streams or {})
    raise ValueError(f"unknown spec mode {mode!r}; known: {SPEC_MODES}")


__all__ = ["Drafter", "NGramDrafter", "ModelDrafter", "ReplayDrafter",
           "AdaptiveK", "make_drafter", "SPEC_MODES"]
