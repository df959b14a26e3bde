"""Paged KV cache, the host side: the port's own copy of
``repro/inference/kv_cache.py``'s :class:`BlockAllocator`, with
:class:`CacheStats` and :func:`paged_geometry` (pure numpy, never on the
device; the KV handoff format of that module arrives with ROADMAP item 8).

The decode cache is carved into blocks of ``block_size`` positions, and
each slot's logical positions map to physical blocks through a per-slot
block table.  The allocator owns the free list, the tables, growth on
demand, preemption, defragmentation and the usage statistics; the device
side (``models/transformer.py``, ``models/layers.py``) reads K/V through
the table, kept in the cache as ``block_tbl`` (on a virtual mesh folded
over the ranks: ``transformer.fold_table``).

Invariants the serving stack relies on:

* **block-0-trash**: physical block 0 is the trash block.  The table rows
  of freed or never-admitted slots point at it, so the fixed-shape decode
  step keeps writing the stale slots' K/V somewhere harmless without any
  masking; its contents are never read.
* **write-ordering**: freed, truncated or preempted blocks may hold stale
  K/V when they return to the free list.  That is safe because a block is
  only read through a slot's table after that slot has written every
  position its attention mask exposes.
* **refcounted sharing**: a block may sit in several slots' tables (a
  shared prompt prefix) or be held from outside; it returns to the free
  list only when its slot references and holds both reach zero.  A slot
  writes only blocks it owns alone (:meth:`BlockAllocator.fork_for_write`
  first).  The port's batcher uses neither yet (prefix cache: ROADMAP
  item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

TRASH_BLOCK = 0


@dataclasses.dataclass
class CacheStats:
    """Point-in-time utilization snapshot (also the bench JSON payload)."""
    n_blocks: int            # physical blocks incl. trash
    block_size: int
    used_blocks: int         # currently owned by live slots
    peak_used_blocks: int    # high-water mark since construction
    used_tokens: int         # positions actually occupied (<= used*bs)
    preemptions: int
    allocations: int
    defrags: int

    @property
    def utilization(self) -> float:
        """Occupied tokens / reserved token capacity of the used blocks."""
        cap = self.used_blocks * self.block_size
        return self.used_tokens / cap if cap else 0.0

    def to_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["utilization"] = self.utilization
        return d


class BlockAllocator:
    """Free-list block allocator + per-slot block tables.

    ``n_blocks`` counts *all* physical blocks including the reserved trash
    block, matching the leading dim of the device-side cache, so a cache
    built with ``init_cache(..., block_size=bs, n_blocks=n)`` pairs with
    ``BlockAllocator(n, bs, slots, max_blocks)`` verbatim.
    """

    def __init__(self, n_blocks: int, block_size: int, slots: int,
                 max_blocks_per_slot: int):
        if block_size <= 0:
            raise ValueError("block_size must be > 0 for a paged cache")
        if n_blocks < max_blocks_per_slot + 1:
            raise ValueError(
                f"n_blocks={n_blocks} cannot hold one full-length request "
                f"({max_blocks_per_slot} blocks) plus the trash block")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.slots = slots
        self.max_blocks = max_blocks_per_slot
        # LIFO free list (reuse hot blocks first); block 0 is never free.
        self._free: List[int] = list(range(n_blocks - 1, TRASH_BLOCK, -1))
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        # per-block slot refcount: how many slot tables reference b.  A
        # freshly allocated block has ref 1; share() raises it.
        self._ref = np.zeros((n_blocks,), np.int64)
        # external holds (prefix-trie pins): block -> hold count.  Held
        # blocks stay off the free list even with zero slot refs.
        self._held: Dict[int, int] = {}
        # called with {old: new} on every defragment (trie remap et al.)
        self._remap_hooks: List = []
        self._tokens = np.zeros((slots,), np.int64)  # occupied positions
        self.table = np.full((slots, max_blocks_per_slot), TRASH_BLOCK,
                             np.int32)
        self.peak_used_blocks = 0
        self.preemptions = 0
        self.allocations = 0
        self.defrags = 0
        # bumped on every table mutation; lets callers skip device uploads
        self.version = 0

    # -- queries -----------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def owned(self, slot: int) -> Tuple[int, ...]:
        return tuple(self._owned[slot])

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)  # ceil div

    def can_allocate(self, slot: int, n_tokens: int) -> bool:
        need = self.blocks_for(n_tokens) - len(self._owned[slot])
        return need <= len(self._free)

    def needs_growth(self, slot: int, n_tokens: int) -> bool:
        """Would covering [0, n_tokens) require new blocks for ``slot``?
        (The question an injected allocator-OOM burst gates on: growth
        that is not actually needed can never fail.)"""
        return self.blocks_for(n_tokens) > len(self._owned[slot])

    def slot_refs(self, block: int) -> int:
        """How many slot tables reference ``block`` (0 for free blocks)."""
        return int(self._ref[block])

    def held_count(self, block: int) -> int:
        """External (trie) hold count on ``block``."""
        return self._held.get(block, 0)

    def is_exclusive(self, slot: int, idx: int) -> bool:
        """True iff ``slot`` may write its ``idx``-th block in place:
        exactly one slot ref (this slot's) and no external holds."""
        b = self._owned[slot][idx]
        return int(self._ref[b]) == 1 and b not in self._held

    def stats(self) -> CacheStats:
        return CacheStats(
            n_blocks=self.n_blocks, block_size=self.block_size,
            used_blocks=self.used_blocks,
            peak_used_blocks=self.peak_used_blocks,
            used_tokens=int(self._tokens.sum()),
            preemptions=self.preemptions, allocations=self.allocations,
            defrags=self.defrags)

    # -- allocate / free ---------------------------------------------------

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` to cover logical positions [0, n_tokens).

        Returns False (no state change) when the free list cannot cover the
        growth — the scheduler then preempts somebody and retries.
        """
        need_total = self.blocks_for(n_tokens)
        if need_total > self.max_blocks:
            raise ValueError(
                f"request needs {need_total} blocks > max_blocks_per_slot="
                f"{self.max_blocks} (s_max too small)")
        own = self._owned[slot]
        grow = need_total - len(own)
        if grow > len(self._free):
            return False
        for _ in range(max(grow, 0)):
            b = self._free.pop()
            self._ref[b] = 1
            self.table[slot, len(own)] = b
            own.append(b)
            self.allocations += 1
            self.version += 1
        self._tokens[slot] = max(self._tokens[slot], n_tokens)
        self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks)
        return True

    # -- sharing (copy-on-write) -------------------------------------------

    def share(self, slot: int, blocks) -> None:
        """Point an *empty* ``slot``'s table at existing live blocks.

        The prefix-splice primitive: an admitted request whose prompt
        matched ``len(blocks)`` trie blocks takes a reference on each —
        the blocks become the slot's leading table entries, and ``ensure``
        then grows only the private suffix.  Each shared block's refcount
        rises by one; nothing is copied.  The slot must own nothing (a
        fresh admission) and every block must be live (slot-referenced or
        held) — a free-list block has undefined K/V.
        """
        own = self._owned[slot]
        assert not own, f"share() into non-empty slot {slot}"
        blocks = list(blocks)
        if len(blocks) > self.max_blocks:
            raise ValueError(f"sharing {len(blocks)} blocks > max_blocks="
                             f"{self.max_blocks}")
        for b in blocks:
            assert b != TRASH_BLOCK, "sharing the trash block"
            assert self._ref[b] > 0 or b in self._held, \
                f"sharing dead block {b}"
        for i, b in enumerate(blocks):
            self._ref[b] += 1
            self.table[slot, i] = b
            own.append(b)
            self.version += 1

    def fork_for_write(self, slot: int, idx: int) -> Optional[Tuple[int, int]]:
        """Give ``slot`` a private copy of its ``idx``-th block.

        Returns ``None`` when the block is already exclusive (write in
        place).  Otherwise pops a free block, moves this slot's reference
        onto it, and returns ``(old_phys, new_phys)`` — the caller MUST
        copy the device K/V ``old -> new`` before any divergent write, in
        the same transaction as the table upload.  Raises RuntimeError
        when the free list is empty (callers reclaim trie holds first, or
        skip the write).
        """
        own = self._owned[slot]
        b = own[idx]
        if self._ref[b] == 1 and b not in self._held:
            return None
        if not self._free:
            raise RuntimeError(
                f"fork_for_write: no free block to copy shared block {b}")
        new = self._free.pop()
        self._ref[b] -= 1
        self._ref[new] = 1
        own[idx] = new
        self.table[slot, idx] = new
        self.allocations += 1
        self.version += 1
        self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks)
        return (b, new)

    def hold(self, blocks) -> None:
        """Take an external (trie) hold on each block: it stays off the
        free list even when every slot releases it.  Blocks must be live
        or just-released by the caller in the same transaction."""
        for b in blocks:
            assert b != TRASH_BLOCK, "holding the trash block"
            assert b not in self._free, f"holding free block {b}"
            self._held[b] = self._held.get(b, 0) + 1

    def release(self, blocks) -> List[int]:
        """Drop one external hold per block; blocks whose refcount and
        hold count both hit zero go back on the free list.  Returns the
        blocks actually freed (the trie's eviction bookkeeping)."""
        freed: List[int] = []
        for b in blocks:
            n = self._held[b] - 1
            if n:
                self._held[b] = n
            else:
                del self._held[b]
                if self._ref[b] == 0:
                    self._free.append(b)
                    freed.append(b)
        return freed

    def register_remap_hook(self, fn) -> None:
        """``fn(old_to_new: Dict[int, int])`` is invoked on every
        defragment so external block indices (the trie's) stay valid."""
        self._remap_hooks.append(fn)

    def reset_stats(self) -> None:
        """Zero the trace-scoped counters (peak/preemptions/allocations/
        defrags) so a fresh replay reports its own numbers; current
        ownership is untouched."""
        self.peak_used_blocks = self.used_blocks
        self.preemptions = 0
        self.allocations = 0
        self.defrags = 0

    def note_usage(self, slot: int, n_tokens: int) -> None:
        """Record occupied positions that did not require growth (writes
        inside an already-allocated block) so utilization stats stay exact
        between block-boundary ``ensure`` calls."""
        assert self.blocks_for(n_tokens) <= len(self._owned[slot]) or \
            n_tokens == 0, (slot, n_tokens)
        self._tokens[slot] = max(self._tokens[slot], n_tokens)

    def _drop_ref(self, block: int) -> bool:
        """Drop one slot reference; True iff the block went back on the
        free list (refcount and hold count both zero)."""
        self._ref[block] -= 1
        assert self._ref[block] >= 0, f"refcount underflow on {block}"
        if self._ref[block] == 0 and block not in self._held:
            self._free.append(block)
            return True
        return False

    def free(self, slot: int) -> int:
        """Drop ``slot``'s reference on every block it holds; its table
        row reverts to trash.  Blocks shared with another slot or held by
        the trie survive — returns the number actually released to the
        free list."""
        own = self._owned[slot]
        n = 0
        # LIFO: freed blocks go back on top, most recently used first.
        for b in reversed(own):
            n += self._drop_ref(b)
        if own:
            self.version += 1
        own.clear()
        self.table[slot, :] = TRASH_BLOCK
        self._tokens[slot] = 0
        return n

    def preempt(self, slot: int) -> int:
        """Evict ``slot`` (count it as a preemption) and return its blocks."""
        self.preemptions += 1
        return self.free(slot)

    def truncate(self, slot: int, n_tokens: int) -> int:
        """Roll ``slot`` back so it covers exactly logical positions
        [0, n_tokens) — the speculative-decode rejection rollback: blocks
        that only held rejected draft K/V go straight back on the free
        list.  Returns the number of blocks released.

        Freed blocks may contain stale K/V; that is safe for the same
        write-ordering reason preemption-freed blocks are (DESIGN.md §7):
        a block is only re-read through some slot's table after that slot
        has overwritten every position the attention mask exposes.
        """
        keep = self.blocks_for(n_tokens)
        own = self._owned[slot]
        tail = own[keep:]
        n = 0
        if tail:
            del own[keep:]
            # LIFO: rejected-tail blocks are the hottest, reuse them first.
            for b in reversed(tail):
                n += self._drop_ref(b)
            self.table[slot, keep:] = TRASH_BLOCK
            self.version += 1
        self._tokens[slot] = min(int(self._tokens[slot]), n_tokens)
        return n

    # -- defragmentation ---------------------------------------------------

    def defragment(self) -> Optional[np.ndarray]:
        """Compact live blocks into the lowest physical indices.

        Returns ``perm`` (n_blocks,) int32 with ``perm[new] = old`` — apply
        ``cache_k = cache_k[:, perm]`` (and same for v) on device, in the
        same transaction as uploading the rewritten ``self.table``.  Returns
        None when already compact (no device work needed).
        """
        # Live = every block some table or hold still references; a block
        # shared by k slots (or slot+trie) is live ONCE — it gets exactly
        # one new index and every referencing table maps through it.
        live: List[int] = []
        seen = set()
        for own in self._owned:
            for b in own:
                if b not in seen:
                    seen.add(b)
                    live.append(b)
        for b in sorted(self._held):       # held-only blocks (no slot ref)
            if b not in seen:
                seen.add(b)
                live.append(b)
        if sorted(live) == list(range(1, len(live) + 1)):
            return None
        old_to_new = {TRASH_BLOCK: TRASH_BLOCK}
        perm = np.empty((self.n_blocks,), np.int32)
        perm[TRASH_BLOCK] = TRASH_BLOCK
        nxt = 1
        for b in live:
            old_to_new[b] = nxt
            perm[nxt] = b
            nxt += 1
        # leftover physical indices map from the remaining old blocks
        rest = [b for b in range(1, self.n_blocks) if b not in old_to_new]
        for new, old in zip(range(nxt, self.n_blocks), rest):
            perm[new] = old
        for s, own in enumerate(self._owned):
            self._owned[s] = [old_to_new[b] for b in own]
            for i, b in enumerate(self._owned[s]):
                self.table[s, i] = b
        new_ref = np.zeros_like(self._ref)
        for old, new in old_to_new.items():
            new_ref[new] = self._ref[old]
        self._ref = new_ref
        self._held = {old_to_new[b]: c for b, c in self._held.items()}
        self._free = list(range(self.n_blocks - 1, nxt - 1, -1))
        self.defrags += 1
        self.version += 1
        for fn in self._remap_hooks:
            fn(old_to_new)
        return perm

    # -- invariant checking (tests / debug) --------------------------------

    def check(self) -> None:
        """Assert refcounts, holds, and the free list exactly partition
        the pool: every block 1..n-1 is either live (slot refcount ==
        its table occurrences, and/or positively held) or appears on the
        free list exactly once — never both, never neither."""
        owned = [b for own in self._owned for b in own]
        assert TRASH_BLOCK not in owned, "trash block allocated"
        assert TRASH_BLOCK not in self._free, "trash block on free list"
        assert TRASH_BLOCK not in self._held, "trash block held"
        assert self._ref[TRASH_BLOCK] == 0, "trash block refcounted"
        # refcount[b] == number of slot tables referencing b
        counts = np.zeros((self.n_blocks,), np.int64)
        for b in owned:
            counts[b] += 1
        assert (counts == self._ref).all(), \
            f"refcount drift: {np.flatnonzero(counts != self._ref)}"
        for b, c in self._held.items():
            assert c > 0, f"zero hold entry for {b}"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "duplicate free blocks"
        expect_free = {b for b in range(1, self.n_blocks)
                       if counts[b] == 0 and b not in self._held}
        assert free_set == expect_free, (
            f"free-list drift: leaked={sorted(expect_free - free_set)} "
            f"premature={sorted(free_set - expect_free)}")
        for s, own in enumerate(self._owned):
            got = list(self.table[s, :len(own)])
            assert got == own, f"slot {s} table mismatch"
            assert (self.table[s, len(own):] == TRASH_BLOCK).all(), \
                f"slot {s} stale table tail"


def paged_geometry(s_max: int, block_size: int) -> int:
    """max_blocks_per_slot for a given logical capacity (s_max must divide
    evenly so the gathered logical cache is exactly (slots, s_max))."""
    if s_max % block_size:
        raise ValueError(f"s_max={s_max} not a multiple of "
                         f"block_size={block_size}")
    return s_max // block_size


__all__ = ["BlockAllocator", "CacheStats", "paged_geometry", "TRASH_BLOCK"]
