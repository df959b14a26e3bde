"""Token-prefix radix trie over paged KV blocks: the port's own copy of
``repro/inference/prefix_cache.py`` (host-side, pure Python).

Most serving traffic shares long system and tool prompts, and every
re-prefilled shared token pays the full TP all-reduce again.  This module
keys *physical KV blocks* by the prompt token ids they cover: admission
looks up the longest previously prefilled prefix of the incoming prompt,
splices those blocks into the new slot's table through
:meth:`~repro_torch.inference.kv_cache.BlockAllocator.share` (refcounts,
no copy), and chunk-prefills only the suffix.

Layout: one trie node per KV block.  A node's edge key is the exact
``block_size``-token group it covers, so a root-to-node path spells a
prompt prefix of ``depth * block_size`` tokens and stores the physical
block of each group.  Lookup is a dict walk a block group.

Pinning: every resident node takes one external *hold* on its block
(:meth:`BlockAllocator.hold`), keeping it off the free list after the
admitting slot exits.  Eviction is LRU over nodes whose block no slot
references, leaf first, and runs only inside admission or growth
(``capacity`` overflow after a publish, or :meth:`reclaim` under
allocation pressure), so the block table is frozen between batcher steps.

Determinism: a prompt's K/V at given positions is a function of its tokens
on one path, so a block published for token group ``g`` holds the K/V
re-prefilling ``g`` at the same positions would write: splicing is exact
(the port holds prefix on == off bitwise, both through chunked
admission).  Two concurrent misses of one group merely waste a block;
``insert`` keeps the first published.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .kv_cache import BlockAllocator


class _Node:
    """One KV block's worth of prompt tokens (an edge in the radix trie)."""
    __slots__ = ("key", "block", "parent", "children", "clock")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.clock = 0


class PrefixCache:
    """Radix trie of published prompt blocks, pinned via allocator holds.

    ``capacity``: max resident (held) blocks; inserts that push past it
    trigger LRU eviction of unreferenced nodes.  ``None`` = bounded only
    by the physical pool (reclaim under pressure still applies).
    Registers itself as a defragment remap hook on construction, so node
    block indices stay valid across :meth:`BlockAllocator.defragment`.
    """

    def __init__(self, alloc: BlockAllocator,
                 capacity: Optional[int] = None):
        self.alloc = alloc
        self.block_size = alloc.block_size
        self.capacity = capacity
        self._root = _Node((), -1, None)
        self._by_block: Dict[int, _Node] = {}
        self._clock = 0
        self.evictions = 0
        alloc.register_remap_hook(self.remap)

    # -- queries -----------------------------------------------------------

    @property
    def held_blocks(self) -> int:
        return len(self._by_block)

    @property
    def nodes(self) -> int:
        return len(self._by_block)

    def _groups(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n = len(tokens) // bs
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n)]

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest-prefix lookup: the physical blocks covering the most
        leading *complete* block groups of ``tokens`` already resident.
        Refreshes the LRU clock along the matched path."""
        self._clock += 1
        node = self._root
        blocks: List[int] = []
        for key in self._groups(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.clock = self._clock
            blocks.append(child.block)
            node = child
        return blocks

    # -- publication -------------------------------------------------------

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Publish a prefilled prompt's complete block groups.

        ``blocks``: the admitting slot's physical block for each group
        (``alloc.table[slot]`` prefix).  Groups already resident keep
        their first-published block (bit-identical contents — see module
        docstring); new groups take a hold on the slot's block, making
        it survive the slot.  Returns the number of newly pinned blocks.
        May evict LRU unreferenced nodes to stay within ``capacity``.
        """
        self._clock += 1
        node = self._root
        new = 0
        for key, b in zip(self._groups(tokens), blocks):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(b), node)
                self.alloc.hold([int(b)])
                self._by_block[int(b)] = child
                node.children[key] = child
                new += 1
            child.clock = self._clock
            node = child
        if self.capacity is not None and self.held_blocks > self.capacity:
            self._evict_lru(self.held_blocks - self.capacity)
        return new

    # -- eviction ----------------------------------------------------------

    def _evictable(self) -> List[_Node]:
        """Leaves whose block no slot currently references."""
        return [n for n in self._by_block.values()
                if not n.children and self.alloc.slot_refs(n.block) == 0]

    def _drop(self, node: _Node) -> int:
        """Unlink one leaf and release its hold; returns blocks freed."""
        assert not node.children
        del node.parent.children[node.key]
        del self._by_block[node.block]
        self.evictions += 1
        return len(self.alloc.release([node.block]))

    def _evict_lru(self, n_nodes: int) -> int:
        """Evict up to ``n_nodes`` unreferenced leaves, oldest clock
        first (re-scanning as interior nodes become leaves)."""
        dropped = 0
        while dropped < n_nodes:
            cands = self._evictable()
            if not cands:
                break
            self._drop(min(cands, key=lambda nd: nd.clock))
            dropped += 1
        return dropped

    def reclaim(self, n_blocks: int) -> int:
        """Free at least ``n_blocks`` physical blocks by evicting LRU
        unreferenced nodes; returns blocks actually freed.  Called by the
        batcher under allocation pressure *before* it preempts a live
        request — cold cache beats evicted traffic."""
        freed = 0
        while freed < n_blocks:
            cands = self._evictable()
            if not cands:
                break
            freed += self._drop(min(cands, key=lambda nd: nd.clock))
        return freed

    def invalidate_block(self, phys: int) -> int:
        """Drop the node owning ``phys`` and its whole subtree (a
        poisoned/scrubbed block invalidates every extension of its
        prefix).  No-op if ``phys`` is not resident.  Returns nodes
        dropped."""
        node = self._by_block.get(phys)
        if node is None:
            return 0
        stack, order = [node], []
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        for n in reversed(order):          # leaves first
            self._drop(n)
        return len(order)

    # -- defragment support ------------------------------------------------

    def remap(self, old_to_new: Dict[int, int]) -> None:
        """Rewrite node block indices after a defragment (allocator remap
        hook) — each resident block moves exactly once."""
        by_block: Dict[int, _Node] = {}
        for b, node in self._by_block.items():
            node.block = old_to_new[b]
            by_block[node.block] = node
        self._by_block = by_block


__all__ = ["PrefixCache"]
