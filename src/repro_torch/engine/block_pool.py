"""Global KV block pool + radix prefix index (host-side, vLLM-style).

A copy of the JAX package's ``engine/block_pool.py`` (pure Python): the
port keeps its own so that it imports nothing of the JAX package.

The block-paged cache divides KV storage into a single pool of
``n_blocks`` fixed-size blocks of ``block_size`` token positions each.
Requests own *block tables* — ordered lists of physical block ids whose
concatenation is the request's virtual KV sequence.  Blocks are
ref-counted: a physical block may appear in several tables at once
(prefix sharing) and is returned to the free list only when the last
reference drops.

:class:`RadixIndex` is a prefix tree over *full* blocks: each node is one
block of exactly ``block_size`` tokens, keyed by its token tuple, and the
root→node chain spells a block-aligned prompt prefix.  Matching a new
prompt walks the tree and returns the physical blocks of the longest
indexed prefix — those blocks are mapped into the new request's table
instead of being recomputed (prefix caching).  The index holds its own
reference on every indexed block; eviction (LRU, leaf-first so interior
chain nodes stay matchable) releases that reference, freeing the block
once no request uses it.

Writable blocks are always exclusively owned: only full, immutable blocks
are ever shared, and a request whose usable prefix ends mid-block gets a
*copy-on-write fork* — a fresh block whose contents are copied from the
shared one — before any token is written (see ``Engine._allocate``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


class PoolExhausted(RuntimeError):
    """Raised by :meth:`BlockPool.alloc` when no block is free."""


class BlockPool:
    """Ref-counted free-list allocator over ``n_blocks`` physical blocks."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1 or block_size < 1:
            raise ValueError("n_blocks and block_size must be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: collections.deque = collections.deque(range(n_blocks))
        self._ref = [0] * n_blocks

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    # ------------------------------------------------------------------
    def alloc(self) -> int:
        """Take one free block (refcount 1)."""
        if not self._free:
            raise PoolExhausted(f"all {self.n_blocks} KV blocks in use")
        b = self._free.popleft()
        self._ref[b] = 1
        return b

    def incref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise ValueError(f"incref on free block {block}")
        self._ref[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True if the block was freed."""
        if self._ref[block] <= 0:
            raise ValueError(f"decref on free block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)
            return True
        return False


@dataclasses.dataclass
class _RadixNode:
    key: Tuple[int, ...]                    # this block's token content
    block: int                              # physical block id
    parent: Optional["_RadixNode"]
    children: Dict[Tuple[int, ...], "_RadixNode"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0


class RadixIndex:
    """Prefix tree mapping block-aligned prompt prefixes → physical blocks.

    Only full blocks are indexed (a partial tail block is mutable and must
    stay private to its request).  The index holds one pool reference per
    indexed block.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.block_size = pool.block_size
        self.root = _RadixNode(key=(), block=-1, parent=None)
        self._clock = 0
        self.n_indexed = 0                  # blocks currently indexed

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _keys(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(len(tokens) // bs)]

    # ------------------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> List[int]:
        """Physical blocks of the longest indexed full-block prefix."""
        node, out = self.root, []
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick()
            out.append(child.block)
            node = child
        return out

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Index the full-block prefix of ``tokens`` backed by ``blocks``.

        Existing nodes win (the first request to index a prefix donates
        the physical blocks everyone else maps); only blocks backing NEW
        nodes gain an index reference.  Returns the number of blocks newly
        indexed.
        """
        node, new = self.root, 0
        now = self._tick()
        for key, block in zip(self._keys(tokens), blocks):
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key=key, block=block, parent=node,
                                   last_used=now)
                node.children[key] = child
                self.pool.incref(block)
                self.n_indexed += 1
                new += 1
            else:
                child.last_used = now
            node = child
        return new

    # ------------------------------------------------------------------
    def _leaves(self) -> List[_RadixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict(self, n_needed: int) -> int:
        """Free ``n_needed`` blocks by releasing index references (LRU,
        leaf-first) or stop when nothing evictable remains.

        Only leaves whose block holds no reference beyond the index's own
        are victims: evicting a block a running request (or an admission
        in progress) still references would destroy a warm, matchable
        entry without returning anything to the free list.  Returns the
        number of blocks actually freed.  O(index²) in the worst case,
        which is fine at serving-pool scale (the tree is per-engine and
        small).
        """
        freed = 0
        while freed < n_needed:
            leaves = [n for n in self._leaves()
                      if self.pool.refcount(n.block) == 1]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_used)
            del victim.parent.children[victim.key]
            self.n_indexed -= 1
            self.pool.decref(victim.block)
            freed += 1
        return freed
