"""Host side of the paged KV cache: the refcounting block allocator and
the prefix cache.

The port's own copy of ``repro.serve.paging`` (pure host bookkeeping, no
framework).  Block 0 is the reserved trash block; ``capacity`` counts
usable blocks only.  ``BlockPool`` keeps a holder list per block
(sequences and the prefix cache), so a shared block returns to the free
list only when its last holder frees it; only a sole holder may write
(``writable``).  ``PrefixCache`` indexes full prompt blocks by a chain
key over their token chunks, so a later request with the same
block-aligned prefix adopts those blocks instead of prefilling them.

One difference from the reference: a chain key is a BLAKE2b digest of
(parent key, chunk), where the reference takes Python's ``hash()``, so
the port's keys are the same in every process whatever
``PYTHONHASHSEED`` is (the reference's own on/off test is flaky across
hash seeds).  ``_key`` stays a hook, so a test can force a collision.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.models.model import set_block_tables

__all__ = ["BlockPool", "PrefixCache", "blocks_for", "set_block_tables"]


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` KV entries."""
    return -(-max(n_tokens, 0) // block_size)


class BlockPool:
    """Refcounting free-list allocator over the shared block pool."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: deque = deque(range(1, num_blocks))
        self._holders: Dict[int, List[object]] = {}

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.capacity - len(self._free)

    def occupancy(self) -> float:
        return self.used_blocks / self.capacity

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    def alloc(self, owner, n: int = 1) -> Optional[List[int]]:
        """Allocate ``n`` exclusive blocks (all or nothing)."""
        if n > len(self._free):
            return None
        out = []
        for _ in range(n):
            b = self._free.popleft()
            assert b not in self._holders, f"double-booked block {b}"
            assert b != 0, "trash block leaked into the free list"
            self._holders[b] = [owner]
            out.append(b)
        return out

    def share(self, blocks: Sequence[int], owner) -> None:
        """Add ``owner`` as a holder of each allocated block (refcount +
        1).  Shared blocks are immutable: the scheduler shares only full,
        registered prompt blocks."""
        for b in blocks:
            hs = self._holders.get(b)
            assert hs, f"sharing unallocated block {b}"
            assert owner not in hs, f"owner {owner} already holds block {b}"
            hs.append(owner)

    def free(self, blocks: Sequence[int], owner) -> None:
        """Release ``owner``'s hold; recycle a block at refcount 0."""
        for b in blocks:
            hs = self._holders.get(b)
            assert hs is not None, f"double-free of block {b}"
            assert owner in hs, f"block {b} not held by {owner} " \
                                f"(holders: {hs})"
            hs.remove(owner)
            if not hs:
                del self._holders[b]
                self._free.append(b)

    def refcount(self, block: int) -> int:
        return len(self._holders.get(block, ()))

    def writable(self, block: int, owner) -> bool:
        """Only the sole holder may write a block."""
        return self._holders.get(block) == [owner]

    def owned_by(self, owner) -> List[int]:
        return [b for b, hs in self._holders.items() if owner in hs]

    def check(self) -> None:
        """Assert the pool's books balance."""
        assert len(self._free) + len(self._holders) == self.capacity
        assert not (set(self._free) & set(self._holders))
        for b, hs in self._holders.items():
            assert len(hs) >= 1, f"allocated block {b} with no holders"
            assert len(hs) == len(set(map(id, hs))), \
                f"duplicate holder on block {b}"


# ---------------------------------------------------------------------------
# prefix cache: chain-keyed index over block-aligned token chunks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Entry:
    """One cached block: the KV of ``tokens`` at logical block ``depth``
    under the chain ``parent`` (None: block 0 of a sequence)."""
    key: int
    parent: Optional[int]
    tokens: Tuple[int, ...]
    block: int
    depth: int
    children: Set[int] = dataclasses.field(default_factory=set)
    last_used: int = 0


class PrefixCache:
    """Chain key of block-aligned token chunks -> live pool block.

    Block ``j``'s key commits to every token from position 0 (it digests
    block ``j - 1``'s key with its own chunk), and a lookup also checks
    each entry's tokens and parent key, so a key collision is a miss,
    never a foreign block.  The cache is a holder of every entry's block
    (prefixes stay warm after their writers retire); eviction is LRU,
    leaf first, and takes only blocks the cache alone holds.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.entries: Dict[int, _Entry] = {}
        self._roots: Set[int] = set()
        self._tick = 0
        self.evictions = 0

    def __len__(self) -> int:
        """Cached blocks (each entry holds one)."""
        return len(self.entries)

    @staticmethod
    def _key(parent: Optional[int], chunk: Tuple[int, ...]) -> int:
        h = hashlib.blake2b(digest_size=8)
        h.update(b"-" if parent is None else parent.to_bytes(8, "little"))
        for t in chunk:
            h.update(int(t).to_bytes(8, "little", signed=True))
        return int.from_bytes(h.digest(), "little")

    def _touch(self, e: _Entry) -> None:
        self._tick += 1
        e.last_used = self._tick

    # ------------------------------------------------------------------
    def lookup(self, tokens, max_blocks: int):
        """Longest cached chain covering ``tokens``, at most
        ``max_blocks`` full blocks: ``(blocks, last_key)`` (``last_key``
        None on a miss).  Touches LRU; takes no reference (the caller
        shares the blocks before anything can evict them)."""
        bs = self.pool.block_size
        blocks: List[int] = []
        parent: Optional[int] = None
        for j in range(max_blocks):
            chunk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            if len(chunk) < bs:
                break
            key = self._key(parent, chunk)
            e = self.entries.get(key)
            # tokens AND parent key checked: by induction over j the whole
            # history matches, so a collision degrades to a miss
            if e is None or e.tokens != chunk or e.parent != parent:
                break
            self._touch(e)
            blocks.append(e.block)
            parent = key
        return blocks, parent

    def cached_overlap(self, parent_key: Optional[int], tail) -> int:
        """Longest common token prefix of ``tail`` (the request's tokens
        inside its first un-adopted block) and any cached chunk under
        ``parent_key``: tokens recomputed rather than copied (CoW by
        recompute; the shared block is never written)."""
        tail = [int(t) for t in tail]
        if not tail:
            return 0
        kids = self._roots if parent_key is None \
            else self.entries[parent_key].children
        best = 0
        for k in kids:
            n = 0
            for a, b in zip(tail, self.entries[k].tokens):
                if a != b:
                    break
                n += 1
            best = max(best, n)
        return best

    def register(self, parent_key: Optional[int], chunk: Tuple[int, ...],
                 block: int) -> Optional[int]:
        """Index ``block`` as holding ``chunk`` under ``parent_key``'s
        chain; the cache takes a reference.  An identical entry is
        touched and its key returned (the writer keeps its private copy).
        Returns None, and the caller stops registering the chain, on a
        key collision with other tokens or parent, or when the parent
        entry was evicted (a root there would be unreachable)."""
        assert len(chunk) == self.pool.block_size, "only full blocks cache"
        key = self._key(parent_key, chunk)
        e = self.entries.get(key)
        if e is not None:
            if e.tokens != chunk or e.parent != parent_key:
                return None
            self._touch(e)
            return key
        parent = None
        if parent_key is not None:
            parent = self.entries.get(parent_key)
            if parent is None:
                return None
        e = _Entry(key=key, parent=parent_key, tokens=tuple(chunk),
                   block=block,
                   depth=0 if parent is None else parent.depth + 1)
        self.pool.share([block], self)
        self.entries[key] = e
        self._touch(e)
        if parent is None:
            self._roots.add(key)
        else:
            parent.children.add(key)
        return key

    # ------------------------------------------------------------------
    def evictable(self) -> int:
        """Blocks iterated leaf-first eviction could free now: an entry
        whose block only the cache holds and whose every child is
        freeable (a pinned descendant pins its ancestors)."""
        freeable: Dict[int, bool] = {}
        for e in sorted(self.entries.values(), key=lambda e: -e.depth):
            freeable[e.key] = (self.pool.refcount(e.block) == 1 and
                               all(freeable[k] for k in e.children))
        return sum(freeable.values())

    def _drop(self, e: _Entry) -> None:
        del self.entries[e.key]
        if e.parent is None:
            self._roots.discard(e.key)
        else:
            parent = self.entries.get(e.parent)
            if parent is not None:
                parent.children.discard(e.key)
        self.pool.free([e.block], self)

    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks, least recently used leaf first,
        skipping blocks live sequences still hold.  Returns the count."""
        freed = 0
        while freed < n:
            best = None
            for e in self.entries.values():
                if e.children or self.pool.refcount(e.block) != 1:
                    continue
                if best is None or e.last_used < best.last_used:
                    best = e
            if best is None:
                break
            self._drop(best)
            freed += 1
        self.evictions += freed
        return freed

    def clear(self) -> None:
        """Release every cache reference (blocks shared with sequences
        stay theirs); a drained engine's pool is then all free."""
        for e in list(self.entries.values()):
            self.pool.free([e.block], self)
        self.entries.clear()
        self._roots.clear()
