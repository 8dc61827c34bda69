"""Host side of the paged KV cache: the refcounting block allocator.

The port's own copy of ``repro.serve.paging.BlockPool`` and
``blocks_for`` (pure host bookkeeping, no framework).  Block 0 is the
reserved trash block; ``capacity`` counts usable blocks only.  The
prefix cache (``PrefixCache``) is not ported yet (ROADMAP.md queue 1
item 9), so every block here has exactly one holder; the holder lists
keep the reference's double-booking and double-free checks.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

from repro_torch.models.model import set_block_tables

__all__ = ["BlockPool", "blocks_for", "set_block_tables"]


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

    def check(self) -> None:
        """Assert the pool's books balance."""
        assert len(self._free) + len(self._holders) == self.capacity
        assert not (set(self._free) & set(self._holders))
        for b, hs in self._holders.items():
            assert len(hs) >= 1, f"allocated block {b} with no holders"
            assert len(hs) == len(set(map(id, hs))), \
                f"duplicate holder on block {b}"
