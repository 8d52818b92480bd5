"""Host-side paged-KV bookkeeping: block allocator + per-kind block tables.

Pure numpy/host state — nothing here is traced. The engine allocates a
slot's blocks at admission (enough to cover prompt + max_new tokens, so a
running request can never hit pool exhaustion mid-decode; lazy growth with
preemption is a ROADMAP item), frees them at eviction, and re-uses both
slots and physical blocks across requests. Fragmentation is the point:
after a few evictions a slot's logical ring maps to scattered physical
blocks, which is exactly what the paged gather/scatter path must survive
(the parity tests drive this).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np


class BlockAllocator:
    """Free-list allocator over one physical pool."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free = deque(range(n_blocks))
        self.high_water = 0
        self.total_allocs = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n physical blocks, or None if the pool can't cover them."""
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        self.total_allocs += n
        self.high_water = max(self.high_water,
                              self.n_blocks - len(self._free))
        return out

    def free(self, blocks: Sequence[int]) -> None:
        self._free.extend(blocks)

    def reset_stats(self) -> None:
        """Restart the diagnostics counters (post-warmup measurement)."""
        self.high_water = self.n_blocks - len(self._free)
        self.total_allocs = 0


class BlockTables:
    """Per-attention-kind block tables [n_slots, nb_kind], -1 = unmapped.

    One table per kind (not per layer): every 'local' layer shares the
    local ring geometry, every 'global' layer the global one, so one
    logical->physical map per kind serves the whole stack. Device uploads
    (covered-prefix sliced + cached) live in ServeEngine._device_tables —
    this class stays pure host state."""

    def __init__(self, n_slots: int, blocks_per_slot: Dict[str, int],
                 pool_blocks: Dict[str, int]):
        self.n_slots = n_slots
        self.blocks_per_slot = dict(blocks_per_slot)
        self.tables = {
            kind: np.full((n_slots, nb), -1, np.int32)
            for kind, nb in blocks_per_slot.items()
        }
        self.allocators = {
            kind: BlockAllocator(pool_blocks[kind])
            for kind in blocks_per_slot
        }
        self._slot_blocks: Dict[int, Dict[str, List[int]]] = {}

    @property
    def kinds(self) -> List[str]:
        return sorted(self.tables)

    def reset_stats(self) -> None:
        for a in self.allocators.values():
            a.reset_stats()

    def assign(self, slot: int) -> bool:
        """Map a full ring of blocks for `slot`; False if any pool is
        exhausted (nothing is allocated in that case)."""
        got: Dict[str, List[int]] = {}
        for kind, nb in self.blocks_per_slot.items():
            blocks = self.allocators[kind].alloc(nb)
            if blocks is None:
                for k2, b2 in got.items():
                    self.allocators[k2].free(b2)
                return False
            got[kind] = blocks
        for kind, blocks in got.items():
            self.tables[kind][slot, :] = blocks
        self._slot_blocks[slot] = got
        return True

    def release(self, slot: int) -> None:
        for kind, blocks in self._slot_blocks.pop(slot, {}).items():
            self.allocators[kind].free(blocks)
            self.tables[kind][slot, :] = -1

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {
            k: {"pool_blocks": a.n_blocks, "free": a.free_count,
                "high_water": a.high_water, "total_allocs": a.total_allocs}
            for k, a in self.allocators.items()
        }
