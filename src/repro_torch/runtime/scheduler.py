"""Continuous-batching slot scheduler of the stream server (host side).

A copy of ``repro.runtime.scheduler``: the FIFO slot pool and the
round-robin refresh cohorts, with the cohorts' shard-local schedule for a
server whose slots are split into blocks.  Pure Python and numpy; nothing
here touches a device.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np


class RefreshCohorts:
    """Round-robin staggering of periodic per-slot refresh rounds.

    Slot i belongs to cohort ``i % n_cohorts``; cohort c comes due on steps
    where ``step % refresh_every`` hits its offset, the offsets spread evenly
    over the period.  Every slot is still refreshed once per
    ``refresh_every`` steps, but each step refreshes at most
    ``ceil(n_slots / n_cohorts)`` slots.  ``n_cohorts=1`` is the global
    round; ``n_cohorts`` is clamped to ``refresh_every``.
    """

    def __init__(self, n_slots: int, refresh_every: int, n_cohorts: int = 1):
        self.n_slots = int(n_slots)
        self.refresh_every = int(refresh_every)
        self.n_cohorts = max(1, min(int(n_cohorts), self.refresh_every))
        self.offsets = [
            (c * self.refresh_every) // self.n_cohorts
            for c in range(self.n_cohorts)
        ]
        self.cohort_of_slot = [i % self.n_cohorts for i in range(self.n_slots)]
        # fixed-shape schedule for the in-step refresh: every cohort's rows
        # padded to the largest cohort with DISTINCT non-cohort slots flagged
        # ok=False, so a scatter over the padded rows has no duplicates (a
        # pad row writes its own current value back)
        self.max_cohort_size = max(1, -(-self.n_slots // self.n_cohorts))
        self._fixed: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for c in range(self.n_cohorts):
            rows = [i for i in range(self.n_slots)
                    if self.cohort_of_slot[i] == c]
            ok = [True] * len(rows)
            pad_pool = [i for i in range(self.n_slots) if i not in set(rows)]
            while len(rows) < self.max_cohort_size:
                rows.append(pad_pool.pop(0) if pad_pool else 0)
                ok.append(False)
            self._fixed[self.offsets[c]] = (
                np.asarray(rows, np.int32), np.asarray(ok, bool)
            )
        self._idle_rows = (
            np.arange(self.max_cohort_size, dtype=np.int32) % self.n_slots,
            np.zeros(self.max_cohort_size, bool),
        )

    def due_cohort(self, step: int) -> Optional[int]:
        """Cohort index due at this server step, or None."""
        phase = step % self.refresh_every
        try:
            return self.offsets.index(phase)
        except ValueError:
            return None

    def due_slots(self, step: int) -> Optional[List[int]]:
        """Slot indices due at this server step, or None between rounds."""
        c = self.due_cohort(step)
        if c is None:
            return None
        return [i for i in range(self.n_slots) if self.cohort_of_slot[i] == c]

    def due_rows_fixed(
        self, step: int
    ) -> Tuple[bool, np.ndarray, np.ndarray]:
        """Fixed-shape view of ``due_slots``: ``(due, rows, ok)`` with
        ``rows``/``ok`` always ``max_cohort_size`` long.  Between rounds
        ``due`` is False and the rows are an arbitrary valid index set."""
        fixed = self._fixed.get(step % self.refresh_every)
        if fixed is None:
            rows, ok = self._idle_rows
            return False, rows, ok
        rows, ok = fixed
        return True, rows, ok

    def _sharded_fixed(
        self, n_shards: int
    ) -> Tuple[int, Dict[int, Tuple[np.ndarray, np.ndarray]]]:
        """Per-shard fixed-shape cohort schedules for the slot-sharded
        server: shard d owns the contiguous global slots ``[d * S/n, (d+1)
        * S/n)`` and its row lists hold *local* indices, so a block's
        refresh never indexes another block's slots.

        Every (cohort, shard) row list is padded to one common width
        ``r_loc`` (the max over cohorts and shards, so one refresh shape
        serves every round) with DISTINCT local non-cohort indices flagged
        ok=False, as ``due_rows_fixed`` pads.  Returns ``(r_loc, {phase:
        (rows, ok)})`` with ``rows``/``ok`` the shard-concatenated
        ``(n_shards * r_loc,)`` arrays.
        """
        if self.n_slots % n_shards:
            raise ValueError(
                f"{self.n_slots} slots not divisible by {n_shards} shards")
        s_loc = self.n_slots // n_shards
        members: Dict[Tuple[int, int], list] = {}
        r_loc = 1
        for c in range(self.n_cohorts):
            for d in range(n_shards):
                local = [i - d * s_loc for i in range(self.n_slots)
                         if self.cohort_of_slot[i] == c
                         and d * s_loc <= i < (d + 1) * s_loc]
                members[(c, d)] = local
                r_loc = max(r_loc, len(local))
        fixed: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for c in range(self.n_cohorts):
            rows_all, ok_all = [], []
            for d in range(n_shards):
                rows = list(members[(c, d)])
                ok = [True] * len(rows)
                pad_pool = [j for j in range(s_loc) if j not in set(rows)]
                while len(rows) < r_loc:
                    rows.append(pad_pool.pop(0) if pad_pool else 0)
                    ok.append(False)
                rows_all += rows
                ok_all += ok
            fixed[self.offsets[c]] = (
                np.asarray(rows_all, np.int32), np.asarray(ok_all, bool))
        return r_loc, fixed

    def due_rows_fixed_sharded(
        self, step: int, n_shards: int
    ) -> Tuple[bool, np.ndarray, np.ndarray]:
        """``due_rows_fixed`` for a slot axis split over ``n_shards``
        contiguous blocks: the same ``(due, rows, ok)`` contract, but
        ``rows`` holds shard-LOCAL indices, ``(n_shards * r_loc,)`` long
        (shard d's block at ``[d * r_loc, (d+1) * r_loc)``).  The padded
        rows write their own values back, so the refreshed slot set, and so
        the served episode, is the unsharded schedule's."""
        cache = getattr(self, "_sharded_cache", None)
        if cache is None:
            cache = self._sharded_cache = {}
        hit = cache.get(n_shards)
        if hit is None:
            r_loc, fixed = self._sharded_fixed(n_shards)
            s_loc = self.n_slots // n_shards
            idle = (
                np.tile(np.arange(r_loc, dtype=np.int32) % s_loc, n_shards),
                np.zeros(n_shards * r_loc, bool),
            )
            hit = cache[n_shards] = (fixed, idle)
        fixed, idle = hit
        got = fixed.get(step % self.refresh_every)
        if got is None:
            return False, idle[0], idle[1]
        return True, got[0], got[1]


class SlotScheduler:
    """Fixed-capacity slot pool with FIFO admission (continuous batching)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.queue: Deque[Any] = deque()
        self.slots: List[Optional[Any]] = [None] * n_slots
        self.completed: List[Any] = []

    def submit(self, item: Any) -> None:
        self.queue.append(item)

    def admit(
        self, on_admit: Optional[Callable[[int, Any], None]] = None
    ) -> List[int]:
        """Fill every free slot from the queue (FIFO); returns the indices
        admitted.  ``on_admit(slot, item)`` runs per admission."""
        admitted = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                item = self.queue.popleft()
                self.slots[i] = item
                if on_admit is not None:
                    on_admit(i, item)
                admitted.append(i)
        return admitted

    def retire(
        self, i: int, on_retire: Optional[Callable[[int, Any], None]] = None
    ) -> Any:
        """Free slot ``i`` into the completed list (it refills on the next
        ``admit``)."""
        item = self.slots[i]
        if item is None:
            raise ValueError(f"retire of empty slot {i}")
        self.slots[i] = None
        self.completed.append(item)
        if on_retire is not None:
            on_retire(i, item)
        return item

    def live(self) -> List[Tuple[int, Any]]:
        """(slot index, item) for every occupied slot."""
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def active(self) -> bool:
        """True while anything is in flight or waiting."""
        return any(s is not None for s in self.slots) or bool(self.queue)
