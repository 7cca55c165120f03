"""Heap on an injected less-fn (reference util/priority_queue.go:26-95)."""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable


class PriorityQueue:
    """Stable heap ordered by a strict less(l, r) -> bool function."""

    def __init__(self, less_fn: Callable[[Any, Any], bool]):
        self._less = less_fn
        self._heap = []
        self._counter = itertools.count()

    def push(self, item) -> None:
        heapq.heappush(self._heap, _Entry(item, next(self._counter), self._less))

    def pop(self):
        if not self._heap:
            return None
        return heapq.heappop(self._heap).item

    def empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)


class KeySortedQueue:
    """PriorityQueue-shaped wrapper over ONE key-based sort.

    Valid only while the ordering keys are frozen (no session mutation
    between pushes and pops) — solver-mode collection and the enqueue
    action qualify; the host allocate loop, whose comparators read live
    shares, does not. Replaces O(n log n) comparator dispatches (each a
    tier walk over plugin fns) with a single C-speed sort."""

    __slots__ = ("_key", "_items", "_sorted", "_pos")

    def __init__(self, key: Callable[[Any], Any]):
        self._key = key
        self._items = []
        self._sorted = False
        self._pos = 0

    def push(self, item) -> None:
        if self._sorted:  # a post-sort push re-opens the list
            self._items = self._items[self._pos:]
            self._sorted = False
            self._pos = 0
        self._items.append(item)

    def pop(self):
        if not self._sorted:
            self._items.sort(key=self._key)
            self._sorted = True
            self._pos = 0
        if self._pos >= len(self._items):
            return None
        item = self._items[self._pos]
        self._pos += 1
        return item

    def empty(self) -> bool:
        return self._pos >= len(self._items)

    def __len__(self) -> int:
        return len(self._items) - self._pos


class _Entry:
    __slots__ = ("item", "seq", "less")

    def __init__(self, item, seq, less):
        self.item = item
        self.seq = seq
        self.less = less

    def __lt__(self, other) -> bool:
        if self.less(self.item, other.item):
            return True
        if self.less(other.item, self.item):
            return False
        return self.seq < other.seq
