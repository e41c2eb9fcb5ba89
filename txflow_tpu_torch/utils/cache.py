"""Fixed-size LRU set (reference txvotepool ``mapTxCache``, :388-451).

push() returns False when the key is already cached -- refreshing its
recency, like the reference's Push (list.MoveToBack before the false
return) -- and at capacity the least-recently-pushed entry is evicted.
``LRUMap`` is the gossip reactor's wire-segment map
(``txflow_tpu/utils/cache.py:167``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class LRUCache:
    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("cache size must be positive")
        self.size = size
        self._mtx = threading.Lock()
        self._map: dict[bytes, None] = {}

    def push(self, key: bytes) -> bool:
        """Add key; False if already present (recency refreshed)."""
        with self._mtx:
            m = self._map
            if key in m:
                del m[key]  # re-insert puts it at the back (MoveToBack)
                m[key] = None
                return False
            if len(m) >= self.size:
                del m[next(iter(m))]
            m[key] = None
            return True

    def remove(self, key: bytes) -> None:
        with self._mtx:
            self._map.pop(key, None)

    def __contains__(self, key: bytes) -> bool:
        with self._mtx:
            return key in self._map

    def __len__(self) -> int:
        with self._mtx:
            return len(self._map)


class LRUMap:
    """Fixed-size LRU key->value map (wire-segment dedup in the reactors)."""

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("cache size must be positive")
        self.size = size
        self._mtx = threading.Lock()
        self._map: OrderedDict[bytes, object] = OrderedDict()

    def get(self, key: bytes):
        with self._mtx:
            v = self._map.get(key)
            if v is not None:
                self._map.move_to_end(key)
            return v

    def peek(self, key: bytes):
        """Read without the lock and without a recency update: a dict
        lookup is atomic under the interpreter lock, and a racing peek can
        only miss a value being inserted, which a caller treats as a miss.
        Recency advances on put alone."""
        return self._map.get(key)

    def put(self, key: bytes, value) -> None:
        with self._mtx:
            if key in self._map:
                self._map.move_to_end(key)
            elif len(self._map) >= self.size:
                self._map.popitem(last=False)
            self._map[key] = value

    def clear(self) -> None:
        with self._mtx:
            self._map.clear()
