"""Fixed-size LRU set (reference txvotepool ``mapTxCache``, :388-451).

push() returns False when the key is already cached -- refreshing its
recency, like the reference's Push (list.MoveToBack before the false
return) -- and at capacity the least-recently-pushed entry is evicted.
"""

from __future__ import annotations

import threading


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
