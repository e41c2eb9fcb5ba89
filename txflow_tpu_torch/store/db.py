"""Key-value database (reference tm-cmn/db memdb): the in-memory backend
the port's slice stores certificates in. Thread-safe; iterates in sorted
key order like the reference's backends.
"""

from __future__ import annotations

import threading
from typing import Iterator


class DB:
    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)

    def set_many(self, pairs: list[tuple[bytes, bytes]], sync: bool = False) -> None:
        """Write a group of rows as one unit (one lock hold in MemDB)."""
        for k, v in pairs:
            self.set(k, v)
        if sync and pairs:
            self.set_sync(pairs[-1][0], pairs[-1][1])

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def iterate(self, start: bytes = b"", end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

class MemDB(DB):
    def __init__(self):
        self._mtx = threading.Lock()
        self._data: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> bytes | None:
        with self._mtx:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._mtx:
            self._data[key] = value

    def set_many(self, pairs: list[tuple[bytes, bytes]], sync: bool = False) -> None:
        with self._mtx:
            self._data.update(pairs)

    def delete(self, key: bytes) -> None:
        with self._mtx:
            self._data.pop(key, None)

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        with self._mtx:
            keys = sorted(k for k in self._data if k >= start and (end is None or k < end))
            items = [(k, self._data[k]) for k in keys]
        yield from items
