"""Key-value database backends (reference tm-cmn/db: goleveldb / memdb),
the counterpart of ``txflow_tpu/store/db.py``.

MemDB mirrors dbm.NewMemDB; FileDB is the durable backend -- an
append-only data log with an in-memory index, in the JAX package's record
format, so either package reads the other's files. Both are thread-safe
and iterate in sorted key order like the reference's backends. The JAX
package's disk-fault failpoints are left out.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
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

    def close(self) -> None:
        pass


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


_REC = struct.Struct("<IIi")  # crc, key len, value len (-1 = tombstone)


class FileDB(DB):
    """Log-structured KV file: records ``crc | klen | vlen | key | value``.

    A torn tail is truncated on open. All reads are served from the
    in-memory index; writes append, and set_sync (or set_many with sync)
    fsyncs -- the durability point the stores rely on.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._mtx = threading.Lock()
        self._data: dict[bytes, bytes] = {}
        self._load()
        self._f = open(path, "ab")

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        good_end = 0
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(_REC.size)
                if len(hdr) < _REC.size:
                    break
                crc, klen, vlen = _REC.unpack(hdr)
                body = f.read(klen + max(vlen, 0))
                if len(body) < klen + max(vlen, 0) or zlib.crc32(body) != crc:
                    break
                key = body[:klen]
                if vlen < 0:
                    self._data.pop(key, None)
                else:
                    self._data[key] = body[klen:]
                good_end = f.tell()
        if good_end < os.path.getsize(self.path):
            with open(self.path, "r+b") as f:
                f.truncate(good_end)

    def _append(self, key: bytes, value: bytes | None, sync: bool) -> None:
        body = key + (value or b"")
        rec = _REC.pack(zlib.crc32(body), len(key), -1 if value is None else len(value)) + body
        self._f.write(rec)
        self._f.flush()
        if sync:
            os.fsync(self._f.fileno())

    def get(self, key: bytes) -> bytes | None:
        with self._mtx:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._mtx:
            self._data[key] = value
            self._append(key, value, sync=False)

    def set_sync(self, key: bytes, value: bytes) -> None:
        with self._mtx:
            self._data[key] = value
            self._append(key, value, sync=True)

    def set_many(self, pairs: list[tuple[bytes, bytes]], sync: bool = False) -> None:
        """One lock hold, one buffered append (a single OS write), at most
        one fsync for the whole group."""
        if not pairs:
            return
        with self._mtx:
            buf = bytearray()
            for key, value in pairs:
                self._data[key] = value
                body = key + value
                buf += _REC.pack(zlib.crc32(body), len(key), len(value))
                buf += body
            self._f.write(buf)
            self._f.flush()
            if sync:
                os.fsync(self._f.fileno())

    def delete(self, key: bytes) -> None:
        with self._mtx:
            if key in self._data:
                del self._data[key]
                self._append(key, None, sync=False)

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        with self._mtx:
            keys = sorted(k for k in self._data if k >= start and (end is None or k < end))
            items = [(k, self._data[k]) for k in keys]
        yield from items

    def close(self) -> None:
        with self._mtx:
            if not self._f.closed:
                self._f.flush()
                self._f.close()
