"""Shared pool plumbing: ingest log, seq wakeups, cursor walks.

Both pools (mempool, txvotepool) expose the same consumer protocol:

- ``seq()`` / ``wait_for_new(last_seq, timeout)`` -- a monotonic ingest
  counter with condition-variable wakeups (the CList TxsWaitChan analog);
- ``entries_from(cursor, limit)`` -- a stable-cursor walk over the ingest
  log (the CList pointer-walk analog, reference txvotepool/reactor.go:
  198-265): removals never shift a cursor.

The log is append-only but compacted: once enough removed keys accumulate
at its head, the dead prefix is dropped and a base offset advances.
Cursors are absolute positions, so a walker behind the new base resumes
at the base -- it only skips entries that were already dead.
"""

from __future__ import annotations

import threading

# Compact when at least this many dead entries can be dropped at once.
COMPACT_THRESHOLD = 4096


class IngestLogPool:
    """Subclasses store live items in ``self._items`` (an insertion-ordered
    dict keyed by bytes) and call ``_log_append`` on accept /
    ``_log_compact`` after bulk removals, all under ``self._mtx``."""

    def __init__(self):
        self._mtx = threading.RLock()
        self._cond = threading.Condition(self._mtx)
        self._seq = 0
        self._log: list[bytes] = []
        self._log_base = 0  # absolute position of _log[0]
        self._items: dict[bytes, object] = {}

    # -- ingest bookkeeping (call under self._mtx) --

    def _log_append(self, key: bytes, notify: bool = True) -> None:
        self._log.append(key)
        self._seq += 1
        if notify:
            self._cond.notify_all()

    def _log_compact(self) -> None:
        """Drop the longest dead prefix once it crosses the threshold
        (the scan only runs when the log holds COMPACT_THRESHOLD more
        entries than live items, so removals stay amortized O(1))."""
        log = self._log
        items = self._items
        if len(log) - len(items) < COMPACT_THRESHOLD:
            return
        n = 0
        while n < len(log) and log[n] not in items:
            n += 1
        if n >= COMPACT_THRESHOLD:
            del log[:n]
            self._log_base += n

    # -- consumer protocol --

    def seq(self) -> int:
        """Monotonic ingest counter; pairs with wait_for_new."""
        with self._mtx:
            return self._seq

    def wait_for_new(self, last_seq: int, timeout: float) -> int:
        """Block until an item arrives after last_seq (or timeout); returns
        the current seq."""
        with self._cond:
            if self._seq == last_seq:
                self._cond.wait(timeout)
            return self._seq

    def _entries_from(self, cursor: int, limit: int):
        """(list of (key, item), new_cursor): live entries only, in ingest
        order, from an absolute cursor."""
        out = []
        with self._mtx:
            pos = max(cursor, self._log_base)
            while pos - self._log_base < len(self._log) and len(out) < limit:
                key = self._log[pos - self._log_base]
                item = self._items.get(key)
                if item is not None:
                    out.append((key, item))
                pos += 1
        return out, pos
