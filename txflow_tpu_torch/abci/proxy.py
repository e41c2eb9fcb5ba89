"""AppConns: the multiplexed, serialized application proxy.

The reference opens three logical ABCI connections to one app (mempool,
consensus, query) through ``proxy.AppConns`` (node/node.go:576); a local
client serializes all calls with one mutex. Same here for the two the fast
path uses (mempool, consensus): one lock around the app preserves the ABCI
ordering contract.

Async semantics: the reference's DeliverTxAsync queues and returns
(txflowstate/execution.go:169-177). Here async submission returns a
``Future``-like holder resolved inline — callbacks preserve ordering —
which keeps the engine code shaped like the reference's flush-then-collect
without a background thread per connection.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from .application import Application
from .types import ResponseCheckTx, ResponseCommit


@dataclass
class _Result:
    value: object = None


class _Conn:
    # in-process direct calls: a CheckTx costs microseconds, so callers
    # may hold their own locks across small call groups (pools use this
    # to pick a batched vs per-call ingest strategy)
    is_local = True

    def __init__(self, app: Application, lock: threading.RLock):
        self._app = app
        self._lock = lock
        self._error: Exception | None = None

    def error(self) -> Exception | None:
        return self._error

    def flush(self) -> None:
        # local client: everything is already applied by the time a call
        # returns; flush is a fence for API parity.
        with self._lock:
            pass


class AppConnMempool(_Conn):
    def check_tx_sync(self, tx: bytes) -> ResponseCheckTx:
        with self._lock:
            return self._app.check_tx(tx)


class AppConnConsensus(_Conn):
    def deliver_tx_async(self, tx: bytes, callback=None) -> _Result:
        res = _Result()
        with self._lock:
            res.value = self._app.deliver_tx(tx)
        if callback is not None:
            callback(res.value)
        return res

    def commit_sync(self) -> ResponseCommit:
        with self._lock:
            return self._app.commit()


class AppConns:
    """The fast path's logical connections over one serialized local app."""

    def __init__(self, app: Application):
        self.app = app
        lock = threading.RLock()
        self.mempool = AppConnMempool(app, lock)
        self.consensus = AppConnConsensus(app, lock)
