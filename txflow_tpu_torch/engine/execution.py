"""TxExecutor: single-tx execution engine (reference txflowstate/execution.go).

ApplyTx pipeline, order preserved from the reference (:77-104): DeliverTx
on the consensus connection -> app Commit with the mempool locked
(:112-155) -> mempool.update removes the tx -> the per-tx commit event,
published last (:190-195).
"""

from __future__ import annotations

import hashlib
import threading

from ..abci.proxy import AppConnConsensus
from ..pool.mempool import Mempool
from ..utils.events import EventBus, EventDataTx, EventTx


class TxExecutor:
    def __init__(
        self,
        proxy_app: AppConnConsensus,
        mempool: Mempool,
        event_bus: EventBus | None = None,
    ):
        self.proxy_app = proxy_app
        self.mempool = mempool
        self.event_bus = event_bus
        # one DeliverTx -> Commit fence is the unit of atomicity against
        # the app
        self._seam_mtx = threading.Lock()

    def apply_tx(
        self,
        height: int,
        tx: bytes,
        tx_hash: str | None = None,
        tx_key: bytes | None = None,
    ):
        """Execute + commit one fast-path tx; returns (app_hash, deliver_res).
        tx_hash / tx_key skip a sha256 when the caller already has them."""
        with self._seam_mtx:
            res = self.proxy_app.deliver_tx_async(tx)
            self.proxy_app.flush()
            deliver_res = res.value
            app_hash = self._commit(height, tx, deliver_res, tx_key)
        if self.event_bus is not None:
            self.event_bus.publish(
                EventTx,
                EventDataTx(
                    height=height,
                    tx=tx,
                    tx_hash=tx_hash or hashlib.sha256(tx).hexdigest().upper(),
                    result_code=deliver_res.code,
                    result_data=deliver_res.data,
                    result_log=deliver_res.log,
                    tags=list(getattr(deliver_res, "tags", []) or []),
                ),
            )
        return app_hash, deliver_res

    def _commit(
        self, height: int, tx: bytes, deliver_res, tx_key: bytes | None = None
    ) -> bytes:
        """App Commit under the mempool lock (reference Commit :112-155): no
        CheckTx may run against the app between Commit and mempool.update."""
        self.mempool.lock()
        try:
            self.proxy_app.flush()
            commit_res = self.proxy_app.commit_sync()
            self.mempool.update(
                height, [tx], [deliver_res],
                keys=[tx_key] if tx_key is not None else None,
            )
            return commit_res.data
        finally:
            self.mempool.unlock()
