"""TxExecutor: single-tx execution engine (reference txflowstate/execution.go).

ApplyTx pipeline, order preserved from the reference (:77-104): DeliverTx
on the consensus connection -> app Commit with the mempool locked
(:112-155) -> mempool.update removes the tx -> the per-tx commit event,
published last (:190-195). ``apply_tx_batch`` group-commits several txs
under one app Commit fence (``txflow_tpu/engine/execution.py:107``), the
committer's path when ``EngineConfig.commit_interval`` > 1.
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
            self._publish(height, tx, deliver_res, tx_hash)
        return app_hash, deliver_res

    def _publish(self, height: int, tx: bytes, deliver_res, tx_hash: str | None) -> None:
        """The per-tx commit event (reference :190-195)."""
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

    def apply_tx_batch(
        self,
        height: int,
        items: list[tuple[bytes, str]],
        keys: list[bytes] | None = None,
    ):
        """Group commit of (tx, tx_hash) pairs: a DeliverTx per tx, one app
        Commit fence and one mempool update, then the per-tx events in
        order. Delivery, certificates, mempool removal and events are those
        of ``apply_tx`` per tx; only the fence is shared, so an app whose
        hash depends on its Commit cadence must keep commit_interval 1.
        Returns (app_hash, deliver_results)."""
        with self._seam_mtx:
            pending = [self.proxy_app.deliver_tx_async(tx) for tx, _ in items]
            self.proxy_app.flush()
            results = [p.value for p in pending]
            self.mempool.lock()
            try:
                self.proxy_app.flush()
                commit_res = self.proxy_app.commit_sync()
                self.mempool.update(height, [tx for tx, _ in items], results, keys=keys)
                app_hash = commit_res.data
            finally:
                self.mempool.unlock()
        if self.event_bus is not None:
            for (tx, tx_hash), res in zip(items, results):
                self._publish(height, tx, res, tx_hash)
        return app_hash, results

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
