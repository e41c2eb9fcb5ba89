"""Mempool: ordered pool of raw txs (reference mempool/clist_mempool.go).

Forked-mempool behaviors kept for the fast path:
- ABCI CheckTx gate on ingest (app connection serialized by the proxy);
- sha256 LRU dedup cache, size/bytes caps, peer-sender tracking;
- ``get_tx(tx_key)`` lookup by sha256 -- the fork's one addition
  (clist_mempool.go:171-177), used by TxFlow on quorum;
- ``update`` on commit removes txs; ``push_committed_many`` stages
  fast-committed txs in the commitpool;
- admission lanes (``txflow_tpu/pool/mempool.py:28-33``): the ``lane_of``
  classifier hook, per-lane counts, and reaps that serve the priority
  lane first.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.hash import sha256
from ..utils.cache import LRUCache
from ..utils.config import MempoolConfig
from .base import IngestLogPool

# mempool lanes: priority txs keep committing under overload while bulk
# traffic sheds at the edges. The constants live here so that admission
# imports them without the pool importing admission.
LANE_PRIORITY = 0
LANE_BULK = 1


class ErrTxInCache(Exception):
    pass


@dataclass
class ErrMempoolIsFull(Exception):
    num_txs: int
    max_txs: int
    txs_bytes: int
    max_txs_bytes: int

    def __str__(self):
        return (
            f"mempool is full: number of txs {self.num_txs} (max: {self.max_txs}), "
            f"total txs bytes {self.txs_bytes} (max: {self.max_txs_bytes})"
        )


@dataclass
class ErrTxTooLarge(Exception):
    max_size: int
    tx_size: int

    def __str__(self):
        return f"Tx too large. Max size is {self.max_size}, but got {self.tx_size}"


@dataclass
class TxInfo:
    sender_id: int = 0


@dataclass(slots=True)
class _MempoolTx:
    height: int
    gas_wanted: int
    tx: bytes
    senders: set[int] = field(default_factory=set)
    lane: int = LANE_BULK  # admission lane (classifier verdict at insert)


class Mempool(IngestLogPool):
    def __init__(self, config: MempoolConfig, proxy_app_conn=None, height: int = 0):
        super().__init__()
        self.config = config
        self.proxy_app = proxy_app_conn
        self.height = height
        self._txs: dict[bytes, _MempoolTx] = self._items  # tx_key -> entry
        self._txs_bytes = 0
        self.cache = LRUCache(config.cache_size)
        # admission lanes: lane_of is the classifier hook (tx -> lane; None
        # = everything bulk)
        self.lane_of = None
        self._lane_counts = [0, 0]  # live entries per lane (PRIORITY, BULK)

    def size(self) -> int:
        with self._mtx:
            return len(self._txs)

    # -- ingest (reference CheckTx/CheckTxWithInfo :220-303) --

    def check_tx(
        self, tx: bytes, tx_info: TxInfo | None = None, key: bytes | None = None
    ) -> None:
        """Raises on rejection; returns None when the tx entered the pool.
        The app conn is in-process, so its CheckTx runs under the lock."""
        with self._mtx:
            self._check_tx_locked(tx, tx_info or TxInfo(), key)

    def check_tx_many(
        self, txs: list[bytes], tx_info: TxInfo | None = None
    ) -> list[Exception | None]:
        """Batched ingest: the per-tx decisions of check_tx, errors
        returned instead of raised, in bounded lock groups of 64."""
        tx_info = tx_info or TxInfo()
        out: list[Exception | None] = [None] * len(txs)
        for base in range(0, len(txs), 64):
            with self._mtx:
                for i, tx in enumerate(txs[base : base + 64], base):
                    try:
                        self._check_tx_locked(tx, tx_info, None, notify=False)
                    except Exception as e:
                        out[i] = e
                self._cond.notify_all()
        return out

    def _check_tx_locked(
        self, tx: bytes, tx_info: TxInfo, key: bytes | None, notify: bool = True
    ) -> None:
        if key is None:
            key = sha256(tx)
        if (
            len(self._txs) >= self.config.size
            or len(tx) + self._txs_bytes > self.config.max_txs_bytes
        ):
            raise ErrMempoolIsFull(
                len(self._txs), self.config.size, self._txs_bytes, self.config.max_txs_bytes
            )
        if not self.cache.push(key):
            entry = self._txs.get(key)
            if entry is not None:
                entry.senders.add(tx_info.sender_id)
            raise ErrTxInCache()
        res = None
        if self.proxy_app is not None:
            try:
                res = self.proxy_app.check_tx_sync(tx)
            except BaseException:
                self.cache.remove(key)
                raise
            if not res.is_ok:
                self.cache.remove(key)
                raise ValueError(f"rejected by app CheckTx (code {res.code}): {res.log}")
        gas = res.gas_wanted if res is not None else 0
        lane = LANE_BULK
        if self.lane_of is not None:
            try:
                lane = self.lane_of(tx)
            except Exception:
                lane = LANE_BULK  # a hostile tx must not error the insert
            if lane != LANE_PRIORITY:
                lane = LANE_BULK
        self._txs[key] = _MempoolTx(self.height, gas, tx, {tx_info.sender_id}, lane)
        self._lane_counts[lane] += 1
        self._log_append(key, notify)
        self._txs_bytes += len(tx)

    # -- lookup (the fork's GetTx, clist_mempool.go:171-177) --

    def get_tx(self, tx_key: bytes) -> bytes | None:
        """Lock-free: the pool is content-addressed (key = sha256(tx)), so
        a key can only ever map to one byte string."""
        entry = self._txs.get(tx_key)
        return entry.tx if entry is not None else None

    def lane_of_key(self, tx_key: bytes) -> int:
        """Admission lane of a pooled tx (LANE_BULK when unknown or gone).
        Lock-free like get_tx: the verdict is immutable per entry. Votes
        inherit their tx's lane through this (``TxVotePool.lane_of_vote``)."""
        entry = self._txs.get(tx_key)
        return entry.lane if entry is not None else LANE_BULK

    def lane_size(self, lane: int) -> int:
        """Live entries in one admission lane."""
        with self._mtx:
            return self._lane_counts[lane]

    # -- reap (reference :306-355) --

    def _reap_order(self):
        """Iteration order for reaps (call under _mtx): priority entries
        first, insertion order within each lane."""
        if self._lane_counts[LANE_PRIORITY] == 0:
            return self._txs.values()
        entries = list(self._txs.values())
        return [e for e in entries if e.lane == LANE_PRIORITY] + [
            e for e in entries if e.lane != LANE_PRIORITY
        ]

    def reap_max_txs(self, n: int) -> list[bytes]:
        with self._mtx:
            if n < 0:
                n = len(self._txs)
            return [e.tx for e in list(self._reap_order())[:n]]

    # -- update on commit (reference :358-422) --

    def lock(self) -> None:
        self._mtx.acquire()

    def unlock(self) -> None:
        self._mtx.release()

    def update(
        self,
        height: int,
        txs: list[bytes],
        deliver_results: list | None = None,
        keys: list[bytes] | None = None,
    ) -> None:
        """Remove committed txs. Caller holds the lock (like the reference).
        keys: precomputed sha256 per tx (commit path: vs.tx_key)."""
        self.height = height
        for i, tx in enumerate(txs):
            key = keys[i] if keys is not None else sha256(tx)
            ok = deliver_results is None or (
                i < len(deliver_results) and deliver_results[i].is_ok
            )
            if ok:
                self.cache.push(key)  # committed txs cannot re-enter
            else:
                self.cache.remove(key)  # invalid txs may be resubmitted
            entry = self._txs.pop(key, None)
            if entry is not None:
                self._txs_bytes -= len(entry.tx)
                self._lane_counts[entry.lane] -= 1
        self._log_compact()

    def push_committed_many(self, txs: list[bytes], keys: list[bytes]) -> None:
        """Commitpool insert of already-executed txs: caps + cache, no app
        CheckTx. Dups and a full pool drop silently."""
        with self._mtx:
            for tx, key in zip(txs, keys):
                if (
                    len(self._txs) >= self.config.size
                    or len(tx) + self._txs_bytes > self.config.max_txs_bytes
                ):
                    continue
                if not self.cache.push(key):
                    continue
                self._txs[key] = _MempoolTx(self.height, 0, tx, {0})
                self._lane_counts[LANE_BULK] += 1
                self._log_append(key)
                self._txs_bytes += len(tx)
