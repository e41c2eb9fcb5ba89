"""Mempool reactor: raw-tx flood on channel 0x30 (reference
mempool/reactor.go), the counterpart of
``txflow_tpu/reactors/mempool_reactor.py``.

Same shape as the vote reactor: a per-peer walk of the pool's ingest log
(the priority lane first) with sender suppression and a 1-block height-lag
throttle (reference mempool/reactor.go:191-260), batched into framed
messages. App-level CheckTx rejections of gossiped txs are logged and
ignored, as in the reference (:137); only an undecodable frame stops the
peer. Left out: the admission controller's gossip hook (it comes with the
front door) and trace spans.
"""

from __future__ import annotations

import threading
import time

from ..codec import amino
from ..p2p.base import CHANNEL_MEMPOOL, ChannelDescriptor, Reactor
from ..pool.mempool import (
    LANE_PRIORITY,
    ErrMempoolIsFull,
    ErrTxInCache,
    ErrTxTooLarge,
    Mempool,
    TxInfo,
)

MSG_TXS = 1
MSG_HEIGHT = 2

PEER_CATCHUP_SLEEP = 0.005
PEER_HEIGHT_KEY = "mempool_height"


def encode_tx_batch(txs: list[bytes]) -> bytes:
    body = bytearray([MSG_TXS])
    for tx in txs:
        body += amino.length_prefixed(tx)
    return bytes(body)


def decode_tx_batch(body: bytes) -> list[bytes]:
    r = amino.AminoReader(body)
    out = []
    while not r.eof():
        out.append(r.read_bytes())
    return out


class MempoolReactor(Reactor):
    def __init__(
        self,
        mempool: Mempool,
        broadcast: bool = True,
        batch_size: int = 1024,
        poll_interval: float = 0.05,
        regossip_interval: float | None = None,
    ):
        super().__init__("mempool")
        self.mempool = mempool
        self.broadcast = broadcast
        self.batch_size = batch_size
        self.poll_interval = poll_interval
        # anti-entropy re-walk cadence for lossy links; None = single pass
        self.regossip_interval = regossip_interval
        self._running = threading.Event()
        self._peer_ids: dict[str, int] = {}
        self._next_peer_id = 1
        self._ids_mtx = threading.Lock()
        self._threads: list[threading.Thread] = []

    def get_channels(self) -> list[ChannelDescriptor]:
        # priority 5 like the reference (mempool/reactor.go:118-125)
        return [ChannelDescriptor(id=CHANNEL_MEMPOOL, priority=5)]

    def on_start(self) -> None:
        self._running.set()

    def on_stop(self) -> None:
        self._running.clear()
        for t in self._threads:
            t.join(timeout=2)
        self._threads = []

    def _peer_id(self, peer) -> int:
        with self._ids_mtx:
            pid = self._peer_ids.get(peer.node_id)
            if pid is None:
                pid = self._next_peer_id
                self._next_peer_id += 1
                self._peer_ids[peer.node_id] = pid
            return pid

    def add_peer(self, peer) -> None:
        self._peer_id(peer)
        # tell the peer our height so its lag throttle tracks us
        peer.try_send(
            CHANNEL_MEMPOOL,
            bytes([MSG_HEIGHT]) + amino.uvarint(max(self.mempool.height, 0)),
        )
        if self.broadcast:
            t = threading.Thread(
                target=self._broadcast_routine,
                args=(peer,),
                name=f"mempool-bcast-{peer.node_id}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def broadcast_height(self, height: int) -> None:
        """Push a height update to all peers (block-boundary hook)."""
        if self.switch is not None:
            self.switch.broadcast(
                CHANNEL_MEMPOOL, bytes([MSG_HEIGHT]) + amino.uvarint(max(height, 0))
            )

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        if not msg:
            raise ValueError("empty mempool message")
        msg_type = msg[0]
        if msg_type == MSG_TXS:
            txs = decode_tx_batch(msg[1:])  # a decode error stops the peer
            pid = self._peer_id(peer)
            for tx in txs:
                try:
                    self.mempool.check_tx(tx, TxInfo(sender_id=pid))
                except ErrTxInCache:
                    peer.stats.duplicates += 1
                except (ErrMempoolIsFull, ErrTxTooLarge, ValueError):
                    continue  # app rejection: log-and-ignore (:137)
        elif msg_type == MSG_HEIGHT:
            height, _ = amino.read_uvarint(msg, 1)
            peer.set(PEER_HEIGHT_KEY, height)
        else:
            raise ValueError(f"unknown mempool msg type {msg_type}")

    def _broadcast_routine(self, peer) -> None:
        pid = self._peer_id(peer)
        cursor = 0
        pcursor = 0
        pending: list[tuple[bytes, bytes, int, bool, int]] = []
        seq = self.mempool.seq()
        last_rewalk = time.monotonic()
        while self._running.is_set() and peer.is_running():
            if not pending:
                pending, pcursor = self.mempool.priority_entries_from(
                    pcursor, limit=self.batch_size
                )
            if not pending:
                bulk, cursor = self.mempool.entries_from(cursor, limit=self.batch_size)
                pending = [it for it in bulk if it[4] != LANE_PRIORITY]
                if not pending and bulk:
                    continue  # the page was all priority: keep walking
            if not pending:
                if (
                    self.regossip_interval is not None
                    and time.monotonic() - last_rewalk >= self.regossip_interval
                    and self.mempool.size() > 0
                ):
                    cursor = 0  # anti-entropy re-walk
                    pcursor = 0
                    last_rewalk = time.monotonic()
                    continue
                seq = self.mempool.wait_for_new(seq, timeout=self.poll_interval)
                continue
            peer_height = peer.get(PEER_HEIGHT_KEY, 0)
            sendable, deferred = [], []
            for item in pending:
                key, tx, h = item[0], item[1], item[2]
                if h - 1 > peer_height:  # allow a lag of 1 block (:236-239)
                    deferred.append(item)
                elif not self.mempool.has_sender(key, pid):
                    sendable.append(tx)
            if sendable:
                if not peer.send(CHANNEL_MEMPOOL, encode_tx_batch(sendable)):
                    time.sleep(PEER_CATCHUP_SLEEP)
                    continue
            pending = deferred
            if deferred:
                time.sleep(PEER_CATCHUP_SLEEP)
