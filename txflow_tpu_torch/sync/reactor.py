"""SyncReactor: the catch-up channel's server and transport glue
(counterpart of ``txflow_tpu/sync/reactor.py``).

Server half (every node): it adverts its commit-order seq count (STATUS)
on every new peer and every ``status_interval``, so lagging peers can find
it, and answers RANGE_REQ with committed txs, their certificates and the
validator-set snapshots needed to verify them at the heights they were
cast (RANGE_RESP). Serving is read-only and bounded (``max_range`` commits
and ``max_resp_bytes`` served bytes a response), by ``serve_range``.

Client half: STATUS and RANGE_RESP frames go to the SyncManager
(manager.py), which runs the lag detector and fetch loop on its own
thread; the peer's receive loop never verifies or applies.
"""

from __future__ import annotations

import threading
from typing import Callable

from ..p2p.base import CHANNEL_SYNC, ChannelDescriptor, Reactor
from ..store.tx_store import _decode_votes
from ..types.validator import ValidatorSet
from . import wire
from .config import SyncConfig


def serve_range(
    tx_store,
    config: SyncConfig,
    start: int,
    count: int,
    snapshot_of: Callable[[int], ValidatorSet | None] | None = None,
) -> tuple[int, list[tuple[str, bytes, bytes]], dict[int, ValidatorSet]]:
    """Commits [start, start+count) of ``tx_store``'s commit-order log as
    ``(advert, entries, snapshots)``, the body of a RANGE_RESP
    (``wire.encode_range_resp(req_id, start, *serve_range(...))``).

    Bounded by ``config.max_range`` commits and ``config.max_resp_bytes``
    served bytes; ``snapshot_of(height)`` gives the validator set on record
    for a vote height (None: no snapshot for it). ``advert`` is the log
    length, lowered to the first row that cannot be served."""
    advert = tx_store.seq_count()
    count = max(0, min(count, config.max_range))
    entries: list[tuple[str, bytes, bytes]] = []
    snapshots: dict[int, ValidatorSet] = {}
    size = 0
    for seq, tx_hash in tx_store.committed_range(start, count):
        cert = tx_store.load_cert_row(tx_hash)
        tx = tx_store.load_tx_bytes(tx_hash)
        if cert is None or tx is None:
            # stop at the first row we cannot serve, and say so in the
            # advert, so the client can tell honest shortness from a lie
            advert = min(advert, seq)
            break
        entries.append((tx_hash, cert, tx))
        size += len(cert) + len(tx)
        try:
            h = _decode_votes(cert)[0].height
        except Exception:
            h = 0
        if h not in snapshots and snapshot_of is not None:
            vals = snapshot_of(h)
            if vals is not None:
                snapshots[h] = vals
        if size >= config.max_resp_bytes:
            # append-then-check: a byte-capped response always carries >=
            # max_resp_bytes, and the capping entry ships with its
            # height's snapshot (collected above)
            break
    return advert, entries, snapshots


class SyncReactor(Reactor):
    def __init__(
        self,
        tx_store,
        state_store=None,
        current_vals: Callable[[], ValidatorSet] | None = None,
        config: SyncConfig | None = None,
    ):
        """``current_vals`` gives the snapshot of a height the state store
        has no record of (the node's current full set)."""
        super().__init__("sync")
        self.tx_store = tx_store
        self.state_store = state_store
        self.current_vals = current_vals
        self.config = config or SyncConfig()
        self.manager = None  # the SyncManager (client half), wired by the node
        self._stop = threading.Event()
        # byzantine-server test hook: callable(entries, snapshots) ->
        # (entries, snapshots), applied to every response before encode
        self.tamper = None
        self.served_ranges = 0

    def get_channels(self) -> list[ChannelDescriptor]:
        # a response carries up to max_range certificates and tx bytes,
        # append-then-check past max_resp_bytes: twice the cap of headroom
        return [
            ChannelDescriptor(
                id=CHANNEL_SYNC,
                priority=2,
                recv_message_capacity=max(2 * 1024 * 1024, 2 * self.config.max_resp_bytes),
            )
        ]

    def on_start(self) -> None:
        self._stop.clear()
        threading.Thread(target=self._status_loop, name="sync-status", daemon=True).start()

    def on_stop(self) -> None:
        self._stop.set()

    def add_peer(self, peer) -> None:
        peer.try_send(
            CHANNEL_SYNC, wire.encode_status(self.tx_store.seq_count(), self.tx_store.height())
        )

    def remove_peer(self, peer, reason: object = None) -> None:
        if self.manager is not None:
            self.manager.note_peer_gone(peer.node_id)

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        if not msg:
            raise ValueError("empty sync frame")
        tag = msg[0]
        if tag == wire.MSG_STATUS:
            seq_count, height = wire.decode_status(msg)
            if self.manager is not None:
                self.manager.note_status(peer.node_id, seq_count, height)
        elif tag == wire.MSG_RANGE_REQ:
            req_id, start, count = wire.decode_range_req(msg)
            peer.try_send(CHANNEL_SYNC, self._serve_range(req_id, start, count))
        elif tag == wire.MSG_RANGE_RESP:
            resp = wire.decode_range_resp(msg)
            if self.manager is not None:
                self.manager.note_response(peer.node_id, *resp)
        else:
            # a peer speaking another protocol version (or garbage): the
            # switch stops the peer on the raise
            raise ValueError(f"unknown sync tag {tag}")

    # -- server --

    def _snapshot_of(self, height: int) -> ValidatorSet | None:
        """The set on record for ``height``, else the current one."""
        vals = self.state_store.load_validators(height) if self.state_store is not None else None
        if vals is None and self.current_vals is not None:
            vals = self.current_vals()
        return vals

    def _serve_range(self, req_id: int, start: int, count: int) -> bytes:
        advert, entries, snapshots = serve_range(
            self.tx_store, self.config, start, count, self._snapshot_of
        )
        if self.tamper is not None:
            entries, snapshots = self.tamper(entries, snapshots)
        self.served_ranges += 1
        if self.manager is not None:
            self.manager.note_served(len(entries))
        return wire.encode_range_resp(req_id, start, advert, entries, snapshots)

    # -- status adverts --

    def _status_loop(self) -> None:
        while not self._stop.wait(self.config.status_interval):
            sw = self.switch
            if sw is None:
                continue
            frame = wire.encode_status(self.tx_store.seq_count(), self.tx_store.height())
            for peer in sw.peers():
                peer.try_send(CHANNEL_SYNC, frame)
