"""Peer exchange + address book (the reference's PEX reactor + addrbook
slot, node/node.go:507-552).

``AddressBook``: known peer listen addresses, optionally persisted as
JSON (the addrbook.json analog). ``PEXReactor`` (channel 0x00): on every
new connection it advertises its own listen address and known peers and
requests the peer's; an ensure-peers loop dials known-but-unconnected
addresses until ``max_peers`` — so a node seeded with ONE address
discovers and joins the whole network. Counterpart of
``txflow_tpu/p2p/pex.py``; ``on_stop`` also joins the ensure-peers
thread.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

from .base import ChannelDescriptor, Reactor

CHANNEL_PEX = 0x00  # reference PexChannel
_ENSURE_INTERVAL = 0.5

MSG_REQUEST = 1
MSG_ADDRS = 2


class AddressBook:
    def __init__(self, path: str = ""):
        self.path = path
        self._mtx = threading.Lock()
        self._addrs: dict[str, tuple[str, int]] = {}  # node_id -> (host, port)
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._addrs = {
                        k: (v[0], int(v[1])) for k, v in json.load(f).items()
                    }
            except (ValueError, OSError):
                pass

    def add(self, node_id: str, host: str, port: int) -> bool:
        with self._mtx:
            known = self._addrs.get(node_id)
            if known == (host, port):
                return False
            self._addrs[node_id] = (host, port)
        self._save()
        return True

    def get(self, node_id: str) -> tuple[str, int] | None:
        with self._mtx:
            return self._addrs.get(node_id)

    def entries(self) -> dict[str, tuple[str, int]]:
        with self._mtx:
            return dict(self._addrs)

    def size(self) -> int:
        with self._mtx:
            return len(self._addrs)

    def _save(self) -> None:
        if not self.path:
            return
        with self._mtx:
            payload = json.dumps(
                {k: [h, p] for k, (h, p) in self._addrs.items()}, indent=1
            ).encode()
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".addrbook-")
        try:
            os.write(fd, payload)
        finally:
            os.close(fd)
        os.replace(tmp, self.path)


def book_reconnector(switch, book: AddressBook):
    """Default PeerScoreBoard reconnect hook for TCP assemblies: re-dial
    an evicted peer at its address-book entry. Node auto-wires this into
    the health monitor whenever the switch has a node key and a PEX book
    (node/node.py); the jittered retry backoff lives in the scoreboard
    (health/peers.py) — this hook is one dial attempt."""

    def reconnect(node_id: str) -> bool:
        addr = book.get(node_id)
        if addr is None:
            return False
        try:
            peer = switch.dial_tcp(addr[0], addr[1])
        except Exception:
            return False
        # the secret-connection handshake verifies who answered: a stale
        # book entry that now serves a DIFFERENT node is a failure
        return peer is not None and peer.node_id == node_id

    return reconnect


class PEXReactor(Reactor):
    def __init__(self, book: AddressBook, max_peers: int = 50):
        super().__init__("pex")
        self.book = book
        self.max_peers = max_peers
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=CHANNEL_PEX, priority=1)]

    def on_start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._ensure_peers_loop, name="pex-ensure", daemon=True
        )
        self._thread.start()

    def on_stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    # -- gossip --

    def _my_addr_entry(self):
        sw = self.switch
        addr = getattr(sw, "listen_addr", None)
        if addr is None:
            return None
        return [sw.node_id, addr[0], addr[1]]

    def add_peer(self, peer) -> None:
        # advertise ourself + what we know, and ask for theirs
        self._send_addrs(peer)
        peer.try_send(CHANNEL_PEX, bytes([MSG_REQUEST]))

    def _send_addrs(self, peer) -> None:
        addrs = [[nid, h, p] for nid, (h, p) in self.book.entries().items()]
        me = self._my_addr_entry()
        if me is not None:
            addrs.append(me)
        if addrs:
            peer.try_send(
                CHANNEL_PEX, bytes([MSG_ADDRS]) + json.dumps(addrs).encode()
            )

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        kind, body = msg[0], msg[1:]
        if kind == MSG_REQUEST:
            self._send_addrs(peer)
        elif kind == MSG_ADDRS:
            for nid, host, port in json.loads(body):
                if nid == self.switch.node_id:
                    continue
                self.book.add(str(nid), str(host), int(port))
        else:
            raise ValueError(f"unknown pex msg {kind}")

    # -- dialing --

    def _ensure_peers_loop(self) -> None:
        while not self._stop.wait(_ENSURE_INTERVAL):
            sw = self.switch
            if sw is None or not sw.is_running:
                continue
            if sw.n_peers() >= self.max_peers:
                continue
            connected = {p.node_id for p in sw.peers()}
            for nid, (host, port) in self.book.entries().items():
                if nid == sw.node_id or nid in connected:
                    continue
                if sw.n_peers() >= self.max_peers:
                    break
                try:
                    sw.dial_tcp(host, port)
                except Exception:
                    continue  # unreachable for now; retried next tick
