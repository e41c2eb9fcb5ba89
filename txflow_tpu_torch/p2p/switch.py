"""Switch + Peer: reactor registry and per-peer message loops.

Reference semantics kept (p2p.Switch, node/node.go:488-505):
- reactors register channel descriptors; one reactor owns each channel id;
- every peer gets a prioritized outbound queue drained by one send thread
  (the reference's per-peer MConnection send routine) and one recv thread
  dispatching inbound frames to the owning reactor's ``receive``;
- a reactor error on receive stops the peer (txvotepool/reactor.go:174);
- ``make_connected_switches`` wires N switches fully connected over
  in-memory pipes — the reference's in-process-testnet trick
  (p2p.MakeConnectedSwitches, txvotepool/reactor_test.go:47-66).

Counterpart of ``txflow_tpu/p2p/switch.py``. Left out, with the fault and
network-weather harness they serve: the fault-injection hook
(``set_fault_injector``, a peer's ``intercept``), the link shaper
(``set_link_shaper``) and the adaptive transport (``configure_net``,
``net_snapshot``, the pinger and per-peer estimators). A switch of the
port still answers a PING frame, so it interoperates with a JAX switch
that probes its links.
"""

from __future__ import annotations

import itertools
import queue
import socket
import threading
import time

from .base import ChannelDescriptor, Reactor
from .transport import (
    ConnectionClosed,
    TCPConnection,
    connection_pair,
    tcp_connect,
)

_HANDSHAKE_CHANNEL = 0xFF
_WAKE_CHANNEL = 0xFE  # internal sentinel: wakes a send loop, never sent
# link-quality probes of the JAX package's adaptive transport: this
# switch sends none, and answers PING so mixed fleets interoperate
_PING_CHANNEL = 0xFD
_PONG_CHANNEL = 0xFC


class PeerStats:
    """Per-peer liveness counters read by the health layer's peer scorer
    of the JAX package. Plain int bumps under the GIL: the send/recv
    loops do not pay a lock for observability."""

    __slots__ = (
        "send_attempts",
        "send_ok",
        "send_fail",
        "recv_count",
        "duplicates",
        "last_recv",
        "connected_at",
    )

    def __init__(self):
        now = time.monotonic()
        self.send_attempts = 0  # frames handed to send/try_send
        self.send_ok = 0  # frames handed to the transport successfully
        self.send_fail = 0  # transport failures + queue-full backpressure
        self.recv_count = 0  # frames received from the peer
        self.duplicates = 0  # frames the owning reactor flagged as dups
        self.last_recv = now
        self.connected_at = now


class Peer:
    """A connected remote switch endpoint."""

    _id_counter = itertools.count(1)

    def __init__(
        self,
        conn,
        node_id: str,
        outbound: bool,
        channels: dict[int, ChannelDescriptor],
    ):
        self.conn = conn
        self.node_id = node_id
        self.outbound = outbound
        self.kv: dict[str, object] = {}  # peer state (reference peer.Set/Get)
        self._channels = channels
        self._send_q = queue.PriorityQueue(maxsize=4096)
        # lane for reliable channels (consensus): never dropped under BULK
        # pressure (its pressure is its own), drained ahead of the shared
        # queue. Bounded all the same — a stalled peer must not grow memory
        # without limit; at this depth the peer is effectively dead and
        # will resync via block catchup when it returns
        self._reliable_q: queue.Queue = queue.Queue(maxsize=1024)
        self._seq = itertools.count()
        self._running = threading.Event()
        self._send_thread: threading.Thread | None = None
        self._recv_thread: threading.Thread | None = None
        self.stats = PeerStats()

    def set(self, key: str, value) -> None:
        self.kv[key] = value

    def get(self, key: str, default=None):
        return self.kv.get(key, default)

    def _is_reliable(self, chan_id: int) -> bool:
        ch = self._channels.get(chan_id)
        return ch is not None and ch.reliable

    def _put_reliable(self, chan_id: int, msg: bytes) -> bool:
        try:
            self._reliable_q.put_nowait((chan_id, msg))
        except queue.Full:
            self.stats.send_fail += 1
            return False  # peer stalled beyond any live-round backlog
        # wake the send loop if it is blocked on the shared queue
        try:
            self._send_q.put_nowait((-(1 << 30), next(self._seq), _WAKE_CHANNEL, b""))
        except queue.Full:
            pass  # loop is busy draining anyway
        return True

    def send(self, chan_id: int, msg: bytes, timeout: float | None = 10.0) -> bool:
        """Queue a message; blocks under backpressure. False if peer down."""
        if not self._running.is_set():
            return False
        self.stats.send_attempts += 1
        if self._is_reliable(chan_id):
            return self._put_reliable(chan_id, msg)
        prio = -self._channels[chan_id].priority if chan_id in self._channels else 0
        try:
            self._send_q.put((prio, next(self._seq), chan_id, msg), timeout=timeout)
            return True
        except queue.Full:
            self.stats.send_fail += 1
            return False

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        if not self._running.is_set():
            return False
        self.stats.send_attempts += 1
        if self._is_reliable(chan_id):
            return self._put_reliable(chan_id, msg)
        prio = -self._channels[chan_id].priority if chan_id in self._channels else 0
        try:
            self._send_q.put_nowait((prio, next(self._seq), chan_id, msg))
            return True
        except queue.Full:
            self.stats.send_fail += 1
            return False

    def is_running(self) -> bool:
        return self._running.is_set()

    def __repr__(self) -> str:
        return f"Peer({self.node_id}{' out' if self.outbound else ' in'})"


class SwitchError(Exception):
    pass


class Switch:
    def __init__(self, node_id: str, node_seed: bytes | None = None):
        # ed25519 node key: when set, TCP links use the authenticated
        # SecretConnection and peer ids are derived from VERIFIED pubkeys
        # (upstream rides secret connections for every socket,
        # node/node.go:420-505); None = plaintext string handshake
        # (in-proc pipes, legacy tests).
        #
        # With a key, our OWN advertised id must be the same verified-key
        # address our peers will register us under — otherwise PEX compares
        # book ids against verified ids, never sees a match, and redials
        # every known peer forever (r3 review finding).
        if node_seed is not None:
            from ..crypto import ed25519 as _ed
            from ..crypto.hash import address_hash as _ah

            self.node_id = _ah(_ed.public_key_from_seed(node_seed)).hex().upper()
        else:
            self.node_id = node_id
        self._node_seed = node_seed
        self.reactors: dict[str, Reactor] = {}
        self._chan_to_reactor: dict[int, Reactor] = {}
        self._channels: dict[int, ChannelDescriptor] = {}
        self._peers: dict[str, Peer] = {}
        self._mtx = threading.RLock()
        self._running = False
        self._accept_thread: threading.Thread | None = None

    # -- reactor registry (reference Switch.AddReactor) --

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        with self._mtx:
            for ch in reactor.get_channels():
                if ch.id in self._chan_to_reactor:
                    raise SwitchError(f"channel {ch.id:#x} already registered")
                self._chan_to_reactor[ch.id] = reactor
                self._channels[ch.id] = ch
            self.reactors[name] = reactor
        reactor.set_switch(self)
        return reactor

    def reactor(self, name: str) -> Reactor | None:
        return self.reactors.get(name)

    # -- lifecycle --

    def start(self) -> None:
        with self._mtx:
            if self._running:
                return
            self._running = True
            reactors = list(self.reactors.values())
        for r in reactors:
            r.on_start()

    def stop(self) -> None:
        with self._mtx:
            if not self._running:
                return
            self._running = False
            peers = list(self._peers.values())
        self.close_listener()
        for p in peers:
            self.stop_peer(p, reason="switch stopping")
        for r in list(self.reactors.values()):
            r.on_stop()
        # the loops see their peer stopped within one poll (0.2 s)
        me = threading.current_thread()
        for p in peers:
            for t in (p._send_thread, p._recv_thread):
                if t is not None and t is not me:
                    t.join(timeout=2.0)

    @property
    def is_running(self) -> bool:
        return self._running

    # -- peers --

    def peers(self) -> list[Peer]:
        with self._mtx:
            return list(self._peers.values())

    def n_peers(self) -> int:
        with self._mtx:
            return len(self._peers)

    def get_peer(self, node_id: str) -> Peer | None:
        with self._mtx:
            return self._peers.get(node_id)

    def add_peer_conn(self, conn, node_id: str, outbound: bool) -> Peer:
        """Attach a live connection as a peer and start its loops."""
        peer = Peer(conn, node_id, outbound, dict(self._channels))
        with self._mtx:
            if not self._running:
                # a handshake completing during/after stop() must not
                # register threads and sockets nothing will ever stop
                conn.close()
                raise SwitchError("switch is stopped")
            if node_id in self._peers:
                conn.close()
                raise SwitchError(f"duplicate peer {node_id}")
            if node_id == self.node_id:
                conn.close()
                raise SwitchError("cannot connect to self")
            self._peers[node_id] = peer
        peer._running.set()
        peer._send_thread = threading.Thread(
            target=self._send_loop, args=(peer,), name=f"p2p-send-{node_id}", daemon=True
        )
        peer._recv_thread = threading.Thread(
            target=self._recv_loop, args=(peer,), name=f"p2p-recv-{node_id}", daemon=True
        )
        peer._send_thread.start()
        peer._recv_thread.start()
        for r in list(self.reactors.values()):
            r.add_peer(peer)
        return peer

    def dial_tcp(self, host: str, port: int) -> Peer:
        """Outbound TCP connect. With a node key: authenticated secret
        connection, peer id = verified pubkey address. Without: legacy
        plaintext node-id string handshake."""
        if self._node_seed is not None:
            from .secret import SecretConnection
            from .transport import tcp_connect_raw

            conn = SecretConnection(
                tcp_connect_raw(host, port), self._node_seed, label=f"{host}:{port}"
            )
            return self.add_peer_conn(conn, conn.peer_id, outbound=True)
        conn = tcp_connect(host, port)
        conn.send(_HANDSHAKE_CHANNEL, self.node_id.encode())
        chan_id, payload = conn.recv(timeout=5.0)
        if chan_id != _HANDSHAKE_CHANNEL:
            conn.close()
            raise SwitchError("handshake expected")
        return self.add_peer_conn(conn, payload.decode(), outbound=True)

    def accept_tcp(self, sock) -> Peer:
        """Inbound accept (call with an accepted socket); secret-connection
        authenticated when this switch has a node key."""
        if self._node_seed is not None:
            from .secret import SecretConnection

            conn = SecretConnection(sock, self._node_seed)
            return self.add_peer_conn(conn, conn.peer_id, outbound=False)
        conn = TCPConnection(sock)
        chan_id, payload = conn.recv(timeout=5.0)
        if chan_id != _HANDSHAKE_CHANNEL:
            conn.close()
            raise SwitchError("handshake expected")
        conn.send(_HANDSHAKE_CHANNEL, self.node_id.encode())
        return self.add_peer_conn(conn, payload.decode(), outbound=False)

    def listen_tcp(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        """Start accepting inbound TCP peers (reference transport.Listen,
        node/node.go:795-800). Returns the bound (host, port)."""
        from .transport import tcp_listen

        srv = tcp_listen(host, port)
        self._listener = srv
        self.listen_addr = srv.getsockname()

        def _handshake_one(sock):
            try:
                self.accept_tcp(sock)
            except Exception:
                try:
                    sock.close()
                except OSError:
                    pass

        def _accept_loop():
            while True:
                try:
                    sock, _ = srv.accept()
                except OSError:
                    return  # listener closed
                # handshake off the accept thread: one slow/silent client
                # must not block further accepts (handshakes are also
                # individually time-bounded in SecretConnection)
                threading.Thread(
                    target=_handshake_one, args=(sock,), daemon=True
                ).start()

        self._accept_thread = threading.Thread(
            target=_accept_loop, name=f"p2p-accept-{self.node_id}", daemon=True
        )
        self._accept_thread.start()
        return self.listen_addr

    def close_listener(self) -> None:
        srv = getattr(self, "_listener", None)
        if srv is not None:
            try:
                srv.shutdown(socket.SHUT_RDWR)  # wakes a blocked accept()
            except OSError:
                pass
            try:
                srv.close()
            except OSError:
                pass
        t, self._accept_thread = self._accept_thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def stop_peer(self, peer: Peer, reason: object = None) -> None:
        with self._mtx:
            existing = self._peers.pop(peer.node_id, None)
        if existing is None:
            return
        peer._running.clear()
        peer.conn.close()
        for r in list(self.reactors.values()):
            r.remove_peer(peer, reason)

    def stop_peer_for_error(self, peer: Peer, err: object) -> None:
        """Reference StopPeerForError: tear down a misbehaving peer."""
        import os
        import sys

        if os.environ.get("TXFLOW_P2P_QUIET") != "1":
            # reference logs every peer stop (p2p/switch.go); a silent stop
            # here buried real consensus bugs in r3 debugging
            print(
                f"p2p[{self.node_id}]: stopping peer {peer.node_id}: {err!r}",
                file=sys.stderr,
            )
        self.stop_peer(peer, reason=err)

    # -- message plumbing --

    def broadcast(self, chan_id: int, msg: bytes) -> None:
        for p in self.peers():
            p.try_send(chan_id, msg)

    def _send_loop(self, peer: Peer) -> None:
        while peer._running.is_set():
            # reliable lane first: consensus messages must not wait behind
            # (or be dropped by) bulk txvote/mempool batches
            try:
                chan_id, msg = peer._reliable_q.get_nowait()
            except queue.Empty:
                try:
                    _, _, chan_id, msg = peer._send_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if chan_id == _WAKE_CHANNEL:
                    continue
            if not peer.conn.send(chan_id, msg, 10.0):
                peer.stats.send_fail += 1
                self.stop_peer(peer, reason="send failed")
                return
            peer.stats.send_ok += 1

    def _recv_loop(self, peer: Peer) -> None:
        while peer._running.is_set():
            try:
                chan_id, msg = peer.conn.recv()
            except ConnectionClosed:
                self.stop_peer(peer, reason="connection closed")
                return
            except TimeoutError:
                continue
            st = peer.stats
            st.recv_count += 1
            st.last_recv = time.monotonic()
            if chan_id == _PING_CHANNEL:
                peer.try_send(_PONG_CHANNEL, msg)
                continue
            if chan_id == _PONG_CHANNEL:
                continue  # this switch sends no probes
            reactor = self._chan_to_reactor.get(chan_id)
            if reactor is None:
                continue  # unknown channel: ignore (switch filters by NodeInfo upstream)
            try:
                reactor.receive(chan_id, peer, msg)
            except Exception as e:  # reference: undecodable msg stops the peer
                self.stop_peer_for_error(peer, e)
                return


def connect_switches(a: Switch, b: Switch, capacity: int = 1024) -> tuple[Peer, Peer]:
    """Wire two switches with an in-memory duplex pipe (reference
    p2p.Connect2Switches)."""
    ca, cb = connection_pair(capacity, labels=(f"{a.node_id}->{b.node_id}", f"{b.node_id}->{a.node_id}"))
    pa = a.add_peer_conn(ca, b.node_id, outbound=True)
    pb = b.add_peer_conn(cb, a.node_id, outbound=False)
    return pa, pb


def make_connected_switches(n: int, init_switch, start: bool = True) -> list[Switch]:
    """N switches, fully connected (reference p2p.MakeConnectedSwitches).

    ``init_switch(i, switch)`` registers reactors on switch i and returns
    the switch (mirroring the initSwitch callback upstream).
    """
    switches = [init_switch(i, Switch(f"node{i}")) for i in range(n)]
    if start:
        for sw in switches:
            sw.start()
    for i in range(n):
        for j in range(i + 1, n):
            connect_switches(switches[i], switches[j])
    return switches
