"""Transports: framed, channel-tagged duplex connections.

Two implementations of one small interface (``send``/``try_send``/``recv``/
``close``):

- ``InMemoryConnection`` — paired bounded queues, the in-process analog of
  the reference's MakeConnectedSwitches wiring (txvotepool/reactor_test.go:
  47-66); used by the BASELINE in-proc validator nets and the gossip tests.
- ``TCPConnection`` — length-prefixed frames over a socket for multi-host
  DCN deployment (the reference's MultiplexTransport slot, node/node.go:
  420-505, minus the station-to-station encryption layer).

Frame format on TCP: ``chan_id u8 | len u32be | payload``. Counterpart of
``txflow_tpu/p2p/transport.py``: the same frames, so a port switch and a
JAX switch talk over either transport.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading


_FRAME_HDR = struct.Struct("!BI")

# Hard cap on one frame; matches the reference's 1 MiB gossip message cap
# (consensus/reactor.go:28) with headroom for batched vote frames.
MAX_FRAME_BYTES = 8 * 1024 * 1024


class ConnectionClosed(Exception):
    pass


class InMemoryConnection:
    """One endpoint of an in-process duplex pipe."""

    def __init__(self, send_q: queue.Queue, recv_q: queue.Queue, label: str = ""):
        self._send_q = send_q
        self._recv_q = recv_q
        self._closed = threading.Event()
        self.label = label

    def send(self, chan_id: int, msg: bytes, timeout: float | None = 10.0) -> bool:
        """Blocking send with backpressure; False if closed/timed out."""
        if self._closed.is_set():
            return False
        try:
            self._send_q.put((chan_id, msg), timeout=timeout)
            return True
        except queue.Full:
            return False

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        if self._closed.is_set():
            return False
        try:
            self._send_q.put_nowait((chan_id, msg))
            return True
        except queue.Full:
            return False

    def recv(self, timeout: float | None = None) -> tuple[int, bytes]:
        """Blocks for the next (chan_id, msg); raises ConnectionClosed."""
        while True:
            if self._closed.is_set() and self._recv_q.empty():
                raise ConnectionClosed()
            try:
                item = self._recv_q.get(timeout=timeout if timeout else 0.2)
            except queue.Empty:
                if timeout is not None:
                    raise TimeoutError()
                continue
            if item is None:  # close sentinel from the other side
                self._closed.set()
                raise ConnectionClosed()
            return item

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            self._send_q.put_nowait(None)  # wake the remote recv loop
        except queue.Full:
            pass
        try:
            self._recv_q.put_nowait(None)  # wake our own recv loop
        except queue.Full:
            pass

    @property
    def is_closed(self) -> bool:
        return self._closed.is_set()


def connection_pair(
    capacity: int = 1024, labels: tuple[str, str] = ("a", "b")
) -> tuple[InMemoryConnection, InMemoryConnection]:
    """A duplex in-memory pipe: what a sends, b recvs, and vice versa."""
    ab: queue.Queue = queue.Queue(maxsize=capacity)
    ba: queue.Queue = queue.Queue(maxsize=capacity)
    return (
        InMemoryConnection(ab, ba, labels[0]),
        InMemoryConnection(ba, ab, labels[1]),
    )


class TCPConnection:
    """Framed duplex connection over one TCP socket."""

    def __init__(self, sock: socket.socket, label: str = ""):
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._wlock = threading.Lock()
        self._closed = threading.Event()
        self._snd_timeout: float | None = None  # last SO_SNDTIMEO armed
        self.label = label
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send(self, chan_id: int, msg: bytes, timeout: float | None = 10.0) -> bool:
        """Blocking send; ``timeout`` bounds the whole-frame write. A
        timeout mid-frame leaves the peer's stream desynced, so it closes
        the connection (False) rather than retry — the adaptive transport
        (p2p/adaptive.py) passes per-peer RTT-derived timeouts here."""
        if self._closed.is_set():
            return False
        if len(msg) > MAX_FRAME_BYTES:
            raise ValueError(f"frame too large: {len(msg)}")
        frame = _FRAME_HDR.pack(chan_id, len(msg)) + msg
        # a peer that stops reading can stall sendall for the socket
        # timeout: callers must not hold shared node locks into send()
        try:
            with self._wlock:
                if timeout is not None:
                    # SO_SNDTIMEO (NOT settimeout: that would also arm a
                    # timeout on the recv loop's blocked read) bounds each
                    # send syscall; an expiry surfaces as EAGAIN/OSError
                    self._set_send_timeout(timeout)
                self._sock.sendall(frame)  # whole frames: interleaved writes would corrupt the stream
            return True
        except OSError:  # includes a SO_SNDTIMEO expiry (EAGAIN)
            self.close()
            return False

    def _set_send_timeout(self, timeout: float) -> None:
        if timeout == self._snd_timeout:
            return
        sec = int(timeout)
        try:
            self._sock.setsockopt(
                socket.SOL_SOCKET,
                socket.SO_SNDTIMEO,
                struct.pack("ll", sec, int((timeout - sec) * 1e6)),
            )
            self._snd_timeout = timeout
        except (OSError, struct.error):
            pass  # platform without the sockopt: sends stay unbounded

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        """Non-blocking best-effort send (parity with InMemoryConnection):
        False when another sender holds the write lock or the kernel
        buffer can't take the first byte — the stream stays intact either
        way. Once ANY byte of the frame is on the wire the frame must be
        completed (blocking), else the receiver desyncs."""
        if self._closed.is_set():
            return False
        if len(msg) > MAX_FRAME_BYTES:
            raise ValueError(f"frame too large: {len(msg)}")
        frame = _FRAME_HDR.pack(chan_id, len(msg)) + msg
        if not self._wlock.acquire(blocking=False):
            return False
        try:
            try:
                # MSG_DONTWAIT: a per-call non-blocking probe that leaves
                # the socket's timeout state alone (settimeout would also
                # flip the recv loop's blocked read into non-blocking)
                try:
                    sent = self._sock.send(
                        frame, getattr(socket, "MSG_DONTWAIT", 0)
                    )
                except (BlockingIOError, InterruptedError):
                    return False  # kernel buffer full, nothing written
                if sent < len(frame):
                    # committed: finish the frame so the stream stays framed
                                self._sock.sendall(frame[sent:])
                return True
            except OSError:
                self.close()
                return False
        finally:
            self._wlock.release()

    def recv(self, timeout: float | None = None) -> tuple[int, bytes]:
        prev_timeout = self._sock.gettimeout()
        if timeout is not None:
            self._sock.settimeout(timeout)
        try:
            hdr = self._rfile.read(_FRAME_HDR.size)
            if hdr is None or len(hdr) < _FRAME_HDR.size:
                raise ConnectionClosed()
            chan_id, length = _FRAME_HDR.unpack(hdr)
            if length > MAX_FRAME_BYTES:
                raise ConnectionClosed()
            payload = self._rfile.read(length)
            if payload is None or len(payload) < length:
                raise ConnectionClosed()
            return chan_id, payload
        except socket.timeout:
            # a timeout mid-frame leaves the buffered reader desynced
            # (partially consumed frame) — that is a connection error, not
            # a retryable idle timeout; only a clean pre-header timeout
            # (nothing buffered, nothing read) is retryable
            self.close()
            raise ConnectionClosed()
        except (OSError, ValueError):
            raise ConnectionClosed()
        finally:
            if timeout is not None and not self._closed.is_set():
                try:
                    self._sock.settimeout(prev_timeout)
                except OSError:
                    pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def is_closed(self) -> bool:
        return self._closed.is_set()


def tcp_listen(host: str, port: int) -> socket.socket:
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(128)
    return srv


def tcp_connect_raw(host: str, port: int, timeout: float = 5.0) -> socket.socket:
    """A connected raw socket (for wrappers like SecretConnection)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    return sock


def tcp_connect(host: str, port: int, timeout: float = 5.0) -> TCPConnection:
    return TCPConnection(tcp_connect_raw(host, port, timeout), label=f"{host}:{port}")
