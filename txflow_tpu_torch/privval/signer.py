"""Remote signer: keep validator keys in a separate process (reference
privval/signer_validator_endpoint.go + signer_remote.go + messages.go).

- ``SignerServer`` runs NEXT TO THE KEY: it wraps a local PrivValidator
  (normally a FilePV) and serves sign requests over a socket.
- ``SignerClient`` implements the PrivValidator protocol for the NODE
  side: every sign call round-trips to the server (reference
  SignerValidatorEndpoint :92-97); the pubkey is fetched once.

Wire: length-prefixed JSON frames (u32 big-endian length). Message types
mirror the reference's amino msg set (privval/messages.go:19-26):
pubkey_request/response and sign_tx_vote_request/signed_tx_vote_response;
errors travel in the response's "error" field (e.g. a FilePV double-sign
refusal crosses the wire as an error and is re-raised client-side).

Counterpart of ``txflow_tpu/privval/signer.py``, byte-compatible on the
wire for the messages it carries. The block-vote and proposal requests
(``txflow_tpu/privval/signer.py:206-234``) wait for the block types of the
block path; a server of the port answers them with an error.
"""

from __future__ import annotations

import json
import socket
import struct
import threading


from ..types.tx_vote import TxVote
from .file import ErrDoubleSign

_LEN = struct.Struct("!I")


def _send_msg(sock: socket.socket, obj: dict) -> None:
    payload = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_msg(sock: socket.socket) -> dict:
    hdr = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(hdr)
    if n > 1 << 20:
        raise ValueError("oversized signer frame")
    return json.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("signer connection closed")
        buf += chunk
    return buf


class RemoteSignerError(Exception):
    pass


class SignerServer:
    """Serves a local PrivValidator over TCP (one signer, many requests)."""

    def __init__(self, priv_val, host: str = "127.0.0.1", port: int = 0):
        self.priv_val = priv_val
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.addr = self._srv.getsockname()
        self._running = threading.Event()
        self._thread: threading.Thread | None = None
        # open connections and their threads: stop() closes and joins them
        self._conns: dict[socket.socket, threading.Thread] = {}
        self._conns_mtx = threading.Lock()

    def start(self) -> None:
        self._running.set()
        self._thread = threading.Thread(
            target=self._accept_loop, name="signer-server", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)  # wakes a blocked accept()
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conns_mtx:
            conns = dict(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in [self._thread, *conns.values()]:
            if t is not None:
                t.join(timeout=2.0)
        self._thread = None

    def _accept_loop(self) -> None:
        while self._running.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            with self._conns_mtx:
                self._conns[conn] = t
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            self._serve(conn)
        finally:
            with self._conns_mtx:
                self._conns.pop(conn, None)
            conn.close()

    def _serve(self, conn: socket.socket) -> None:
        while self._running.is_set():
            try:
                req = _recv_msg(conn)
            except (ConnectionError, OSError, ValueError):
                return
            try:
                resp = self._handle(req)
            except ErrDoubleSign as e:
                resp = {"type": req.get("type", "") + "_response", "error": f"double sign: {e}"}
            except Exception as e:  # refuse, never crash the key holder
                resp = {"type": req.get("type", "") + "_response", "error": repr(e)}
            try:
                _send_msg(conn, resp)
            except OSError:
                return

    def _handle(self, req: dict) -> dict:
        kind = req.get("type")
        pv = self.priv_val
        if kind == "pubkey_request":
            return {"type": "pubkey_response", "pub_key": pv.get_pub_key().hex()}
        if kind == "sign_tx_vote_request":
            from ..types.tx_vote import decode_tx_vote, encode_tx_vote

            vote = decode_tx_vote(bytes.fromhex(req["vote"]))
            pv.sign_tx_vote(req["chain_id"], vote)
            return {
                "type": "signed_tx_vote_response",
                "vote": encode_tx_vote(vote).hex(),
            }
        raise ValueError(f"unknown signer request {kind!r}")


class SignerClient:
    """PrivValidator whose key lives behind a SignerServer socket."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(timeout)
        self._mtx = threading.Lock()
        resp = self._call({"type": "pubkey_request"})
        self._pub_key = bytes.fromhex(resp["pub_key"])

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _call(self, req: dict) -> dict:
        with self._mtx:  # one in-flight request per connection
            _send_msg(self._sock, req)
            resp = _recv_msg(self._sock)
        if resp.get("error"):
            if resp["error"].startswith("double sign"):
                raise ErrDoubleSign(resp["error"])
            raise RemoteSignerError(resp["error"])
        return resp

    def get_pub_key(self) -> bytes:
        return self._pub_key

    def get_address(self) -> bytes:
        from ..crypto.hash import address_hash

        return address_hash(self._pub_key)

    def sign_tx_vote(self, chain_id: str, vote: TxVote) -> None:
        from ..types.tx_vote import decode_tx_vote, encode_tx_vote

        resp = self._call(
            {
                "type": "sign_tx_vote_request",
                "chain_id": chain_id,
                "vote": encode_tx_vote(vote).hex(),
            }
        )
        signed = decode_tx_vote(bytes.fromhex(resp["vote"]))
        vote.timestamp_ns = signed.timestamp_ns
        vote.signature = signed.signature

