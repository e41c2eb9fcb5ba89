"""SecretConnection: authenticated, encrypted peer links (the upstream
tendermint secret-connection slot the reference rides for every p2p
socket — Station-to-Station over X25519 + ed25519 identity signatures,
ChaCha20-Poly1305 frames).

Handshake (both directions symmetric):
1. exchange 32-byte ephemeral X25519 public keys in the clear;
2. shared = X25519(eph_priv, peer_eph_pub); role = lexicographic order
   of the two ephemeral pubkeys (lo/hi, like upstream);
3. HKDF-SHA256(shared, transcript=lo||hi) -> (key_lo->hi, key_hi->lo,
   challenge);
4. each side sends, ENCRYPTED, its ed25519 node pubkey + signature over
   the challenge; the peer verifies the signature before any payload
   flows. The authenticated identity is exposed as ``peer_pub_key`` /
   ``peer_id`` (address hex) — the switch uses it as the node id, so ids
   cannot be spoofed the way the plaintext string handshake allows.

Frames: u32-be length || ChaCha20-Poly1305(ciphertext of
``chan_id u8 || payload``), nonce = 12-byte little-endian per-direction
counter (distinct keys per direction, so counters cannot collide).

Counterpart of ``txflow_tpu/p2p/secret.py``, with its AEAD choice:
``cryptography``'s ChaCha20-Poly1305 when that package imports, else the
stdlib ``_HashlibAEAD``. Two endpoints interoperate when both made the
same choice.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import socket
import struct
import threading

try:  # OpenSSL-backed AEAD when available (the normal case)
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
except ImportError:  # pragma: no cover - environment-dependent
    ChaCha20Poly1305 = None

from ..crypto import ed25519, x25519
from ..crypto.hash import address_hash
from .transport import MAX_FRAME_BYTES, ConnectionClosed

_LEN = struct.Struct("!I")


class _HashlibAEAD:
    """Stdlib-only AEAD with the ChaCha20Poly1305 call surface.

    Used only when the ``cryptography`` package is absent: encrypt-then-MAC
    with an HMAC-SHA256 keystream in counter mode and a 16-byte truncated
    HMAC-SHA256 tag over nonce||aad||ciphertext. Same 16-byte overhead as
    Poly1305, so the frame-length cap math is unchanged. Both endpoints of
    a deployment run the same image, so the two AEADs never need to
    interoperate on the wire.
    """

    _TAG = 16

    def __init__(self, key: bytes):
        self._enc_key = hashlib.sha256(b"txflow-aead-enc" + key).digest()
        self._mac_key = hashlib.sha256(b"txflow-aead-mac" + key).digest()

    def _keystream(self, nonce: bytes, n: int) -> bytes:
        out = bytearray()
        block = 0
        while len(out) < n:
            out += hmac_mod.new(
                self._enc_key, nonce + block.to_bytes(8, "little"), hashlib.sha256
            ).digest()
            block += 1
        return bytes(out[:n])

    @staticmethod
    def _xor(a: bytes, b: bytes) -> bytes:
        return (int.from_bytes(a, "little") ^ int.from_bytes(b, "little")).to_bytes(
            len(a), "little"
        )

    def _tag(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
        return hmac_mod.new(
            self._mac_key, nonce + aad + ct, hashlib.sha256
        ).digest()[: self._TAG]

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
        ct = self._xor(data, self._keystream(nonce, len(data)))
        return ct + self._tag(nonce, aad or b"", ct)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
        if len(data) < self._TAG:
            raise ValueError("aead: frame shorter than tag")
        ct, tag = data[: -self._TAG], data[-self._TAG :]
        if not hmac_mod.compare_digest(tag, self._tag(nonce, aad or b"", ct)):
            raise ValueError("aead: tag mismatch")
        return self._xor(ct, self._keystream(nonce, len(ct)))


_AEAD = ChaCha20Poly1305 if ChaCha20Poly1305 is not None else _HashlibAEAD


def _hkdf_sha256(ikm: bytes, info: bytes, n: int) -> bytes:
    """HKDF (RFC 5869) with a fixed zero salt."""
    prk = hmac_mod.new(b"\x00" * 32, ikm, hashlib.sha256).digest()
    out, t, i = b"", b"", 1
    while len(out) < n:
        t = hmac_mod.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:n]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionClosed()
        buf += chunk
    return buf


class SecretConnection:
    """Same send/recv surface as transport.TCPConnection, authenticated."""

    HANDSHAKE_TIMEOUT = 10.0

    def __init__(self, sock: socket.socket, node_seed: bytes, label: str = ""):
        self._sock = sock
        self._wlock = threading.Lock()
        self._closed = threading.Event()
        self.label = label
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the WHOLE handshake is time-bounded: a silent client must not
        # wedge the caller (the plaintext path bounds its handshake recv;
        # an unbounded one here is a zero-byte DoS on the accept path)
        prev_timeout = sock.gettimeout()
        sock.settimeout(self.HANDSHAKE_TIMEOUT)
        try:
            self._handshake(sock, node_seed)
        except (socket.timeout, TimeoutError):
            self.close()
            raise ValueError("secret connection: handshake timeout")
        except Exception:
            self.close()
            raise
        finally:
            if not self._closed.is_set():
                try:
                    sock.settimeout(prev_timeout)
                except OSError:
                    pass

    def _handshake(self, sock: socket.socket, node_seed: bytes) -> None:
        # 1-2: ephemeral exchange + shared secret
        eph_priv = x25519.generate_private()
        eph_pub = x25519.public_key(eph_priv)
        sock.sendall(eph_pub)
        peer_eph = _recv_exact(sock, 32)
        shared = x25519.shared_secret(eph_priv, peer_eph)
        lo, hi = sorted((eph_pub, peer_eph))
        we_are_lo = eph_pub == lo

        # 3: key schedule + challenge
        material = _hkdf_sha256(shared, b"txflow-secret-conn" + lo + hi, 96)
        key_lo_to_hi, key_hi_to_lo = material[:32], material[32:64]
        challenge = material[64:]
        self._send_aead = _AEAD(key_lo_to_hi if we_are_lo else key_hi_to_lo)
        self._recv_aead = _AEAD(key_hi_to_lo if we_are_lo else key_lo_to_hi)
        self._send_ctr = 0
        self._recv_ctr = 0

        # 4: authenticate identities over the encrypted channel. The signed
        # material binds the signer's ROLE via its own ephemeral key: both
        # directions share `challenge`, so a bare signature over it could be
        # reflected back by a keyless man-in-the-middle (decrypt our auth
        # frame, re-encrypt under its own send key) to authenticate as us.
        # Signing challenge||own-ephemeral makes the two directions sign
        # different messages (echoing our ephemeral back would leave the
        # attacker without the DH shared secret, so it cannot re-frame).
        node_pub = ed25519.public_key_from_seed(node_seed)
        sig = ed25519.sign(node_seed, challenge + eph_pub)
        self._send_frame(0xFF, node_pub + sig)
        chan, auth = self._recv_frame()
        if chan != 0xFF or len(auth) != 96:
            raise ValueError("secret connection: bad auth frame")
        peer_pub, peer_sig = auth[:32], auth[32:]
        if peer_pub == node_pub:
            raise ValueError("secret connection: peer claims our own identity")
        if not ed25519.verify(peer_pub, challenge + peer_eph, peer_sig):
            raise ValueError("secret connection: peer identity signature invalid")
        self.peer_pub_key = peer_pub
        self.peer_id = address_hash(peer_pub).hex().upper()

    # -- framing (TCPConnection-compatible surface) --

    def _nonce(self, ctr: int) -> bytes:
        return ctr.to_bytes(12, "little")

    def _send_frame(self, chan_id: int, msg: bytes) -> None:
        with self._wlock:
            ct = self._send_aead.encrypt(
                self._nonce(self._send_ctr), bytes([chan_id]) + msg, b""
            )
            self._send_ctr += 1
            self._sock.sendall(_LEN.pack(len(ct)) + ct)  # nonce counter and wire bytes advance together

    def _recv_frame(self, timeout: float | None = None) -> tuple[int, bytes]:
        prev = self._sock.gettimeout()
        if timeout is not None:
            self._sock.settimeout(timeout)
        try:
            hdr = _recv_exact(self._sock, _LEN.size)
            (n,) = _LEN.unpack(hdr)
            if n > MAX_FRAME_BYTES + 17:
                raise ConnectionClosed()
            ct = _recv_exact(self._sock, n)
            try:
                pt = self._recv_aead.decrypt(self._nonce(self._recv_ctr), ct, b"")
            except Exception:
                # tampered/replayed frame: the link is gone, not retryable
                raise ConnectionClosed()
            self._recv_ctr += 1
            return pt[0], pt[1:]
        except socket.timeout:
            self.close()
            raise ConnectionClosed()
        except OSError:
            raise ConnectionClosed()
        finally:
            if timeout is not None and not self._closed.is_set():
                try:
                    self._sock.settimeout(prev)
                except OSError:
                    pass

    def send(self, chan_id: int, msg: bytes, timeout: float | None = 10.0) -> bool:
        if self._closed.is_set():
            return False
        if len(msg) > MAX_FRAME_BYTES:
            raise ValueError(f"frame too large: {len(msg)}")
        try:
            self._send_frame(chan_id, msg)
            return True
        except OSError:
            self.close()
            return False

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        """Best-effort send: skips (False) when another sender holds the
        write lock. Unlike TCPConnection.try_send it cannot probe the
        kernel buffer first — AEAD nonces must advance in lockstep with
        wire bytes, so a frame once encrypted is always written in full."""
        if self._closed.is_set():
            return False
        if len(msg) > MAX_FRAME_BYTES:
            raise ValueError(f"frame too large: {len(msg)}")
        if not self._wlock.acquire(blocking=False):
            return False
        try:
            ct = self._send_aead.encrypt(
                self._nonce(self._send_ctr), bytes([chan_id]) + msg, b""
            )
            self._send_ctr += 1
            self._sock.sendall(_LEN.pack(len(ct)) + ct)
            return True
        except OSError:
            self.close()
            return False
        finally:
            self._wlock.release()

    def recv(self, timeout: float | None = None) -> tuple[int, bytes]:
        if self._closed.is_set():
            raise ConnectionClosed()
        return self._recv_frame(timeout)

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
