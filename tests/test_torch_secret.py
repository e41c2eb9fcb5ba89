"""PyTorch port, authenticated links on the CPU: the port's
SecretConnection against the JAX package's over a loopback TCP pair, in
both roles, frames both ways; TCPConnection framing between the packages;
a tampered frame and a wrong identity. Both packages pick the same AEAD
(``cryptography`` when it imports, else the stdlib one), so the links
interoperate. TCP only over 127.0.0.1 inside each test; every wait is
bounded. (A ``socket.socketpair()`` is an AF_UNIX pair on Linux, where the
connection's TCP_NODELAY does not apply: the pair here is a loopback TCP
accept/connect.)"""

import socket
import struct
import threading

import numpy as np
import pytest

import txflow_tpu.p2p.secret as jsecret
import txflow_tpu.p2p.transport as jtransport

import txflow_tpu_torch.p2p.secret as psecret
import txflow_tpu_torch.p2p.transport as ptransport
from txflow_tpu_torch.crypto import ed25519
from txflow_tpu_torch.crypto.hash import address_hash


def tcp_pair():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(5.0)
    c = socket.create_connection(srv.getsockname(), timeout=5.0)
    s, _ = srv.accept()
    srv.close()
    for x in (c, s):
        x.settimeout(None)
    return c, s


def handshake_both(make_a, make_b):
    """Run both ends' handshakes at once (each waits on the other);
    returns (conn_a, conn_b) or raises the first error."""
    sa, sb = tcp_pair()
    out, errs = {}, []

    def run(name, make, sock):
        try:
            out[name] = make(sock)
        except Exception as e:  # raised below, in the test thread
            errs.append((name, e))
            sock.close()

    threads = [threading.Thread(target=run, args=("a", make_a, sa)),
               threading.Thread(target=run, args=("b", make_b, sb))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive(), "handshake hung"
    return out, errs


def seeds(n, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


@pytest.mark.parametrize("port_side", ["a", "b"])
def test_secret_connection_interop_both_roles(port_side):
    s1, s2 = seeds(2)
    mod = {"a": (psecret, jsecret), "b": (jsecret, psecret)}[port_side]
    out, errs = handshake_both(lambda s: mod[0].SecretConnection(s, s1),
                               lambda s: mod[1].SecretConnection(s, s2))
    assert not errs, errs
    a, b = out["a"], out["b"]
    try:
        id1 = address_hash(ed25519.public_key_from_seed(s1)).hex().upper()
        id2 = address_hash(ed25519.public_key_from_seed(s2)).hex().upper()
        assert a.peer_id == id2 and b.peer_id == id1
        assert type(a._send_aead) is type(b._send_aead)
        rng = np.random.default_rng(3)
        msgs = [(int(rng.integers(0, 256)), rng.bytes(int(rng.integers(0, 5000))))
                for _ in range(20)]
        for chan, msg in msgs:
            assert a.send(chan, msg)
            assert b.recv(timeout=5.0) == (chan, msg)
            assert b.try_send(chan, msg[::-1])
            assert a.recv(timeout=5.0) == (chan, msg[::-1])
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("sender", ["port", "jax"])
def test_tcp_connection_framing_interop(sender):
    sa, sb = tcp_pair()
    mods = (ptransport, jtransport) if sender == "port" else (jtransport, ptransport)
    a, b = mods[0].TCPConnection(sa), mods[1].TCPConnection(sb)
    try:
        rng = np.random.default_rng(4)
        for i in range(10):
            msg = rng.bytes(int(rng.integers(0, 70000)))
            assert (a.send if i % 2 else a.try_send)(0x32, msg) is True
            assert b.recv(timeout=5.0) == (0x32, msg)
        with pytest.raises(ValueError, match="too large"):
            a.send(1, bytes(ptransport.MAX_FRAME_BYTES + 1))
        assert ptransport.MAX_FRAME_BYTES == jtransport.MAX_FRAME_BYTES
    finally:
        a.close()
        b.close()
    with pytest.raises(mods[1].ConnectionClosed):
        b.recv(timeout=1.0)


def test_tampered_frame_closes_the_link():
    s1, s2 = seeds(2, seed=10)
    out, errs = handshake_both(lambda s: psecret.SecretConnection(s, s1),
                               lambda s: jsecret.SecretConnection(s, s2))
    assert not errs, errs
    a, b = out["a"], out["b"]
    try:
        assert b.send(7, b"good")
        assert a.recv(timeout=5.0) == (7, b"good")
        # a frame of the right length whose ciphertext is flipped
        ct = b._send_aead.encrypt(b._nonce(b._send_ctr), bytes([7]) + b"evil", b"")
        b._send_ctr += 1
        bad = bytes([ct[0] ^ 1]) + ct[1:]
        b._sock.sendall(struct.pack("!I", len(bad)) + bad)
        with pytest.raises(ptransport.ConnectionClosed):
            a.recv(timeout=5.0)
    finally:
        a.close()
        b.close()


def test_wrong_identity_is_refused(monkeypatch):
    # a peer presenting our own key is refused
    s1, s2 = seeds(2, seed=11)
    out, errs = handshake_both(lambda s: psecret.SecretConnection(s, s1),
                               lambda s: jsecret.SecretConnection(s, s1))
    assert not out and {n for n, _ in errs} == {"a", "b"}
    assert any("our own identity" in str(e) for n, e in errs if n == "a")
    # a JAX peer whose identity signature does not verify: the port refuses
    real_sign = jsecret.ed25519.sign
    monkeypatch.setattr(jsecret.ed25519, "sign",
                        lambda seed, msg: real_sign(seed, msg + b"x"))
    out, errs = handshake_both(lambda s: psecret.SecretConnection(s, s1),
                               lambda s: jsecret.SecretConnection(s, s2))
    assert "a" not in out
    assert any(n == "a" and "signature invalid" in str(e) for n, e in errs)
