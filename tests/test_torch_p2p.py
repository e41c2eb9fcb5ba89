"""PyTorch port, the p2p layer on the CPU: X25519, node ids, the amino
reader, the in-memory transport and the switch, each against the JAX
package on the same seeded inputs (tolerance 0: bytes, bools and ints).
Every wait is bounded; the switches run over in-memory pipes."""

import threading
import time

import numpy as np
import pytest

import txflow_tpu.codec.amino as jamino
import txflow_tpu.crypto.x25519 as jx
import txflow_tpu.node.id as jid
import txflow_tpu.p2p as jp2p
import txflow_tpu.p2p.transport as jtransport

import txflow_tpu_torch.codec.amino as pamino
import txflow_tpu_torch.crypto.x25519 as px
import txflow_tpu_torch.node.id as pid
import txflow_tpu_torch.p2p as pp2p
import txflow_tpu_torch.p2p.transport as ptransport
from txflow_tpu_torch.crypto import ed25519
from txflow_tpu_torch.p2p.base import ChannelDescriptor, Reactor


def wait_until(cond, timeout=5.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


# -- X25519 (RFC 7748) --

RFC_DH = {  # section 6.1
    "a": "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
    "A": "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a",
    "b": "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb",
    "B": "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f",
    "K": "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742",
}


def test_x25519_rfc7748_vectors():
    h = bytes.fromhex
    # section 5.2, first vector
    assert px.scalar_mult(
        h("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4"),
        h("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c"),
    ).hex() == "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
    assert px.public_key(h(RFC_DH["a"])).hex() == RFC_DH["A"]
    assert px.public_key(h(RFC_DH["b"])).hex() == RFC_DH["B"]
    assert px.shared_secret(h(RFC_DH["a"]), h(RFC_DH["B"])).hex() == RFC_DH["K"]
    assert px.shared_secret(h(RFC_DH["b"]), h(RFC_DH["A"])).hex() == RFC_DH["K"]
    with pytest.raises(ValueError, match="low-order"):
        px.shared_secret(h(RFC_DH["a"]), bytes(32))


def test_x25519_matches_jax_on_seeded_scalars():
    rng = np.random.default_rng(1701)
    for _ in range(12):
        k, u = rng.bytes(32), rng.bytes(32)
        assert px.scalar_mult(k, u) == jx.scalar_mult(k, u)
        assert px.public_key(k) == jx.public_key(k)


# -- node ids --

def test_node_ids_and_greetings_match_jax():
    rng = np.random.default_rng(77)
    for i in range(3):
        seed = rng.bytes(32)
        pub = ed25519.public_key_from_seed(seed)
        pj = jid.PrivNodeID(jid.NodeID(f"n{i}", pub), seed)
        pq = pid.PrivNodeID(pid.NodeID(f"n{i}", pub), seed)
        gj = pj.sign_greeting("v1", "chain", "hello")
        gp = pq.sign_greeting("v1", "chain", "hello")
        gp.greeting.time_ns = gj.greeting.time_ns
        assert gp.greeting.sign_bytes() == gj.greeting.sign_bytes()
        sig = ed25519.sign(seed, gj.greeting.sign_bytes())
        assert pid.SignedNodeGreeting(gp.greeting, sig).verify()
        # a switch's id from its node key: the verified-key address
        assert pp2p.Switch("x", node_seed=seed).node_id == jp2p.Switch("x", node_seed=seed).node_id


# -- the amino reader --

def _reader_script(mod, data):
    """The same read sequence on both packages' readers: values, cursor
    positions and the first error."""
    out = []
    r = mod.AminoReader(data)
    try:
        while not r.eof():
            fnum, typ3 = r.read_field_key()
            if fnum % 5 == 0:
                r.skip_field(typ3)
                out.append(("skip", r.pos))
            elif typ3 == mod.TYP3_VARINT:
                out.append(("v", r.read_varint(), r.pos))
            elif typ3 == mod.TYP3_8BYTE:
                out.append(("f", r.read_fixed64(), r.pos))
            elif typ3 == mod.TYP3_BYTELEN:
                if fnum % 2:
                    sub = r.sub_reader()
                    out.append(("sub", sub.pos, sub.end, r.pos))
                else:
                    out.append(("b", r.read_bytes(), r.pos))
            else:
                r.skip_field(typ3)
    except ValueError as e:
        out.append(("err", str(e)))
    return out


def test_amino_reader_matches_jax():
    rng = np.random.default_rng(5)
    # well-formed streams built with the encoders, then truncations and
    # random bytes
    body = bytearray()
    for f in range(1, 40):
        kind = int(rng.integers(3))
        if kind == 0:
            body += jamino.field_key(f, 0) + jamino.varint(int(rng.integers(-2**40, 2**40)))
        elif kind == 1:
            body += jamino.field_key(f, 1) + jamino.fixed64(int(rng.integers(-2**62, 2**62)))
        else:
            body += jamino.field_key(f, 2) + jamino.length_prefixed(rng.bytes(int(rng.integers(0, 40))))
    streams = [bytes(body), bytes(body[:-3]), bytes(body[:17])]
    streams += [rng.bytes(int(rng.integers(1, 64))) for _ in range(40)]
    streams.append(b"\xff" * 11)  # a uvarint past 64 bits
    for data in streams:
        assert _reader_script(pamino, data) == _reader_script(jamino, data)
    assert pamino.fixed64(-5) == jamino.fixed64(-5)


# -- the in-memory transport --

def _transport_script(mod):
    a, b = mod.connection_pair(capacity=4, labels=("a", "b"))
    out = [a.send(0x30, b"one"), a.try_send(0x32, b"two"), b.recv(timeout=1.0)]
    for _ in range(4):
        out.append(b.try_send(1, b"x"))  # the fourth fills the queue
    out.append(b.try_send(1, b"full"))
    a.close()
    out += [a.is_closed, a.send(1, b"late"), a.try_send(1, b"late")]
    out.append(b.recv(timeout=1.0))  # queued before the close: delivered
    try:
        b.recv(timeout=1.0)
        out.append("no close")
    except mod.ConnectionClosed:
        out.append("closed")
    out.append(b.is_closed)
    try:
        a.recv(timeout=0.05)
        out.append("no close")
    except mod.ConnectionClosed:
        out.append("closed")
    c, d = mod.connection_pair(capacity=2)
    try:
        d.recv(timeout=0.05)
    except TimeoutError:
        out.append("timeout")
    return out


def test_in_memory_transport_close_semantics_match_jax():
    assert _transport_script(ptransport) == _transport_script(jtransport)


# -- the switch --

class Recorder(Reactor):
    def __init__(self, chans, fail_on=None):
        super().__init__("rec")
        self.chans = chans
        self.fail_on = fail_on
        self.got = []
        self.added, self.removed = [], []

    def get_channels(self):
        return [ChannelDescriptor(id=c) for c in self.chans]

    def add_peer(self, peer):
        self.added.append(peer.node_id)

    def remove_peer(self, peer, reason=None):
        self.removed.append((peer.node_id, str(reason)))

    def receive(self, chan_id, peer, msg):
        if msg == self.fail_on:
            raise ValueError("bad frame")
        self.got.append((chan_id, peer.node_id, msg))


def test_switch_channel_dispatch():
    a, b = pp2p.Switch("A"), pp2p.Switch("B")
    ra, rb = Recorder([0x30]), Recorder([0x30, 0x31])
    a.add_reactor("rec", ra)
    b.add_reactor("rec", rb)
    with pytest.raises(pp2p.switch.SwitchError):
        b.add_reactor("dup", Recorder([0x31]))
    a.start()
    b.start()
    try:
        pa, pb = pp2p.connect_switches(a, b)
        assert ra.added == ["B"] and rb.added == ["A"]
        frames = [(0x30, b"m%d" % i) for i in range(5)] + [(0x31, b"x"), (0x77, b"nobody")]
        for chan, msg in frames:
            assert pa.send(chan, msg)
        wait_until(lambda: len(rb.got) == 6, what="frames at B")
        assert sorted(rb.got) == sorted((c, "A", m) for c, m in frames[:6])
        # one channel keeps its order; the unknown channel was dropped
        assert [m for c, _, m in rb.got if c == 0x30] == [m for c, m in frames[:5]]
        b.broadcast(0x30, b"back")
        wait_until(lambda: ra.got == [(0x30, "B", b"back")], what="broadcast at A")
        assert a.n_peers() == b.n_peers() == 1 and pb.stats.recv_count >= 1
    finally:
        a.stop()
        b.stop()
    assert a.n_peers() == b.n_peers() == 0


def test_bad_frame_stops_the_peer(monkeypatch):
    monkeypatch.setenv("TXFLOW_P2P_QUIET", "1")
    a, b = pp2p.Switch("A"), pp2p.Switch("B")
    rb = Recorder([0x30], fail_on=b"poison")
    a.add_reactor("rec", Recorder([0x30]))
    b.add_reactor("rec", rb)
    a.start()
    b.start()
    try:
        pa, _ = pp2p.connect_switches(a, b)
        pa.send(0x30, b"fine")
        pa.send(0x30, b"poison")
        pa.send(0x30, b"after")
        wait_until(lambda: b.n_peers() == 0, what="B to drop A")
        # the pipe closed under A too: its loops stop the peer
        wait_until(lambda: a.n_peers() == 0, what="A to drop B")
        assert rb.got == [(0x30, "A", b"fine")]
        assert rb.removed and "bad frame" in rb.removed[0][1]
        assert not pa.is_running() and not pa.send(0x30, b"x")
    finally:
        a.stop()
        b.stop()


def test_peer_stop_ends_broadcast_threads():
    """A stopped peer's send and receive loops and both reactors' broadcast
    routines exit; a stopped switch leaves no thread."""
    from txflow_tpu_torch.node import Node, NodeConfig
    from txflow_tpu_torch.abci import KVStoreApplication
    from txflow_tpu_torch.types import MockPV, Validator, ValidatorSet
    from txflow_tpu_torch.utils.config import test_config

    before = set(threading.enumerate())
    pvs = [MockPV(bytes([i + 1]) * 32) for i in range(2)]
    vals = ValidatorSet([Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])
    nodes = [Node(f"node{i}", "chain", vals, KVStoreApplication(), pvs[i],
                  NodeConfig(config=test_config(), device="cpu", sign_votes=False))
             for i in range(2)]
    for n in nodes:
        n.switch.start()
    try:
        pa, _ = pp2p.connect_switches(nodes[0].switch, nodes[1].switch)
        names = lambda: {t.name for t in threading.enumerate()}  # noqa: E731
        wait_until(lambda: {"txvote-bcast-node1", "mempool-bcast-node1"} <= names(),
                   what="broadcast routines")
        nodes[0].switch.stop_peer(pa, reason="test")
        wait_until(lambda: not ({"txvote-bcast-node1", "mempool-bcast-node1",
                                 "p2p-send-node1", "p2p-recv-node1"} & names()),
                   what="node0's loops for node1 to exit")
    finally:
        for n in nodes:
            n.switch.stop()
    wait_until(lambda: set(threading.enumerate()) <= before, what="every thread to exit")
