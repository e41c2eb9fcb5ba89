"""PyTorch port, peer exchange on the CPU: the address book's file and the
PEX messages equal to the JAX package's (through fake peers), and one
loopback dial from the book between two keyed switches of the port
(authenticated secret connections). Every wait is bounded."""

import json
import threading
import time

import numpy as np

import txflow_tpu.p2p.pex as jpex

import txflow_tpu_torch.p2p as pp2p
import txflow_tpu_torch.p2p.pex as ppex


class FakePeer:
    def __init__(self, node_id="peer"):
        self.node_id = node_id
        self.sent = []

    def try_send(self, chan, msg):
        self.sent.append((chan, msg))
        return True


class FakeSwitch:
    node_id = "SELF"
    listen_addr = ("127.0.0.1", 26656)


def test_address_book_and_pex_messages_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    adds = [(rng.bytes(20).hex().upper(), "10.0.0.%d" % int(rng.integers(1, 250)),
             int(rng.integers(1024, 65535))) for _ in range(6)]
    adds.append(adds[2])  # a repeat: no change
    adds.append((adds[3][0], "10.9.9.9", 1))  # a move
    out = {}
    for name, mod in (("jax", jpex), ("port", ppex)):
        path = tmp_path / f"{name}.json"
        book = mod.AddressBook(str(path))
        changed = [book.add(*a) for a in adds]
        reloaded = mod.AddressBook(str(path))
        r = mod.PEXReactor(book)
        r.set_switch(FakeSwitch())
        peer = FakePeer()
        r.add_peer(peer)  # advertise ours + ask for theirs
        r.receive(mod.CHANNEL_PEX, peer, bytes([mod.MSG_REQUEST]))
        incoming = json.dumps([["SELF", "1.1.1.1", 1], ["NEWID", "2.2.2.2", 2]]).encode()
        r.receive(mod.CHANNEL_PEX, peer, bytes([mod.MSG_ADDRS]) + incoming)
        try:
            r.receive(mod.CHANNEL_PEX, peer, b"\x07")
            err = None
        except ValueError as e:
            err = str(e)
        out[name] = (changed, path.read_bytes(), reloaded.entries(), peer.sent,
                     book.entries(), err)
    assert out["port"] == out["jax"]
    assert out["port"][0][-2:] == [False, True] and "NEWID" in out["port"][4]


def test_loopback_dial_from_the_book():
    seeds = [np.random.default_rng(90 + i).bytes(32) for i in range(2)]
    a, b = pp2p.Switch("a", node_seed=seeds[0]), pp2p.Switch("b", node_seed=seeds[1])
    book_a = ppex.AddressBook()
    ra = a.add_reactor("pex", ppex.PEXReactor(book_a))
    b.add_reactor("pex", ppex.PEXReactor(ppex.AddressBook()))
    before = set(threading.enumerate())
    a.start()
    b.start()
    try:
        host, port = b.listen_tcp("127.0.0.1", 0)
        book_a.add(b.node_id, host, port)
        deadline = time.monotonic() + 10
        while not (a.get_peer(b.node_id) and b.get_peer(a.node_id)):
            assert time.monotonic() < deadline, "the ensure-peers loop never dialed"
            time.sleep(0.01)
        pa = a.get_peer(b.node_id)
        assert pa.outbound and not b.get_peer(a.node_id).outbound
        assert ra.book.get(b.node_id) == (host, port)
    finally:
        a.stop()
        b.stop()
    deadline = time.monotonic() + 5
    while [t for t in set(threading.enumerate()) - before if t.is_alive()]:
        assert time.monotonic() < deadline, [t.name for t in set(threading.enumerate()) - before]
        time.sleep(0.01)
