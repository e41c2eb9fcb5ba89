"""PyTorch port, the two gossip reactors on the CPU, frame by frame through
fake peers, against the JAX package's reactors (``ledger=None``) on the
same seeded votes (tolerance 0: bytes, keys, sets, codes, counters):

- the frame encoders' bytes;
- one scripted sequence of vote frames -- fresh votes, a duplicate from a
  second peer, a same-peer replay, re-gossip of a committed vote, a full
  pool, a malformed segment, an undecodable vote, an unknown message
  type, a height update -- with the pool's keys in order, every sender
  set, the duplicate counters and the errors raised compared after every
  frame, then ``add_sender``'s codes;
- the sign routine's votes (priority lane first, a block-only tx skipped);
- one broadcast walk's frames to a fake peer for each reactor, with sender
  suppression and the one-block lag;
- the mempool reactor's anti-entropy re-walk: the same frame again.
The process-wide wire maps are cleared first, so no decoded vote of
another test is a hit here."""

import hashlib
import threading
import time

import numpy as np
import pytest

import txflow_tpu.abci as jabci
import txflow_tpu.pool as jpool
import txflow_tpu.reactors.mempool_reactor as jmr
import txflow_tpu.reactors.txvote_reactor as jtr
import txflow_tpu.types as jtypes
from txflow_tpu.utils.config import MempoolConfig as JMempoolConfig

import txflow_tpu_torch.abci as pabci
import txflow_tpu_torch.pool as ppool
import txflow_tpu_torch.reactors.mempool_reactor as pmr
import txflow_tpu_torch.reactors.txvote_reactor as ptr
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.codec import amino
from txflow_tpu_torch.utils.config import MempoolConfig

CHAIN = "reactor-chain"
PKG = {
    "jax": dict(types=jtypes, pool=jpool, tr=jtr, mr=jmr, abci=jabci, cfg=JMempoolConfig),
    "port": dict(types=ptypes, pool=ppool, tr=ptr, mr=pmr, abci=pabci, cfg=MempoolConfig),
}


@pytest.fixture(autouse=True)
def clean_wire_maps():
    jtr.TxVoteReactor._shared_wire._map.clear()
    ptr.TxVoteReactor._shared_wire.clear()
    yield


class FakeStats:
    def __init__(self):
        self.duplicates = 0


class FakePeer:
    """What a reactor reads of a peer: id, state, stats, sends."""

    def __init__(self, node_id):
        self.node_id = node_id
        self.kv = {}
        self.stats = FakeStats()
        self.sent = []
        self.running = True
        self.reads = {}  # key -> times a routine read it

    def set(self, k, v):
        self.kv[k] = v

    def get(self, k, default=None):
        self.reads[k] = self.reads.get(k, 0) + 1
        return self.kv.get(k, default)

    def send(self, chan, msg, timeout=10.0):
        self.sent.append((chan, msg))
        return True

    def try_send(self, chan, msg):
        return self.send(chan, msg)

    def is_running(self):
        return self.running


def make_pvs(n=4, seed=31):
    rng = np.random.default_rng(seed)
    pvs = [jtypes.MockPV(rng.bytes(32)) for _ in range(n)]
    vals = {k: m["types"].ValidatorSet([m["types"].Validator.from_pub_key(pv.get_pub_key(), 10)
                                        for pv in pvs]) for k, m in PKG.items()}
    return pvs, vals


def signed_votes(pvs, n_txs, height=1, ts=1_700_000_000_000_000_000):
    """Wire bytes of one vote by each signer for each tx."""
    out = []
    for t in range(n_txs):
        tx = b"rt%d=v" % t
        key = hashlib.sha256(tx).digest()
        for pv in pvs:
            v = jtypes.TxVote(height, key.hex().upper(), key, ts + t, pv.get_address())
            pv.sign_tx_vote(CHAIN, v)
            out.append(jtypes.encode_tx_vote(v))
    return out


def build(pkg, vals, pool_size=8):
    m = PKG[pkg]
    cfg = m["cfg"](size=pool_size, cache_size=1000)
    mp = m["pool"].Mempool(cfg)
    vp = m["pool"].TxVotePool(cfg)
    st = m["tr"].StateView(CHAIN, 1, vals[pkg])
    r = m["tr"].TxVoteReactor(lambda: st, mp, vp, broadcast=False)
    return r, mp, vp


def pool_view(pkg, vp, peers):
    entries, _ = vp.entries_from(0, 10_000)
    keys = [e[0] for e in entries]
    senders = {(k, p): vp.has_sender(k, p) for k in keys for p in range(len(peers) + 2)}
    return keys, senders, [e[3] for e in entries]


def vote_frame(pkg, segs):
    return bytes([PKG[pkg]["tr"].MSG_VOTES]) + b"".join(amino.length_prefixed(s) for s in segs)


def test_frame_encoders_match_jax():
    pvs, _ = make_pvs()
    wires = signed_votes(pvs, 5)
    jv = [jtypes.decode_tx_vote(w) for w in wires]
    pv = [ptypes.decode_tx_vote(w) for w in wires]
    assert ptr.encode_vote_batch(pv) == jtr.encode_vote_batch(jv)
    rng = np.random.default_rng(2)
    txs = [rng.bytes(int(rng.integers(0, 300))) for _ in range(20)]
    assert pmr.encode_tx_batch(txs) == jmr.encode_tx_batch(txs)
    assert pmr.decode_tx_batch(pmr.encode_tx_batch(txs)[1:]) == txs


def test_scripted_receive_matches_jax():
    pvs, vals = make_pvs()
    w = signed_votes(pvs, 3)  # 12 votes: w[0..11]
    bad_vote = bytearray(w[5])
    bad_vote[2] = 0xFF  # a field key no vote has: the decoder raises
    script = [
        ("p1", "votes", [w[0], w[1], w[2], w[3], w[4], w[5]]),  # fresh
        ("p2", "votes", [w[0], w[1], w[2], w[6]]),  # duplicates + one fresh
        ("p1", "votes", [w[0]]),  # same-peer replay
        ("commit", [1]),  # w[1] commits: out of the pool, into its cache
        ("p2", "votes", [w[1]]),  # re-gossip of the committed vote
        ("p3", "votes", [w[7], w[8], w[9], w[10]]),  # fills the pool (size 8)
        ("p3", "raw", bytes([1]) + b"\x05ab"),  # truncated segment
        ("p3", "votes", [bytes(bad_vote)]),  # an undecodable vote
        ("p2", "raw", b"\x09xyz"),  # unknown message type
        ("p1", "raw", bytes([2]) + amino.uvarint(7)),  # height update
        ("p3", "raw", b""),  # empty
    ]
    results = {}
    for pkg in PKG:
        r, mp, vp = build(pkg, vals)
        peers = {n: FakePeer(n) for n in ("p1", "p2", "p3")}
        trace = []
        for step in script:
            if step[0] == "commit":
                votes = [PKG[pkg]["types"].decode_tx_vote(w[i]) for i in step[1]]
                vp.update(1, votes)
                trace.append(("commit", pool_view(pkg, vp, peers)))
                continue
            name, kind, body = step
            msg = vote_frame(pkg, body) if kind == "votes" else body
            try:
                r.receive(0x32, peers[name], msg)
                err = None
            except Exception as e:
                err = (type(e).__name__, str(e))
            trace.append((name, err, pool_view(pkg, vp, peers),
                          {n: p.stats.duplicates for n, p in peers.items()},
                          {n: dict(p.kv) for n, p in peers.items()}))
        keys = pool_view(pkg, vp, peers)[0]
        codes = [vp.add_sender(k, pid) for k in keys[:3] for pid in (1, 2, 5)]
        codes.append(vp.add_sender(hashlib.sha256(b"gone").digest(), 1))
        codes.append(vp.in_cache(PKG[pkg]["types"].decode_tx_vote(w[1]).vote_key()))
        codes.append(vp.origins_of(keys + [b"\x00" * 32]))
        results[pkg] = (trace, codes)
    assert results["port"] == results["jax"]
    trace, codes = results["port"]
    # what the script exercised, by construction
    assert trace[1][3]["p2"] == 3 and trace[2][3]["p1"] == 1  # dups, replay
    assert trace[4][3]["p2"] == 4  # the committed vote re-gossiped: skipped
    assert len(trace[5][2][0]) == 8  # full: w[10] bounced
    assert all(trace[i][1] is not None for i in (6, 7, 8, 10))
    assert trace[9][4]["p1"] == {"txvote_height": 7}
    # w[0] came from p1 (pid 1) and p2 (pid 2): repeats; pid 5 is new
    assert codes[:3] == [2, 2, 1] and codes[9] == 0


class FixedTimePV:
    """A signer that stamps one timestamp on every vote first, so both
    packages' sign routines produce the same bytes."""

    def __init__(self, pv):
        self.pv = pv

    def get_address(self):
        return self.pv.get_address()

    def sign_tx_vote(self, chain_id, vote):
        vote.timestamp_ns = 1_700_000_000_123_456_789
        self.pv.sign_tx_vote(chain_id, vote)


def test_sign_routine_votes_match_jax():
    pvs, vals = make_pvs()
    txs = [b"s%d=v" % i for i in range(6)] + [b"fee=1;s=v", b"val:" + b"00" * 32 + b"!5",
                                              b"s9=v", b"fee=2;t=v"]
    # the block-only validator tx is skipped, the two fee txs go first
    expect_n = len(txs) - 1
    got = {}
    for pkg in PKG:
        m = PKG[pkg]
        cfg = m["cfg"](size=100, cache_size=1000)
        conns = m["abci"].AppConns(m["abci"].KVStoreApplication())
        mp = m["pool"].Mempool(cfg, proxy_app_conn=conns.mempool)
        mp.lane_of = lambda tx: 0 if tx.startswith(b"fee") else 1
        vp = m["pool"].TxVotePool(cfg)
        for tx in txs:
            mp.check_tx(tx)
        st = m["tr"].StateView(CHAIN, 4, vals[pkg])
        r = m["tr"].TxVoteReactor(lambda st=st: st, mp, vp, priv_val=FixedTimePV(pvs[2]),
                                  broadcast=False, poll_interval=0.01)
        r._running.set()
        t = threading.Thread(target=r._sign_tx_routine, daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while vp.size() < expect_n and time.monotonic() < deadline:
            time.sleep(0.005)
        r._running.clear()
        t.join(timeout=5)
        assert not t.is_alive()
        entries, _ = vp.entries_from(0, 100)
        got[pkg] = [(e[0], e[3]) for e in entries]
    assert len(got["port"]) == expect_n
    assert got["port"] == got["jax"]


def _walk_frames(pkg, vals, votes_wire, from_peer, peer_height, txs):
    """One broadcast routine of each reactor to a fake peer (pid 1): the
    vote pool holds ``votes_wire`` (those with index in ``from_peer``
    delivered by that peer), the mempool ``txs`` (every third delivered by
    it); the peer starts at ``peer_height`` and moves to 9 after the first
    frames. Returns the frames each routine sent."""
    m = PKG[pkg]
    cfg = m["cfg"](size=100, cache_size=1000)
    mp = m["pool"].Mempool(cfg)
    vp = m["pool"].TxVotePool(cfg)
    st = m["tr"].StateView(CHAIN, 1, vals[pkg])
    r = m["tr"].TxVoteReactor(lambda: st, mp, vp, broadcast=False, poll_interval=0.01)
    mr = m["mr"].MempoolReactor(mp, broadcast=False, poll_interval=0.01)
    peer = FakePeer("walker")
    assert r._peer_id(peer) == 1 and mr._peer_id(peer) == 1
    info = m["pool"].TxInfo
    for i, wv in enumerate(votes_wire):
        vp.check_tx(m["types"].decode_tx_vote(wv), info(sender_id=1 if i in from_peer else 0))
    for i, tx in enumerate(txs):
        mp.check_tx(tx, info(sender_id=1 if i % 3 == 0 else 0))
    peer.kv[m["tr"].PEER_HEIGHT_KEY] = peer_height
    peer.kv[m["mr"].PEER_HEIGHT_KEY] = peer_height
    r._running.set()
    mr._running.set()
    threads = [threading.Thread(target=r._broadcast_routine, args=(peer,), daemon=True),
               threading.Thread(target=mr._broadcast_routine, args=(peer,), daemon=True)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while len(peer.sent) < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    # the deferred votes wait for the peer's height: the vote routine has
    # re-read it twice more without sending them
    seen = peer.reads.get(m["tr"].PEER_HEIGHT_KEY, 0)
    while peer.reads.get(m["tr"].PEER_HEIGHT_KEY, 0) < seen + 2:
        assert time.monotonic() < deadline, "the vote routine stopped re-reading the height"
        time.sleep(0.005)
    first = sorted(peer.sent)
    peer.kv[m["tr"].PEER_HEIGHT_KEY] = 9
    while len(peer.sent) < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    peer.running = False
    r._running.clear()
    mr._running.clear()
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    return first, sorted(peer.sent)


def test_broadcast_walk_frames_match_jax():
    pvs, vals = make_pvs()
    wire = signed_votes(pvs, 2, height=1) + signed_votes(pvs[:2], 2, height=4)
    from_peer = {1, 4, 9}
    txs = [b"b%d=v" % i for i in range(7)]
    frames = {pkg: _walk_frames(pkg, vals, wire, from_peer, 2, txs) for pkg in PKG}
    assert frames["port"] == frames["jax"]
    first, every = frames["port"]
    by_chan = {c: [m for cc, m in every if cc == c] for c in (0x30, 0x32)}
    # votes: the height-1 ones not from the peer first, then the height-4
    # ones once the peer reached height 9, none the peer sent
    segs = [amino.length_prefixed(w) for w in wire]
    assert by_chan[0x32] == [
        b"\x01" + b"".join(s for i, s in enumerate(segs[:8]) if i not in from_peer),
        b"\x01" + b"".join(s for i, s in enumerate(segs[8:], 8) if i not in from_peer)]
    assert by_chan[0x30] == [pmr.encode_tx_batch([tx for i, tx in enumerate(txs) if i % 3])]


def _regossip_frames(pkg, txs):
    """The mempool reactor's broadcast routine with a 20 ms anti-entropy
    interval to a fake peer that never reports the txs back: the frames of
    the first walk and of the re-walk."""
    m = PKG[pkg]
    mp = m["pool"].Mempool(m["cfg"](size=100, cache_size=1000))
    for tx in txs:
        mp.check_tx(tx)
    mr = m["mr"].MempoolReactor(mp, broadcast=False, poll_interval=0.01,
                                regossip_interval=0.02)
    peer = FakePeer("walker")
    peer.kv[m["mr"].PEER_HEIGHT_KEY] = 1
    mr._running.set()
    t = threading.Thread(target=mr._broadcast_routine, args=(peer,), daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while len(peer.sent) < 2:
        assert time.monotonic() < deadline, "no re-walk"
        time.sleep(0.005)
    peer.running = False
    mr._running.clear()
    t.join(timeout=5)
    assert not t.is_alive()
    return peer.sent[:2]


def test_mempool_regossip_rewalk_matches_jax():
    txs = [b"rg%d=v" % i for i in range(5)]
    frames = {pkg: _regossip_frames(pkg, txs) for pkg in PKG}
    assert frames["port"] == frames["jax"]
    assert frames["port"] == [(0x30, pmr.encode_tx_batch(txs))] * 2
