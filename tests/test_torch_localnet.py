"""PyTorch port, the fast-path node and LocalNet on the CPU (plain kernels,
one shared verifier with the verdict cache), against the JAX package
(tolerance 0: committed sets, certificates, kvstore maps):

- ``LocalNet(4)`` with sign routines and mempool gossip commits every
  broadcast tx on every node, with quorum-sized certificates;
- a replay of pregenerated votes with config 4's corruption mix (one
  validator corrupted on some txs: they commit without it; two on
  others: they commit nowhere) commits exactly the expected set, with no
  corrupted vote in a certificate, and the kvstore maps equal across the
  nodes and to the JAX ``LocalNet``'s on the same corpus (JAX side
  ``use_device_verifier=False``, ``health=False``, ``sync=False``);
- a mixed net of two JAX nodes and two port nodes over in-memory pipes,
  catch-up sync on at both packages' defaults, commits the same set on all
  four, and every sync channel's STATUS advert crosses the packages;
- a clean stop leaves no thread behind, and the last engine's stop closes
  the shared verifier.
Commit order differs between nodes and runs under gossip, so parity is
judged on sets and maps, not on the app digest. Every wait is bounded."""

import hashlib
import queue
import threading
import time

import numpy as np
import pytest
import torch

import txflow_tpu.node as jnode
import txflow_tpu.p2p.transport as jtransport
import txflow_tpu.types as jtypes
from txflow_tpu.utils.config import test_config as j_test_config

import txflow_tpu_torch.node as pnode
import txflow_tpu_torch.p2p as pp2p
import txflow_tpu_torch.p2p.transport as ptransport
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.abci import KVStoreApplication
from txflow_tpu_torch.utils.config import test_config as p_test_config
from txflow_tpu_torch.verifier import DeviceVoteVerifier

CHAIN = "txflow-localnet"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeds(n=4, seed=2024):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


def port_net(pv_seeds, **kw):
    """A LocalNet of the port whose nodes serve from one CPU verifier with
    the verdict cache; returns (net, verifier)."""
    pvs = [ptypes.MockPV(s) for s in pv_seeds]
    vals = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), 10)
                                for pv in pvs])
    v = DeviceVoteVerifier(vals, device="cpu", buckets=(64, 256), shared_cache=True)
    return pnode.LocalNet(len(pvs), config=p_test_config(), priv_vals=pvs, device="cpu",
                          verifier=v, **kw), v


def wait_threads_gone(before, timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        extra = [t for t in set(threading.enumerate()) - before if t.is_alive()]
        if not extra:
            return
        assert time.monotonic() < deadline, sorted(t.name for t in extra)
        time.sleep(0.02)


def test_localnet_commits_every_broadcast_tx_on_every_node():
    before = set(threading.enumerate())
    # the counts below are the engines' own decisions: a catch-up sync
    # apply would commit a tx without one, so sync is off here
    net, verifier = port_net(seeds(), sync=False)
    txs = [b"ln%d=v%d" % (i, i) for i in range(6)]
    net.start()
    try:
        for i, tx in enumerate(txs):
            net.broadcast_tx(tx, node_index=i % 4)
        assert net.wait_all_committed(txs, timeout=45)
        quorum = net.val_set.quorum_power()
        power = {v.address: v.voting_power for v in net.val_set}
        for node in net.nodes:
            assert all(node.is_committed(tx) for tx in txs)
            for tx in txs:
                cert = node.txflow.load_commit(hashlib.sha256(tx).hexdigest().upper())
                stake = sum(power[cs.validator_address] for cs in cert.commits)
                assert stake >= quorum and stake - min(power.values()) < quorum
        assert net.committed_votes_total() == 4 * len(txs) * 3
        # each distinct vote verified once, by the engine that claimed it
        assert verifier.cache_verify_rows <= 4 * len(txs)
    finally:
        net.stop()
    assert verifier.staging_stats() is None
    wait_threads_gone(before)


class Corpus:
    """Pregenerated votes of ``n_txs`` txs by 4 validators: validator 0
    corrupted (a flipped S byte) on the txs in ``one``, validators 0 and 1
    on those in ``two`` (half the stake honest: never commits)."""

    def __init__(self, pv_seeds, n_txs=16, seed=5):
        rng = np.random.default_rng(seed)
        self.pvs = [jtypes.MockPV(s) for s in pv_seeds]
        perm = rng.permutation(n_txs)
        self.one, self.two = set(perm[:2].tolist()), set(perm[2:4].tolist())
        self.txs = [b"rp%d=v%d" % (i, i) for i in range(n_txs)]
        self.wire = [[] for _ in self.pvs]  # per validator, encoded votes
        self.bad = set()
        for t, tx in enumerate(self.txs):
            key = hashlib.sha256(tx).digest()
            for v, pv in enumerate(self.pvs):
                vote = jtypes.TxVote(0, key.hex().upper(), key, 1_700_000_000 + t,
                                     pv.get_address())
                pv.sign_tx_vote(CHAIN, vote)
                if (v == 0 and t in self.one | self.two) or (v == 1 and t in self.two):
                    s = vote.signature
                    vote.signature = s[:40] + bytes([s[40] ^ 1]) + s[41:]
                    self.bad.add(vote.signature)
                self.wire[v].append(jtypes.encode_tx_vote(vote))
        self.expect = [t not in self.two for t in range(n_txs)]

    def replay(self, nodes, types, chunk=8):
        """bench.py's protocol: per chunk, the txs into every mempool, then
        validator v's votes into node v's vote pool."""
        for base in range(0, len(self.txs), chunk):
            for node in nodes:
                node.mempool.check_tx_many(self.txs[base : base + chunk])
            for v, node in enumerate(nodes):
                node.tx_vote_pool.check_tx_many(
                    [types.decode_tx_vote(w) for w in self.wire[v][base : base + chunk]])


def _outcome(corpus, nodes):
    hashes = [hashlib.sha256(tx).hexdigest().upper() for tx in corpus.txs]
    sets, states = [], []
    for node in nodes:
        committed = [node.txflow.is_tx_committed(h) for h in hashes]
        sets.append(committed)
        for h, c in zip(hashes, committed):
            if c:
                cert = node.txflow.load_commit(h)
                assert not any(cs.signature in corpus.bad for cs in cert.commits)
                assert len(cert.commits) == 3
        states.append(dict(node.app.state))
    return sets, states


def test_replay_with_corruption_mix_matches_jax_localnet():
    s = seeds(seed=77)
    corpus = Corpus(s)
    want = [tx for tx, ok in zip(corpus.txs, corpus.expect) if ok]
    net, _ = port_net(s, sign=False, mempool_broadcast=False)
    net.start()
    try:
        corpus.replay(net.nodes, ptypes)
        assert net.wait_all_committed(want, timeout=45)
    finally:
        net.stop()  # collects and routes every ticket in flight
    sets_p, states_p = _outcome(corpus, net.nodes)
    jnet = jnode.LocalNet(4, config=j_test_config(), use_device_verifier=False,
                          priv_vals=corpus.pvs, sign=False, mempool_broadcast=False,
                          health=False, sync=False, index_txs=False)
    jnet.start()
    try:
        corpus.replay(jnet.nodes, jtypes)
        assert jnet.wait_all_committed(want, timeout=45)
    finally:
        jnet.stop()
    sets_j, states_j = _outcome(corpus, jnet.nodes)
    assert all(s == corpus.expect for s in sets_p)
    assert sets_p == sets_j
    assert all(st == states_p[0] for st in states_p + states_j)
    assert set(states_p[0]) == {tx.split(b"=")[0] for tx in want}


def test_mixed_jax_and_port_nodes_commit_the_same_set():
    """Two JAX nodes (validators 0 and 1) and two port nodes (2 and 3) in
    one full mesh of in-memory pipes: mempool and vote gossip cross the
    packages, and every node commits every tx."""
    before = set(threading.enumerate())
    s = seeds(seed=99)
    jpvs = [jtypes.MockPV(x) for x in s]
    jnet = jnode.LocalNet(4, config=j_test_config(), use_device_verifier=False,
                          priv_vals=jpvs, n_nodes=2, health=False, index_txs=False)
    ppvs = [ptypes.MockPV(x) for x in s]
    vals = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), 10)
                                for pv in ppvs])
    assert vals.hash() == jnet.val_set.hash()
    verifier = DeviceVoteVerifier(vals, device="cpu", buckets=(64, 256), shared_cache=True)
    pnodes = [pnode.Node(f"node{i}", CHAIN, vals, KVStoreApplication(), ppvs[i],
                         pnode.NodeConfig(config=p_test_config(), device="cpu"),
                         verifier=verifier) for i in (2, 3)]
    txs = [b"mx%d=v%d" % (i, i) for i in range(6)]
    jnet.start()
    for n in pnodes:
        n.start()
    try:
        pp2p.connect_switches(pnodes[0].switch, pnodes[1].switch)
        for jn in jnet.nodes:
            for pn in pnodes:
                # one pipe, each end its own package's connection (each
                # raises its own ConnectionClosed)
                qa, qb = queue.Queue(maxsize=1024), queue.Queue(maxsize=1024)
                a = jtransport.InMemoryConnection(qa, qb, f"{jn.node_id}->{pn.node_id}")
                b = ptransport.InMemoryConnection(qb, qa, f"{pn.node_id}->{jn.node_id}")
                jn.switch.add_peer_conn(a, pn.switch.node_id, outbound=True)
                pn.switch.add_peer_conn(b, jn.switch.node_id, outbound=False)
        for i, tx in enumerate(txs):
            (jnet.nodes[0] if i % 2 else pnodes[1]).broadcast_tx(tx)
        assert jnet.wait_all_committed(txs, timeout=45)
        deadline = time.monotonic() + 45
        for n in pnodes:
            while not (all(n.is_committed(tx) for tx in txs) and n.txflow.commits_drained()):
                assert time.monotonic() < deadline, "a port node never committed"
                time.sleep(0.01)
        states = [dict(n.app.state) for n in jnet.nodes + pnodes]
        assert all(st == states[0] for st in states)
        assert set(states[0]) == {tx.split(b"=")[0] for tx in txs}
        assert all(n.switch.n_peers() == 3 for n in jnet.nodes + pnodes)
        # each node's sync client heard the STATUS advert of all three peers
        names = {n.switch.node_id for n in jnet.nodes + pnodes}
        for n in jnet.nodes + pnodes:
            deadline = time.monotonic() + 45
            while set(n.sync_manager._servable_adverts()) != names - {n.switch.node_id}:
                assert time.monotonic() < deadline, "a sync advert never crossed"
                time.sleep(0.01)
            assert n.sync_manager.snapshot()["byzantine_strikes"] == 0
    finally:
        for n in pnodes:
            n.stop()
        jnet.stop()
    wait_threads_gone(before, timeout=15)


def test_node_and_localnet_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pvs = [ptypes.MockPV(x) for x in seeds(seed=3)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pnode.LocalNet(4, priv_vals=pvs)
    vals = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), 10)
                                for pv in pvs])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pnode.Node("n", CHAIN, vals, KVStoreApplication(), pvs[0])
    node = pnode.Node("n", CHAIN, vals, KVStoreApplication(), pvs[0],
                      pnode.NodeConfig(device="cpu"))
    assert node.txflow.verifier.device.type == "cpu"
