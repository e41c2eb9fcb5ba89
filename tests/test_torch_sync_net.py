"""PyTorch port, catch-up sync drills on a port LocalNet (4 nodes over
in-memory pipes, one shared CPU verifier with the verdict cache, node 3
durable on FileDB stores), each held against the same drill on a JAX
LocalNet (``use_device_verifier=False, enable_consensus=False,
health=False``), mirroring tests/test_sync.py without chaos:

- a quiet wipe and rejoin whose commit order is its server's prefix;
- byzantine servers through the ``tamper`` hook (a forged certificate, a
  wrong epoch snapshot, a truncated range, a tx-hash mismatch) on nodes 0
  and 1: each is struck and banned, and the rows come from node 2;
- a stall that rotates to a live server;
- a lagging node whose links are cut with the switch's own API and then
  reconnected: only the new commits are fetched;
- the fallback state when no peer can serve.

Each package's drills run in turn on one net per package (module
fixtures), the txs committed once. Parity is judged on the committed set,
certificate rows (each equal to some live node's), kvstore maps, and the
client's counters; commit order only in the quiet case. Every wait is
bounded; nothing sleeps to make a thing happen."""

import hashlib
import time

import numpy as np
import pytest
import torch

import txflow_tpu.node as jnode
import txflow_tpu.p2p as jp2p
import txflow_tpu.types as jtypes
from txflow_tpu.sync.config import SyncConfig as JSyncConfig
from txflow_tpu.utils.config import test_config as j_test_config

import txflow_tpu_torch.node as pnode
import txflow_tpu_torch.p2p as pp2p
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.sync import SyncConfig
from txflow_tpu_torch.utils.config import test_config as p_test_config
from txflow_tpu_torch.verifier import DeviceVoteVerifier

CHAIN = "txflow-localnet"
SYNC_KW = dict(poll_interval=0.05, status_interval=0.1, request_timeout=0.5, backoff_base=0.05,
               backoff_cap=0.5, fallback_cooldown=30.0, byzantine_ban=60.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeds(n=4, seed=4242):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


def wait_for(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what()
        time.sleep(0.02)


def hashes_of(txs):
    return [hashlib.sha256(t).hexdigest().upper() for t in txs]


def holds(node, hashes):
    return all(node.tx_store.has_tx(h) for h in hashes)


class Rig:
    """One package's 4-node net, node 3 durable, 8 txs committed."""

    TXS = [b"drill%d=v%d" % (i, i) for i in range(8)]

    def __init__(self, port: bool, root, **kw):
        self.port = port
        s = seeds()
        if port:
            pvs = [ptypes.MockPV(x) for x in s]
            vals = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), 10)
                                        for pv in pvs])
            self.verifier = DeviceVoteVerifier(vals, device="cpu", buckets=(64, 256),
                                               shared_cache=True)
            self.net = pnode.LocalNet(4, config=p_test_config(), priv_vals=pvs, device="cpu",
                                      verifier=self.verifier, sync_config=SyncConfig(**SYNC_KW),
                                      **kw)
        else:
            pvs = [jtypes.MockPV(x) for x in s]
            self.net = jnode.LocalNet(4, config=j_test_config(), use_device_verifier=False,
                                      priv_vals=pvs, enable_consensus=False, health=False,
                                      index_txs=False, sync_config=JSyncConfig(**SYNC_KW), **kw)
        self.types = ptypes if port else jtypes
        self.net.make_durable(3, str(root / ("port" if port else "jax") / "node3"))
        self.net.start()
        for i, tx in enumerate(self.TXS):
            self.net.broadcast_tx(tx, node_index=i % 4)
        assert self.net.wait_all_committed(self.TXS, timeout=60)
        self.want = hashes_of(self.TXS)

    def rejoin(self, tampers=None, timeout=45.0):
        """Crash and wipe node 3, set ``tampers`` ({node index: hook}),
        revive it and wait until it holds every committed tx; returns its
        client's snapshot after the tampers are cleared."""
        net = self.net
        net.crash_node(3)
        net.wipe_node(3)
        for i, hook in (tampers or {}).items():
            net.nodes[i].sync_reactor.tamper = hook
        try:
            node3 = net.revive_node(3)
            wait_for(lambda: holds(node3, self.want), timeout,
                     lambda: f"node 3 did not converge: {node3.sync_manager.snapshot()}")
            wait_for(node3.txflow.commits_drained, timeout, lambda: "node 3's commits pending")
        finally:
            for i in (tampers or {}):
                net.nodes[i].sync_reactor.tamper = None
        return node3.sync_manager.snapshot()

    def rows_are_live_rows(self, node3, hashes, live=(0, 1, 2)):
        for h in hashes:
            rows = {self.net.nodes[i].tx_store.load_cert_row(h) for i in live}
            if node3.tx_store.load_cert_row(h) not in rows:
                return False
            if node3.tx_store.load_tx_bytes(h) != self.net.nodes[0].tx_store.load_tx_bytes(h):
                return False
        return True

    def kv_equal(self):
        states = [dict(n.app.state) for n in self.net.nodes]
        return all(s == states[0] for s in states)

    def stop(self):
        self.net.stop()


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sync-net")
    port = Rig(True, root)
    try:
        jax = Rig(False, root)
    except BaseException:
        port.stop()
        raise
    yield {"port": port, "jax": jax}
    port.stop()
    jax.stop()
    assert port.verifier.staging_stats() is None


def _outcome(rig, snap, strict=True):
    node3 = rig.net.nodes[3]
    out = {
        "holds": holds(node3, rig.want), "rows": rig.rows_are_live_rows(node3, rig.want),
        "kv": rig.kv_equal(), "applied": snap["applied"],
    }
    if strict:
        out.update(fetched=snap["fetched"], strikes=snap["byzantine_strikes"],
                   banned=sorted(snap["banned_peers"]))
    return out


def test_quiet_rejoin_follows_its_servers_order(rigs):
    outs = []
    for name in ("jax", "port"):
        rig = rigs[name]
        snap = rig.rejoin()
        node3 = rig.net.nodes[3]
        server = next(n for n in rig.net.nodes if n.node_id == snap["last_server"])
        k = node3.tx_store.seq_count()
        assert [h for _s, h in node3.tx_store.committed_range(0, k)] == [
            h for _s, h in server.tx_store.committed_range(0, k)], name
        outs.append(dict(_outcome(rig, snap), rotations=snap["rotations"]))
    assert outs[1] == outs[0]
    assert outs[1] == dict(holds=True, rows=True, kv=True, applied=8, fetched=8, strikes=0,
                           banned=[], rotations=0)


def _tamper(kind, types):
    evil = types.ValidatorSet([types.Validator.from_pub_key(
        types.MockPV(hashlib.sha256(b"evil-epoch").digest()).get_pub_key(), 99)])

    def forge(entries, snaps):
        out = []
        for h, cert, tx in entries:
            mid = len(cert) // 2
            out.append((h, cert[:mid] + bytes([cert[mid] ^ 0xFF]) + cert[mid + 1 :], tx))
        return out, snaps

    return {
        "forged_certificate": forge,
        "wrong_epoch_snapshot": lambda e, s: (e, {h: evil for h in s} or {0: evil}),
        "truncated_range": lambda e, s: (e[: max(1, len(e) // 2)], s),
        "tx_hash_mismatch": lambda e, s: ([(h, c, t + b"!") for h, c, t in e], s),
    }[kind]


@pytest.mark.parametrize("kind", ["forged_certificate", "wrong_epoch_snapshot",
                                  "truncated_range", "tx_hash_mismatch"])
def test_byzantine_servers_are_banned_and_nothing_poisoned(rigs, kind):
    """Nodes 0 and 1 lie, node 2 is honest: whichever liar the client
    tries first, both are struck and banned before node 2 serves it."""
    outs = []
    for name in ("jax", "port"):
        rig = rigs[name]
        hook = _tamper(kind, rig.types)
        snap = rig.rejoin({0: hook, 1: hook})
        out = _outcome(rig, snap)
        out["rows_from_node2"] = rig.rows_are_live_rows(rig.net.nodes[3], rig.want, live=(2,))
        out["last_server"] = snap["last_server"]
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[1] == dict(holds=True, rows=True, kv=True, applied=8, fetched=8, strikes=2,
                           banned=["node0", "node1"], rows_from_node2=True, last_server="node2")


def test_a_stall_rotates_to_a_live_server(rigs):
    """Node 0 answers past request_timeout: a stall strike (a timeout, no
    ban). Without the health layer's peer scoreboard (not ported, as in a
    JAX node with health off) the tie-break would pick node 0 again, so
    the drill drops node 0's link once the stall is counted, as the
    scoreboard's eviction would; the next round rotates to a live
    server."""
    outs = []
    for name in ("jax", "port"):
        rig = rigs[name]
        net = rig.net
        released = []

        def black_hole(entries, snaps, released=released):
            while not released:
                time.sleep(0.02)
            return entries, snaps

        net.crash_node(3)
        net.wipe_node(3)
        net.nodes[0].sync_reactor.tamper = black_hole
        try:
            node3 = net.revive_node(3)
            wait_for(lambda: node3.sync_manager.snapshot()["timeouts"] >= 1, 30,
                     lambda: f"no stall counted: {node3.sync_manager.snapshot()}")
            node3.switch.stop_peer(node3.switch.get_peer(net.nodes[0].switch.node_id),
                                   reason="stalled")
            wait_for(lambda: holds(node3, rig.want), 45,
                     lambda: f"node 3 did not converge: {node3.sync_manager.snapshot()}")
            wait_for(node3.txflow.commits_drained, 45, lambda: "node 3's commits pending")
        finally:
            released.append(True)
            net.nodes[0].sync_reactor.tamper = None
        snap = node3.sync_manager.snapshot()
        out = _outcome(rig, snap, strict=False)
        out.update(node0_banned="node0" in snap["banned_peers"],
                   strikes=snap["byzantine_strikes"], timeouts=snap["timeouts"],
                   rotated=snap["rotations"] >= 1 and snap["last_server"] != "node0",
                   rows_live=rig.rows_are_live_rows(node3, rig.want, live=(1, 2)))
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[1] == dict(holds=True, rows=True, kv=True, applied=8, node0_banned=False,
                           strikes=0, timeouts=1, rotated=True, rows_live=True)


def test_a_lagging_node_fetches_only_what_it_lacks(rigs):
    """Node 3's links are cut (the switch's stop_peer), 5 txs commit on
    nodes 0-2, the links come back over fresh pipes: node 3 catches up by
    sync, and the 8 txs it held are skipped before verification."""
    outs = []
    for name in ("jax", "port"):
        rig = rigs[name]
        net = rig.net
        node3 = net.nodes[3]
        others = net.nodes[:3]
        p2p = pp2p if rig.port else jp2p
        assert holds(node3, rig.want)
        for peer in node3.switch.peers():
            node3.switch.stop_peer(peer, reason="cut")
        wait_for(lambda: all(o.switch.get_peer(node3.switch.node_id) is None for o in others),
                 10, lambda: "the far ends kept node 3")
        before = node3.sync_manager.snapshot()
        late = [b"late-%s-%d=v" % (name.encode(), i) for i in range(5)]
        for i, tx in enumerate(late):
            net.broadcast_tx(tx, node_index=i % 3)
        late_h = hashes_of(late)
        for o in others:
            wait_for(lambda o=o: holds(o, late_h), 45, lambda: "the live nodes did not commit")
        assert not any(node3.tx_store.has_tx(h) for h in late_h)
        for o in others:
            p2p.connect_switches(node3.switch, o.switch)
        wait_for(lambda: holds(node3, late_h), 45,
                 lambda: f"node 3 did not catch up: {node3.sync_manager.snapshot()}")
        wait_for(node3.txflow.commits_drained, 45, lambda: "node 3's commits pending")
        snap = node3.sync_manager.snapshot()
        outs.append({"fetched": snap["fetched"] - before["fetched"],
                     "applied": snap["applied"] - before["applied"],
                     "strikes": snap["byzantine_strikes"] - before["byzantine_strikes"],
                     "rows": rig.rows_are_live_rows(node3, late_h), "kv": rig.kv_equal()})
        rig.want = rig.want + late_h
    assert outs[1] == outs[0]
    assert outs[1] == dict(fetched=5, applied=5, strikes=0, rows=True, kv=True)


def test_fallback_when_no_peer_can_serve(rigs):
    """Every server serves empty ranges: each is struck and banned, and
    after max_rounds failed rounds the client sits in the fallback state
    (its cooldown outlasts the test) having applied nothing."""
    outs = []
    for name in ("jax", "port"):
        rig = rigs[name]
        net = rig.net
        net.crash_node(3)
        net.wipe_node(3)
        for i in (0, 1, 2):
            net.nodes[i].sync_reactor.tamper = lambda e, s: ([], {})
        try:
            node3 = net.revive_node(3)
            wait_for(lambda: node3.sync_manager.snapshot()["state"] == "fallback", 30,
                     lambda: f"no fallback: {node3.sync_manager.snapshot()}")
        finally:
            for i in (0, 1, 2):
                net.nodes[i].sync_reactor.tamper = None
        snap = node3.sync_manager.snapshot()
        outs.append({k: snap[k] for k in ("state", "applied", "fetched", "fallbacks",
                                          "byzantine_strikes", "rounds_failed", "rotations")}
                    | {"banned": sorted(snap["banned_peers"]), "seq": node3.tx_store.seq_count()})
        rig.net.crash_node(3)  # leave the net as a later drill expects: node 3 revivable
        rig.net.wipe_node(3)
        node3 = rig.net.revive_node(3)
        wait_for(lambda: holds(node3, rig.want), 45, lambda: "node 3 did not converge again")
    assert outs[1] == outs[0]
    assert outs[1] == dict(state="fallback", applied=0, fetched=0, fallbacks=1,
                           byzantine_strikes=3, rounds_failed=3, rotations=3,
                           banned=["node0", "node1", "node2"], seq=0)


def test_committee_rejoin_verifies_through_batch_cert_verifier(tmp_path):
    """Committee mode (a static committee of 4 over the 4 validators): the
    wiped node's client verifies each response's certificates as one
    BatchCertVerifier call (K6's plain version here; one JAX jit of rung 16
    over V = 4 on the other side), with the same decisions and counters."""
    from txflow_tpu.epoch import EpochConfig as JEpochConfig

    from txflow_tpu_torch.epoch import EpochConfig

    txs = [b"com%d=v%d" % (i, i) for i in range(5)]  # 5 certificates x 3 votes: rung 16
    want = hashes_of(txs)
    outs = []
    for port in (False, True):
        s = seeds(seed=515)
        if port:
            pvs = [ptypes.MockPV(x) for x in s]
            vals = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), 10)
                                        for pv in pvs])
            net = pnode.LocalNet(4, config=p_test_config(), priv_vals=pvs, device="cpu",
                                 verifier=DeviceVoteVerifier(vals, device="cpu", buckets=(64, 256),
                                                             shared_cache=True),
                                 epoch_config=EpochConfig(committee_size=4),
                                 sync_config=SyncConfig(**SYNC_KW))
        else:
            net = jnode.LocalNet(4, config=j_test_config(), use_device_verifier=False,
                                 priv_vals=[jtypes.MockPV(x) for x in s], enable_consensus=False,
                                 health=False, index_txs=False,
                                 epoch_config=JEpochConfig(committee_size=4),
                                 sync_config=JSyncConfig(**SYNC_KW))
        net.make_durable(3, str(tmp_path / ("port" if port else "jax") / "node3"))
        net.start()
        try:
            assert net.nodes[0].committee_schedule is not None
            for i, tx in enumerate(txs):
                net.broadcast_tx(tx, node_index=i % 4)
            assert net.wait_all_committed(txs, timeout=60)
            net.crash_node(3)
            net.wipe_node(3)
            node3 = net.revive_node(3)
            wait_for(lambda: holds(node3, want), 45,
                     lambda: f"node 3 did not converge: {node3.sync_manager.snapshot()}")
            wait_for(node3.txflow.commits_drained, 45, lambda: "node 3's commits pending")
            snap = node3.sync_manager.snapshot()
            verifiers = list(node3.sync_manager._verifiers.values())
            rows = all(node3.tx_store.load_cert_row(h) in
                       {net.nodes[i].tx_store.load_cert_row(h) for i in (0, 1, 2)} for h in want)
            states = [dict(n.app.state) for n in net.nodes]
            outs.append({"applied": snap["applied"], "strikes": snap["byzantine_strikes"],
                         "rows": rows, "kv": all(st == states[0] for st in states),
                         "verifiers": [type(v).__name__ for v in verifiers],
                         "batch_calls": sum(v.batch_calls for v in verifiers),
                         "scalar_calls": sum(v.scalar_calls for v in verifiers),
                         "batched_votes": sum(v.batched_votes for v in verifiers)})
        finally:
            net.stop()
    assert outs[1] == outs[0]
    assert outs[1] == dict(applied=5, strikes=0, rows=True, kv=True,
                           verifiers=["BatchCertVerifier"], batch_calls=1, scalar_calls=0,
                           batched_votes=15)


def test_a_wiped_port_node_catches_up_from_jax_nodes():
    """Three JAX nodes (validators 0-2, enough for quorum) commit 6 txs; a
    port node with empty stores (validator 3) joins them over in-memory
    pipes and recovers every tx by sync: STATUS, RANGE_REQ and RANGE_RESP
    cross the packages byte for byte."""
    import queue

    import txflow_tpu.p2p.transport as jtransport

    import txflow_tpu_torch.p2p.transport as ptransport
    from txflow_tpu_torch.abci import KVStoreApplication

    s = seeds(seed=616)
    jnet = jnode.LocalNet(4, config=j_test_config(), use_device_verifier=False,
                          priv_vals=[jtypes.MockPV(x) for x in s], n_nodes=3,
                          enable_consensus=False, health=False, index_txs=False,
                          sync_config=JSyncConfig(**SYNC_KW))
    ppvs = [ptypes.MockPV(x) for x in s]
    vals = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in ppvs])
    assert vals.hash() == jnet.val_set.hash()
    txs = [b"mixsync%d=v%d" % (i, i) for i in range(6)]
    want = hashes_of(txs)
    jnet.start()
    pn = None
    try:
        for i, tx in enumerate(txs):
            jnet.broadcast_tx(tx, node_index=i % 3)
        assert jnet.wait_all_committed(txs, timeout=60)
        pn = pnode.Node("node3", CHAIN, vals, KVStoreApplication(), ppvs[3],
                        pnode.NodeConfig(config=p_test_config(), device="cpu",
                                         sync_config=SyncConfig(**SYNC_KW)))
        pn.start()
        for jn in jnet.nodes:
            qa, qb = queue.Queue(maxsize=1024), queue.Queue(maxsize=1024)
            a = jtransport.InMemoryConnection(qa, qb, f"{jn.node_id}->node3")
            b = ptransport.InMemoryConnection(qb, qa, f"node3->{jn.node_id}")
            jn.switch.add_peer_conn(a, "node3", outbound=True)
            pn.switch.add_peer_conn(b, jn.switch.node_id, outbound=False)
        wait_for(lambda: holds(pn, want), 45,
                 lambda: f"the port node did not catch up: {pn.sync_manager.snapshot()}")
        wait_for(pn.txflow.commits_drained, 45, lambda: "the port node's commits pending")
        snap = pn.sync_manager.snapshot()
        assert (snap["applied"], snap["fetched"], snap["byzantine_strikes"]) == (6, 6, 0)
        for h in want:
            assert pn.tx_store.load_cert_row(h) in {jn.tx_store.load_cert_row(h)
                                                    for jn in jnet.nodes}
            assert pn.tx_store.load_tx_bytes(h) == jnet.nodes[0].tx_store.load_tx_bytes(h)
        server = next(jn for jn in jnet.nodes if jn.node_id == snap["last_server"])
        assert pn.tx_store.committed_hashes_in_order() == server.tx_store.committed_hashes_in_order()
        assert dict(pn.app.state) == dict(jnet.nodes[0].app.state)
        assert all(pn.switch.get_peer(jn.node_id) is not None for jn in jnet.nodes)
    finally:
        if pn is not None:
            pn.stop()
        jnet.stop()
