"""PyTorch port, the rules the catch-up sync slice keeps: a crashed node
that was not wiped cannot be revived (its fresh app would need the block
path's replay of its commit log); the sync client and a committee-mode
node raise without CUDA unless told ``device="cpu"``; and an engine that
stops releases its verdict-cache claims, so the other engines of a shared
verifier commit the same votes without waiting out the claim TTL."""

import hashlib
import time

import numpy as np
import pytest
import torch

import txflow_tpu_torch.node as pnode
import txflow_tpu_torch.verifier as pver
from txflow_tpu_torch.abci import KVStoreApplication
from txflow_tpu_torch.epoch import EpochConfig
from txflow_tpu_torch.store import MemDB, TxStore
from txflow_tpu_torch.sync import SyncManager
from txflow_tpu_torch.types import MockPV, TxVote, Validator, ValidatorSet
from txflow_tpu_torch.utils.config import test_config as p_test_config

from test_torch_shared_verifier import _serve_tx, _shared_engine
from test_torch_verify_cache import one_torch_thread  # noqa: F401


def _pvs(n=4, seed=9):
    rng = np.random.default_rng(seed)
    pvs = [MockPV(rng.bytes(32)) for _ in range(n)]
    return pvs, ValidatorSet([Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])


def test_revive_needs_a_crash_and_a_wipe(tmp_path):
    pvs, vals = _pvs()
    v = pver.DeviceVoteVerifier(vals, device="cpu", buckets=(64,), shared_cache=True)
    net = pnode.LocalNet(4, config=p_test_config(), priv_vals=pvs, device="cpu", verifier=v)
    net.make_durable(3, str(tmp_path / "node3"))
    net.start()
    try:
        with pytest.raises(RuntimeError, match="make_durable must run before start"):
            net.make_durable(1, str(tmp_path / "node1"))
        with pytest.raises(RuntimeError, match="is not down"):
            net.revive_node(3)
        with pytest.raises(RuntimeError, match="must be crashed before wiping"):
            net.wipe_node(3)
        net.crash_node(2)
        with pytest.raises(RuntimeError, match="no durable root"):
            net.wipe_node(2)
        net.crash_node(3)
        assert [n.node_id for n in net.live_nodes()] == ["node0", "node1"]
        with pytest.raises(RuntimeError, match="was not wiped"):
            net.revive_node(3)
        net.wipe_node(3)
        node3 = net.revive_node(3)
        assert node3 is net.nodes[3] and node3.tx_store.seq_count() == 0
        assert {p.node_id for p in node3.switch.peers()} == {"node0", "node1"}
    finally:
        net.stop()
    assert v.staging_stats() is None


def test_sync_client_and_committee_node_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pvs, vals = _pvs(8, seed=10)

    class Flow:
        val_set = vals

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyncManager("chain", TxStore(MemDB()), Flow())
    assert SyncManager("chain", TxStore(MemDB()), Flow(), device="cpu").device.type == "cpu"
    ec = EpochConfig(committee_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pnode.Node("n", "chain", vals, KVStoreApplication(), pvs[0],
                   pnode.NodeConfig(epoch_config=ec))
    # a verifier on the CPU given, the device left to default: the sync
    # client still asks for CUDA
    given = pver.DeviceVoteVerifier(vals, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pnode.Node("n", "chain", vals, KVStoreApplication(), pvs[0],
                   pnode.NodeConfig(epoch_config=ec), verifier=given)
    node = pnode.Node("n", "chain", vals, KVStoreApplication(), pvs[0],
                      pnode.NodeConfig(epoch_config=ec, device="cpu"))
    committee = node.committee_schedule.for_vote_height(0, vals)
    assert committee.size() == 4 and node.txflow.val_set is committee
    assert node.state_view().committee is committee and node.state_view().validators is vals
    assert node.sync_manager.device.type == "cpu" and node.sync_manager.committee is not None
    assert node.state_store.load_validators(0) is None  # nothing on record, as in JAX
    off = pnode.Node("n", "chain", vals, KVStoreApplication(), pvs[0],
                     pnode.NodeConfig(device="cpu", sync=False))
    assert off.sync_manager is None and off.sync_reactor is None
    assert "sync" not in off.switch.reactors


def test_a_stopped_engine_releases_its_claims(one_torch_thread):  # noqa: F811
    """Engine A claims a tx's votes in a shared cache whose claim TTL is a
    minute, and stops while its verify may be in flight: its stop collects
    every ticket, so no claim is left, and engine B commits the same votes
    at once instead of deferring them for the minute."""
    pvs, vals = _pvs(4, seed=12)
    cache = pver.VerifyCache(claim_ttl=60.0)
    shared = pver.DeviceVoteVerifier(vals, device="cpu", buckets=(64,), shared_cache=cache)
    a, b = _shared_engine(vals, shared), _shared_engine(vals, shared)
    tx = b"claimed=v"
    a[0].start()
    try:
        a[1].check_tx(tx)
        key = hashlib.sha256(tx).digest()
        votes = []
        for pv in pvs[:3]:
            vote = TxVote(1, key.hex().upper(), key, 1_700_000_000_000_000_001, pv.get_address())
            pv.sign_tx_vote(a[0].chain_id, vote)
            votes.append(vote)
        for vote in votes:
            a[2].check_tx(vote)
        deadline = time.monotonic() + 30
        while cache.misses == 0:  # A has claimed them
            assert time.monotonic() < deadline, "engine A never claimed the votes"
            time.sleep(0.001)
    finally:
        a[0].stop()
    assert not cache._inflight
    b[0].start()
    try:
        t0 = time.monotonic()
        assert _serve_tx(b, pvs[:3], tx, 1, timeout=30)
        assert time.monotonic() - t0 < 30 < cache.claim_ttl
        assert cache.deferrals == 0
    finally:
        b[0].stop()
    assert shared.staging_stats() is None
