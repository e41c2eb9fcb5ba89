"""PyTorch port, the threaded engine on the CPU: TxFlow.start()/stop() with
the pipelined run loop (tickets in flight, collected and routed in
submission order), the committer thread and the warm step, against the JAX
package's scalar ``try_add_vote`` golden path on the mixed honest and
byzantine stream of tests/test_pipeline.py:128 (this file's own copy of the
stream builder, keys from a seed). Certificate bytes, commit order (app
digest), app state and uncommitted stake must be identical; stop() must
leave no ticket, commit or thread behind; a failure in a thread must
surface at stop()."""

import hashlib
import random
import time

import numpy as np
import pytest
import torch

import txflow_tpu.abci as jabci
import txflow_tpu.engine as jengine
import txflow_tpu.pool as jpool
import txflow_tpu.store as jstore
import txflow_tpu.types as jtypes
from txflow_tpu.utils.config import EngineConfig as JEngineConfig
from txflow_tpu.utils.config import MempoolConfig as JMempoolConfig

import txflow_tpu_torch.abci as pabci
import txflow_tpu_torch.engine as pengine
import txflow_tpu_torch.pool as ppool
import txflow_tpu_torch.store as pstore
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.ops import _lib
from txflow_tpu_torch.utils.config import EngineConfig, MempoolConfig
from txflow_tpu_torch.verifier import DeviceVoteVerifier, ScalarVoteVerifier

CHAIN_ID = "txflow-test"
HEIGHT = 1


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain kernels at these sizes run as fast on one thread, and the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pvs(n, seed):
    """n seeded signers (the JAX package's MockPV, for the golden path's
    votes) in validator-set order, and the set in both packages."""
    nrng = np.random.default_rng(seed)
    pvs = [jtypes.MockPV(seed=nrng.bytes(32)) for _ in range(n)]
    vals_j = jtypes.ValidatorSet(
        [jtypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])
    vals_p = ptypes.ValidatorSet(
        [ptypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])
    by_addr = {pv.get_address(): pv for pv in pvs}
    return [by_addr[v.address] for v in vals_j], vals_j, vals_p


def sign_vote(pv, tx: bytes, ts=1700000000_000000000):
    v = jtypes.TxVote(
        height=HEIGHT, tx_hash=hashlib.sha256(tx).hexdigest().upper(),
        tx_key=hashlib.sha256(tx).digest(), timestamp_ns=ts,
        validator_address=pv.get_address(),
    )
    pv.sign_tx_vote(CHAIN_ID, v)
    return v


def mixed_stream(pvs, txs, seed):
    """At most one vote per (tx, validator), about 15% with a zeroed
    signature, plus votes of a signer outside the set; shuffled."""
    rng = random.Random(seed)
    stranger = jtypes.MockPV(seed=hashlib.sha256(b"stranger%d" % seed).digest())
    stream = []
    for tx in txs:
        for vi in rng.sample(range(len(pvs)), rng.randint(2, len(pvs))):
            vote = sign_vote(pvs[vi], tx)
            if rng.random() < 0.15:
                vote.signature = bytes(64)
            stream.append(vote)
        if rng.random() < 0.3:
            stream.append(sign_vote(stranger, tx))
    rng.shuffle(stream)
    return stream


def port_vote(v):
    return ptypes.TxVote(v.height, v.tx_hash, v.tx_key, v.timestamp_ns, v.validator_address,
                         v.signature)


def jax_golden(vals_j, txs, stream):
    """The JAX package's scalar engine, one vote at a time."""
    conns = jabci.AppConns(jabci.KVStoreApplication())
    mempool = jpool.Mempool(JMempoolConfig(cache_size=4000), conns.mempool)
    flow = jengine.TxFlow(
        CHAIN_ID, HEIGHT, vals_j, jpool.TxVotePool(JMempoolConfig(cache_size=20000)), mempool,
        jpool.Mempool(JMempoolConfig(cache_size=4000)),
        jengine.TxExecutor(conns.consensus, mempool), jstore.TxStore(jstore.MemDB()),
        config=JEngineConfig(use_device=False),
    )
    for tx in txs:
        mempool.check_tx(tx)
    for v in stream:
        flow.try_add_vote(v.copy())
    return flow, flow.tx_store, conns.app


def make_port_engine(vals_p, verifier=None, **cfg):
    conns = pabci.AppConns(pabci.KVStoreApplication())
    mempool = ppool.Mempool(MempoolConfig(cache_size=4000), conns.mempool)
    votepool = ppool.TxVotePool(MempoolConfig(cache_size=20000))
    store = pstore.TxStore(pstore.MemDB())
    flow = pengine.TxFlow(
        CHAIN_ID, HEIGHT, vals_p, votepool, mempool, ppool.Mempool(MempoolConfig(cache_size=4000)),
        pengine.TxExecutor(conns.consensus, mempool), store,
        config=EngineConfig(device="cpu", **cfg), verifier=verifier,
    )
    return flow, mempool, votepool, store, conns.app


def make_verifier(kind, vals_p, **kw):
    if kind == "scalar":
        return ScalarVoteVerifier(vals_p)
    return DeviceVoteVerifier(vals_p, device="cpu", **kw)


def wait_quiescent(flow, votepool, timeout=40.0):
    """The threaded engine has visited every pool entry, holds no retry
    and no ticket, and has applied every decided commit, three polls in a
    row."""
    deadline = time.monotonic() + timeout
    stable = 0
    while time.monotonic() < deadline:
        assert flow.error is None, flow.error
        idle = (flow._drain_cursor >= votepool.seq() and not flow._retry
                and flow.pipeline_stats()["in_flight"] == 0 and flow.commits_drained())
        stable = stable + 1 if idle else 0
        if stable >= 3:
            return True
        time.sleep(0.02)
    return False


def feed(votepool, stream):
    for v in stream:
        try:
            votepool.check_tx(port_vote(v))
        except Exception:
            pass  # a cache dup (zeroed signatures share a vote key)


def serve(flow, mempool, votepool, txs, stream):
    """Start the engine, feed the stream, wait until quiescent, stop."""
    for tx in txs:
        mempool.check_tx(tx)
    flow.start()
    try:
        feed(votepool, stream)
        assert wait_quiescent(flow, votepool), "the threaded engine never drained"
        stats = flow.pipeline_stats()
    finally:
        flow.stop()
    return stats


def assert_same_outcome(txs, golden, store_p, app_p, flow_p):
    flow_s, store_s, app_s = golden
    assert app_p.tx_count == app_s.tx_count > 0
    assert app_p.state == app_s.state
    assert app_p.digest == app_s.digest  # commit order
    assert store_p.committed_hashes_in_order() == store_s.committed_hashes_in_order()
    for tx in txs:
        key = b"H:" + hashlib.sha256(tx).hexdigest().upper().encode()
        assert store_p.db.get(key) == store_s.db.get(key)  # certificate bytes
    for h, vs in flow_s.vote_sets.items():
        assert flow_p.vote_sets[h].stake() == vs.stake()


@pytest.mark.parametrize("kind", ["scalar", "device"])
@pytest.mark.parametrize("seed", [11, 23])
def test_pipelined_matches_jax_scalar_golden(seed, kind):
    pvs, vals_j, vals_p = make_pvs(7, seed)  # total 70, quorum 47: 5 votes
    txs = [b"pp%d-%d=%d" % (seed, i, i) for i in range(14)]
    stream = mixed_stream(pvs, txs, seed)
    golden = jax_golden(vals_j, txs, stream)
    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, make_verifier(kind, vals_p), max_batch=17, min_batch=1, pipeline_depth=3)
    _lib.reset_launches()
    stats = serve(flow, mempool, votepool, txs, stream)
    assert sum(_lib.launches.values()) == 0  # CPU tensors: plain versions
    assert_same_outcome(txs, golden, store, app, flow)
    assert stats["depth"] == 3 and stats["steps"] > 1
    if kind == "device":
        assert flow.warm_s is not None  # the warm step ran at start()
        # every step and the warm step read back through the ring: three
        # tickets in flight on two slots read some back on the caller
        ring = stats["staging"]
        assert ring["host_readbacks"] + ring["sync_readbacks"] == stats["steps"] + 1
        assert ring["host_readbacks"] > 1 and ring["in_flight"] == 0


@pytest.mark.parametrize("pipeline_commits,commit_interval,depth",
                         [(False, 1, 2), (True, 1, 2), (True, 4, 2), (True, 4, 1)])
def test_commit_modes_agree(pipeline_commits, commit_interval, depth):
    """Inline commits against the committer thread, the app Commit per tx
    against once per 4 txs, the pipelined against the serial loop: the
    same certificates, commit order and app digest as the JAX golden."""
    pvs, vals_j, vals_p = make_pvs(7, 11)
    txs = [b"cm-%d=%d" % (i, i) for i in range(16)]
    stream = mixed_stream(pvs, txs, 11)
    golden = jax_golden(vals_j, txs, stream)
    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, make_verifier("scalar", vals_p), max_batch=9, min_batch=1,
        pipeline_depth=depth, pipeline_commits=pipeline_commits,
        commit_interval=commit_interval)
    serve(flow, mempool, votepool, txs, stream)
    assert (flow._committer is None) and (flow._thread is None)
    assert_same_outcome(txs, golden, store, app, flow)


def test_stop_drains_inflight_tickets():
    """stop() with votes still flowing collects and routes every ticket in
    flight, drains the commit queue and joins both threads; no vote is
    lost: serial steps finish the rest (the readback ring's side:
    tests/test_torch_staging_ring.py::test_stop_drains_staged_slots)."""
    pvs, _, vals_p = make_pvs(4, 5)
    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, make_verifier("scalar", vals_p), max_batch=8, min_batch=1, pipeline_depth=4)
    txs = [b"drain%d=v" % i for i in range(30)]
    votes = [sign_vote(pv, tx) for tx in txs for pv in pvs[:3]]
    for tx in txs:
        mempool.check_tx(tx)
    flow.start()
    try:
        feed(votepool, votes)
    finally:
        flow.stop()
    assert flow.pipeline_stats()["in_flight"] == 0, "a drained batch outlived stop()"
    assert flow._thread is None and flow._committer is None
    assert flow._commit_q.empty() and flow.commits_drained()
    while flow.step():
        pass
    assert app.tx_count == len(txs)
    for tx in txs:
        cert = store.load_tx_commit(hashlib.sha256(tx).hexdigest().upper())
        assert cert is not None and len(cert.commits) == 3


@pytest.mark.parametrize("kind", ["scalar", "device"])
def test_step_accounting_reconciles(kind):
    """step() returns decided + dropped; a requeued in-batch repeat is
    counted by the step that decides it, and last_step_stats reconciles
    decided + requeued with the verified batch."""
    pvs, _, vals_p = make_pvs(4, 7)
    flow, mempool, votepool, _, app = make_port_engine(vals_p, make_verifier(kind, vals_p))
    tx = b"acct=1"
    mempool.check_tx(tx)
    for pv in pvs[:3]:
        votepool.check_tx(port_vote(sign_vote(pv, tx)))
    # validator 0 again, another timestamp: the in-batch repeat is deferred
    votepool.check_tx(port_vote(sign_vote(pvs[0], tx, ts=1700000001_000000000)))
    got = flow.step()
    s = flow.last_step_stats
    assert s["batch"] == 4 and s["requeued"] == 1
    assert s["decided"] + s["requeued"] == s["batch"]
    assert got == s["decided"] + s["dropped"] == 3
    assert app.tx_count == 1  # 30 >= quorum 27
    # the repeat's tx committed meanwhile: dropped at drain, counted once
    got2 = flow.step()
    assert flow.last_step_stats == {"decided": 0, "requeued": 0, "dropped": 1, "batch": 0}
    assert got2 == 1
    while flow.step():
        pass
    assert votepool.size() == 0


class _FailingVerifier(ScalarVoteVerifier):
    """Its tickets raise at result(): a failed readback."""

    def submit(self, *a, **k):
        class Ticket:
            def result(self):
                raise RuntimeError("readback failed")
        return Ticket()


@pytest.mark.parametrize("depth", [1, 2])
def test_thread_failure_raises_at_stop(depth):
    """A failed readback ends the loop and raises at stop(), with the
    engine stopped; nothing carries on on another path."""
    pvs, _, vals_p = make_pvs(4, 9)
    flow, mempool, votepool, _, app = make_port_engine(
        vals_p, _FailingVerifier(vals_p), min_batch=1, pipeline_depth=depth)
    mempool.check_tx(b"f=1")
    flow.start()
    votepool.check_tx(port_vote(sign_vote(pvs[0], b"f=1")))
    deadline = time.monotonic() + 10
    while flow.error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="readback failed"):
        flow.stop()
    assert flow._thread is None and flow._committer is None
    assert app.tx_count == 0


def test_unapplied_commit_applies_when_bytes_arrive():
    """A quorum decided before its tx bytes reach the mempool is saved at
    once and applied by the committer when the bytes arrive;
    commits_drained() waits for it."""
    pvs, _, vals_p = make_pvs(4, 13)
    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, make_verifier("scalar", vals_p), min_batch=1)
    tx = b"late=1"
    h = hashlib.sha256(tx).hexdigest().upper()
    flow.start()
    try:
        feed(votepool, [sign_vote(pv, tx) for pv in pvs[:3]])
        deadline = time.monotonic() + 10
        while not flow.is_tx_committed(h) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert flow.is_tx_committed(h) and app.tx_count == 0
        assert not flow.commits_drained()
        mempool.check_tx(tx)
        deadline = time.monotonic() + 10
        while not flow.commits_drained() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert flow.commits_drained() and app.tx_count == 1
        assert store.load_tx_bytes(h) == tx
    finally:
        flow.stop()
    flow.register_unapplied([("AB" * 32, bytes(32))])
    assert not flow.commits_drained()
