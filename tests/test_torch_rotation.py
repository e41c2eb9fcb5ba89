"""PyTorch port, epoch rotation in committee mode: the port's TxFlow and the
JAX package's, each mounting its BatchCertVerifier (the port's with
device="cpu", i.e. the plain verify kernel), driven through a committee
swap mid-run on the same vote stream (model:
tests/test_committee.py::test_engine_committee_swap_revalidates_and_preserves_certs).
last_rotation, certificate bytes, commit order, app digest, uncommitted
stake and the verifier's counters must be identical (tolerance 0)."""

import hashlib

import numpy as np
import pytest

import txflow_tpu.abci as jabci
import txflow_tpu.committee as jcom
import txflow_tpu.engine as jengine
import txflow_tpu.pool as jpool
import txflow_tpu.store as jstore
import txflow_tpu.types as jtypes
from txflow_tpu.utils.config import EngineConfig as JEngineConfig
from txflow_tpu.utils.config import MempoolConfig as JMempoolConfig

import txflow_tpu_torch.abci as pabci
import txflow_tpu_torch.committee as pcom
import txflow_tpu_torch.engine as pengine
import txflow_tpu_torch.pool as ppool
import txflow_tpu_torch.store as pstore
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.utils.config import EngineConfig, MempoolConfig

CHAIN = "txflow-rotation-test"
N_TXS = 8


def _engine(port, vals, verifier):
    abci, engine, pool, store = (pabci, pengine, ppool, pstore) if port else (jabci, jengine, jpool, jstore)
    mcfg = MempoolConfig if port else JMempoolConfig
    ecfg = (EngineConfig(max_batch=16, device="cpu") if port
            else JEngineConfig(max_batch=16, use_device=False))
    conns = abci.AppConns(abci.KVStoreApplication())
    mempool = pool.Mempool(mcfg(cache_size=1000), conns.mempool)
    votepool = pool.TxVotePool(mcfg(cache_size=10000))
    tx_store = store.TxStore(store.MemDB())
    flow = engine.TxFlow(
        CHAIN, 1, vals, votepool, mempool, pool.Mempool(mcfg(cache_size=1000)),
        engine.TxExecutor(conns.consensus, mempool), tx_store,
        config=ecfg, verifier=verifier,
    )
    return flow, mempool, votepool, tx_store, conns.app


def _validators():
    rng = np.random.default_rng(346)
    pvs = [jtypes.MockPV(rng.bytes(32)) for _ in range(8)]
    jvals = jtypes.ValidatorSet([jtypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])
    pvals = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])
    return {pv.get_address(): pv for pv in pvs}, jvals, pvals


def _vote(pv, tx, height, corrupt=False):
    key = hashlib.sha256(tx).digest()
    v = jtypes.TxVote(height=height, tx_hash=key.hex().upper(), tx_key=key,
                      timestamp_ns=1_700_000_000_000_000_000 + height,
                      validator_address=pv.get_address())
    pv.sign_tx_vote(CHAIN, v)
    if corrupt:
        v.signature = v.signature[:40] + bytes([v.signature[40] ^ 1]) + v.signature[41:]
    return v


def _port_vote(v):
    return ptypes.TxVote(v.height, v.tx_hash, v.tx_key, v.timestamp_ns,
                         v.validator_address, v.signature)


def _to_port_set(jset):
    return ptypes.ValidatorSet([ptypes.Validator(v.address, v.pub_key, v.voting_power) for v in jset])


def _feed(sides, votes):
    for (flow, _m, pool, _s, _a), port in zip(sides, (False, True)):
        for v in votes:
            pool.check_tx(_port_vote(v) if port else v.copy())


def _drain(sides):
    steps = []
    for flow, *_ in sides:
        n = 0
        while flow.step():
            n += 1
        steps.append(n)
    assert steps[0] == steps[1]
    return steps[0]


def _compare(sides, txs):
    (fj, _mj, pj, sj, aj), (fp, _mp, pp, sp, ap) = sides
    assert ap.tx_count == aj.tx_count and ap.state == aj.state
    assert ap.digest == aj.digest  # commit order through the app
    assert sp.committed_hashes_in_order() == sj.committed_hashes_in_order()
    assert sp.seq_count() == sj.seq_count()
    for tx in txs:
        h = hashlib.sha256(tx).hexdigest().upper()
        assert sp.load_cert_row(h) == sj.load_cert_row(h)  # certificate bytes
        assert sp.load_tx_bytes(h) == sj.load_tx_bytes(h)
    assert set(fp.vote_sets) == set(fj.vote_sets)
    for h, vs in fj.vote_sets.items():
        assert fp.vote_sets[h].stake() == vs.stake()  # uncommitted stake
        assert sorted(fp.vote_sets[h].votes) == sorted(vs.votes)
    assert pp.size() == pj.size()
    for a, b in (("batch_calls",) * 2, ("scalar_calls",) * 2, ("batched_votes",) * 2):
        assert getattr(fp.verifier, a) == getattr(fj.verifier, b)


@pytest.mark.parametrize("target", ["next_committee", "shrunk_committee"])
def test_committee_rotation_matches_jax(target):
    """Phase 1: the epoch-0 committee votes (four txs reach quorum, four
    stay pending with two valid votes, one corrupted vote). Rotation:
    ``next_committee`` is the epoch-1 sample of the same size (votes of
    rotated-out members dropped, no commit); ``shrunk_committee`` keeps two
    members of the epoch-0 committee, so the quorum drops and a pending tx
    commits on rotation. Phase 2: the new committee's votes at height 2."""
    by_addr, jvals, pvals = _validators()
    jc0 = jcom.sample_committee(jvals, CHAIN, 0, 4)
    pc0 = pcom.sample_committee(pvals, CHAIN, 0, 4)
    assert [v.address for v in pc0] == [v.address for v in jc0]
    if target == "next_committee":
        jc1 = jcom.sample_committee(jvals, CHAIN, 1, 4)
        pc1 = pcom.sample_committee(pvals, CHAIN, 1, 4)
    else:
        jc1 = jtypes.ValidatorSet(list(jc0.validators)[:2])
        pc1 = _to_port_set(jc1)
    assert [(v.address, v.voting_power) for v in pc1] == [(v.address, v.voting_power) for v in jc1]

    sides = [
        _engine(False, jc0, jcom.BatchCertVerifier(jc0, min_batch=4)),
        _engine(True, pc0, pcom.BatchCertVerifier(pc0, min_batch=4, device="cpu")),
    ]
    txs = [b"rot%d=%d" % (i, i) for i in range(N_TXS)]
    for _f, mempool, *_ in sides:
        for tx in txs:
            mempool.check_tx(tx)
    m0 = [by_addr[v.address] for v in jc0]
    pending_pairs = [(0, 1), (0, 2), (1, 3), (2, 3)]
    phase1 = []
    for i, tx in enumerate(txs):
        voters = range(4) if i < 4 else pending_pairs[i - 4]
        phase1 += [_vote(m0[m], tx, 1) for m in voters]
    phase1.append(_vote(m0[0], txs[7], 1, corrupt=True))
    phase1 += [_vote(m0[3], txs[4], 1, corrupt=True)]
    rng = np.random.default_rng(7)
    phase1 = [phase1[i] for i in rng.permutation(len(phase1))]
    _feed(sides, phase1)
    assert _drain(sides) == 2  # 26 votes at max_batch 16
    _compare(sides, txs)
    assert sides[1][4].tx_count == 4

    for flow, *_ in sides:
        flow.update_state(2, jc1 if flow is sides[0][0] else pc1)
    rot_j, rot_p = sides[0][0].last_rotation, sides[1][0].last_rotation
    assert rot_p == rot_j
    assert rot_p["restaged"] is True and rot_p["val_set_hash"] == pc1.hash().hex()
    _compare(sides, txs)
    if target == "shrunk_committee":
        assert rot_p["commits_on_rotation"] == 1 and rot_p["votes_dropped"] == 4
    else:
        assert rot_p["commits_on_rotation"] == 0 and rot_p["votes_dropped"] > 0

    # phase 2: the new committee's members vote for every pending tx
    members = [by_addr[v.address] for v in jc1]
    # the shrunk committee's three votes stay under min_batch: the host
    # loop runs (scalar_calls), on both sides alike
    per_tx = 2 if target == "next_committee" else 1
    phase2 = []
    for flow_vs in sorted(sides[0][0].vote_sets.values(), key=lambda vs: vs.tx_hash):
        tx = next(t for t in txs if hashlib.sha256(t).hexdigest().upper() == flow_vs.tx_hash)
        have = set(flow_vs.votes)
        phase2 += [_vote(pv, tx, 2) for pv in members if pv.get_address() not in have][:per_tx]
    _feed(sides, phase2)
    assert _drain(sides) >= 1
    _compare(sides, txs)
    assert sides[1][4].tx_count > 4 + rot_p["commits_on_rotation"]
    # every certificate vote comes from the committee of its own vote
    # height; a tx pending across the swap certifies with votes of both
    # heights (the JAX engine does the same)
    mixed = []
    for tx in txs:
        h = hashlib.sha256(tx).hexdigest().upper()
        cert = sides[1][3].load_tx_commit(h)
        if cert is None:
            continue
        for cs in cert.commits:
            assert (pc0 if cs.height == 1 else pc1).has_address(cs.validator_address)
        if len({cs.height for cs in cert.commits}) > 1:
            mixed.append((h, sides[1][3].load_cert_row(h), tx))
    assert mixed
    _sync_rejects_mixed(mixed[0], jc0, pc0)


def _sync_rejects_mixed(entry, jvals, pvals):
    """Such a certificate is one that both packages' sync clients refuse as
    Byzantine ("mixing vote heights"): a reference-side finding, pinned."""
    from txflow_tpu.store.db import MemDB as JMemDB
    from txflow_tpu.store.tx_store import TxStore as JTxStore
    from txflow_tpu.sync.manager import SyncError as JSyncError
    from txflow_tpu.sync.manager import SyncManager as JSyncManager

    from txflow_tpu_torch.sync import SyncError, SyncManager

    class _Flow:
        def __init__(self, vals):
            self.val_set = vals

    class _Peer:
        node_id = "server"

    jm = JSyncManager(CHAIN, JTxStore(JMemDB()), _Flow(jvals), switch=None)
    pm = SyncManager(CHAIN, pstore.TxStore(pstore.MemDB()), _Flow(pvals), device="cpu")
    with pytest.raises(JSyncError) as je:
        jm._verify_apply(_Peer(), [entry], {})
    with pytest.raises(SyncError) as pe:
        pm._verify_apply("server", [entry], {})
    assert str(pe.value) == str(je.value) and "mixing vote heights" in str(pe.value)
    assert pe.value.byzantine and je.value.byzantine


def _port_engine_device(vals):
    return _engine(True, vals, None)[0]


def test_device_verifier_rotation_restages_then_rebuilds():
    """The port's engine over its own DeviceVoteVerifier (device="cpu"): a
    set within the staged capacity restages in place; a set past it gets a
    new DeviceVoteVerifier on the same device; an unchanged set is not
    restaged at all."""
    from txflow_tpu_torch.verifier import DeviceVoteVerifier

    _by_addr, _jvals, pvals = _validators()
    four = ptypes.ValidatorSet(list(pvals.validators)[:4])
    three = ptypes.ValidatorSet(list(pvals.validators)[1:4])
    flow = _port_engine_device(four)
    dv = flow.verifier
    assert isinstance(dv, DeviceVoteVerifier) and dv.capacity == 4
    flow.update_state(2, three)
    assert flow.verifier is dv and dv.val_set.hash() == three.hash()
    assert flow.last_rotation["restaged"] is True
    flow.update_state(3, pvals)  # 8 validators: past capacity 4
    assert flow.last_rotation["restaged"] is False
    assert isinstance(flow.verifier, DeviceVoteVerifier) and flow.verifier is not dv
    assert flow.verifier.device == dv.device and flow.verifier.capacity == 8
    assert flow._addr_to_idx == {v.address: i for i, v in enumerate(pvals)}
    last = flow.last_rotation
    flow.update_state(4, pvals.copy())  # same content: nothing happens
    assert flow.last_rotation is last and flow.height == 4


def test_rotation_past_int32_tally_cap_matches_jax():
    """A rotation into a set whose total power reaches 2^30 (8 validators
    at 2^28): the port's device verifier restages in place into its int64
    tally, where the JAX engine serves such a set on its host verifier.
    Both engines run the same votes before and after the rotation; the
    rotation record, certificate bytes, commit order, app digest,
    uncommitted stake and pool size must be identical."""
    by_addr, jvals, pvals = _validators()
    jhuge = jtypes.ValidatorSet([jtypes.Validator(v.address, v.pub_key, 2**28) for v in jvals])
    phuge = _to_port_set(jhuge)
    assert phuge.total_voting_power() == 2**31
    sides = [_engine(False, jvals, None), _engine(True, pvals, None)]
    dv = sides[1][0].verifier
    assert not dv._stage.wide
    txs = [b"wide%d=%d" % (i, i) for i in range(5)]
    for _f, mempool, *_ in sides:
        for tx in txs:
            mempool.check_tx(tx)
    pvs = [by_addr[v.address] for v in jvals]
    # quorum 54 of 80: 6 votes commit; tx1, tx3 and tx4 stay pending
    counts = (6, 3, 7, 5, 2)
    phase1 = [_vote(pvs[m], tx, 1) for tx, c in zip(txs, counts) for m in range(c)]
    phase1.append(_vote(pvs[7], txs[1], 1, corrupt=True))
    rng = np.random.default_rng(11)
    _feed(sides, [phase1[i] for i in rng.permutation(len(phase1))])
    assert _drain(sides) >= 2
    for flow, *_ in sides:
        flow.update_state(2, jhuge if flow is sides[0][0] else phuge)
    assert sides[1][0].last_rotation == sides[0][0].last_rotation
    assert sides[1][0].last_rotation["restaged"] is True
    assert sides[1][0].verifier is dv and dv._stage.wide
    # after: the pending txs gain votes; tx1 and tx3 cross 2/3 of 2^31
    phase2 = [_vote(pvs[m], txs[1], 2) for m in range(3, 6)] + [_vote(pvs[5], txs[3], 2)]
    phase2 += [_vote(pvs[m], txs[4], 2) for m in range(2, 4)]
    _feed(sides, phase2)
    assert _drain(sides) >= 1
    (fj, _mj, pj, sj, aj), (fp, _mp, pp, sp, ap) = sides
    assert ap.tx_count == aj.tx_count == 4 and ap.state == aj.state
    assert ap.digest == aj.digest
    assert sp.committed_hashes_in_order() == sj.committed_hashes_in_order()
    for tx in txs:
        h = hashlib.sha256(tx).hexdigest().upper()
        assert sp.load_cert_row(h) == sj.load_cert_row(h)
    assert {h: vs.stake() for h, vs in fp.vote_sets.items()} == {
        h: vs.stake() for h, vs in fj.vote_sets.items()} == {
        hashlib.sha256(txs[4]).hexdigest().upper(): 4 * 2**28}
    assert pp.size() == pj.size()
