"""PyTorch port, a rotation restages the quarter tables with the epoch
tables: the port's engine over each of its batched verifiers -- the
DeviceVoteVerifier (device="cpu", the plain four-lane verify), the
committee BatchCertVerifier and a DeviceVoteVerifier over a 2-shard CPU
mesh -- and the JAX package's engine on its host verifier run the same
votes, rotate from one set of four validators to a disjoint one (the
port restages in place), and run the new set's votes for the txs left
pending. The new set's votes verify only against its own quarter tables:
certificate bytes, commit order and app digest must equal the JAX
engine's, and every staged quarter tensor must equal a fresh build for
the new set (tolerance 0)."""

import hashlib

import numpy as np
import pytest

import txflow_tpu.abci as jabci
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
from txflow_tpu_torch.ops import ed25519_batch as eb
from txflow_tpu_torch.utils.config import EngineConfig, MempoolConfig
from txflow_tpu_torch.verifier import DeviceVoteVerifier

CHAIN = "txflow-quarter-rotation"
TXS = [b"qrot%d=%d" % (i, i) for i in range(6)]


def _engine(vals, port, config, verifier=None):
    abci, engine, pool, store = (pabci, pengine, ppool, pstore) if port else (jabci, jengine, jpool, jstore)
    mcfg = MempoolConfig if port else JMempoolConfig
    conns = abci.AppConns(abci.KVStoreApplication())
    mempool = pool.Mempool(mcfg(cache_size=1000), conns.mempool)
    votepool = pool.TxVotePool(mcfg(cache_size=10000))
    tx_store = store.TxStore(store.MemDB())
    flow = engine.TxFlow(
        CHAIN, 1, vals, votepool, mempool, pool.Mempool(mcfg(cache_size=1000)),
        engine.TxExecutor(conns.consensus, mempool), tx_store, config=config, verifier=verifier,
    )
    for tx in TXS:
        mempool.check_tx(tx)
    return flow, votepool, tx_store, conns.app


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
    return ptypes.TxVote(v.height, v.tx_hash, v.tx_key, v.timestamp_ns, v.validator_address,
                         v.signature)


def _drain(flow):
    n = 0
    while flow.step():
        n += 1
    return n


def _staged_quarters(verifier):
    """Every quarter tensor the verifier would launch with, as numpy."""
    if isinstance(verifier, DeviceVoteVerifier):
        q = verifier._stage.quarters_dev
        return [t.numpy() for t in (q if isinstance(q, list) else [q])]
    return [verifier._stage[5].numpy()]


@pytest.mark.parametrize("kind", ["device", "committee", "mesh2"])
def test_rotation_restages_quarter_tables_and_matches_jax(kind):
    rng = np.random.default_rng(0x0A7)
    pvs = [jtypes.MockPV(rng.bytes(32)) for _ in range(8)]
    by_addr = {pv.get_address(): pv for pv in pvs}
    jsets = [jtypes.ValidatorSet([jtypes.Validator.from_pub_key(pv.get_pub_key(), 10)
                                  for pv in half]) for half in (pvs[:4], pvs[4:])]
    psets = [ptypes.ValidatorSet([ptypes.Validator(v.address, v.pub_key, v.voting_power)
                                  for v in js]) for js in jsets]
    jside = _engine(jsets[0], False, JEngineConfig(max_batch=16, use_device=False))
    if kind == "committee":
        pside = _engine(psets[0], True, EngineConfig(max_batch=16, device="cpu"),
                        pcom.BatchCertVerifier(psets[0], min_batch=1, device="cpu"))
    else:
        pside = _engine(psets[0], True, EngineConfig(
            max_batch=16, device="cpu", mesh_devices=2 if kind == "mesh2" else 0))
    verifier = pside[0].verifier
    if kind == "mesh2":
        assert verifier.mesh is not None and verifier.mesh.size == 2
    # phase 1, set 0 (quorum 27 of 40): tx0-2 commit, tx3-5 stay pending
    m0 = [by_addr[v.address] for v in jsets[0]]
    counts = (4, 3, 3, 2, 2, 1)
    phase1 = [_vote(m0[m], tx, 1) for tx, c in zip(TXS, counts) for m in range(c)]
    phase1 += [_vote(m0[3], TXS[4], 1, corrupt=True)]
    phase1 = [phase1[i] for i in rng.permutation(len(phase1))]
    # the rotation to the disjoint set 1, then its votes for the pending txs
    m1 = [by_addr[v.address] for v in jsets[1]]
    phase2 = [_vote(m1[m], tx, 2) for tx in TXS[3:] for m in range(3)]
    phase2 += [_vote(m1[0], TXS[5], 2, corrupt=True)]
    for flow, pool, _store, _app in (jside, pside):
        port = flow is pside[0]
        pool.check_tx_many([_port_vote(v) if port else v.copy() for v in phase1])
        assert _drain(flow) >= 1
        flow.update_state(2, psets[1] if port else jsets[1])
        pool.check_tx_many([_port_vote(v) if port else v.copy() for v in phase2])
        assert _drain(flow) >= 1
    rot = pside[0].last_rotation
    assert rot == jside[0].last_rotation and rot["restaged"] is True
    assert pside[0].verifier is verifier  # restaged in place
    fresh = eb.EpochTables([v.pub_key for v in psets[1]]).quarter_tables
    for q in _staged_quarters(verifier):
        np.testing.assert_array_equal(q[: len(psets[1])], fresh)
    (fj, _pj, sj, aj), (fp, _pp, sp, ap) = jside, pside
    assert ap.tx_count == aj.tx_count == len(TXS) and ap.state == aj.state
    assert ap.digest == aj.digest
    assert sp.committed_hashes_in_order() == sj.committed_hashes_in_order()
    for tx in TXS:
        h = hashlib.sha256(tx).hexdigest().upper()
        assert sp.load_cert_row(h) == sj.load_cert_row(h)
        cert = sp.load_tx_commit(h)
        assert {cs.height for cs in cert.commits} == ({2} if tx in TXS[3:] else {1})
