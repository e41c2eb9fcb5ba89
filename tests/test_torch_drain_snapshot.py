"""PyTorch port, the engine's drain-time verifier snapshot: the batch a
step drained under one validator set goes to the verifier that the drain
saw, whatever ``update_state`` swaps in before the submit (the JAX engine
keeps ``prep.verifier``). Both engines drain, rotate, then submit, collect
and route the drained batch; the routed decisions, the verify mask, the
pool's contents, certificate bytes, commit order and app digest must be
identical (tolerance 0).

The JAX side mounts its own ``DeviceVoteVerifier`` (V = 4, one 64-row
bucket), so that a rotation past its capacity builds a new verifier there
too; the port runs the plain kernels on the CPU."""

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
from txflow_tpu.verifier import DeviceVoteVerifier as JDeviceVoteVerifier

import txflow_tpu_torch.abci as pabci
import txflow_tpu_torch.engine as pengine
import txflow_tpu_torch.pool as ppool
import txflow_tpu_torch.store as pstore
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.utils.config import EngineConfig, MempoolConfig
from txflow_tpu_torch.verifier import DeviceVoteVerifier

CHAIN = "txflow-drain-test"


def _signers():
    """Four validators, and a fifth whose address sorts before theirs:
    in the five-validator set every old index points at another key."""
    rng = np.random.default_rng(1217)
    pvs = [jtypes.MockPV(rng.bytes(32)) for _ in range(4)]
    first = min(pv.get_address() for pv in pvs)
    while True:
        extra = jtypes.MockPV(rng.bytes(32))
        if extra.get_address() < first:
            return pvs, extra


def _sets(pvs):
    j = jtypes.ValidatorSet([jtypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])
    p = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])
    return j, p


def _side(port, vals):
    abci, engine, pool, store = (pabci, pengine, ppool, pstore) if port else (jabci, jengine, jpool, jstore)
    mcfg = MempoolConfig if port else JMempoolConfig
    if port:
        ecfg, verifier = EngineConfig(max_batch=16, device="cpu"), None
    else:
        ecfg, verifier = JEngineConfig(max_batch=16), JDeviceVoteVerifier(vals)
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


def _vote(pv, tx):
    key = hashlib.sha256(tx).digest()
    v = jtypes.TxVote(height=1, tx_hash=key.hex().upper(), tx_key=key,
                      timestamp_ns=1_700_000_000_000_000_000,
                      validator_address=pv.get_address())
    pv.sign_tx_vote(CHAIN, v)
    return v


@pytest.mark.parametrize("rotation", ["past_capacity", "in_place"])
def test_drained_batch_goes_to_the_verifier_of_its_set(rotation):
    """``past_capacity``: five validators where four are staged; both
    engines build a new verifier, and the drained batch must still be
    checked by the old one (an engine that submits to whichever verifier
    is current sends it to the new one, whose shifted indices reject every
    honest vote). ``in_place``: the three validators after the first,
    restaged into the same verifier object; both packages read the stage
    at submit, so the stale indices meet the new keys on both sides alike
    (a reference-side finding, pinned here)."""
    pvs, extra = _signers()
    j4, p4 = _sets(pvs)
    if rotation == "past_capacity":
        jnew, pnew = _sets(pvs + [extra])
    else:
        order = sorted(pvs, key=lambda pv: pv.get_address())
        jnew, pnew = _sets(order[1:])
    sides = [_side(False, j4), _side(True, p4)]
    assert isinstance(sides[1][0].verifier, DeviceVoteVerifier) and sides[1][0].verifier.capacity == 4
    txs = [b"drain%d=%d" % (i, i) for i in range(4)]
    votes = [_vote(pv, tx) for tx in txs[:3] for pv in pvs] + [_vote(pv, txs[3]) for pv in pvs[:2]]
    got = []
    for (flow, mempool, pool, store, app), port, new in zip(sides, (False, True), (jnew, pnew)):
        for tx in txs:
            mempool.check_tx(tx)
        for v in votes:
            pool.check_tx(ptypes.TxVote(v.height, v.tx_hash, v.tx_key, v.timestamp_ns,
                                        v.validator_address, v.signature) if port else v.copy())
        prep = flow._prep_batch()
        assert len(prep.votes) == len(votes)
        drained_by = flow.verifier
        flow.update_state(2, new)
        assert (flow.verifier is drained_by) == (rotation == "in_place")
        result = flow._collect(prep, flow._submit_prep(prep))
        routed = tuple(flow._route_result(prep, result)[:2])
        while flow.step():
            pass
        got.append(dict(
            routed=routed,
            valid=np.asarray(result.valid, bool).tolist(),
            pool=[k for k, *_ in pool.entries_from(0, 1000)[0]],
            order=store.committed_hashes_in_order(),
            certs=[store.load_cert_row(hashlib.sha256(tx).hexdigest().upper()) for tx in txs],
            digest=app.digest,
            tx_count=app.tx_count,
            stake={h: vs.stake() for h, vs in flow.vote_sets.items()},
        ))
    assert got[1] == got[0]
    if rotation == "past_capacity":
        assert all(got[1]["valid"]) and got[1]["tx_count"] == 3
    else:
        assert not all(got[1]["valid"])
