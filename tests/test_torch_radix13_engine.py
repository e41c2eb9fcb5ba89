"""PyTorch port, one node's fast path over the radix-2^13 field (K8): the
port's ``TxFlow`` with ``EngineConfig(fe_radix=13, device="cpu")`` (its
``DeviceVoteVerifier`` over the plain radix-13 verify and the tally)
against the JAX package's engine on the same shuffled adversarial votes:
certificate bytes, commit order, app digest, uncommitted stake and pool
size identical (tolerance 0). Steps of at most 16 votes."""

import hashlib
import random

import numpy as np

import txflow_tpu.types as jtypes

import txflow_tpu_torch.types as ptypes
from test_torch_engine import JAX_PKG, PORT_PKG, make_engine
from txflow_tpu_torch.ops import _lib
from txflow_tpu_torch.verifier import DeviceVoteVerifier

CHAIN_ID = "txflow-test"  # test_torch_engine's chain


def _stream():
    """4 validators (quorum 3 of 4 votes), 7 txs with 1-4 votes each,
    about 1 in 6 signatures corrupted, shuffled (seeded)."""
    rng = random.Random(1313)
    nrng = np.random.default_rng(1313)
    pvs = [jtypes.MockPV(seed=nrng.bytes(32)) for _ in range(4)]
    vals_j = jtypes.ValidatorSet([jtypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])
    vals_p = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs])
    txs = [b"r13tx%d=%d" % (i, i) for i in range(7)]
    stream = []
    for tx in txs:
        for vi in rng.sample(range(4), rng.randint(1, 4)):
            key = hashlib.sha256(tx).digest()
            vote = jtypes.TxVote(height=1, tx_hash=key.hex().upper(), tx_key=key,
                                 timestamp_ns=1_700_000_000_000_000_000,
                                 validator_address=pvs[vi].get_address())
            pvs[vi].sign_tx_vote(CHAIN_ID, vote)
            if rng.random() < 1 / 6:
                vote.signature = vote.signature[:40] + bytes([vote.signature[40] ^ 1]) + vote.signature[41:]
            stream.append(vote)
    rng.shuffle(stream)
    return txs, stream, vals_j, vals_p


def test_radix13_engine_matches_jax_engine():
    txs, stream, vals_j, vals_p = _stream()
    assert 16 < len(stream) <= 32
    out = []
    for pkg, vals, cfg in ((JAX_PKG, vals_j, dict(use_device=False)),
                           (PORT_PKG, vals_p, dict(fe_radix=13, device="cpu"))):
        flow, mempool, pool, store, app = make_engine(pkg, vals, max_batch=16, **cfg)
        for tx in txs:
            mempool.check_tx(tx)
        for v in stream:
            pool.check_tx(v.copy() if pkg is JAX_PKG else ptypes.TxVote(
                v.height, v.tx_hash, v.tx_key, v.timestamp_ns, v.validator_address, v.signature))
        _lib.reset_launches()
        steps = 0
        while flow.step():
            steps += 1
        if pkg is PORT_PKG:
            assert isinstance(flow.verifier, DeviceVoteVerifier) and flow.verifier.fe_radix == 13
            assert flow.verifier.epoch.tables.shape == (4, 16, 4, 20)
            assert sum(_lib.launches.values()) == 0  # CPU tensors: the plain versions
        out.append(dict(
            steps=steps, digest=app.digest, state=app.state, tx_count=app.tx_count,
            order=store.committed_hashes_in_order(),
            certs=[store.db.get(b"H:" + hashlib.sha256(tx).hexdigest().upper().encode()) for tx in txs],
            stake={h: vs.stake() for h, vs in flow.vote_sets.items()}, pool=pool.size(),
        ))
    assert out[1] == out[0]
    assert out[1]["steps"] == 2 and 0 < out[1]["tx_count"] < len(txs) and out[1]["stake"]
