"""PyTorch port, the slice end to end: the port's TxFlow.step() (device
verifier on the CPU, i.e. the plain kernels) against the JAX package's
batched and scalar engines on the shuffled adversarial stream of
tests/test_engine.py::test_batched_matches_scalar_reference_engine.
App digest (commit order), app state, certificate bytes, commit-order log
and uncommitted stake must all be identical."""

import hashlib
import random

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
from txflow_tpu_torch.verifier import DeviceVoteVerifier

CHAIN_ID = "txflow-test"
HEIGHT = 1


def make_engine(pkg, vals, **engine_cfg):
    abci, engine, pool, store, cfg = pkg
    conns = abci.AppConns(abci.KVStoreApplication())
    mempool = pool.Mempool(cfg.MempoolConfig(cache_size=1000), conns.mempool)
    commitpool = pool.Mempool(cfg.MempoolConfig(cache_size=1000))
    votepool = pool.TxVotePool(cfg.MempoolConfig(cache_size=10000))
    tx_store = store.TxStore(store.MemDB())
    execu = engine.TxExecutor(conns.consensus, mempool)
    flow = engine.TxFlow(
        CHAIN_ID, HEIGHT, vals, votepool, mempool, commitpool, execu, tx_store,
        config=cfg.EngineConfig(**engine_cfg),
    )
    return flow, mempool, votepool, tx_store, conns.app


class _JCfg:
    MempoolConfig, EngineConfig = JMempoolConfig, JEngineConfig


class _PCfg:
    MempoolConfig, EngineConfig = MempoolConfig, EngineConfig


JAX_PKG = (jabci, jengine, jpool, jstore, _JCfg)
PORT_PKG = (pabci, pengine, ppool, pstore, _PCfg)


def _stream():
    """Seeded adversarial stream: 7 validators (quorum 5 of 7 votes),
    12 txs with 2-7 votes each, ~15% zeroed signatures, shuffled."""
    rng = random.Random(42)
    nrng = np.random.default_rng(42)
    seeds = [nrng.bytes(32) for _ in range(7)]
    pvs = [jtypes.MockPV(seed=s) for s in seeds]
    vals_j = jtypes.ValidatorSet(
        [jtypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs]
    )
    vals_p = ptypes.ValidatorSet(
        [ptypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in pvs]
    )
    txs = [b"ptx%d=%d" % (i, i) for i in range(12)]
    stream = []
    for tx in txs:
        for vi in rng.sample(range(7), rng.randint(2, 7)):
            vote = jtypes.TxVote(
                height=HEIGHT,
                tx_hash=hashlib.sha256(tx).hexdigest().upper(),
                tx_key=hashlib.sha256(tx).digest(),
                timestamp_ns=1700000000_000000000,
                validator_address=pvs[vi].get_address(),
            )
            pvs[vi].sign_tx_vote(CHAIN_ID, vote)
            if rng.random() < 0.15:
                vote.signature = bytes(64)
            stream.append(vote)
    rng.shuffle(stream)
    return txs, stream, vals_j, vals_p


def _port_vote(v):
    return ptypes.TxVote(
        v.height, v.tx_hash, v.tx_key, v.timestamp_ns, v.validator_address, v.signature
    )


def test_port_engine_matches_jax_engines():
    txs, stream, vals_j, vals_p = _stream()

    # JAX golden scalar engine: one vote at a time through add_vote
    flow_s, mem_s, _, store_s, app_s = make_engine(JAX_PKG, vals_j, use_device=False)
    for tx in txs:
        mem_s.check_tx(tx)
    for v in stream:
        flow_s.try_add_vote(v.copy())

    # JAX batched engine, uneven batches
    flow_j, mem_j, pool_j, store_j, app_j = make_engine(JAX_PKG, vals_j, max_batch=17)
    # the port's batched engine, same batches, plain kernels on the CPU
    flow_p, mem_p, pool_p, store_p, app_p = make_engine(
        PORT_PKG, vals_p, max_batch=17, device="cpu"
    )
    assert isinstance(flow_p.verifier, DeviceVoteVerifier)
    for tx in txs:
        mem_j.check_tx(tx)
        mem_p.check_tx(tx)
    for v in stream:
        for pool, vote in ((pool_j, v.copy()), (pool_p, _port_vote(v))):
            try:
                pool.check_tx(vote)
            except Exception:
                pass
    steps_j = steps_p = 0
    while flow_j.step():
        steps_j += 1
    _lib.reset_launches()
    while flow_p.step():
        steps_p += 1
    assert steps_p == steps_j > 1
    assert sum(_lib.launches.values()) == 0  # CPU tensors: plain versions

    assert app_p.tx_count == app_j.tx_count == app_s.tx_count > 0
    assert app_p.state == app_j.state == app_s.state
    assert app_p.digest == app_j.digest == app_s.digest  # commit order
    assert store_p.committed_hashes_in_order() == store_j.committed_hashes_in_order()
    n_certs = 0
    for tx in txs:
        h = hashlib.sha256(tx).hexdigest().upper()
        key = b"H:" + h.encode()
        assert store_p.db.get(key) == store_j.db.get(key)  # certificate bytes
        assert (store_p.db.get(key) is None) == (store_s.db.get(key) is None)
        cert = flow_p.load_commit(h)
        if cert is not None:
            n_certs += 1
            assert flow_p.is_tx_committed(h)
            assert sum(10 for _ in cert.commits) >= vals_p.quorum_power()
    assert n_certs == app_p.tx_count
    # uncommitted stake identical
    assert set(flow_p.vote_sets) == set(flow_j.vote_sets) == set(flow_s.vote_sets)
    for h, vs in flow_s.vote_sets.items():
        assert flow_p.vote_sets[h].stake() == flow_j.vote_sets[h].stake() == vs.stake()
    assert pool_p.size() == pool_j.size()


def test_port_scalar_engine_matches_batched():
    """The port's own golden path (try_add_vote, host verify) agrees with
    its batched step."""
    txs, stream, _, vals_p = _stream()
    flow_s, mem_s, _, store_s, app_s = make_engine(PORT_PKG, vals_p, use_device=False)
    flow_b, mem_b, pool_b, store_b, app_b = make_engine(
        PORT_PKG, vals_p, max_batch=64, device="cpu"
    )
    for tx in txs:
        mem_s.check_tx(tx)
        mem_b.check_tx(tx)
    for v in stream:
        flow_s.try_add_vote(_port_vote(v))
        try:
            pool_b.check_tx(_port_vote(v))
        except Exception:
            pass
    while flow_b.step():
        pass
    assert app_b.digest == app_s.digest and app_b.tx_count == app_s.tx_count > 0
    assert store_b.committed_hashes_in_order() == store_s.committed_hashes_in_order()


def test_engine_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, vals_p = _stream()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_engine(PORT_PKG, vals_p)  # EngineConfig.device defaults to cuda
    flow, *_ = make_engine(PORT_PKG, vals_p, device="cpu")
    assert flow.verifier.device.type == "cpu"
