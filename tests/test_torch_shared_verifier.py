"""PyTorch port, one verifier shared by four engines' threads on the CPU
(the LocalNet's case): four threads submitting and collecting at once on
one ``DeviceVoteVerifier`` (plain kernels, readback ring, thread host-prep
pool), with and without the verdict cache, each get their own ticket's
result, equal to a serial verify (tolerance 0); and a process host-prep
pool serves four callers at once, each prep byte-equal to the serial
one; and two engines built over one verifier keep it through a rotation
of one of them (a private successor) and close each verifier with its
last engine."""

import hashlib
import threading
import time

import numpy as np
import pytest

from test_torch_verify_cache import Batch, as_tuple, cpu_verifier, one_torch_thread  # noqa: F401
import txflow_tpu_torch.verifier as pver
from txflow_tpu_torch.engine.hostprep import ProcHostPrepPool
from txflow_tpu_torch.ops import ed25519_batch


@pytest.mark.parametrize("with_cache", [False, True])
def test_four_threads_share_one_verifier(with_cache):
    batches = [Batch(20 + i, n=20) for i in range(4)]
    vals = batches[0].vals["port"]  # same seeds: one set
    shared = cpu_verifier(vals, pver.VerifyCache() if with_cache else None, staging_ring=2)
    shared.ensure_host_pool(3, "thread")
    ref = [as_tuple(cpu_verifier(vals).verify_and_tally(*b.args(), prior_stake=b.prior))
           for b in batches]
    got = [[] for _ in batches]
    barrier = threading.Barrier(4)
    errors = []

    def run(i):
        try:
            barrier.wait(timeout=10)
            for _ in range(2 if with_cache else 1):  # the cache's second round: hits
                t = shared.submit(*batches[i].args(), prior_stake=batches[i].prior)
                got[i].append(as_tuple(t.result()))
        except Exception as e:  # reported by the test thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    for i in range(4):
        for res in got[i]:
            assert res == ref[i]
    shared.close()
    assert shared.staging_stats() is None


def test_process_pool_serves_four_callers_at_once():
    b = Batch(30, n=300)
    epoch = ed25519_batch.EpochTables([v.pub_key for v in b.vals["port"]])
    serial = ed25519_batch.prepare_compact(b.msgs, b.sigs, b.val_idx, epoch)
    pool = ProcHostPrepPool(3)
    try:
        outs, errors = [None] * 4, []
        barrier = threading.Barrier(4)

        def run(i):
            try:
                barrier.wait(timeout=10)
                lo = 20 * i
                outs[i] = pool.prepare_compact_shm(b.msgs[lo:], b.sigs[lo:], b.val_idx[lo:], epoch)
            except Exception as e:  # reported by the test thread
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errors, errors
        for i, o in enumerate(outs):
            lo = 20 * i
            for got, want in zip(o[:6], (serial.s_nibbles, serial.h_nibbles, serial.val_idx,
                                         serial.r_y, serial.r_sign, serial.pre_ok)):
                np.testing.assert_array_equal(got, want[lo:])
        assert pool.healthy and pool.stats()["live_segments"] == 0
    finally:
        pool.close()


def _shared_engine(vals, verifier):
    from txflow_tpu_torch import abci, engine, pool, store
    from txflow_tpu_torch.utils.config import EngineConfig, MempoolConfig

    conns = abci.AppConns(abci.KVStoreApplication())
    mempool = pool.Mempool(MempoolConfig(cache_size=1000), conns.mempool)
    votepool = pool.TxVotePool(MempoolConfig(cache_size=1000))
    flow = engine.TxFlow(
        "txflow-shared-rotation", 1, vals, votepool, mempool,
        pool.Mempool(MempoolConfig(cache_size=1000)),
        engine.TxExecutor(conns.consensus, mempool), store.TxStore(store.MemDB()),
        config=EngineConfig(max_batch=16, device="cpu", coalesce=False, lane_split=False),
        verifier=verifier,
    )
    return flow, mempool, votepool


def _serve_tx(side, pvs, tx, height, timeout=30.0):
    """Put tx in the engine's mempool and the votes of pvs in its vote pool;
    True once the engine has committed it (bounded wait)."""
    from txflow_tpu_torch.types import TxVote

    flow, mempool, votepool = side
    mempool.check_tx(tx)
    key = hashlib.sha256(tx).digest()
    for pv in pvs:
        v = TxVote(height, key.hex().upper(), key, 1_700_000_000_000_000_000 + height,
                   pv.get_address())
        pv.sign_tx_vote(flow.chain_id, v)
        votepool.check_tx(v)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert flow.error is None, flow.error
        if flow.tx_store.has_tx(key.hex().upper()):
            return True
        time.sleep(0.01)
    return False


def test_rotation_leaves_a_shared_verifier_to_the_other_engines():
    """Two engines on one given DeviceVoteVerifier: stopping the one that
    never started leaves the shared count alone; rotating the other moves
    it to a private successor and leaves the shared verifier staged for the
    old set, so the first engine still commits the old set's votes; each
    verifier closes when its last engine stops."""
    from txflow_tpu_torch.types import MockPV, Validator, ValidatorSet

    rng = np.random.default_rng(41)
    pvs = [MockPV(rng.bytes(32)) for _ in range(8)]
    old, new = (ValidatorSet([Validator.from_pub_key(pv.get_pub_key(), 10) for pv in half])
                for half in (pvs[:4], pvs[4:]))
    shared = pver.DeviceVoteVerifier(old, device="cpu")
    a, b = _shared_engine(old, shared), _shared_engine(old, shared)
    a[0].start()
    try:
        b[0].stop()  # never started: no detach
        assert shared._users == 1
        b[0].start()
        try:
            assert shared._users == 2
            a[0].update_state(2, new)
            succ = a[0].verifier
            assert succ is not shared and a[0].last_rotation["restaged"] is False
            assert shared.val_set.hash() == old.hash() and succ.val_set.hash() == new.hash()
            assert shared._users == 2 and succ._users == 1
            assert _serve_tx(b, pvs[:3], b"shared=old", 1)
            assert _serve_tx(a, pvs[4:7], b"private=new", 2)
        finally:
            b[0].stop()
        assert shared._users == 1 and shared.staging_stats() is not None
    finally:
        a[0].stop()
    assert shared._users == 0 and succ._users == 0
    assert shared.staging_stats() is None and succ.staging_stats() is None
