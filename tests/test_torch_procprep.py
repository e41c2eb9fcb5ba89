"""PyTorch port, the process host-prep pool (engine/hostprep.py) and its
worker half (prep.py): the pool's compact prep and sign bytes byte for
byte against the JAX package's ``prep_proc.prep_rows_cat`` and
``sign_bytes_many`` (sizes 0, 1, one the worker count does not divide,
a few hundred; adversarial rows), a second validator set through the same
pool, close() releasing workers and segments, the deliberate differences
(a failed spawn and a dead worker raise), an engine on the process backend
against the JAX golden path, and the worker module importing no torch
(tests/test_procprep.py:97-201). Each pool here closes before its test
ends."""

import hashlib
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from test_torch_pipeline import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_same_outcome, jax_golden, make_port_engine, make_pvs, one_torch_thread,
    port_vote, sign_vote, wait_quiescent,
)
from txflow_tpu import prep_proc as jprep
from txflow_tpu.crypto import ed25519 as jed
from txflow_tpu.types import TxVote as JTxVote
from txflow_tpu.types.tx_vote import canonical_sign_bytes as jcanonical_sign_bytes
from txflow_tpu.types.tx_vote import sign_bytes_many as jsign_bytes_many

import txflow_tpu_torch.engine.hostprep as hostprep
from txflow_tpu_torch.engine.hostprep import (
    HostPoolSpawnError, HostPoolWorkerError, HostPrepPool, ProcHostPrepPool, make_host_pool,
)
from txflow_tpu_torch.ops import ed25519_batch
from txflow_tpu_torch.verifier import DeviceVoteVerifier

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("s_nibbles", "h_nibbles", "val_idx", "r_y", "r_sign", "pre_ok")
CHAIN = "proc-chain"


def _shm_names() -> set:
    try:
        return {n for n in os.listdir("/dev/shm") if not n.startswith("sem.")}
    except OSError:
        return set()


@pytest.fixture(scope="module")
def pool():
    p = ProcHostPrepPool(3, name="hostprep-test")
    yield p
    p.close()


def _keys(n_vals, seed):
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n_vals)]
    return seeds, [jed.public_key_from_seed(s) for s in seeds]


def _adversarial(n, n_vals, seed):
    """Signed rows with: flipped bytes, the wrong key, empty, truncated
    and all-zero signatures, S >= L, and out-of-range indices."""
    rng = np.random.default_rng(seed)
    seeds, pubs = _keys(n_vals, seed)
    msgs = [rng.bytes(int(rng.integers(20, 120))) for _ in range(n)]
    vidx = rng.integers(0, n_vals, n)
    sigs = [jed.sign(seeds[v], m) for m, v in zip(msgs, vidx)]
    for i in range(n):
        kind = i % 9
        if kind == 1:
            sigs[i] = sigs[i][:9] + bytes([sigs[i][9] ^ 1]) + sigs[i][10:]
        elif kind == 2:
            sigs[i] = jed.sign(seeds[(vidx[i] + 1) % n_vals], msgs[i])
        elif kind == 3:
            sigs[i] = b"" if i % 2 else sigs[i][:40]
        elif kind == 4:
            sigs[i] = bytes(64)
        elif kind == 5:
            sigs[i] = sigs[i][:32] + (jprep.L + 5).to_bytes(32, "little")
        elif kind == 6:
            vidx[i] = -2 if i % 2 else n_vals + 3
    return msgs, sigs, vidx, pubs


def _jax_rows(msgs, sigs, vidx, epoch):
    msg_cat, offs = jprep.cat_msgs(msgs)
    sig_arr, sig_ok = jprep.cat_sigs(sigs)
    return jprep.prep_rows_cat(msg_cat, offs, sig_arr, sig_ok, np.asarray(vidx, np.int64),
                               epoch.pub_arr, epoch.key_ok)


@pytest.mark.parametrize("n", [0, 1, 7, 301])
def test_compact_prep_matches_jax(pool, n):
    msgs, sigs, vidx, pubs = _adversarial(n, 5, 40 + n)
    epoch = ed25519_batch.EpochTables(pubs)
    want = _jax_rows(msgs, sigs, vidx, epoch)
    got = pool.prepare_compact_shm(msgs, sigs, vidx, epoch)
    for name, w, g in zip(FIELDS, want, got[:6]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[6] >= 0.0  # wait seconds


def test_prepare_compact_through_each_backend(pool):
    """prepare_compact with the process pool, the thread pool and none:
    the same bytes, and the process pool took the shared-memory path."""
    msgs, sigs, vidx, pubs = _adversarial(293, 4, 7)
    epoch = ed25519_batch.EpochTables(pubs)
    serial = ed25519_batch.prepare_compact(msgs, sigs, vidx, epoch)
    calls = pool.stats()["shm_calls"]
    proc = ed25519_batch.prepare_compact(msgs, sigs, vidx, epoch, pool=pool)
    assert pool.stats()["shm_calls"] == calls + 1
    threads = HostPrepPool(3)
    try:
        threaded = ed25519_batch.prepare_compact(msgs, sigs, vidx, epoch, pool=threads)
        assert threads.stats()["jobs_total"] == 3
    finally:
        threads.close()
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(proc, name), getattr(serial, name), name)
        np.testing.assert_array_equal(getattr(threaded, name), getattr(serial, name), name)


@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_sign_bytes_match_jax(pool, n):
    rng = np.random.default_rng(n)
    votes = [JTxVote(height=int(rng.integers(0, 2**40)),
                     tx_hash=hashlib.sha256(b"t%d" % i).hexdigest().upper(),
                     tx_key=hashlib.sha256(b"t%d" % i).digest(),
                     timestamp_ns=int(rng.integers(0, 2**62)), validator_address=b"")
             for i in range(n)]
    want = jsign_bytes_many(votes, CHAIN)
    if n > 1:  # rows the segment cannot carry: encoded by the caller
        votes[0].tx_hash = "A" * 2048
        votes[1].height = 2**70
        want[:2] = [jcanonical_sign_bytes(CHAIN, v.height, v.tx_hash, v.timestamp_ns)
                    for v in votes[:2]]
    rows, wait_s = pool.sign_bytes_shm([v.height for v in votes], [v.tx_hash for v in votes],
                                       [v.timestamp_ns for v in votes], CHAIN)
    assert rows == want and wait_s >= 0.0


def test_second_validator_set_through_the_same_pool(pool):
    """A mid-run restage: another set's batch through the same pool stays
    byte-identical (the protocol keeps no per-set state)."""
    for n_vals, seed in ((4, 1), (7, 2)):
        msgs, sigs, vidx, pubs = _adversarial(300 + n_vals, n_vals, seed)
        epoch = ed25519_batch.EpochTables(pubs)
        got = pool.prepare_compact_shm(msgs, sigs, vidx, epoch)
        for name, w, g in zip(FIELDS, _jax_rows(msgs, sigs, vidx, epoch), got):
            np.testing.assert_array_equal(g, w, err_msg=f"{n_vals}:{name}")


def test_close_releases_workers_and_segments():
    before = _shm_names()
    p = ProcHostPrepPool(3, name="hostprep-close")
    msgs, sigs, vidx, pubs = _adversarial(300, 4, 3)
    p.prepare_compact_shm(msgs, sigs, vidx, ed25519_batch.EpochTables(pubs))
    procs = list(p._procs)
    assert len(procs) == 2 and p.alive_workers() == 2
    p.close()
    for proc in procs:
        assert not proc.is_alive(), "a worker outlived close()"
    assert p.stats()["live_segments"] == 0
    assert not (_shm_names() - before), "a shared-memory segment outlived close()"
    with pytest.raises(HostPoolWorkerError, match="closed"):
        p.sign_bytes_shm([1], ["AB"], [1], CHAIN)
    p.close()  # idempotent


def test_failed_spawn_raises(monkeypatch):
    """The deliberate difference: no thread pool in its place."""
    with pytest.raises(HostPoolSpawnError):
        ProcHostPrepPool(3, mp_context="no-such-method")
    monkeypatch.setattr(hostprep, "default_mp_method", lambda: "no-such-method")
    with pytest.raises(HostPoolSpawnError):
        make_host_pool(3, backend="process")
    with pytest.raises(ValueError):
        make_host_pool(3, backend="fibers")
    with pytest.raises(ValueError):
        ProcHostPrepPool(1)


def test_engine_start_raises_when_the_pool_cannot_spawn(monkeypatch):
    _, _, vals_p = make_pvs(4, 3)
    flow, *_ = make_port_engine(vals_p, DeviceVoteVerifier(vals_p, device="cpu"),
                                host_prep_workers=3, host_prep_backend="process")
    monkeypatch.setattr(hostprep, "default_mp_method", lambda: "no-such-method")
    with pytest.raises(HostPoolSpawnError):
        flow.start()
    assert not flow._running and flow._thread is None


def test_dead_worker_raises_at_the_caller():
    """The deliberate difference: a lost worker is an error at the caller
    (and for every later call), never recomputed in its place."""
    p = ProcHostPrepPool(3, name="hostprep-dead")
    try:
        victim = p._procs[0]
        victim.kill()
        victim.join(timeout=10)
        msgs, sigs, vidx, pubs = _adversarial(300, 4, 5)
        epoch = ed25519_batch.EpochTables(pubs)
        with pytest.raises(HostPoolWorkerError, match="died"):
            p.prepare_compact_shm(msgs, sigs, vidx, epoch)
        with pytest.raises(HostPoolWorkerError, match="died"):
            p.sign_bytes_shm([1], ["AB"], [1], CHAIN)
        assert not p.healthy
    finally:
        p.close()
    assert p.alive_workers() == 0 and p.stats()["live_segments"] == 0


@pytest.mark.parametrize("kind", ["scalar", "device"])
def test_engine_on_process_backend_matches_jax_golden(kind):
    """Sign bytes (and, on the device verifier, the compact prep) in
    worker processes: the JAX golden path's certificates, order and app
    digest; stop() closes the pool."""
    pvs, vals_j, vals_p = make_pvs(4, 31)
    txs = [b"proc%d=%d" % (i, i) for i in range(80)]  # 320 votes: past the pool's gate
    rng = random.Random(31)
    stream = []
    for tx in txs:
        for pv in pvs:
            vote = sign_vote(pv, tx)
            if rng.random() < 0.15:
                vote.signature = bytes(64)
            stream.append(vote)
    rng.shuffle(stream)
    golden = jax_golden(vals_j, txs, stream)
    verifier = DeviceVoteVerifier(vals_p, device="cpu") if kind == "device" else None
    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, verifier, use_device=kind == "device", max_batch=1024, min_batch=1,
        host_prep_workers=3, host_prep_backend="process", coalesce=False, lane_split=False)
    for tx in txs:
        mempool.check_tx(tx)
    for v in stream:  # all queued before start: one pooled drain
        try:
            votepool.check_tx(port_vote(v))
        except Exception:
            pass
    flow.start()
    pool = flow._host_pool
    try:
        assert pool.backend == "process"
        assert wait_quiescent(flow, votepool)
        stats = flow.pipeline_stats()
    finally:
        flow.stop()
    # sign bytes, plus the compact prep on the device verifier
    assert stats["host_prep"]["shm_calls"] == (2 if kind == "device" else 1)
    assert pool.alive_workers() == 0 and not pool.healthy
    assert flow._host_pool is None
    assert_same_outcome(txs, golden, store, app, flow)


_NO_TORCH = r"""
import sys
sys.modules["torch"] = None  # any "import torch" now raises ImportError
import txflow_tpu_torch.prep  # the module a worker process imports
assert "torch" not in [k for k, v in sys.modules.items() if v is not None]
assert not [k for k in sys.modules if k.startswith("cryptography")]
print("ok")
"""


def test_worker_module_imports_no_torch():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
