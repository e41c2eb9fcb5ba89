"""PyTorch port, the readback ring (parallel/staging.py) over CPU tensors:
the counterparts of tests/test_staging_ring.py:41, 65, 95, 114, 142 and
201. On the CPU a slot's copy runs on the caller into an ordinary host
buffer, through the same slots and accounting as the side-stream copy on
the card (which chip_smoke.py checks): bytes, depth overflow, error
capture, close, and the threaded engine's certificates and drain with the
ring on."""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_pipeline import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_same_outcome, feed, jax_golden, make_port_engine, make_pvs, one_torch_thread, serve,
    sign_vote,
)
from txflow_tpu_torch.parallel import Mesh
from txflow_tpu_torch.parallel.staging import StagingRing
from txflow_tpu_torch.verifier import DeviceVoteVerifier


def test_ring_readback_and_accounting():
    """A submitted ticket's parts come back joined in shard order; the
    slot is consumed at result() and the counters say where it went."""
    ring = StagingRing(depth=2)
    a = torch.arange(64, dtype=torch.int32)
    slot = ring.submit([a[:32], a[32:]])
    assert ring.stats()["in_flight"] == 1
    np.testing.assert_array_equal(ring.result(slot), a.numpy())
    st = ring.stats()
    assert st["slots_total"] == 1 and st["host_readbacks"] == 1 and st["in_flight"] == 0
    assert st["stream_readbacks"] == 0 and st["sync_readbacks"] == 0
    # a host copy runs on the caller: none of it is hidden
    assert st["hidden_s"] == 0.0 and st["readback_s"] >= 0.0
    # the buffer goes back to the ring and carries a larger ticket next
    big = torch.arange(100, dtype=torch.int32)
    np.testing.assert_array_equal(ring.result(ring.submit([big])), big.numpy())
    assert ring.result(slot) is not None  # a consumed slot keeps its bytes


def test_ring_depth_overflow_reads_back_on_the_caller():
    """More un-awaited submits than ``depth`` never block: the overflow
    reads back at once on the caller and counts ``sync_readbacks``."""
    ring = StagingRing(depth=1)
    first = ring.submit([torch.zeros(4, dtype=torch.int32)])
    second = ring.submit([torch.ones(4, dtype=torch.int32)])
    assert first.queued and not second.queued
    np.testing.assert_array_equal(ring.result(second), np.ones(4))
    np.testing.assert_array_equal(ring.result(first), np.zeros(4))
    st = ring.stats()
    assert st["sync_readbacks"] == 1 and st["slots_total"] == 2 and st["in_flight"] == 0
    # the overflow held no slot: the freed ring stages the next submit
    third = ring.submit([torch.full((4,), 2, dtype=torch.int32)])
    assert third.queued
    np.testing.assert_array_equal(ring.result(third), np.full(4, 2))
    assert ring.stats()["sync_readbacks"] == 1


class _Boom:
    """A part whose readback fails."""

    def numel(self):
        raise RuntimeError("device readback failed")

    def reshape(self, *a):
        raise RuntimeError("device readback failed")


@pytest.mark.parametrize("depth", [1, 2])
def test_ring_error_reraised_at_waiter(depth):
    """A readback that fails surfaces at result(), and the ring keeps
    serving (its slot is given back)."""
    ring = StagingRing(depth=depth)
    bad = ring.submit([_Boom()])
    with pytest.raises(RuntimeError, match="device readback failed"):
        ring.result(bad)
    assert ring.stats()["in_flight"] == 0
    good = ring.submit([torch.full((3,), 7, dtype=torch.int32)])
    assert good.queued
    np.testing.assert_array_equal(ring.result(good), np.full(3, 7))


def test_ring_close_drains_then_reads_back_on_the_caller():
    """close() leaves queued slots readable; later submits read back on
    the caller and are not counted as overflow. Idempotent."""
    ring = StagingRing(depth=4)
    queued = [ring.submit([torch.full((2,), i, dtype=torch.int32)]) for i in range(3)]
    ring.close()
    for i, slot in enumerate(queued):
        np.testing.assert_array_equal(ring.result(slot), np.full(2, i))
    late = ring.submit([torch.full((2,), 9, dtype=torch.int32)])
    assert not late.queued
    np.testing.assert_array_equal(ring.result(late), np.full(2, 9))
    assert ring.stats()["sync_readbacks"] == 0
    ring.close()


@pytest.mark.parametrize("shards", [1, 2])
def test_staged_engine_certificates_match_golden(shards):
    """The threaded engine on the device verifier (plain kernels on the
    CPU, one device or a 2-shard mesh whose tickets have two parts) with
    the ring on: certificates, app state and commit order identical to
    the JAX golden path, and every readback went through the ring."""
    pvs, vals_j, vals_p = make_pvs(4, 17)
    txs = [b"sr%d=%d" % (i, i) for i in range(12)]
    stream = []
    for i, tx in enumerate(txs):
        for vi, pv in enumerate(pvs):
            vote = sign_vote(pv, tx)
            if (i + vi) % 7 == 0:
                vote.signature = bytes(64)
            stream.append(vote)
    golden = jax_golden(vals_j, txs, stream)
    verifier = (DeviceVoteVerifier(vals_p, device="cpu", staging_ring=2) if shards == 1 else
                DeviceVoteVerifier(vals_p, mesh=Mesh(("cpu",) * shards), staging_ring=2))
    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, verifier, max_batch=16, min_batch=4, pipeline_depth=2)
    stats = serve(flow, mempool, votepool, txs, stream)
    ring = stats["staging"]
    assert ring["host_readbacks"] == stats["steps"] + 1 > 1  # + the warm step
    assert ring["sync_readbacks"] == 0 and ring["in_flight"] == 0
    assert_same_outcome(txs, golden, store, app, flow)


def test_stop_drains_staged_slots():
    """stop() with staged readbacks in flight settles every slot."""
    pvs, _, vals_p = make_pvs(4, 19)
    verifier = DeviceVoteVerifier(vals_p, device="cpu", staging_ring=2)
    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, verifier, max_batch=8, min_batch=1, pipeline_depth=2)
    txs = [b"sd%d=v" % i for i in range(12)]
    for tx in txs:
        mempool.check_tx(tx)
    flow.start()
    ring = verifier._ring
    try:
        feed(votepool, [sign_vote(pv, tx) for tx in txs for pv in pvs[:3]])
    finally:
        flow.stop()
    assert ring.stats()["in_flight"] == 0, "a staged slot outlived stop()"
    assert verifier.staging_stats() is None  # stop() closed and dropped the ring
    while flow.step():  # the verifier serves on, with a new ring
        pass
    assert app.tx_count == len(txs)
    h = hashlib.sha256(txs[0]).hexdigest().upper()
    assert len(store.load_tx_commit(h).commits) == 3
