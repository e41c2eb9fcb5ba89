"""PyTorch port, the mesh's own rules, where no JAX program is needed:
the ring all-reduce equals the psum (on bare partials at several shard
counts, and as the whole ring step against the psum step, every shard's
copy equal to the global), a restaged mesh verifier answers as a fresh
one and the golden scalar verifier, padding splits evenly, the engine's
drains are shard multiples and its rebuild past capacity stays on the
mesh, and a mesh of more cards than are visible
raises -- in ``make_mesh``, in ``DeviceVoteVerifier`` and in the engine
(``torch.cuda`` faked, as tests/test_torch_launch.py fakes the card).
``bucket_size`` is held against the JAX package's. Tolerance 0."""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_engine import PORT_PKG, make_engine
from test_verifier import make_batch, make_valset
from txflow_tpu.verifier import bucket_size as jax_bucket_size
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import ed25519_batch as eb
from txflow_tpu_torch.parallel import mesh as pm
from txflow_tpu_torch.types import Validator, ValidatorSet
from txflow_tpu_torch.verifier import (
    DeviceVoteVerifier,
    ScalarVoteVerifier,
    bucket_size,
)


def _port_valset(n, tag=b"val"):
    seeds = [hashlib.sha256(tag + b"%d" % i).digest() for i in range(n)]
    pubs = [host_ed.public_key_from_seed(s) for s in seeds]
    vals = ValidatorSet([Validator.from_pub_key(p, 10) for p in pubs])
    by_pub = dict(zip(pubs, seeds))
    return vals, [by_pub[v.pub_key] for v in vals]


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_ring_tally_equals_the_psum_on_every_shard(n):
    rng = np.random.default_rng(n)
    mesh = pm.make_mesh(n, device="cpu")
    partials = [torch.from_numpy(rng.integers(0, 1 << 24, 40).astype(np.int32)) for _ in range(n)]
    prior = torch.from_numpy(rng.integers(0, 1 << 24, 40).astype(np.int32))
    want = prior.numpy().astype(np.int64) + sum(p.numpy().astype(np.int64) for p in partials)
    totals = pm.ring_tally(mesh, partials)
    stakes, majs = pm.psum_quorum(mesh, partials, mesh.replicate(prior), int(np.median(want)))
    assert len(totals) == len(stakes) == n
    for sh in range(n):
        np.testing.assert_array_equal(totals[sh].numpy() + prior.numpy(), want)
        np.testing.assert_array_equal(stakes[sh].numpy(), want)
        np.testing.assert_array_equal(majs[sh].numpy(), want >= np.median(want))


def test_ring_step_equals_the_psum_step():
    vals, seeds = make_valset(4)
    msgs, sigs, vidx, slot = make_batch(vals, seeds, n_txs=6, corrupt=("ok", "flip", "ok", "badidx"))
    pv, _ = _port_valset(4)
    assert [v.pub_key for v in pv] == [v.pub_key for v in vals]
    epoch = eb.EpochTables([v.pub_key for v in pv])
    c = eb.prepare_compact(msgs, sigs, vidx, epoch)
    t = torch.from_numpy
    prior = np.array([0, 25, 0, 0, 10, 0, 0, 0], np.int32)
    args = [t(np.ascontiguousarray(x)) for x in (c.s_nibbles, c.h_nibbles, c.val_idx, c.r_y,
                                                 c.r_sign, c.pre_ok)] + [
        t(np.asarray(slot, np.int32)), t(epoch.tables), t(np.full(4, 10, np.int32)), t(prior),
        int(pv.quorum_power())]
    mesh = pm.make_mesh(4, device="cpu")
    v_p, st_p, mj_p = pm.sharded_compact_step(mesh)(*args)
    v_r, st_r, mj_r = pm.sharded_ring_step(mesh)(*args)
    np.testing.assert_array_equal(pm.to_host(v_r).numpy(), pm.to_host(v_p).numpy())
    assert pm.to_host(st_r).shape == (4 * 8,)  # per-shard copies, [n * S] on the host
    for sh in range(4):
        np.testing.assert_array_equal(st_r[sh].numpy(), st_p[0].numpy())
        np.testing.assert_array_equal(mj_r[sh].numpy(), mj_p[0].numpy())
    scalar = ScalarVoteVerifier(pv).verify_and_tally(msgs, sigs, vidx, slot, 8, prior)
    np.testing.assert_array_equal(st_r[0].numpy(), scalar.stake)
    assert 0 < scalar.maj23.sum() < 6


def test_mesh_restage_answers_as_a_fresh_verifier():
    vals, seeds = _port_valset(4)
    mesh = pm.make_mesh(4, device="cpu")
    verifier = DeviceVoteVerifier(vals, mesh=mesh)
    assert verifier._n_shards == 4 and len(verifier._stage.tables_dev) == 4
    new_vals, new_seeds = _port_valset(4, tag=b"rot")
    assert new_vals.hash() != vals.hash()
    assert verifier.restage(new_vals)
    msgs, sigs, vidx, slot = make_batch(new_vals, new_seeds, n_txs=5, corrupt=("ok", "flip", "ok"))
    prior = np.array([0, 0, 20, 0, 0])
    r = verifier.verify_and_tally(msgs, sigs, vidx, slot, 5, prior)  # 20 votes: pads to 64
    fresh = DeviceVoteVerifier(new_vals, mesh=mesh).verify_and_tally(msgs, sigs, vidx, slot, 5, prior)
    golden = ScalarVoteVerifier(new_vals).verify_and_tally(msgs, sigs, vidx, slot, 5, prior)
    for got in (r, fresh):
        np.testing.assert_array_equal(got.valid, golden.valid)
        np.testing.assert_array_equal(got.stake, golden.stake)
        np.testing.assert_array_equal(got.maj23, golden.maj23)
        np.testing.assert_array_equal(got.dropped, golden.dropped)
    assert golden.valid.any() and not golden.valid.all()


@pytest.mark.parametrize("n,multiple", [(1, 1), (28, 4), (64, 3), (258, 3), (259, 3),
                                        (1027, 4), (65536, 8), (70000, 3), (0, 5)])
def test_bucket_size_matches_jax(n, multiple):
    got = bucket_size(n, multiple=multiple)
    assert got == jax_bucket_size(n, multiple=multiple)
    assert got % multiple == 0 and got >= n
    assert bucket_size(n, (256, 1024), multiple) == jax_bucket_size(n, (256, 1024), multiple)


def test_engine_on_a_cpu_mesh_drains_shard_multiples():
    vals, _ = _port_valset(4)
    flow, *_ = make_engine(PORT_PKG, vals, max_batch=17, mesh_devices=4, device="cpu")
    assert flow._verifier_shards() == 4 and flow.verifier.mesh.size == 4
    assert flow._drain_cap == 16
    flow1, *_ = make_engine(PORT_PKG, vals, max_batch=17, device="cpu")
    assert flow1._verifier_shards() == 1 and flow1._drain_cap == 17 and flow1.verifier.mesh is None


def test_engine_rebuild_past_capacity_stays_on_the_mesh():
    """A rotation to a set past the verifier's capacity rebuilds the
    verifier on the same mesh; mesh_devices 0 and 1 mean one device."""
    vals, _ = _port_valset(4)
    flow, *_ = make_engine(PORT_PKG, vals, mesh_devices=4, device="cpu")
    base = flow.verifier
    assert base.capacity == 4
    bigger, _ = _port_valset(6, tag=b"big")
    flow.update_state(2, bigger)
    assert flow.last_rotation["restaged"] is False and flow.height == 2
    assert flow.verifier is not base and flow.verifier.mesh is base.mesh
    assert flow.verifier._n_shards == 4 and flow.verifier.capacity == 8
    assert len(flow.verifier._stage.tables_dev) == 4
    for n in (0, 1):
        one, *_ = make_engine(PORT_PKG, vals, mesh_devices=n, device="cpu")
        assert one.verifier.mesh is None and one._verifier_shards() == 1


@pytest.fixture
def two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def test_make_mesh_takes_distinct_cards_and_raises_on_too_few(two_cards):
    mesh = pm.make_mesh(2)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert pm.make_mesh().size == 2  # default: every visible card
    for n in (3, 4, 8):
        with pytest.raises(RuntimeError, match=f"a mesh of {n} CUDA cards .* 2 are visible"):
            pm.make_mesh(n)
    assert pm.make_mesh(3, device="cpu").size == 3


def test_engine_with_more_mesh_cards_than_visible_raises(two_cards):
    vals, _ = _port_valset(4)
    with pytest.raises(RuntimeError, match="a mesh of 4 CUDA cards .* 2 are visible"):
        make_engine(PORT_PKG, vals, mesh_devices=4)


def test_no_cuda_mesh_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vals, _ = _port_valset(4)
    with pytest.raises(RuntimeError, match="0 are visible"):
        pm.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceVoteVerifier(vals, mesh=pm.Mesh(("cuda:0", "cuda:1")))
    with pytest.raises(ValueError, match="not both"):
        DeviceVoteVerifier(vals, device="cpu", mesh=pm.make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="all CUDA cards or all CPU"):
        pm.Mesh(("cpu", "cuda:0"))
