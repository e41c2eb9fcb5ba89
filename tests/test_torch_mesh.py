"""PyTorch port, the mesh-sharded fused step (K7): the port's
``sharded_compact_step_packed`` over a mesh of n CPU entries (the plain
versions of the verify, partial-tally and reduce kernels, partials
crossing shards as on cards) at n = 1, 2, 4 and 8 against the JAX
package's ``sharded_compact_step_packed_cached(make_mesh(8))`` over the
8-device CPU mesh, computed once. Valid, stake and maj23 of the JAX step
do not depend on n, so one reference serves every n. The batch is 28
votes padded to 32 (pad rows: pre_ok False, slot -1), with nonzero prior
stake. Outputs are unpacked the way the verifier reads them (valid from
every shard, stake and maj23 from shard 0) and every shard's stake and
maj23 segments must equal shard 0's. Tolerance 0 (int32 and bools)."""

import numpy as np
import pytest
import torch

from test_verifier import make_batch, make_valset
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu.parallel import make_mesh as jax_make_mesh
from txflow_tpu.parallel.mesh import sharded_compact_step_packed_cached
from txflow_tpu_torch import convert
from txflow_tpu_torch.parallel import mesh as pm

B, N_VOTES, N_SLOTS = 32, 28, 8


def _unpack(host, n, s=N_SLOTS):
    rows = np.asarray(host).reshape(n, -1)
    bs = B // n
    for sh in range(1, n):  # the replicated global tally on every shard
        np.testing.assert_array_equal(rows[sh, bs:], rows[0, bs:])
    return rows[:, :bs].reshape(-1), rows[0, bs : bs + s], rows[0, bs + s :]


@pytest.fixture(scope="module")
def ref():
    vals, seeds = make_valset(4)
    msgs, sigs, vidx, slot = make_batch(
        vals, seeds, n_txs=7, corrupt=("ok", "flip", "ok", "wrongkey", "badidx")
    )
    epoch = jeb.EpochTables([v.pub_key for v in vals])
    batch = jeb.prepare_compact(msgs, sigs, vidx, epoch)
    pad = B - N_VOTES

    def p(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    slot = np.concatenate([np.asarray(slot, np.int32), np.full(pad, -1, np.int32)])
    prior = np.zeros(N_SLOTS, np.int32)
    prior[:7] = [0, 25, 0, 0, 10, 0, 0]
    powers = vals.powers_array().astype(np.int32)
    vote = [p(x) for x in (batch.s_nibbles, batch.h_nibbles, batch.val_idx, batch.r_y,
                           batch.r_sign, batch.pre_ok)] + [slot]
    quorum = int(vals.quorum_power())
    packed = sharded_compact_step_packed_cached(jax_make_mesh(8))(
        *vote, epoch.tables, powers, prior, np.int32(quorum)
    )
    want = _unpack(packed, 8)
    tables, powers_p = convert.epoch_from_jax(epoch.tables, powers)
    port_args = [torch.from_numpy(np.ascontiguousarray(x)) for x in vote] + [
        torch.from_numpy(tables), torch.from_numpy(powers_p), torch.from_numpy(prior), quorum]
    return port_args, want


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_packed_step_matches_jax(ref, n):
    args, (valid, stake, maj) = ref
    mesh = pm.make_mesh(n, device="cpu")
    parts = pm.sharded_compact_step_packed(mesh)(*args)
    assert len(parts) == n and all(p.shape == (B // n + 2 * N_SLOTS,) for p in parts)
    host = pm.to_host(parts)
    assert host.shape == (B + 2 * N_SLOTS * n,) and host.dtype == torch.int32
    got = _unpack(host.numpy(), n)
    np.testing.assert_array_equal(got[0], valid)
    np.testing.assert_array_equal(got[1], stake)
    np.testing.assert_array_equal(got[2], maj)
    assert 0 < valid.sum() < N_VOTES and not valid[N_VOTES:].any()
    assert 0 < maj.sum() < 7 and (stake > 0).any()


def test_sharded_step_unpacked_matches_jax(ref):
    """The unpacked form over shards given as per-shard lists."""
    args, (valid, stake, maj) = ref
    mesh = pm.make_mesh(2, device="cpu")
    shards = [mesh.shard(a) for a in args[:7]] + [mesh.replicate(a) for a in args[7:10]]
    v, st, mj = pm.sharded_compact_step(mesh)(*shards, args[10])
    np.testing.assert_array_equal(torch.cat(v).numpy(), valid.astype(bool))
    for sh in range(2):
        np.testing.assert_array_equal(st[sh].numpy(), stake)
        np.testing.assert_array_equal(mj[sh].numpy(), maj.astype(bool))
