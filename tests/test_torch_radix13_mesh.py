"""PyTorch port, the sharded step over the radix-2^13 field (K8): the
port's ``sharded_compact_step_packed(mesh, fe_radix=13)`` over 2 CPU
shards (the plain versions of the radix-13 verify and of the partial
tally and reduction) against the JAX package's default-radix
``sharded_compact_step_packed_cached(make_mesh(8))`` on the batch and
shapes of ``tests/test_torch_mesh.py`` (28 votes padded to 32, 8 slots,
nonzero prior): valid, stake and maj23 equal (tolerance 0). A verify
mask and a tally do not depend on the field, so JAX's default field is
the reference (``tests/test_fe13.py`` holds its two fields together)."""

import numpy as np
import torch

from test_torch_mesh import B, N_SLOTS, N_VOTES, _unpack
from test_verifier import make_batch, make_valset
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu.parallel import make_mesh as jax_make_mesh
from txflow_tpu.parallel.mesh import sharded_compact_step_packed_cached
from txflow_tpu_torch import convert
from txflow_tpu_torch.parallel import mesh as pm


def test_two_shard_radix13_step_matches_jax_mesh():
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
    want = _unpack(sharded_compact_step_packed_cached(jax_make_mesh(8))(
        *vote, epoch.tables, powers, prior, np.int32(quorum)), 8)

    tables, quarters, powers_p = convert.epoch_from_jax(epoch.tables, powers, fe_radix=13)
    assert tables.shape[-1] == 20
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in vote] + [
        torch.from_numpy(tables), torch.from_numpy(quarters), torch.from_numpy(powers_p),
        torch.from_numpy(prior), quorum]
    mesh = pm.make_mesh(2, device="cpu")
    parts = pm.sharded_compact_step_packed(mesh, fe_radix=13)(*args)
    assert [p.shape for p in parts] == [(B // 2 + 2 * N_SLOTS,)] * 2
    got = _unpack(pm.to_host(parts).numpy(), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < want[0].sum() < N_VOTES and 0 < want[2].sum() < 7
