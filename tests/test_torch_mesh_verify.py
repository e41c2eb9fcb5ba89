"""PyTorch port, the gathered-table verify composed with the tally over a
mesh (K5 inside K7): the port's ``sharded_verify_and_tally`` over a mesh
of n CPU entries at n = 1, 2, 4 and 8 against the JAX package's
``sharded_verify_and_tally(make_mesh(8))`` over the 8-device CPU mesh,
computed once (its valid, stake and maj23 do not depend on n). 28 votes
with per-vote tables and power, padded to 32 (pad rows: pre_ok False,
slot -1, power 0), nonzero prior stake. Tolerance 0."""

import numpy as np
import pytest
import torch

from test_verifier import make_batch, make_valset
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu.parallel import make_mesh as jax_make_mesh
from txflow_tpu.parallel.mesh import sharded_verify_and_tally as jax_svt
from txflow_tpu_torch import convert
from txflow_tpu_torch.parallel import mesh as pm

B, N_VOTES, N_SLOTS = 32, 28, 8


@pytest.fixture(scope="module")
def ref():
    vals, seeds = make_valset(4)
    msgs, sigs, vidx, slot = make_batch(
        vals, seeds, n_txs=7, corrupt=("ok", "wrongkey", "ok", "flip", "badidx")
    )
    pad = B - N_VOTES
    msgs, sigs = msgs + [b""] * pad, sigs + [b""] * pad  # short sigs: pre_ok False
    vidx = np.concatenate([vidx, np.zeros(pad, np.int64)])
    jbatch = jeb.prepare_batch(msgs, sigs, vidx, jeb.EpochTables([v.pub_key for v in vals]))
    assert not jbatch.pre_ok[N_VOTES:].any()
    slot = np.concatenate([np.asarray(slot, np.int32), np.full(pad, -1, np.int32)])
    power = vals.powers_array().astype(np.int32)[np.clip(vidx, 0, 3)]
    power[N_VOTES:] = 0
    prior = np.zeros(N_SLOTS, np.int32)
    prior[:7] = [0, 25, 0, 0, 10, 0, 0]
    quorum = int(vals.quorum_power())
    vin = (jbatch.s_nibbles, jbatch.h_nibbles, jbatch.a_tables, jbatch.r_y,
           jbatch.r_sign, jbatch.pre_ok)
    valid, stake, maj = jax_svt(jax_make_mesh(8))(vin, slot, power, prior, np.int32(quorum))
    conv = convert.prepared_batch_from_jax(jbatch)
    t = torch.from_numpy
    port = (tuple(t(np.ascontiguousarray(x)) for x in (
        conv.s_nibbles, conv.h_nibbles, conv.a_tables, conv.r_y, conv.r_sign, conv.pre_ok)),
        t(slot), t(power), t(prior), quorum)
    return port, (np.asarray(valid), np.asarray(stake), np.asarray(maj))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_verify_and_tally_matches_jax(ref, n):
    port, (valid, stake, maj) = ref
    v, st, mj = pm.sharded_verify_and_tally(pm.make_mesh(n, device="cpu"))(*port)
    assert len(v) == len(st) == len(mj) == n
    np.testing.assert_array_equal(pm.to_host(v).numpy(), valid)
    for sh in range(n):  # every shard holds the global tally
        np.testing.assert_array_equal(st[sh].numpy(), stake)
        np.testing.assert_array_equal(mj[sh].numpy(), maj)
    assert 0 < valid.sum() < N_VOTES and 0 < maj.sum() < 7
