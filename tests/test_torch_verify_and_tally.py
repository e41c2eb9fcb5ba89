"""PyTorch port, the unfused verify + tally composition and the tally
pieces of the sharded step (K7): ``ops.tally.verify_and_tally(
verify_kernel)`` on one device against the JAX package's
``jit(verify_and_tally(verify_kernel))`` (computed once: one jit
compile), and the plain versions of the partial tally, the reduction and
the ring hop (the operations of csrc/tally.cu) against JAX
``tally_kernel`` and numpy. Inputs from seeded generators; tolerance 0
(integers and bools)."""

import jax
import numpy as np
import pytest
import torch

from test_verifier import make_batch, make_valset
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu.ops import tally as jtally
from txflow_tpu_torch import convert
from txflow_tpu_torch.ops import ed25519_batch as eb
from txflow_tpu_torch.ops import tally

N_SLOTS = 8


def _inputs():
    """K5 inputs of 28 votes (4 validators x 7 txs; flipped, wrong-key and
    out-of-set votes mixed in), per-vote power, prior stake, quorum."""
    vals, seeds = make_valset(4)
    msgs, sigs, vidx, slot = make_batch(
        vals, seeds, n_txs=7, corrupt=("ok", "flip", "ok", "wrongkey", "badidx")
    )
    epoch = jeb.EpochTables([v.pub_key for v in vals])
    jbatch = jeb.prepare_batch(msgs, sigs, vidx, epoch)
    power = vals.powers_array().astype(np.int32)[np.clip(vidx, 0, 3)]
    prior = np.zeros(N_SLOTS, np.int32)
    prior[:7] = [0, 25, 0, 0, 10, 0, 0]
    return jbatch, np.asarray(slot, np.int32), power, prior, int(vals.quorum_power())


@pytest.fixture(scope="module")
def ref():
    jbatch, slot, power, prior, quorum = _inputs()
    vin = (jbatch.s_nibbles, jbatch.h_nibbles, jbatch.a_tables, jbatch.r_y,
           jbatch.r_sign, jbatch.pre_ok)
    valid, stake, maj = jax.jit(jtally.verify_and_tally(jeb.verify_kernel))(
        vin, slot, power, prior, np.int32(quorum)
    )
    return (jbatch, slot, power, prior, quorum,
            (np.asarray(valid), np.asarray(stake), np.asarray(maj)))


def _port_inputs(jbatch):
    conv = convert.prepared_batch_from_jax(jbatch)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        conv.s_nibbles, conv.h_nibbles, conv.a_tables, conv.r_y, conv.r_sign, conv.pre_ok))


def test_verify_and_tally_matches_jax(ref):
    jbatch, slot, power, prior, quorum, (valid, stake, maj) = ref
    got = tally.verify_and_tally(eb.verify_kernel)(
        _port_inputs(jbatch), torch.from_numpy(slot), torch.from_numpy(power),
        torch.from_numpy(prior), quorum,
    )
    np.testing.assert_array_equal(got[0].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), stake)
    np.testing.assert_array_equal(got[2].numpy(), maj)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    assert 0 < valid.sum() < valid.size and 0 < maj.sum() < N_SLOTS  # not vacuous


def _tally_case(seed, b=200, s=16, v=9):
    rng = np.random.default_rng(seed)
    valid = rng.random(b) < 0.7
    slot = rng.integers(-2, s + 2, b).astype(np.int32)  # some outside [0, s)
    powers = rng.integers(1, 1000, v).astype(np.int32)
    vidx = rng.integers(0, v, b).astype(np.int32)
    return valid, slot, powers, vidx, s


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_partial_tally_matches_jax_tally_kernel(seed):
    valid, slot, powers, vidx, s = _tally_case(seed)
    power = powers[vidx]
    want = np.asarray(jtally.tally_kernel(valid, slot, power, s))
    t = torch.from_numpy
    by_vote = tally.tally_partial(t(valid.astype(np.int32)), t(slot), None, t(power), s)
    by_index = tally.tally_partial(t(valid.astype(np.int32)), t(slot), t(vidx), t(powers), s)
    np.testing.assert_array_equal(by_vote.numpy(), want)
    np.testing.assert_array_equal(by_index.numpy(), want)
    assert by_vote.dtype == torch.int32


@pytest.mark.parametrize("n", [1, 2, 5])
def test_reduce_quorum_and_ring_add_plain(n):
    rng = np.random.default_rng(n)
    parts = rng.integers(0, 1 << 20, (n, 32)).astype(np.int32)
    prior = rng.integers(0, 1 << 20, 32).astype(np.int32)
    quorum = int(np.median(prior + parts.sum(0)))
    stake, maj = tally.reduce_quorum(torch.from_numpy(parts), torch.from_numpy(prior), quorum)
    want = prior.astype(np.int64) + parts.astype(np.int64).sum(0)
    np.testing.assert_array_equal(stake.numpy(), want)
    np.testing.assert_array_equal(maj.numpy(), (want >= quorum).astype(np.int32))
    # into given destinations (the packed segments), as on a card
    packed = torch.full((64,), -7, dtype=torch.int32)
    tally.reduce_quorum(torch.from_numpy(parts), torch.from_numpy(prior), quorum,
                        packed[:32], packed[32:])
    np.testing.assert_array_equal(packed[:32].numpy(), want)
    # the ring hop accumulates in place into a buffer its caller owns
    acc = torch.from_numpy(parts[0].copy())
    total = tally.ring_add(acc, torch.from_numpy(prior))
    assert total is acc
    np.testing.assert_array_equal(total.numpy(), parts[0].astype(np.int64) + prior)
