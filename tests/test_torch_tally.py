"""PyTorch port, stake tally and the fused step (K4): the packed
``[valid | stake | maj23]`` readback of the port's step (plain versions on
the CPU, the operations of txflow_tpu_torch/csrc/tally.cu) against the JAX
package's ``compact_step_packed``, and the port's DeviceVoteVerifier
against the JAX one, with replays and prior stake. Tolerance 0 (int32)."""

import numpy as np
import jax.numpy as jnp
import torch

from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu.ops import tally as jtally
from txflow_tpu.types import Validator as JValidator
from txflow_tpu.types import ValidatorSet as JValidatorSet
from txflow_tpu.verifier import DeviceVoteVerifier as JDeviceVoteVerifier
from txflow_tpu_torch import convert
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import tally
from txflow_tpu_torch.types import Validator, ValidatorSet
from txflow_tpu_torch.verifier import DeviceVoteVerifier, ScalarVoteVerifier

RNG = np.random.default_rng(0x7A)


def test_tally_kernel_matches_jax():
    b, s = 64, 16
    valid = RNG.random(b) < 0.7
    slot = RNG.integers(-2, s + 3, b).astype(np.int32)  # out-of-range + padding
    power = RNG.integers(1, 100, b).astype(np.int32)
    want = np.asarray(
        jtally.tally_kernel(jnp.asarray(valid), jnp.asarray(slot), jnp.asarray(power), s)
    )
    got = tally.tally_kernel(
        torch.from_numpy(valid), torch.from_numpy(slot), torch.from_numpy(power), s
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _keys(n):
    seeds = [RNG.bytes(32) for _ in range(n)]
    return seeds, [host_ed.public_key_from_seed(sd) for sd in seeds]


def test_compact_step_packed_matches_jax():
    """One padded 64-vote step over 4 validators with prior stake: the
    packed vector is identical, valid, stake and maj23 segments alike."""
    seeds, pubs = _keys(4)
    n, b, s = 40, 64, 64
    vidx = RNG.integers(0, 4, n)
    msgs = [RNG.bytes(30) for _ in range(n)]
    sigs = [host_ed.sign(seeds[v], m) for v, m in zip(vidx, msgs)]
    for i in range(0, n, 5):  # corrupt some
        sigs[i] = bytes(64)
    jepoch = jeb.EpochTables(pubs)
    batch = jeb._prepare_compact_np(msgs, sigs, vidx, jepoch)

    def pad(a):
        return np.concatenate([a, np.zeros((b - n,) + a.shape[1:], a.dtype)])

    vote_args = [pad(x) for x in (batch.s_nibbles, batch.h_nibbles, batch.val_idx,
                                  batch.r_y, batch.r_sign, batch.pre_ok)]
    slot = np.full(b, -1, np.int32)
    slot[:n] = RNG.integers(0, 12, n)
    powers = np.array([10, 20, 30, 40], np.int32)
    prior = np.zeros(s, np.int32)
    prior[:12] = RNG.integers(0, 40, 12)
    quorum = 67
    want = np.asarray(jtally.compact_step_packed_jit()(
        *(jnp.asarray(a) for a in vote_args), jnp.asarray(slot),
        jnp.asarray(jepoch.tables), jnp.asarray(powers), jnp.asarray(prior),
        jnp.int32(quorum),
    ))
    tables, quarters, pw = convert.epoch_from_jax(jepoch.tables, powers)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in vote_args]
    got = tally.compact_step_packed(
        *t, torch.from_numpy(slot), torch.from_numpy(tables), torch.from_numpy(quarters),
        torch.from_numpy(pw), torch.from_numpy(prior), quorum,
    )
    assert got.dtype == torch.int32 and got.shape == (b + 2 * s,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[b + s : b + s + 12].any()  # some slot reached quorum
    # the unpacked form (JAX compact_step's three results are the packed
    # vector's segments, tally.py:114)
    valid, stake, maj = tally.compact_step(
        *t, torch.from_numpy(slot), torch.from_numpy(tables), torch.from_numpy(quarters),
        torch.from_numpy(pw), torch.from_numpy(prior), quorum,
    )
    assert valid.dtype == torch.bool and maj.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), want[:b].astype(bool))
    np.testing.assert_array_equal(stake.numpy(), want[b : b + s])
    np.testing.assert_array_equal(maj.numpy(), want[b + s :].astype(bool))


def _sets(powers):
    seeds, pubs = _keys(len(powers))
    port = ValidatorSet([Validator.from_pub_key(p, w) for p, w in zip(pubs, powers)])
    jax_ = JValidatorSet([JValidator.from_pub_key(p, w) for p, w in zip(pubs, powers)])
    by_addr = dict(zip([Validator.from_pub_key(p, 1).address for p in pubs], seeds))
    return port, jax_, [by_addr[v.address] for v in port]


def test_device_verifier_matches_jax_with_replays_and_prior():
    port_vals, jax_vals, seeds = _sets([10, 10, 10, 10])
    n_slots = 9
    msgs, sigs, vidx, slots = [], [], [], []
    for i in range(44):
        v, s = int(RNG.integers(4)), int(RNG.integers(n_slots))
        m = b"tx%d-%d" % (s, v)
        sig = host_ed.sign(seeds[v], m)
        if i % 7 == 3:
            sig = sig[:10] + bytes([sig[10] ^ 1]) + sig[11:]
        msgs.append(m)
        sigs.append(sig)
        vidx.append(v)
        slots.append(s)
    # replays: the same (slot, validator) vote again, later in the batch
    for i in (0, 1, 2):
        msgs.append(msgs[i])
        sigs.append(sigs[i])
        vidx.append(vidx[i])
        slots.append(slots[i])
    vidx, slots = np.array(vidx), np.array(slots, np.int32)
    prior = RNG.integers(0, 30, n_slots)
    want = JDeviceVoteVerifier(jax_vals).verify_and_tally(
        msgs, sigs, vidx, slots, n_slots, prior_stake=prior
    )
    got = DeviceVoteVerifier(port_vals, device="cpu").verify_and_tally(
        msgs, sigs, vidx, slots, n_slots, prior_stake=prior
    )
    scalar = ScalarVoteVerifier(port_vals).verify_and_tally(
        msgs, sigs, vidx, slots, n_slots, prior_stake=prior
    )
    for res in (want, scalar):
        for f in ("valid", "stake", "maj23", "dropped"):
            np.testing.assert_array_equal(getattr(got, f), getattr(res, f), err_msg=f)
    assert got.dropped.sum() >= 3 and got.maj23.any() and not got.maj23.all()
