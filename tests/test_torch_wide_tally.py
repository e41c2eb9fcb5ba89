"""PyTorch port, the int64 stake tally: a validator set of total power
>= 2^30 is served on the device verifier (the plain versions of
``tally64``, ``tally_partial64`` and ``reduce_quorum64`` on the CPU),
where the JAX engine serves it on its host ``ScalarVoteVerifier``. The
port's engine, on one device and at 2 CPU shards, against the JAX engine
on the same shuffled adversarial votes: certificate bytes, commit order,
app digest, uncommitted stake and pool contents identical (tolerance 0).
Also the int64 plain versions and the packed layout against int64 numpy
sums, the width chosen per stage (int32 below 2^30), and the one bound
left: a total of 2^62 or more raises."""

import hashlib
import random

import numpy as np
import pytest
import torch

import txflow_tpu.types as jtypes

import txflow_tpu_torch.types as ptypes
from test_torch_engine import JAX_PKG, PORT_PKG, make_engine
from txflow_tpu_torch.ops import tally
from txflow_tpu_torch.verifier import MAX_TOTAL_POWER, WIDE_TALLY_POWER, DeviceVoteVerifier

CHAIN_ID = "txflow-test"  # test_torch_engine's chain


def _stream(power):
    """7 validators at ``power`` each, 10 txs with 2-7 votes each, about
    15% zeroed signatures, shuffled (seeded)."""
    rng = random.Random(43)
    nrng = np.random.default_rng(43)
    pvs = [jtypes.MockPV(seed=nrng.bytes(32)) for _ in range(7)]
    vals_j = jtypes.ValidatorSet([jtypes.Validator.from_pub_key(pv.get_pub_key(), power) for pv in pvs])
    vals_p = ptypes.ValidatorSet([ptypes.Validator.from_pub_key(pv.get_pub_key(), power) for pv in pvs])
    txs = [b"wtx%d=%d" % (i, i) for i in range(10)]
    stream = []
    for tx in txs:
        for vi in rng.sample(range(7), rng.randint(2, 7)):
            key = hashlib.sha256(tx).digest()
            vote = jtypes.TxVote(height=1, tx_hash=key.hex().upper(), tx_key=key,
                                 timestamp_ns=1_700_000_000_000_000_000,
                                 validator_address=pvs[vi].get_address())
            pvs[vi].sign_tx_vote(CHAIN_ID, vote)
            if rng.random() < 0.15:
                vote.signature = bytes(64)
            stream.append(vote)
    rng.shuffle(stream)
    return txs, stream, vals_j, vals_p


def _port_vote(v):
    return ptypes.TxVote(v.height, v.tx_hash, v.tx_key, v.timestamp_ns, v.validator_address, v.signature)


def _run(pkg, vals, txs, stream, **cfg):
    flow, mempool, pool, store, app = make_engine(pkg, vals, **cfg)
    for tx in txs:
        mempool.check_tx(tx)
    for v in stream:
        try:  # zeroed signatures share one pool key: later ones bounce, on both sides
            pool.check_tx(_port_vote(v) if pkg is PORT_PKG else v.copy())
        except Exception:
            pass
    steps = 0
    while flow.step():
        steps += 1
    return flow, pool, store, app, steps


def _outcome(flow, pool, store, app, txs):
    return dict(
        digest=app.digest, state=app.state, tx_count=app.tx_count,
        order=store.committed_hashes_in_order(),
        certs=[store.db.get(b"H:" + hashlib.sha256(tx).hexdigest().upper().encode()) for tx in txs],
        stake={h: vs.stake() for h, vs in flow.vote_sets.items()},
        pool=pool.size(),
    )


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX engine on its host verifier (the set is past its int32
    device tally), one serial step of 17 votes at a time."""
    txs, stream, vals_j, vals_p = _stream(2**28)
    assert vals_p.total_voting_power() >= WIDE_TALLY_POWER
    flow, pool, store, app, steps = _run(JAX_PKG, vals_j, txs, stream, max_batch=17, use_device=False)
    out = _outcome(flow, pool, store, app, txs)
    assert 0 < out["tx_count"] < len(txs) and out["stake"]
    return txs, stream, vals_p, out, steps


@pytest.mark.parametrize("mesh_devices", [0, 2])
def test_wide_set_serves_on_the_device_verifier_like_the_jax_engine(jax_ref, mesh_devices):
    txs, stream, vals_p, want, steps_j = jax_ref
    cfg = dict(max_batch=17, device="cpu")
    if mesh_devices:
        cfg["mesh_devices"] = mesh_devices
    flow, pool, store, app, steps = _run(PORT_PKG, vals_p, txs, stream, **cfg)
    assert isinstance(flow.verifier, DeviceVoteVerifier) and flow.verifier._stage.wide
    assert flow.verifier._stage.powers_dev[0].dtype == torch.int64 if mesh_devices else (
        flow.verifier._stage.powers_dev.dtype == torch.int64)
    assert flow.verifier._n_shards == max(1, mesh_devices)
    got = _outcome(flow, pool, store, app, txs)
    assert got == want
    if not mesh_devices:  # a 2-shard engine drains 16 (17 rounded down to a shard multiple)
        assert steps == steps_j
    assert max(got["stake"].values()) >= 2**30  # a pending stake past int32's tally range


def test_stage_width_follows_the_set_and_the_int64_bound_raises():
    """int32 below 2^30 (the existing kernels), int64 from 2^30; a restage
    picks the width of the new set; a total of 2^62 raises (an int64 sum
    of prior and batch stake could overflow), 2^62 - 1 serves."""
    _txs, _stream_, _vj, small = _stream(10)
    dv = DeviceVoteVerifier(small, device="cpu")
    assert not dv._stage.wide and dv._stage.powers_dev.dtype == torch.int32
    big = ptypes.ValidatorSet([ptypes.Validator(v.address, v.pub_key, 2**28) for v in small])
    assert dv.restage(big) and dv._stage.wide and dv._stage.powers_dev.dtype == torch.int64
    assert dv.restage(small) and not dv._stage.wide
    vs = list(small)
    edge = ptypes.ValidatorSet([ptypes.Validator(v.address, v.pub_key, 2**59) for v in vs[:7]]
                               + [ptypes.Validator(vs[0].address[:-1] + b"\x00", vs[0].pub_key, 2**59 - 1)])
    assert edge.total_voting_power() == MAX_TOTAL_POWER - 1
    assert DeviceVoteVerifier(edge, device="cpu")._stage.wide
    over = ptypes.ValidatorSet([ptypes.Validator(v.address, v.pub_key, 2**59) for v in vs[:7]]
                               + [ptypes.Validator(vs[0].address[:-1] + b"\x00", vs[0].pub_key, 2**59)])
    assert over.total_voting_power() == MAX_TOTAL_POWER
    with pytest.raises(ValueError, match="2\\^62"):
        DeviceVoteVerifier(over, device="cpu")
    with pytest.raises(ValueError, match="2\\^62"):
        dv.restage(over)
    assert not dv._stage.wide and dv.val_set.hash() == small.hash()  # the old stage stays whole


def test_int64_plain_versions_and_packed_layout():
    """The plain tally, partial and reduction in int64 against numpy int64
    sums past 2^31; the packed vector holds the stake as 2S int32 words
    (low, high) and reads back through ``packed_stake``."""
    rng = np.random.default_rng(9)
    b, s, v = 96, 12, 5
    valid = torch.from_numpy(rng.integers(0, 2, b).astype(bool))
    slot = torch.from_numpy(rng.integers(-1, s + 1, b).astype(np.int32))
    vidx = torch.from_numpy(rng.integers(0, v, b).astype(np.int32))
    powers = torch.from_numpy((rng.integers(1, 4, v) * 2**40).astype(np.int64))
    prior = torch.from_numpy(rng.integers(0, 2**41, s).astype(np.int64))
    want = prior.numpy().copy()
    for i in range(b):
        if valid[i] and 0 <= slot[i] < s:
            want[slot[i]] += int(powers[vidx[i]])
    quorum = int(np.sort(want)[s // 2])  # half the slots at quorum
    stake, maj = tally.tally_plain(valid, slot, vidx, powers, prior, quorum)
    assert stake.dtype == torch.int64 and (stake.numpy() == want).all()
    assert (maj.numpy() == (want >= quorum)).all() and 0 < int(maj.sum()) < s
    part = tally.tally_partial(valid.to(torch.int32), slot, vidx, powers, s)
    assert part.dtype == torch.int64 and (part.numpy() == want - prior.numpy()).all()
    st, mj = tally.reduce_quorum(torch.stack([part, part]), prior, quorum)
    assert (st.numpy() == prior.numpy() + 2 * part.numpy()).all()
    words = torch.zeros(2 * s, dtype=torch.int32)
    mj_out = torch.zeros(s, dtype=torch.int32)
    tally.reduce_quorum(part[None], prior, quorum, words, mj_out)
    assert (words.view(torch.int64).numpy() == want).all() and (mj_out == maj).all()
    packed = torch.cat([valid.to(torch.int32), stake.view(torch.int32), maj])
    assert packed.shape[0] == tally.packed_size(b, s, True) == b + 3 * s
    for p in (packed, packed.numpy()):
        st2, mj2 = tally.packed_stake(p, b, s, True)
        assert (np.asarray(st2) == want).all() and (np.asarray(mj2) == maj.numpy()).all()
    # the int32 form is the same functions on int32 tensors
    st32, _ = tally.tally_plain(valid, slot, vidx, powers.div(2**40, rounding_mode="floor").to(torch.int32),
                                torch.zeros(s, dtype=torch.int32), 1)
    assert st32.dtype == torch.int32 and not tally.is_wide(st32)
