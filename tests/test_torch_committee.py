"""PyTorch port, committee certificates: the port's sampler, schedule and
BatchCertVerifier (device="cpu", i.e. the plain verify kernel) against the
JAX package's, on the same inputs made from a numpy seed. Every output is
bytes, bools or ints: tolerance 0. The JAX side runs as
tests/test_committee.py runs it, with BatchCertVerifier's jitted gather
kernel on the CPU."""

import hashlib

import numpy as np
import pytest

import txflow_tpu.committee as jcom
import txflow_tpu.epoch as jepoch
import txflow_tpu.ops.ed25519_batch as jed
import txflow_tpu.types as jtypes
from txflow_tpu.types.tx_vote import canonical_sign_bytes

import txflow_tpu_torch.committee as pcom
import txflow_tpu_torch.epoch as pepoch
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch import convert
from txflow_tpu_torch.committee.certverify import _rung
from txflow_tpu_torch.ops import ed25519_batch as ped

CHAIN = "txflow-committee-test"


def _sets(n, powers, tag):
    """The same validator set in both packages, keys from a numpy seed."""
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(tag).digest()[:4], "little"))
    pvs = [jtypes.MockPV(rng.bytes(32)) for _ in range(n)]
    jvals = jtypes.ValidatorSet(
        [jtypes.Validator.from_pub_key(pv.get_pub_key(), p) for pv, p in zip(pvs, powers)]
    )
    pvals = ptypes.ValidatorSet(
        [ptypes.Validator.from_pub_key(pv.get_pub_key(), p) for pv, p in zip(pvs, powers)]
    )
    by_addr = {pv.get_address(): pv for pv in pvs}
    return [by_addr[v.address] for v in jvals], jvals, pvals


def _members(vs):
    return [(v.address, v.pub_key, v.voting_power) for v in vs]


@pytest.mark.parametrize(
    "n,powers,size,min_size,frac",
    [
        (12, "uniform", 4, 4, 0.0),
        (11, "whale", 3, 4, 0.0),
        (8, "uniform", 2, 2, 0.75),  # the stake floor binds
        (8, "uniform", 2, 4, 0.0),  # the size floor binds
        (8, "uniform", 8, 4, 0.0),  # covers the set: the set itself
        (40, "longtail", 6, 4, 0.5),
    ],
)
def test_sampler_matches_jax(n, powers, size, min_size, frac):
    pw = {
        "uniform": [10] * n,
        "whale": [100] + [10] * (n - 1),
        "longtail": [1 + (1000 // (i + 1)) for i in range(n)],
    }[powers]
    _pvs, jvals, pvals = _sets(n, pw, b"sampler-%d" % n)
    assert _members(jvals) == _members(pvals)
    for chain in ("chain-a", CHAIN):
        for epoch in range(6):
            assert pcom.committee_seed(chain, epoch) == jcom.committee_seed(chain, epoch)
            j = jcom.sample_committee(jvals, chain, epoch, size, min_size=min_size, min_stake_frac=frac)
            p = pcom.sample_committee(pvals, chain, epoch, size, min_size=min_size, min_stake_frac=frac)
            assert _members(p) == _members(j)
            assert (p is pvals) == (j is jvals)
    assert pcom.SEED_DOMAIN == jcom.SEED_DOMAIN
    for length in (0, 1, 4):
        jcfg = jepoch.EpochConfig(length=length, committee_size=size,
                                  committee_min_size=min_size, committee_min_stake_frac=frac)
        pcfg = pepoch.EpochConfig(length=length, committee_size=size,
                                  committee_min_size=min_size, committee_min_stake_frac=frac)
        assert pcfg.committee_enabled() == jcfg.committee_enabled()
        js, ps = jcom.CommitteeSchedule(CHAIN, jcfg), pcom.CommitteeSchedule(CHAIN, pcfg)
        for h in range(10):
            assert pcfg.epoch_of(h) == jcfg.epoch_of(h)
            assert ps.epoch_for_vote_height(h) == js.epoch_for_vote_height(h)
            assert _members(ps.for_vote_height(h, pvals)) == _members(js.for_vote_height(h, jvals))
        assert ps.for_vote_height(2, pvals) is ps.for_vote_height(2, pvals)


def _batch(pvs, vals, spec, height=1):
    """(msgs, sigs, val_idx, tx_slot, n_slots) from (slot, member, corrupt)
    triples (the helper of tests/test_committee.py)."""
    msgs, sigs, vidx, slot = [], [], [], []
    idx = {v.address: i for i, v in enumerate(vals)}
    for s, pi, corrupt in spec:
        tx = b"cparity-%d=v" % s
        key = hashlib.sha256(tx).digest()
        v = jtypes.TxVote(height=height, tx_hash=key.hex().upper(), tx_key=key,
                          timestamp_ns=1_700_000_000_000_000_000,
                          validator_address=pvs[pi].get_address())
        pvs[pi].sign_tx_vote(CHAIN, v)
        sig = bytearray(v.signature)
        if corrupt:
            sig[corrupt % 64] ^= 0xFF
        msgs.append(canonical_sign_bytes(CHAIN, height, v.tx_hash, v.timestamp_ns))
        sigs.append(bytes(sig))
        vidx.append(idx[pvs[pi].get_address()])
        slot.append(s)
    n_slots = max(s for s, _, _ in spec) + 1
    return msgs, sigs, np.array(vidx), np.array(slot), n_slots


def _random_spec(rng, n_rows, n_vals, n_slots):
    """Seeded Byzantine mix: about 1/4 corrupted signatures (R or S
    bytes), repeated (slot, validator) rows, every slot drawn from."""
    spec = []
    for _ in range(n_rows):
        corrupt = int(rng.choice([0, 0, 0, 5, 40]))
        spec.append((int(rng.integers(n_slots)), int(rng.integers(n_vals)), corrupt))
    return spec


def _assert_same(p, j):
    for field in ("valid", "stake", "maj23", "dropped"):
        pa, ja = np.asarray(getattr(p, field)), np.asarray(getattr(j, field))
        assert pa.dtype.kind == ja.dtype.kind and np.array_equal(pa, ja), (
            f"{field}: port {pa} vs JAX {ja}"
        )


def _counters(v):
    return (v.batch_calls, v.scalar_calls, v.batched_votes)


CASES = {
    # the spec of tests/test_committee.py::test_batch_cert_verifier_decision_parity
    "spec": [(0, 0, 0), (0, 1, 0), (0, 2, 0), (1, 0, 0), (1, 1, 5),
             (2, 0, 0), (2, 0, 0), (2, 1, 0), (3, 3, 0)],
    "byzantine_rung8": ("random", 7, 3),
    "byzantine_rung64": ("random", 33, 9),
    "small_batch": [(0, 0, 0), (0, 1, 0), (0, 2, 40)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_cert_verifier_matches_jax(case):
    pvs, jvals, pvals = _sets(4, [10] * 4, b"bcv")
    spec = CASES[case]
    if spec[0] == "random":
        rng = np.random.default_rng(len(case) * 7919 + spec[1])
        spec = _random_spec(rng, spec[1], 4, spec[2])
    batch = _batch(pvs, jvals, spec)
    n = len(batch[0])
    jv = jcom.BatchCertVerifier(jvals, min_batch=4)
    pv = pcom.BatchCertVerifier(pvals, min_batch=4, device="cpu")
    _assert_same(pv.verify_and_tally(*batch), jv.verify_and_tally(*batch))
    # the quorum override and prior stake take the same path
    prior = np.arange(batch[4], dtype=np.int64) * 3
    _assert_same(pv.verify_and_tally(*batch, quorum=20, prior_stake=prior),
                 jv.verify_and_tally(*batch, quorum=20, prior_stake=prior))
    assert _counters(pv) == _counters(jv)
    if case == "small_batch":
        assert pv.scalar_calls == 2 and pv.batch_calls == 0
    else:
        assert pv.batch_calls == 2 and pv.scalar_calls == 0 and pv.batched_votes == 2 * n
    if case == "byzantine_rung8":
        assert _rung(n) == 8
    if case == "byzantine_rung64":
        assert _rung(n) == 64


def test_rung_matches_jax():
    from txflow_tpu.committee.certverify import _rung as jrung

    for n in list(range(0, 70)) + [1000, 1024, 1025, 8192, 16384]:
        assert _rung(n) == jrung(n)


def test_batch_cert_verifier_restage_matches_jax():
    """A committee swap restages the tables in place; the next call
    verifies under the new committee; a same-set restage keeps the staged
    tables (no rebuild, no upload)."""
    pvs, jvals, pvals = _sets(8, [10] * 8, b"brestage")
    jc = [jcom.sample_committee(jvals, CHAIN, e, 4) for e in (0, 1)]
    pc = [pcom.sample_committee(pvals, CHAIN, e, 4) for e in (0, 1)]
    assert _members(jc[0]) != _members(jc[1])
    by_addr = {pv.get_address(): pv for pv in pvs}
    jv = jcom.BatchCertVerifier(jc[0], min_batch=4)
    pv = pcom.BatchCertVerifier(pc[0], min_batch=4, device="cpu")
    for e in (0, 1):
        members = [by_addr[v.address] for v in jc[e]]
        # 2 txs x 3 members, plus one vote of the OTHER epoch's committee
        # signed under this epoch's index (it must not verify)
        spec = [(s, m, 0) for s in range(2) for m in range(3)]
        batch = list(_batch(members, jc[e], spec))
        outsider = [by_addr[v.address] for v in jc[1 - e] if not jc[e].has_address(v.address)][0]
        extra = _batch([outsider], jc[1 - e], [(0, 0, 0)])
        batch[0] = batch[0] + extra[0]
        batch[1] = batch[1] + extra[1]
        batch[2] = np.append(batch[2], 3)
        batch[3] = np.append(batch[3], 1)
        jr, pr = jv.verify_and_tally(*batch), pv.verify_and_tally(*batch)
        _assert_same(pr, jr)
        assert bool(pr.valid[:6].all()) and bool(pr.maj23.all()) and not pr.valid[6]
        if e == 0:
            tables0 = pv._stage[4]
            assert pv.restage(pc[0]) is True
            assert pv._stage[4] is tables0  # same set: no new upload
            assert jv.restage(jc[1]) is True and pv.restage(pc[1]) is True
            assert pv._stage[4] is not tables0
    assert _counters(pv) == _counters(jv) == (2, 0, 14)


def test_batch_cert_verifier_failed_restage_keeps_stage(monkeypatch):
    """A restage whose table upload fails raises and leaves the old stage
    whole: the host loop (under min_batch) and the kernel path both go on
    verifying against the old committee, as the JAX verifier that was
    never restaged does."""
    pvs, jvals, pvals = _sets(8, [10] * 8, b"brestage")
    jc = [jcom.sample_committee(jvals, CHAIN, e, 4) for e in (0, 1)]
    pc = [pcom.sample_committee(pvals, CHAIN, e, 4) for e in (0, 1)]
    by_addr = {pv.get_address(): pv for pv in pvs}
    jv = jcom.BatchCertVerifier(jc[0], min_batch=4)
    pv = pcom.BatchCertVerifier(pc[0], min_batch=4, device="cpu")
    stage = pv._stage

    def failing_upload(self, device):
        raise RuntimeError("upload failed")

    monkeypatch.setattr(ped.EpochTables, "device_tables", failing_upload)
    with pytest.raises(RuntimeError, match="upload failed"):
        pv.restage(pc[1])
    assert pv._stage is stage and pv.val_set is pc[0]
    members = [by_addr[v.address] for v in jc[0]]
    for spec in ([(s, m, 0) for s in range(2) for m in range(3)], [(0, 0, 0), (0, 1, 40)]):
        batch = _batch(members, jc[0], spec)
        _assert_same(pv.verify_and_tally(*batch), jv.verify_and_tally(*batch))
    assert _counters(pv) == _counters(jv) == (1, 1, 6)


def test_epoch_from_jax_on_committee_tables():
    """The committee's window tables: the JAX package's [V, 16, 4, 32]
    radix-2^8 tables, carried into the port's layout, equal the port's own
    and what BatchCertVerifier stages (V = committee size, unpadded)."""
    _pvs, jvals, pvals = _sets(12, [10 + i for i in range(12)], b"ctables")
    jc = jcom.sample_committee(jvals, CHAIN, 3, 5)
    pc = pcom.sample_committee(pvals, CHAIN, 3, 5)
    jt = jed.EpochTables([v.pub_key for v in jc])
    tables, quarters, powers = convert.epoch_from_jax(np.asarray(jt.tables), jc.powers_array())
    own = ped.EpochTables([v.pub_key for v in pc])
    assert tables.shape == (5, 16, 4, 10) and np.array_equal(tables, own.tables)
    assert np.array_equal(quarters, own.quarter_tables)
    assert np.array_equal(powers, pc.powers_array().astype(np.int32))
    assert np.array_equal(own.key_ok, np.asarray(jt.key_ok))
    staged = pcom.BatchCertVerifier(pc, device="cpu")._stage[4]
    assert staged.shape[0] == pc.size() and np.array_equal(staged.numpy(), tables)
