"""PyTorch port, catch-up sync: the port's wire codec, serving function and
certificate re-check (SyncManager._verify_apply in committee mode, one
BatchCertVerifier launch per epoch group, device="cpu") against the JAX
package's, on the same inputs made from a numpy seed. Outputs are bytes,
bools, ints and messages: tolerance 0. The verify cases mirror
tests/test_sync.py:565-645."""

import hashlib

import numpy as np
import pytest

import txflow_tpu.abci as jabci
import txflow_tpu.committee as jcom
import txflow_tpu.engine as jengine
import txflow_tpu.epoch as jepoch
import txflow_tpu.pool as jpool
import txflow_tpu.store as jstore
import txflow_tpu.types as jtypes
from txflow_tpu.state.store import StateStore as JStateStore
from txflow_tpu.store.tx_store import _encode_votes
from txflow_tpu.sync import wire as jwire
from txflow_tpu.sync.config import SyncConfig as JSyncConfig
from txflow_tpu.sync.manager import SyncError as JSyncError
from txflow_tpu.sync.manager import SyncManager as JSyncManager
from txflow_tpu.sync.reactor import SyncReactor
from txflow_tpu.utils.config import EngineConfig as JEngineConfig
from txflow_tpu.utils.config import MempoolConfig as JMempoolConfig

import txflow_tpu_torch.abci as pabci
import txflow_tpu_torch.committee as pcom
import txflow_tpu_torch.engine as pengine
import txflow_tpu_torch.epoch as pepoch
import txflow_tpu_torch.pool as ppool
import txflow_tpu_torch.store as pstore
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.state import StateStore
from txflow_tpu_torch.sync import SyncConfig, SyncError, SyncManager, serve_range, wire
from txflow_tpu_torch.utils.config import EngineConfig, MempoolConfig

CHAIN = "unit-chain"


def _set(tag, n, power=10):
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(tag).digest()[:4], "little"))
    pvs = [jtypes.MockPV(rng.bytes(32)) for _ in range(n)]
    return pvs, jtypes.ValidatorSet([jtypes.Validator.from_pub_key(pv.get_pub_key(), power) for pv in pvs])


def _port_set(jset):
    return ptypes.ValidatorSet(
        [ptypes.Validator(v.address, v.pub_key, v.voting_power, v.proposer_priority) for v in jset]
    )


def _fp(vs):
    return tuple((v.address, v.voting_power) for v in vs)


def _votes(pvs, tx, height):
    key = hashlib.sha256(tx).digest()
    out = []
    for pv in pvs:
        v = jtypes.TxVote(height=height, tx_hash=key.hex().upper(), tx_key=key,
                          timestamp_ns=1_700_000_000_000_000_000 + height,
                          validator_address=pv.get_address())
        pv.sign_tx_vote(CHAIN, v)
        out.append(v)
    return out


def _entry(votes, tx):
    return (votes[0].tx_hash, _encode_votes(votes), tx)


# -- wire codec --


def test_wire_bytes_match_jax():
    _pvs, jvals = _set(b"wire", 3)
    jvals.validators[1].proposer_priority = -7  # carried through the JSON
    pvals = _port_set(jvals)
    assert wire.encode_status(12345, 67) == jwire.encode_status(12345, 67)
    assert wire.encode_range_req(9, 1024, 64) == jwire.encode_range_req(9, 1024, 64)
    entries = [("AA" * 32, b"cert-blob-1", b"tx-bytes-1"), ("BB" * 32, b"", b"")]
    frame = jwire.encode_range_resp(7, 100, 250, entries, {4: jvals, 0: jvals})
    assert wire.encode_range_resp(7, 100, 250, entries, {0: pvals, 4: pvals}) == frame
    req, start, advert, got, snaps = wire.decode_range_resp(frame)
    assert (req, start, advert, got) == (7, 100, 250, entries)
    assert sorted(snaps) == [0, 4]
    assert [(v.address, v.pub_key, v.voting_power, v.proposer_priority) for v in snaps[4]] == [
        (v.address, v.pub_key, v.voting_power, v.proposer_priority) for v in jvals
    ]
    assert wire.decode_status(jwire.encode_status(5, 6)) == (5, 6)
    assert wire.decode_range_req(jwire.encode_range_req(1, 2, 3)) == (1, 2, 3)


# -- the serving side --


def _stores(n_txs=12, missing=()):
    """The same committed history in both packages' TxStores (certificate
    rows, tx bytes, commit-order log) and state stores (the full set on
    record at each vote height)."""
    pvs, jvals = _set(b"serve", 4)
    pvals = _port_set(jvals)
    js, ps = jstore.TxStore(jstore.MemDB()), pstore.TxStore(pstore.MemDB())
    jss, pss = JStateStore(jstore.MemDB()), StateStore(pstore.MemDB())
    for h in (1, 2):
        jss.save_validators(h, jvals)
        pss.save_validators(h, pvals)
    for i in range(n_txs):
        tx = b"serve%d=%s" % (i, b"x" * (40 * (i % 3)))
        height = 1 + i // (n_txs // 2)
        votes = _votes(pvs[: 3 + i % 2], tx, height)
        jvs = jtypes.TxVoteSet(CHAIN, height, votes[0].tx_hash, votes[0].tx_key, jvals)
        pvs_ = ptypes.TxVoteSet(CHAIN, height, votes[0].tx_hash, votes[0].tx_key, pvals)
        pvotes = [ptypes.TxVote(v.height, v.tx_hash, v.tx_key, v.timestamp_ns,
                                v.validator_address, v.signature) for v in votes]
        for a, b in zip(votes, pvotes):
            jvs.add_verified_vote(a)
            pvs_.add_verified_vote(b)
        keep_tx = i not in missing
        js.save_tx(jvs, votes=votes, tx=tx if keep_tx else None)
        ps.save_tx(pvs_, votes=pvotes, tx=tx if keep_tx else None)
    return (js, jss, jvals), (ps, pss, pvals)


@pytest.mark.parametrize(
    "start,count,max_range,max_bytes,missing",
    [
        (0, 64, 256, 512 * 1024, ()),  # everything
        (3, 64, 4, 512 * 1024, ()),  # max_range clamps
        (0, 64, 256, 2000, ()),  # byte cap: append then check
        (2, 64, 256, 512 * 1024, (7,)),  # a row it cannot serve: advert lowered
        (20, 5, 256, 512 * 1024, ()),  # past the log
    ],
)
def test_serve_range_matches_jax(start, count, max_range, max_bytes, missing):
    (js, jss, _jv), (ps, pss, _pv) = _stores(missing=missing)
    assert ps.seq_count() == js.seq_count() == 12
    assert ps.committed_range(start, count) == js.committed_range(start, count)
    reactor = SyncReactor(js, jss, config=JSyncConfig(max_range=max_range, max_resp_bytes=max_bytes))
    want = reactor._serve_range(5, start, count)
    advert, entries, snaps = serve_range(
        ps, SyncConfig(max_range=max_range, max_resp_bytes=max_bytes), start, count,
        pss.load_validators,
    )
    assert wire.encode_range_resp(5, start, advert, entries, snaps) == want
    if missing:
        assert advert == missing[0] and len(entries) == missing[0] - start
    if max_bytes == 2000:
        assert sum(len(c) + len(t) for _h, c, t in entries) >= 2000 and len(entries) < 12


# -- the certificate re-check in committee mode --


class _JFlow:
    def __init__(self, vals):
        self.val_set = vals
        self.applied = []

    def apply_synced_commit(self, vs, votes, tx):
        self.applied.append(vs.tx_hash)
        return True


class _Peer:
    node_id = "server"


def _managers(jfull, committee_size, trusted=None, records=()):
    """A JAX and a port SyncManager in committee mode (EpochConfig(length=1),
    so vote height h is epoch h), each with a state store holding the full
    set at ``records`` heights."""
    pfull = _port_set(jfull)
    jss, pss = JStateStore(jstore.MemDB()), StateStore(pstore.MemDB())
    for h in records:
        jss.save_validators(h, jfull)
        pss.save_validators(h, pfull)
    jtv = trusted if trusted is not None else jfull
    jm = JSyncManager(
        CHAIN, jstore.TxStore(jstore.MemDB()), _JFlow(jtv), switch=None, state_store=jss,
        config=JSyncConfig(),
        committee=jcom.CommitteeSchedule(CHAIN, jepoch.EpochConfig(length=1, committee_size=committee_size)),
    )
    pm = SyncManager(
        CHAIN, pstore.TxStore(pstore.MemDB()), _JFlow(_port_set(jtv)), state_store=pss,
        committee=pcom.CommitteeSchedule(CHAIN, pepoch.EpochConfig(length=1, committee_size=committee_size)),
        device="cpu",
    )
    return jm, pm


def _committee_case(case):
    """(full set, entries, snapshots, records, trusted) for one case: an
    8-validator set, committees of 4 sampled per epoch (vote heights 3 and
    5 draw different committees)."""
    pvs, full = _set(b"vfull", 8)
    by_addr = {pv.get_address(): pv for pv in pvs}
    sched = jcom.CommitteeSchedule(CHAIN, jepoch.EpochConfig(length=1, committee_size=4))
    com = {h: [by_addr[v.address] for v in sched.for_vote_height(h, full)] for h in (3, 5)}
    assert set(com[3]) != set(com[5])
    outsider = next(pv for pv in pvs if pv not in com[3])
    entries = []
    for h in (3, 5):
        for i in range(2):
            tx = b"sync-%d-%d=v" % (h, i)
            entries.append((h, _votes(com[h][i : i + 3], tx, h), tx))
    snaps = {3: full, 5: full}
    h, votes, tx = entries[1]
    if case == "forged":
        votes[1].signature = votes[1].signature[:9] + bytes([votes[1].signature[9] ^ 4]) + votes[1].signature[10:]
    elif case == "duplicate":
        votes.append(votes[0].copy())
    elif case == "below_quorum":
        del votes[2]
    elif case == "mixed_height":
        votes[2:] = _votes([com[3][3]], tx, 5)
    elif case == "unknown_validator":
        votes[2:] = _votes([outsider], tx, 3)
    elif case == "wrong_tx_bytes":
        entries[1] = (h, votes, tx + b"!")
    elif case == "snapshot_mismatch":
        snaps = {3: _set(b"claimant", 8)[1], 5: full}
    return full, [(v[0].tx_hash, _encode_votes(v), t) for _h, v, t in entries], snaps, (3, 5), None


def _endorse_case(case):
    """tests/test_sync.py's endorsement rigs in committee mode: committees
    of 4 over 4-validator sets are the sets themselves."""
    old_pvs, old = _set(b"epoch-old", 4)
    if case == "endorsed":
        new_pvs = old_pvs[:3] + _set(b"epoch-new", 1)[0]
        new = jtypes.ValidatorSet([jtypes.Validator.from_pub_key(pv.get_pub_key(), 10) for pv in new_pvs])
    else:
        new_pvs, new = _set(b"usurper", 4)
    tx = b"rotated=v"
    return old, [_entry(_votes(new_pvs, tx, 7), tx)], {7: new}, (), old


CASES = ["honest", "forged", "duplicate", "below_quorum", "mixed_height",
         "unknown_validator", "wrong_tx_bytes", "snapshot_mismatch", "endorsed", "unendorsed"]


@pytest.mark.parametrize("case", CASES)
def test_verify_apply_matches_jax(case):
    build = _endorse_case if case in ("endorsed", "unendorsed") else _committee_case
    full, entries, snaps, records, trusted = build(case)
    jm, pm = _managers(full, 4, trusted=trusted, records=records)
    psnaps = {h: _port_set(v) for h, v in snaps.items()}
    jerr = perr = None
    try:
        japplied = jm._verify_apply(_Peer(), entries, snaps)
    except JSyncError as e:
        jerr = e
    try:
        papplied = pm._verify_apply("server", entries, psnaps)
    except SyncError as e:
        perr = e
    assert (jerr is None) == (perr is None)
    if jerr is not None:
        assert str(perr) == str(jerr) and perr.byzantine == jerr.byzantine
    else:
        assert papplied == japplied == len(entries)
    assert pm.txflow.applied == jm.txflow.applied
    assert {h: _fp(v) for h, v in pm._trusted_vals.items()} == {
        h: _fp(v) for h, v in jm._trusted_vals.items()
    }
    for h in (3, 5, 7):
        a, b = pm.state_store.load_validators(h), jm.state_store.load_validators(h)
        assert (a is None) == (b is None) and (a is None or _fp(a) == _fp(b))
    counters = [
        tuple(sum(getattr(v, k) for v in m._verifiers.values())
              for k in ("batch_calls", "scalar_calls", "batched_votes"))
        for m in (jm, pm)
    ]
    assert counters[0] == counters[1]
    expect = {
        "honest": (None, 2),
        "forged": ("invalid signature", 1),
        # a repeated vote is never verified, so it comes back invalid and
        # the invalid-signature check fires before the duplicate check
        "duplicate": ("invalid signature", 1),
        "below_quorum": ("below 2/3+ stake", 1),
        "mixed_height": ("mixing vote heights", 0),
        "unknown_validator": ("unknown validator", 0),
        "wrong_tx_bytes": ("served tx bytes that hash to", 0),
        "snapshot_mismatch": ("claims a different validator set", 0),
        "endorsed": (None, 1),
        "unendorsed": ("no quorum of our trusted set endorses", 1),
    }[case]
    assert (perr is None) == (expect[0] is None)
    if perr is not None:
        assert expect[0] in str(perr) and perr.byzantine == (case != "unendorsed")
    assert counters[1][0] == expect[1] and counters[1][1] == 0


# -- a follower walking a server's log, through both packages' engines --


def _follower(port, vals):
    abci, engine, pool, store = (pabci, pengine, ppool, pstore) if port else (jabci, jengine, jpool, jstore)
    mcfg = MempoolConfig if port else JMempoolConfig
    ecfg = EngineConfig(device="cpu") if port else JEngineConfig(use_device=False)
    conns = abci.AppConns(abci.KVStoreApplication())
    mempool = pool.Mempool(mcfg(cache_size=1000), conns.mempool)
    tx_store = store.TxStore(store.MemDB())
    flow = engine.TxFlow(
        CHAIN, 2, vals, pool.TxVotePool(mcfg(cache_size=1000)), mempool,
        pool.Mempool(mcfg(cache_size=1000)), engine.TxExecutor(conns.consensus, mempool),
        tx_store, config=ecfg,
    )
    return flow, tx_store, conns.app


def test_follower_walk_matches_jax():
    """A follower fetches a server's whole log in byte-capped responses
    (serve_range -> encode -> apply_range_resp) and applies it through
    TxFlow.apply_synced_commit; the JAX follower takes the same frames.
    Both end with the server's certificate rows, order and kv state, and a
    replayed response applies nothing."""
    (js, jss, jvals), (ps, pss, pvals) = _stores()
    sched_cfg = dict(length=1, committee_size=4)  # covers the 4-validator set
    jflow, jstore_, japp = _follower(False, jvals)
    pflow, pstore_, papp = _follower(True, pvals)
    jm = JSyncManager(CHAIN, jstore_, jflow, switch=None, state_store=jss,
                      committee=jcom.CommitteeSchedule(CHAIN, jepoch.EpochConfig(**sched_cfg)))
    pm = SyncManager(CHAIN, pstore_, pflow, state_store=pss,
                     committee=pcom.CommitteeSchedule(CHAIN, pepoch.EpochConfig(**sched_cfg)),
                     device="cpu")
    cfg = SyncConfig(max_range=256, max_resp_bytes=1200)
    start, frames = 0, []
    while start < ps.seq_count():
        frame = wire.encode_range_resp(len(frames), start, *serve_range(ps, cfg, start, 64, pss.load_validators))
        got_start, served, applied = pm.apply_range_resp("server", frame)
        _r, _s, _a, entries, snaps = jwire.decode_range_resp(frame)
        assert got_start == start and applied == served == jm._verify_apply(_Peer(), entries, snaps)
        frames.append(frame)
        start += served
    assert len(frames) == 6  # the byte cap binds at the second entry
    assert pm.apply_range_resp("server", frames[0])[2] == 0  # already applied
    hashes = ps.committed_hashes_in_order()
    assert pstore_.committed_hashes_in_order() == jstore_.committed_hashes_in_order() == hashes
    for h in hashes:
        assert pstore_.load_cert_row(h) == ps.load_cert_row(h) == jstore_.load_cert_row(h)
        assert pstore_.load_tx_bytes(h) == ps.load_tx_bytes(h)
    assert papp.state == japp.state and papp.digest == japp.digest and papp.tx_count == 12
    # one launch per response (one epoch group each); the replay launches none
    assert sum(v.batch_calls for v in pm._verifiers.values()) == len(frames)
