"""Shared rigs of the port's catch-up sync tests (not a test module): the
same committed history in both packages' stores, and scripted peers and
switches that record what a reactor or a manager sends."""

import hashlib

import numpy as np

import txflow_tpu.store as jstore
import txflow_tpu.types as jtypes
from txflow_tpu.state.store import StateStore as JStateStore

import txflow_tpu_torch.store as pstore
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.state import StateStore

CHAIN = "unit-chain"


def jax_set(tag: bytes, n: int, power: int = 10):
    """``n`` seeded JAX signers and their validator set."""
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(tag).digest()[:4], "little"))
    pvs = [jtypes.MockPV(rng.bytes(32)) for _ in range(n)]
    return pvs, jtypes.ValidatorSet([jtypes.Validator.from_pub_key(pv.get_pub_key(), power)
                                     for pv in pvs])


def port_set(jset):
    return ptypes.ValidatorSet(
        [ptypes.Validator(v.address, v.pub_key, v.voting_power, v.proposer_priority) for v in jset]
    )


def signed_votes(pvs, tx: bytes, height: int, chain: str = CHAIN):
    key = hashlib.sha256(tx).digest()
    out = []
    for pv in pvs:
        v = jtypes.TxVote(height=height, tx_hash=key.hex().upper(), tx_key=key,
                          timestamp_ns=1_700_000_000_000_000_000 + height,
                          validator_address=pv.get_address())
        pv.sign_tx_vote(chain, v)
        out.append(v)
    return out


def port_votes(votes):
    return [ptypes.TxVote(v.height, v.tx_hash, v.tx_key, v.timestamp_ns, v.validator_address,
                          v.signature) for v in votes]


class History:
    """``n_txs`` committed txs (3 of 4 validators' votes each, tx sizes
    varied) in a JAX and a port TxStore, byte-identical rows; the rows of
    the txs in ``missing`` lack their tx bytes. ``records``: heights whose
    full set both state stores hold."""

    def __init__(self, n_txs: int = 12, missing=(), records=(0,), tag: bytes = b"history",
                 height: int = 0):
        self.pvs, self.jvals = jax_set(tag, 4)
        self.pvals = port_set(self.jvals)
        self.js, self.ps = jstore.TxStore(jstore.MemDB()), pstore.TxStore(pstore.MemDB())
        self.jss, self.pss = JStateStore(jstore.MemDB()), StateStore(pstore.MemDB())
        for h in records:
            self.jss.save_validators(h, self.jvals)
            self.pss.save_validators(h, self.pvals)
        self.txs = []
        for i in range(n_txs):
            tx = b"hist%d=%s" % (i, b"x" * (40 * (i % 3)))
            votes = signed_votes(self.pvs[i % 2 : i % 2 + 3], tx, height)
            pv_ = port_votes(votes)
            jvs = jtypes.TxVoteSet(CHAIN, height, votes[0].tx_hash, votes[0].tx_key, self.jvals)
            pvs_ = ptypes.TxVoteSet(CHAIN, height, votes[0].tx_hash, votes[0].tx_key, self.pvals)
            for a, b in zip(votes, pv_):
                jvs.add_verified_vote(a)
                pvs_.add_verified_vote(b)
            keep = tx if i not in missing else None
            self.js.save_tx(jvs, votes=votes, tx=keep)
            self.ps.save_tx(pvs_, votes=pv_, tx=keep)
            self.txs.append(tx)
        self.hashes = [hashlib.sha256(t).hexdigest().upper() for t in self.txs]


class FakePeer:
    """A peer that records every frame sent to it; ``on_send(frame)`` may
    answer (a scripted server)."""

    def __init__(self, node_id: str = "server", on_send=None, accept: bool = True):
        self.node_id = node_id
        self.sent: list[tuple[int, bytes]] = []
        self.on_send = on_send
        self.accept = accept

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        self.sent.append((chan_id, msg))
        if self.on_send is not None:
            self.on_send(msg)
        return self.accept


class FakeSwitch:
    def __init__(self, peers=()):
        self._peers = list(peers)

    def peers(self):
        return list(self._peers)


class StubFlow:
    """The engine seam the manager applies through: records the applies."""

    def __init__(self, vals, store=None):
        self.val_set = vals
        self.applied = []
        self.store = store

    def apply_synced_commit(self, vs, votes, tx):
        if self.store is not None:
            if self.store.has_tx(vs.tx_hash):
                return False
            self.store.save_tx(vs, votes=votes, tx=tx)
        self.applied.append(vs.tx_hash)
        return True


class RecordingManager:
    """Stands in for a SyncManager behind a reactor: records the calls."""

    def __init__(self):
        self.calls = []

    def note_status(self, node_id, seq_count, height):
        self.calls.append(("status", node_id, seq_count, height))

    def note_peer_gone(self, node_id):
        self.calls.append(("gone", node_id))

    def note_response(self, node_id, *resp):
        req_id, start, advert, entries, snapshots = resp
        snaps = {h: tuple((v.address, v.pub_key, v.voting_power, v.proposer_priority)
                          for v in vs) for h, vs in snapshots.items()}
        self.calls.append(("response", node_id, req_id, start, advert, entries, snaps))

    def note_served(self, n):
        self.calls.append(("served", n))
