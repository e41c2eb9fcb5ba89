"""TxStore: durable store of fast-path-committed transactions.

Reference tx/store.go:28-163 — rows keyed ``H:<txhash>`` (the TxVoteSet)
and ``C:<txhash>`` (the Commit certificate), plus a height-watermark JSON
under ``TxStoreHeight``. Values here use the framework's deterministic
codec (votes are amino-compatible; the envelope is length-prefixed
concatenation) — the storage format is node-internal in the reference too.
Load methods raise on undecodable rows (probable disk corruption), like
the reference's panics.
"""

from __future__ import annotations

import json
import threading

from ..codec import amino
from ..types import Commit, CommitSig, TxVote, TxVoteSet, decode_tx_vote, encode_tx_vote
from ..types.validator import ValidatorSet
from .db import DB

_HEIGHT_KEY = b"TxStoreHeight"


def _tx_key(tx_hash: str) -> bytes:
    return b"H:" + tx_hash.encode()


def _commit_key(tx_hash: str) -> bytes:
    return b"C:" + tx_hash.encode()


def _encode_votes(votes: list[TxVote]) -> bytes:
    out = bytearray()
    for v in votes:
        out += amino.length_prefixed(encode_tx_vote(v))
    return bytes(out)


def _decode_votes(data: bytes) -> list[TxVote]:
    votes, off = [], 0
    while off < len(data):
        ln, off = amino.read_uvarint(data, off)
        votes.append(decode_tx_vote(data[off : off + ln]))
        off += ln
    return votes


class TxStore:
    def __init__(self, db: DB):
        self.db = db
        self._mtx = threading.Lock()
        self._height = self._load_height()
        self._seq = self._load_seq()

    def _load_height(self) -> int:
        raw = self.db.get(_HEIGHT_KEY)
        if raw is None:
            return 0
        return json.loads(raw)["height"]

    def _load_seq(self) -> int:
        raw = self.db.get(b"TxStoreSeq")
        return json.loads(raw)["seq"] if raw is not None else 0

    def height(self) -> int:
        with self._mtx:
            return self._height

    # -- save (reference :83-107) --

    def save_tx(
        self,
        vote_set: TxVoteSet,
        commit: Commit | None = None,
        votes: list[TxVote] | None = None,
        tx: bytes | None = None,
    ) -> None:
        """votes: the caller's already-materialized vote_set.get_votes()
        copy, so the commit path doesn't re-copy the set. tx: the raw tx
        bytes when the caller has them -- stored under T:, as in the JAX
        package."""
        if vote_set is None:
            raise ValueError("TxStore can only save a non-nil TxVoteSet")
        with self._mtx:
            rows, sync = self._rows_for(vote_set, commit, votes, tx)
            self.db.set_many(rows, sync=sync)

    def save_txs_batch(self, items: list[tuple]) -> None:
        """Certificate rows for a whole committer wake in one db write
        group (``txflow_tpu/store/tx_store.py:92``): one store lock, one
        ``set_many``. Rows and their order equal per-item ``save_tx``
        calls. Items are (vote_set, votes) or (vote_set, votes, tx)."""
        if not items:
            return
        with self._mtx:
            rows: list[tuple[bytes, bytes]] = []
            sync = False
            for item in items:
                vote_set, votes = item[0], item[1]
                tx = item[2] if len(item) > 2 else None
                if vote_set is None:
                    raise ValueError("TxStore can only save a non-nil TxVoteSet")
                r, s = self._rows_for(vote_set, None, votes, tx)
                rows.extend(r)
                sync = sync or s
            self.db.set_many(rows, sync=sync)

    def save_tx_bytes(self, tx_hash: str, tx: bytes) -> None:
        """Late tx-bytes row for a certificate saved before the bytes
        arrived (deferred-apply resolution)."""
        self.db.set(b"T:" + tx_hash.encode(), tx)

    def _rows_for(
        self,
        vote_set: TxVoteSet,
        commit: Commit | None,
        votes: list[TxVote] | None,
        tx: bytes | None = None,
    ) -> tuple[list[tuple[bytes, bytes]], bool]:
        """Rows for one certificate (call under self._mtx). Returns
        (rows, needs_fsync) — fsync when the height watermark advanced
        (the durability point, reference tx/store.go SaveTx)."""
        tx_hash = vote_set.tx_hash
        if votes is None:
            votes = vote_set.get_votes()
        hash_b = tx_hash.encode()
        rows: list[tuple[bytes, bytes]] = [(b"H:" + hash_b, _encode_votes(votes))]
        if tx is not None:
            rows.append((b"T:" + hash_b, tx))
        if commit is None and vote_set.has_two_thirds_majority():
            # the commit certificate is exactly the set's votes (a
            # TxVoteSet only ever holds votes for its own tx), so the
            # row would be byte-identical to H: — load_tx_commit falls
            # back to the H: row instead of storing the blob twice
            pass
        elif commit is not None:
            rows.append(
                (
                    b"C:" + hash_b,
                    _encode_votes([cs.to_vote() for cs in commit.commits]),
                )
            )
        # commit-order log: S:<seq> -> tx_hash, so crash recovery can
        # replay fast-path commits in the exact order they happened
        # (the reference stores no order; its recovery story for the
        # fast path is correspondingly incomplete — SURVEY §0)
        if not self.db.has(b"O:" + hash_b):
            rows.append((b"S:%016d" % self._seq, hash_b))
            rows.append((b"O:" + hash_b, b"%d" % self._seq))
            self._seq += 1
            rows.append((b"TxStoreSeq", b'{"seq": %d}' % self._seq))
        sync = False
        h = vote_set.height()
        if h > self._height:
            self._height = h
            rows.append((_HEIGHT_KEY, b'{"height": %d}' % h))
            sync = True
        return rows, sync

    # -- load (reference :54-80) --

    def load_tx_votes(self, tx_hash: str) -> list[TxVote] | None:
        """The saved votes for a tx hash, or None if unknown."""
        raw = self.db.get(_tx_key(tx_hash))
        if raw is None:
            return None
        return _decode_votes(raw)

    def load_tx_commit(self, tx_hash: str) -> Commit | None:
        raw = self.db.get(_commit_key(tx_hash))
        if raw is None:
            # quorum certificates are stored once under H: (identical vote
            # list — see save_tx); a distinct C: row exists only for
            # explicitly supplied commits
            raw = self.db.get(_tx_key(tx_hash))
        if raw is None:
            return None
        votes = _decode_votes(raw)
        return Commit(tx_hash, [CommitSig.from_vote(v) for v in votes])

    def has_tx(self, tx_hash: str) -> bool:
        return self.db.has(_tx_key(tx_hash))

    def committed_hashes_in_order(self) -> list[str]:
        """Tx hashes in fast-path commit order (crash-recovery replay)."""
        out = []
        for _, v in self.db.iterate(b"S:", b"S;"):
            out.append(v.decode())
        return out

    # -- catch-up sync reads (sync/reactor.py serves from these) --

    def seq_count(self) -> int:
        """Number of fast-path commits in the order log: the node's
        advertised sync height."""
        with self._mtx:
            return self._seq

    def committed_range(self, start: int, count: int) -> list[tuple[int, str]]:
        """(seq, tx_hash) pairs of the commit-order log with seq in
        [start, start+count); missing seqs are absent."""
        if count <= 0 or start < 0:
            return []
        lo = b"S:%016d" % start
        hi = b"S:%016d" % (start + count)
        return [(int(k[2:]), v.decode()) for k, v in self.db.iterate(lo, hi)]

    def load_cert_row(self, tx_hash: str) -> bytes | None:
        """The raw H: certificate row, byte-identical to what this node
        committed (sync serves it verbatim)."""
        return self.db.get(_tx_key(tx_hash))

    def load_tx_bytes(self, tx_hash: str) -> bytes | None:
        return self.db.get(b"T:" + tx_hash.encode())
