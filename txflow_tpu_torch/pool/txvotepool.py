"""TxVotePool: pending TxVotes (reference txvotepool/txvotepool.go).

Semantics kept from the reference:
- dedup key is **sha256(signature)** (:467-469) -- two votes for the same tx
  by the same validator but different sign-bytes are distinct pool entries;
- size / total-bytes caps checked before the cache (:198-208);
- max single-vote size derived from the gossip msg cap (:211);
- a cache hit records the new sender for in-pool votes, then rejects
  (:213-228);
- ``update(height, votes)`` pushes committed votes into the cache and
  removes them from the pool (:329-359);
- ``txs_available()``: an event set once per height when the pool holds
  votes, after ``enable_txs_available()`` (:146-152, the JAX package's
  ``txflow_tpu/pool/txvotepool.py:156-162,449-452``).

The engine consumes through ``entries_from`` (a stable-cursor walk that
does not remove: removal happens on commit/purge, like the reference's
checkMaj23Routine walking the CList without popping).

Lanes (``txflow_tpu/pool/txvotepool.py:65-103,229-258,490-546``): a vote
takes its tx's admission lane through the ``lane_of_vote`` hook, read once
at ingest and frozen on the entry. Priority votes also enter a priority
ingest log, so ``priority_entries_from`` and ``bulk_entries_from`` (the
main log without them) partition the pool exactly; a priority vote that
meets a full pool evicts the oldest bulk vote.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..types import TxVote, encode_tx_vote
from ..utils.cache import LRUCache
from ..utils.config import MempoolConfig
from .base import COMPACT_THRESHOLD, IngestLogPool
from .mempool import LANE_PRIORITY, ErrMempoolIsFull, ErrTxInCache, ErrTxTooLarge, TxInfo

UNKNOWN_PEER_ID = 0

# amino overhead allowance for a wrapped vote message (reference
# calcMaxTxSize subtracts the TxMessage envelope from MaxMsgBytes).
_MSG_OVERHEAD = 8


def vote_key(vote: TxVote) -> bytes:
    """sha256(signature) -- the reference's txVoteKey (:467-469)."""
    return vote.vote_key()


@dataclass(slots=True)
class _PoolVote:
    height: int
    vote: TxVote
    senders: set[int] = field(default_factory=set)
    size: int = 0  # encoded wire size, cached so removals never re-encode
    # ingest-time lane (LANE_PRIORITY or -1), frozen so that the priority
    # log and bulk_entries_from stay an exact partition of the main log
    # even if the hook's answer drifts later (a tx leaving the mempool)
    lane: int = -1


class TxVotePool(IngestLogPool):
    def __init__(self, config: MempoolConfig, height: int = 0):
        super().__init__()
        self.config = config
        self.height = height
        self._votes: dict[bytes, _PoolVote] = self._items  # vote_key -> entry
        self._votes_bytes = 0
        self.cache = LRUCache(config.cache_size)
        # vote lanes: lane_of_vote is the hook (vote -> lane; a node wires
        # the mempool's lane_of_key over the vote's tx_key); a hook fault
        # demotes to bulk. The priority log has the main log's design.
        self.lane_of_vote = None
        self._prio_log: list[bytes] = []
        self._prio_log_base = 0  # absolute position of _prio_log[0]
        self._txs_available = threading.Event()
        self._notified_txs_available = False
        self._notify_available = False

    def size(self) -> int:
        with self._mtx:
            return len(self._votes)

    def has(self, key: bytes) -> bool:
        with self._mtx:
            return key in self._votes

    def txs_available(self) -> threading.Event:
        self._notify_available = True
        return self._txs_available

    def enable_txs_available(self) -> None:
        self._notify_available = True

    def _notify_txs_available(self) -> None:
        """Set the event once per height (call under self._mtx)."""
        if self._notify_available and not self._notified_txs_available:
            self._notified_txs_available = True
            self._txs_available.set()

    def _lane_quiet(self, vote: TxVote) -> int:
        """lane_of_vote with a hook fault demoted to bulk (any error, or no
        hook, is -1)."""
        if self.lane_of_vote is None:
            return -1
        try:
            return self.lane_of_vote(vote)
        except Exception:
            return -1

    def _evict_bulk_locked(self) -> bool:
        """Evict the oldest bulk vote to make room for a priority vote
        (under _mtx, pool full): a bounced priority vote is a quorum
        signature lost. The evicted vote leaves the dedup cache too, so a
        later delivery can bring it back. The hook is asked again here, as
        in the JAX package."""
        for k, e in self._votes.items():
            if self._lane_quiet(e.vote) == LANE_PRIORITY:
                continue
            self._votes.pop(k)
            self._votes_bytes -= e.size
            self.cache.remove(k)
            return True
        return False

    # -- ingest (reference CheckTx/CheckTxWithInfo :180-261) --

    def check_tx(self, vote: TxVote, tx_info: TxInfo | None = None) -> None:
        """Raises on rejection; returns None when the vote entered the pool."""
        with self._mtx:
            self._ingest_locked(vote, tx_info or TxInfo(UNKNOWN_PEER_ID))
            self._notify_txs_available()

    def check_tx_many(
        self, votes: list[TxVote], tx_info: TxInfo | None = None
    ) -> list[Exception | None]:
        """Batched ingest: check_tx's decisions in order, errors returned
        instead of raised, in bounded lock groups of 64 votes."""
        tx_info = tx_info or TxInfo(UNKNOWN_PEER_ID)
        out: list[Exception | None] = [None] * len(votes)
        for base in range(0, len(votes), 64):
            with self._mtx:
                for i in range(base, min(base + 64, len(votes))):
                    try:
                        self._ingest_locked(votes[i], tx_info, notify=False)
                    except (ErrMempoolIsFull, ErrTxTooLarge, ErrTxInCache) as e:
                        out[i] = e
                self._cond.notify_all()
                if self._votes:
                    self._notify_txs_available()
        return out

    def _ingest_locked(self, vote: TxVote, tx_info: TxInfo, notify: bool = True) -> None:
        vote_size = len(encode_tx_vote(vote))
        lane = self._lane_quiet(vote)
        while (
            len(self._votes) >= self.config.size
            or vote_size + self._votes_bytes > self.config.max_txs_bytes
        ):
            if lane != LANE_PRIORITY or not self._evict_bulk_locked():
                break
        if (
            len(self._votes) >= self.config.size
            or vote_size + self._votes_bytes > self.config.max_txs_bytes
        ):
            raise ErrMempoolIsFull(
                len(self._votes), self.config.size,
                self._votes_bytes, self.config.max_txs_bytes,
            )
        max_size = self.config.max_msg_bytes - _MSG_OVERHEAD
        if vote_size > max_size:
            raise ErrTxTooLarge(max_size, vote_size)
        key = vote_key(vote)
        if not self.cache.push(key):
            entry = self._votes.get(key)
            if entry is not None:
                entry.senders.add(tx_info.sender_id)
            raise ErrTxInCache()
        self._votes[key] = _PoolVote(self.height, vote, {tx_info.sender_id}, vote_size, lane)
        self._log_append(key, notify)
        if lane == LANE_PRIORITY:
            self._prio_log.append(key)
        self._votes_bytes += vote_size

    # -- consumption --

    def entries_from(self, cursor: int, limit: int = 256):
        """Stable-cursor walk of live votes: (key, vote, height) tuples;
        see IngestLogPool._entries_from for the cursor contract."""
        raw, pos = self._entries_from(cursor, limit)
        return [(k, e.vote, e.height) for k, e in raw], pos

    def prio_seq(self) -> int:
        """Monotonic priority-ingest counter (seq()'s twin for the priority
        log): prio_seq minus a cursor over-counts only removed entries not
        yet walked."""
        with self._mtx:
            return self._prio_log_base + len(self._prio_log)

    def bulk_entries_from(self, cursor: int, limit: int = 256):
        """entries_from over bulk votes only: the main-log walk, skipping
        entries whose ingest-time lane was priority (the priority log
        delivers those). The cursor still advances over skipped and dead
        entries."""
        out = []
        with self._mtx:
            pos = max(cursor, self._log_base)
            while pos - self._log_base < len(self._log) and len(out) < limit:
                key = self._log[pos - self._log_base]
                e = self._votes.get(key)
                if e is not None and e.lane != LANE_PRIORITY:
                    out.append((key, e.vote, e.height))
                pos += 1
        return out, pos

    def priority_entries_from(self, cursor: int, limit: int = 256):
        """entries_from over priority votes only, walking the priority
        ingest log: O(priority backlog), however deep the bulk backlog."""
        out = []
        with self._mtx:
            pos = max(cursor, self._prio_log_base)
            while pos - self._prio_log_base < len(self._prio_log) and len(out) < limit:
                key = self._prio_log[pos - self._prio_log_base]
                e = self._votes.get(key)
                if e is not None:
                    out.append((key, e.vote, e.height))
                pos += 1
        return out, pos

    def _prio_compact(self) -> None:
        """_log_compact's twin for the priority log (call under _mtx)."""
        log = self._prio_log
        n = 0
        while n < len(log) and log[n] not in self._votes:
            n += 1
        if n >= COMPACT_THRESHOLD:
            del log[:n]
            self._prio_log_base += n

    def remove(self, keys: list[bytes]) -> None:
        """Remove votes by key (votes that can never be added)."""
        with self._mtx:
            for k in keys:
                entry = self._votes.pop(k, None)
                if entry is not None:
                    self._votes_bytes -= entry.size
            self._log_compact()
            self._prio_compact()

    # -- update on commit (reference Update :329-359) --

    def update(self, height: int, votes: list[TxVote]) -> None:
        with self._mtx:
            self.height = height
            self._notified_txs_available = False
            self._txs_available.clear()
            for v in votes:
                k = vote_key(v)
                self.cache.push(k)  # committed votes stay cached
                entry = self._votes.pop(k, None)
                if entry is not None:
                    self._votes_bytes -= entry.size
            self._log_compact()
            self._prio_compact()
            if self._votes:
                self._notify_txs_available()
