"""TxVote reactor: sign mempool txs and gossip the vote pool (channel 0x32),
the counterpart of ``txflow_tpu/reactors/txvote_reactor.py``.

Reference: txvotepool/reactor.go. Two duties:

- ``signTxRoutine`` (:87-138): walk the mempool (the priority lane first);
  if this node's key is in the current validator set (and in the epoch's
  committee, in committee mode), sign a TxVote per fast-path tx at the
  state's last block height and inject it into the local vote pool.
- per-peer broadcast (:198-265): walk the vote pool from a stable cursor,
  suppress votes the peer itself sent us (sender ids, :298-359), throttle
  votes more than one height ahead of the peer ("allow for a lag of 1
  block", :240), and ship what remains.

Votes travel in batched frames, as in the JAX package: ``msg_type u8 |
body``; type 1 body = repeated uvarint-length-prefixed amino TxVotes,
type 2 body = uvarint height (the peer's height for the lag throttle).

Left out: the accountable-gossip ledger's pre-checks and quarantine gate
(``txflow_tpu/reactors/txvote_reactor.py:207-218,283-334,335-347``, the
fault harness's), so the port behaves as the JAX reactor does with
``ledger=None``; trace spans. Where the JAX reactor hands a frame's
unknown segments to its native batch decoder, the port decodes each with
``decode_tx_vote``: the same votes, and a ValueError on the same
segment.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

from ..codec import amino
from ..p2p.base import CHANNEL_TXVOTE, ChannelDescriptor, Reactor
from ..pool.mempool import (
    LANE_PRIORITY,
    ErrMempoolIsFull,
    ErrTxInCache,
    ErrTxTooLarge,
    Mempool,
    TxInfo,
)
from ..pool.txvotepool import TxVotePool
from ..types import TxVote, decode_tx_vote, encode_tx_vote
from ..types.validator import ValidatorSet
from ..utils.cache import LRUMap

MSG_VOTES = 1
MSG_HEIGHT = 2
_MSG_VOTES_B = bytes([MSG_VOTES])

PEER_CATCHUP_SLEEP = 0.005  # reference peerCatchupSleepIntervalMS=100; faster here
PEER_HEIGHT_KEY = "txvote_height"


@dataclass
class StateView:
    """The slice of node state the reactors read (reference reads
    state.State directly, txvotepool/reactor.go:111-115)."""

    chain_id: str
    last_block_height: int
    validators: ValidatorSet
    # committee mode: the epoch's sampled tx-vote committee for votes at
    # last_block_height; None = every validator signs
    committee: ValidatorSet | None = None


def encode_vote_batch(votes: list[TxVote]) -> bytes:
    body = bytearray([MSG_VOTES])
    for v in votes:
        body += amino.length_prefixed(encode_tx_vote(v))
    return bytes(body)


class TxVoteReactor(Reactor):
    # process-wide map of wire segments to decoded votes: gossip delivers
    # each vote 2-3 times, and co-located nodes each receive the same
    # canonical bytes, so the first node to decode a segment shares the
    # immutable vote with the rest. The key is the exact bytes, so a
    # variant encoding misses and pays its own decode; sender bookkeeping
    # stays per node in the pool, whose signature dedup is authoritative.
    # A test that counts decodes clears it first.
    _shared_wire = LRUMap(1 << 16)

    def __init__(
        self,
        get_state: Callable[[], StateView],
        mempool: Mempool,
        tx_vote_pool: TxVotePool,
        priv_val=None,
        broadcast: bool = True,
        batch_size: int = 1024,
        poll_interval: float = 0.05,
        regossip_interval: float | None = None,
    ):
        super().__init__("txvote")
        self.get_state = get_state
        self.mempool = mempool
        self.tx_vote_pool = tx_vote_pool
        self.priv_val = priv_val
        self.broadcast = broadcast
        self.batch_size = batch_size
        self.poll_interval = poll_interval
        # anti-entropy for lossy links: an idle broadcast routine re-walks
        # the live pool every interval (None = the single-pass walk;
        # in-memory pipes lose no frame)
        self.regossip_interval = regossip_interval
        self._running = threading.Event()
        self._peer_ids: dict[str, int] = {}  # node_id -> small int (txVotePoolIDs)
        self._next_peer_id = 1
        self._ids_mtx = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._sign_thread: threading.Thread | None = None
        self._seen_wire = TxVoteReactor._shared_wire

    # -- channels --

    def get_channels(self) -> list[ChannelDescriptor]:
        # priority 5, like the reference (txvotepool/reactor.go:142-149)
        return [ChannelDescriptor(id=CHANNEL_TXVOTE, priority=5)]

    # -- lifecycle --

    def on_start(self) -> None:
        self._running.set()
        self._sign_thread = threading.Thread(
            target=self._sign_tx_routine, name="txvote-sign", daemon=True
        )
        self._sign_thread.start()

    def on_stop(self) -> None:
        self._running.clear()
        if self._sign_thread is not None:
            self._sign_thread.join(timeout=2)
            self._sign_thread = None
        for t in self._threads:
            t.join(timeout=2)
        self._threads = []

    # -- peer management --

    def _peer_id(self, peer) -> int:
        with self._ids_mtx:
            pid = self._peer_ids.get(peer.node_id)
            if pid is None:
                pid = self._next_peer_id
                self._next_peer_id += 1
                self._peer_ids[peer.node_id] = pid
            return pid

    def add_peer(self, peer) -> None:
        self._peer_id(peer)  # reserve (reference ids.ReserveForPeer)
        # tell the peer our height so its lag throttle tracks us
        st = self.get_state()
        peer.try_send(
            CHANNEL_TXVOTE,
            bytes([MSG_HEIGHT]) + amino.uvarint(max(st.last_block_height, 0)),
        )
        if self.broadcast:
            t = threading.Thread(
                target=self._broadcast_routine,
                args=(peer,),
                name=f"txvote-bcast-{peer.node_id}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def remove_peer(self, peer, reason: object = None) -> None:
        # the broadcast routine exits on peer.is_running(); the id mapping
        # stays so a reconnecting peer reuses its slot
        pass

    # -- receive (reference :170-190) --

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        if not msg:
            raise ValueError("empty txvote message")
        msg_type = msg[0]
        if msg_type == MSG_VOTES:
            pid = self._peer_id(peer)
            r = amino.AminoReader(msg, 1)
            pool = self.tx_vote_pool
            seen = self._seen_wire
            tx_info = TxInfo(sender_id=pid)
            ingest: list = []  # (segment, vote) for the authoritative path
            fresh_segs: list[bytes] = []  # wire-map misses: decoded together
            fresh_slots: list[int] = []  # their ingest positions
            while not r.eof():
                seg = r.read_bytes()  # a decode error stops the peer
                hit = seen.peek(seg)
                if hit is not None:
                    vk, vote = hit
                    if pool.add_sender(vk, pid):
                        # the pool holds it: a duplicate (SENDER_ADDED) or
                        # this peer's replay (SENDER_REPEAT)
                        peer.stats.duplicates += 1
                        continue
                    if pool.in_cache(vk):
                        # gone from the pool but vetoed by its dedup cache
                        # (a committed vote re-gossiped): check_tx would
                        # reject it with no side effect
                        peer.stats.duplicates += 1
                        continue
                    ingest.append((seg, vote))
                else:
                    # a placeholder keeps wire order: acceptance at a full
                    # pool sees the votes in arrival order
                    fresh_slots.append(len(ingest))
                    ingest.append((seg, None))
                    fresh_segs.append(seg)
            for slot, seg in zip(fresh_slots, fresh_segs):
                ingest[slot] = (seg, decode_tx_vote(seg))
            if ingest:
                # full or too-large rejections drop the vote like the
                # reference; in-cache duplicates still enter the wire map
                errs = pool.check_tx_many([v for _, v in ingest], tx_info)
                for (seg, vote), err in zip(ingest, errs):
                    if err is None or isinstance(err, ErrTxInCache):
                        seen.put(seg, (vote.vote_key(), vote))
                    if isinstance(err, ErrTxInCache):
                        peer.stats.duplicates += 1
        elif msg_type == MSG_HEIGHT:
            height, _ = amino.read_uvarint(msg, 1)
            peer.set(PEER_HEIGHT_KEY, height)
        else:
            raise ValueError(f"unknown txvote msg type {msg_type}")

    def broadcast_height(self, height: int) -> None:
        """Push a height update to all peers (block-boundary hook)."""
        if self.switch is not None:
            self.switch.broadcast(
                CHANNEL_TXVOTE, bytes([MSG_HEIGHT]) + amino.uvarint(max(height, 0))
            )

    # -- sign routine (reference :87-138) --

    def _sign_tx_routine(self) -> None:
        cursor = 0
        pcursor = 0
        seq = self.mempool.seq()
        while self._running.is_set():
            # the priority lane first each pass: the bulk walk can be deep
            pitems, pcursor = self.mempool.priority_entries_from(
                pcursor, limit=self.batch_size
            )
            items, cursor = self.mempool.entries_from(cursor, limit=self.batch_size)
            items = pitems + [it for it in items if it[4] != LANE_PRIORITY]
            if not items:
                seq = self.mempool.wait_for_new(seq, timeout=self.poll_interval)
                continue
            st = self.get_state()
            if self.priv_val is None:
                continue
            my_addr = self.priv_val.get_address()
            if not st.validators.has_address(my_addr):
                continue  # keep running: could become a validator any round
            if st.committee is not None and not st.committee.has_address(my_addr):
                continue  # committee mode: only members sign tx votes
            for tx_key, _tx, _h, fast_path, _lane in items:
                if not fast_path:
                    # the app flagged the tx block-only: honest validators
                    # do not sign it, and the block path carries it
                    continue
                # the mempool key IS sha256(tx)
                vote = TxVote(
                    height=st.last_block_height,
                    tx_hash=tx_key.hex().upper(),
                    tx_key=tx_key,
                    validator_address=my_addr,
                )
                self.priv_val.sign_tx_vote(st.chain_id, vote)
                try:
                    self.tx_vote_pool.check_tx(vote)
                except (ErrTxInCache, ErrMempoolIsFull, ErrTxTooLarge):
                    continue

    # -- per-peer broadcast (reference :198-265) --

    def _broadcast_routine(self, peer) -> None:
        pid = self._peer_id(peer)
        cursor = 0
        pending: list[tuple[bytes, TxVote, int, bytes]] = []
        seq = self.tx_vote_pool.seq()
        last_rewalk = time.monotonic()
        while self._running.is_set() and peer.is_running():
            if not pending:
                pending, cursor = self.tx_vote_pool.entries_from(
                    cursor, limit=self.batch_size
                )
            if not pending:
                if (
                    self.regossip_interval is not None
                    and time.monotonic() - last_rewalk >= self.regossip_interval
                    and self.tx_vote_pool.size() > 0
                ):
                    cursor = 0  # anti-entropy re-walk
                    last_rewalk = time.monotonic()
                    continue
                seq = self.tx_vote_pool.wait_for_new(seq, timeout=self.poll_interval)
                continue
            peer_height = peer.get(PEER_HEIGHT_KEY, 0)
            known = self.tx_vote_pool.has_sender_many(
                [key for key, _v, _h, _s in pending], pid
            )
            sendable, deferred = [], []
            for item, peer_has in zip(pending, known):
                if item[1].height - 1 > peer_height:  # allow a lag of 1 block
                    deferred.append(item)
                elif not peer_has:
                    sendable.append(item[3])
            if sendable:
                # a join of the segments cached at ingest: no re-encode
                frame = _MSG_VOTES_B + b"".join(sendable)
                if not peer.send(CHANNEL_TXVOTE, frame):
                    time.sleep(PEER_CATCHUP_SLEEP)
                    continue  # retry the same batch
            pending = deferred
            if deferred:
                time.sleep(PEER_CATCHUP_SLEEP)  # peer catching up
