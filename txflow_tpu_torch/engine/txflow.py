"""TxFlow: per-tx vote aggregation + instant commit (reference
txflow/service.go), the serial path of ``txflow_tpu/engine/txflow.py``.

The reference's ``checkMaj23Routine`` walks the vote-pool CList one vote at
a time, verifying each ed25519 signature on the host under a mutex
(:123-166 -> types/vote_set.go:81-131). Here one aggregation **step**:

1. drains a batch of pending votes from the pool (insertion order -- the
   canonical intra-batch order, so replays and the scalar model agree);
2. assigns a tx slot per distinct tx hash and gathers each slot's prior
   accumulated stake from its host TxVoteSet;
3. runs the batched device verify + tally (the CUDA verify and tally
   kernels, one readback);
4. routes each verified vote into its authoritative ``TxVoteSet`` via the
   reference-identical decision path (first-signature-wins, conflict
   rejection) and, for every tx that crossed 2/3: save to TxStore -> fetch
   the tx from the mempool by key -> ApplyTx -> purge the quorum's votes
   from the pool -> push the tx into the commitpool (the sequence of
   txflow/service.go:216-232).

At a block boundary ``update_state`` moves the engine to a new height and,
on a rotated set (a new epoch's committee), restages the verifier's tables
and re-evaluates every in-flight vote set; ``apply_synced_commit`` is the
seam through which the catch-up client (``sync/``) applies a fetched,
re-verified certificate.

Divergences from the reference (defects fixed, as in the JAX package):
committed TxVoteSets are dropped from the in-flight map and late votes for
a committed tx are discarded; votes that can never be added (invalid
signature, conflicting signature, unknown validator) are removed from the
pool instead of lingering.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

from ..pool.mempool import Mempool
from ..pool.txvotepool import TxVotePool
from ..store.tx_store import TxStore
from ..types import TxVote, TxVoteSet
from ..types.tx_vote import sign_bytes_many
from ..types.validator import ValidatorSet
from ..utils.cache import LRUCache
from ..utils.config import EngineConfig
from ..parallel.mesh import make_mesh
from ..verifier import DeviceVoteVerifier, ScalarVoteVerifier
from .execution import TxExecutor


class _StepPrep:
    """Host-side product of one pool drain: everything the verify call and
    the routing pass need."""

    __slots__ = (
        "keys", "votes", "slots", "n_slots", "prior", "msgs", "sigs",
        "val_idx", "dropped", "verifier",
    )

    def __init__(self):
        self.keys: list[bytes] = []
        self.votes: list[TxVote] = []
        self.slots: list[int] = []
        self.n_slots = 0
        self.prior = None
        self.msgs: list[bytes] = []
        self.sigs: list[bytes] = []
        self.val_idx = None
        self.dropped = 0
        # the verifier of the set whose address->index map built val_idx
        self.verifier = None


class TxFlow:
    def __init__(
        self,
        chain_id: str,
        height: int,
        val_set: ValidatorSet,
        tx_vote_pool: TxVotePool,
        mempool: Mempool,
        commitpool: Mempool,
        tx_executor: TxExecutor,
        tx_store: TxStore,
        config: EngineConfig | None = None,
        verifier=None,
    ):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.tx_vote_pool = tx_vote_pool
        self.mempool = mempool
        self.commitpool = commitpool
        self.tx_executor = tx_executor
        self.tx_store = tx_store
        self.config = config or EngineConfig()
        if verifier is not None:
            self.verifier = verifier
        elif self.config.use_device:
            # no fallback: a device or build failure raises, and so does a
            # mesh of more cards than are visible (the JAX engine falls
            # back to one device there); a set of total power >= 2^30 is
            # tallied in int64 on the device (the JAX engine takes its
            # host verifier there)
            fe_radix = self.config.fe_radix
            if int(self.config.mesh_devices or 0) > 1:
                mesh = make_mesh(int(self.config.mesh_devices), device=self.config.device)
                self.verifier = DeviceVoteVerifier(val_set, mesh=mesh, fe_radix=fe_radix)
            else:
                self.verifier = DeviceVoteVerifier(
                    val_set, device=self.config.device, fe_radix=fe_radix
                )
        else:
            self.verifier = ScalarVoteVerifier(val_set)
        self._addr_to_idx = {v.address: i for i, v in enumerate(val_set)}
        self._drain_cap = min(
            self.config.max_batch,
            getattr(self.verifier, "max_batch", self.config.max_batch),
        )
        # on a mesh, a full drain splits evenly over the shards: no pad rows
        shards = self._verifier_shards()
        if self._drain_cap >= shards:
            self._drain_cap -= self._drain_cap % shards
        self.vote_sets: dict[str, TxVoteSet] = {}  # in-flight only
        self._committed = LRUCache(1 << 16)  # recently committed tx hashes
        # ingest-log cursor: each pool entry is visited by step() exactly
        # once (in-batch repeats re-queue on _retry)
        self._drain_cursor = 0
        self._retry: list[tuple[bytes, TxVote]] = []
        self._mtx = threading.RLock()
        # quorum-before-tx: a certificate can be decided before the tx
        # bytes reach the local mempool; the apply then waits (tx_hash ->
        # tx_key), as in the JAX package
        self._unapplied: dict[str, bytes] = {}
        self.app_hash = b""
        self.last_rotation: dict | None = None

    # ---- batched aggregation step ----

    def step(self) -> int:
        """One serial verify+tally+commit round (prep -> submit -> collect
        -> route); returns votes processed this step: votes routed to a
        decision plus votes dropped at drain time. Votes the verifier
        deferred (in-batch repeats) re-enter via _retry and are counted by
        the step that decides them."""
        prep = self._prep_batch()
        if prep is None:
            return 0
        if not prep.votes:
            return prep.dropped
        # device verify outside the engine lock: routing re-validates
        # against vote_sets/_committed
        ticket = self._submit_prep(prep)
        result = self._collect(prep, ticket)
        decided, _requeued = self._route_result(prep, result)
        return decided + prep.dropped

    def _prep_batch(self) -> "_StepPrep | None":
        """Drain the pool, dedup against committed/held votes, assign tx
        slots, gather prior stake, and build sign bytes. Returns None when
        nothing was drained; a prep with empty ``votes`` when everything
        drained was dropped."""
        with self._mtx:
            raw, self._drain_cursor = self.tx_vote_pool.entries_from(
                self._drain_cursor, limit=max(self._drain_cap - len(self._retry), 0)
            )
            batch = self._retry + [(k, v) for k, v, _h in raw]
            self._retry = []
            if not batch:
                return None
            prep = _StepPrep()
            keys, votes, slots = prep.keys, prep.votes, prep.slots
            slot_of: dict[str, int] = {}
            drop_now: list[bytes] = []
            for bi, (key, vote) in enumerate(batch):
                if _hash_key(vote.tx_hash) in self._committed or (
                    vote.tx_hash not in self.vote_sets
                    and self.tx_store.has_tx(vote.tx_hash)
                ):
                    drop_now.append(key)  # late vote for a committed tx
                    continue
                vs = self.vote_sets.get(vote.tx_hash)
                if vs is not None and vs.get_by_address(vote.validator_address) is not None:
                    # the set already holds a vote from this validator:
                    # identical signature = silent dup, different = an
                    # honest re-sign; both dropped first-signature-wins
                    drop_now.append(key)
                    continue
                if (
                    vote.tx_hash not in slot_of
                    and len(slot_of) >= self.config.max_slots
                ):
                    # leave the tail for the next step (the cursor has
                    # passed it, so it re-queues explicitly)
                    self._retry.extend(batch[bi:])
                    break
                slot = slot_of.setdefault(vote.tx_hash, len(slot_of))
                keys.append(key)
                votes.append(vote)
                slots.append(slot)
            if drop_now:
                self.tx_vote_pool.remove(drop_now)
            prep.dropped = len(drop_now)
            if not votes:
                return prep
            prep.n_slots = len(slot_of)
            prior = np.zeros(prep.n_slots, np.int64)
            for tx_hash, s in slot_of.items():
                vs = self.vote_sets.get(tx_hash)
                if vs is not None:
                    prior[s] = vs.stake()
            prep.prior = prior
            # this drain's set epoch: update_state swaps the map and the
            # verifier together under _mtx, so the batch goes to the
            # verifier that matches the indices it was built with
            addr_to_idx = self._addr_to_idx
            prep.verifier = self.verifier
        prep.msgs = sign_bytes_many(votes, self.chain_id)
        prep.sigs = [v.signature or b"" for v in votes]
        prep.val_idx = np.array(
            [addr_to_idx.get(v.validator_address, -1) for v in votes], dtype=np.int64
        )
        return prep

    def _submit_prep(self, prep: "_StepPrep"):
        """Hand the prepped batch to the verifier captured at drain
        (launch; no readback)."""
        return prep.verifier.submit(
            prep.msgs, prep.sigs, prep.val_idx,
            np.array(prep.slots, np.int32), prep.n_slots,
            prior_stake=prep.prior,
        )

    def _collect(self, prep: "_StepPrep", ticket):
        """Block for the ticket's readback."""
        return ticket.result()

    def _route_result(self, prep: "_StepPrep", result) -> tuple[int, int]:
        """Route the verified batch in submission (= pool ingest) order into
        the authoritative vote sets, committing the moment a set crosses
        2/3 -- the reference's per-vote order (service.go:192-234), so
        certificates equal the scalar path's. Returns (decided, requeued);
        decided + requeued == len(prep.votes)."""
        keys, votes = prep.keys, prep.votes
        requeued = 0
        inline_commits: list[tuple[TxVoteSet, list[TxVote], bytes | None]] = []
        purge_votes: list[TxVote] = []  # quorum votes, one pool purge a step
        with self._mtx:
            bad_keys: list[bytes] = []
            valid_l = result.valid.tolist()
            dropped_l = result.dropped.tolist()
            for i, vote in enumerate(votes):
                if dropped_l[i]:
                    # in-batch (slot, validator) repeat: the cursor has
                    # passed this entry, so re-queue it for the next step
                    self._retry.append((keys[i], vote))
                    requeued += 1
                    continue
                if not valid_l[i]:
                    bad_keys.append(keys[i])
                    continue
                vs = self.vote_sets.get(vote.tx_hash)
                if vs is None:
                    if _hash_key(vote.tx_hash) in self._committed:
                        bad_keys.append(keys[i])  # late: committed this batch
                        continue
                    vs = TxVoteSet(
                        self.chain_id, self.height, vote.tx_hash, vote.tx_key, self.val_set
                    )
                    self.vote_sets[vote.tx_hash] = vs
                added, _err = vs.add_verified_vote(vote)
                if added:
                    if vs.has_two_thirds_majority():
                        # decision under _mtx; store/ABCI effects below
                        inline_commits.append(self._decide_commit(vs))
                else:
                    bad_keys.append(keys[i])  # dup/conflict: can never add
            if bad_keys:
                self.tx_vote_pool.remove(bad_keys)
        for vs, quorum_votes, tx in inline_commits:
            self._commit_effects(
                vs, quorum_votes, purge_votes, tx=tx, deferred=tx is None
            )
        if purge_votes:
            self.tx_vote_pool.update(self.height, purge_votes)
        return len(votes) - requeued, requeued

    # ---- scalar parity API (reference TryAddVote :169-188) ----

    def try_add_vote(self, vote: TxVote) -> tuple[bool, Exception | None]:
        with self._mtx:
            return self._add_vote_scalar(vote)

    def _add_vote_scalar(self, vote: TxVote) -> tuple[bool, Exception | None]:
        """Reference-exact scalar path (the golden engine of the tests)."""
        if _hash_key(vote.tx_hash) in self._committed or (
            vote.tx_hash not in self.vote_sets and self.tx_store.has_tx(vote.tx_hash)
        ):
            return False, None
        vs = self.vote_sets.get(vote.tx_hash)
        if vs is None:
            vs = TxVoteSet(self.chain_id, self.height, vote.tx_hash, vote.tx_key, self.val_set)
            self.vote_sets[vote.tx_hash] = vs
        added, err = vs.add_vote(vote)
        if added and vs.has_two_thirds_majority():
            self._commit_tx(vs)
        return added, err

    # ---- commit (reference addVote :216-232) ----

    def _decide_commit(
        self, vs: TxVoteSet
    ) -> tuple[TxVoteSet, list[TxVote], bytes | None]:
        """Locked half of an inline commit: drop the in-flight set, mark the
        hash committed, and capture the tx bytes (or register the deferred
        apply) atomically with the mark."""
        quorum_votes = vs.get_votes()
        self.vote_sets.pop(vs.tx_hash, None)
        self._committed.push(_hash_key(vs.tx_hash))
        tx = self.mempool.get_tx(vs.tx_key)
        if tx is None:
            self._unapplied[vs.tx_hash] = vs.tx_key
        return vs, quorum_votes, tx

    def _commit_tx(self, vs: TxVoteSet, purge_batch: list | None = None) -> None:
        """Inline commit (scalar golden path)."""
        quorum_votes = vs.get_votes()
        self.vote_sets.pop(vs.tx_hash, None)
        self._committed.push(_hash_key(vs.tx_hash))
        self._commit_effects(vs, quorum_votes, purge_batch)
        if purge_batch is None:
            self.tx_vote_pool.update(self.height, quorum_votes)

    def _commit_effects(
        self,
        vs: TxVoteSet,
        quorum_votes: list[TxVote],
        purge_batch: list | None,
        tx: bytes | None = None,
        deferred: bool = False,
    ) -> None:
        """Store + execute + commitpool effects (reference addVote :216-232
        sequence). deferred=True: the tx bytes were absent at decision time
        and an _unapplied entry was registered; apply only if the bytes
        have arrived since, and never twice."""
        had_tx = tx is not None
        self.tx_store.save_tx(vs, votes=quorum_votes, tx=tx)
        if tx is None:
            with self._mtx:
                if not deferred or vs.tx_hash in self._unapplied:
                    tx = self.mempool.get_tx(vs.tx_key)
                    if tx is None:
                        self._unapplied[vs.tx_hash] = vs.tx_key
                    elif deferred:
                        del self._unapplied[vs.tx_hash]
        if tx is not None and not had_tx:
            self.tx_store.save_tx_bytes(vs.tx_hash, tx)
        if tx is not None:
            # the mempool keys by sha256, so tx_key IS sha256(tx): the hash
            # handed to the app and events describes the tx actually applied
            app_hash, _ = self.tx_executor.apply_tx(
                self.height, tx, vs.tx_key.hex().upper(), tx_key=vs.tx_key
            )
            self.app_hash = app_hash
            try:
                self.commitpool.check_tx(tx, key=vs.tx_key)
            except Exception:
                pass  # commitpool dup (e.g. replays) is harmless
        if purge_batch is not None:
            purge_batch.extend(quorum_votes)

    # ---- catch-up sync commit seam ----

    def apply_synced_commit(
        self, vs: TxVoteSet, votes: list[TxVote], tx: bytes
    ) -> bool:
        """Commit a certificate fetched and already verified by the
        catch-up client (sync/manager.py), through the live commit seam:
        the committed mark is pushed under _mtx as for a fast-path
        decision, so a racing local quorum never double-applies; the
        TxStore save assigns the next local seq, so the commit-order log
        extends in the server's order; store, then apply.

        The caller must have verified the certificate and that sha256(tx)
        is the certified hash: the sign bytes zero TxKey, so a vote's own
        tx_key field is never trusted here. Returns False when the tx is
        already committed locally."""
        tx_key = hashlib.sha256(tx).digest()
        tx_hash = tx_key.hex().upper()
        with self._mtx:
            if _hash_key(tx_hash) in self._committed or self.tx_store.has_tx(tx_hash):
                return False
            live = self.vote_sets.pop(tx_hash, None)
            self._committed.push(_hash_key(tx_hash))
        if live is not None:
            # a below-quorum local aggregation was racing the sync apply:
            # release its pool votes
            self.tx_vote_pool.update(self.height, live.votes_snapshot())
        self.tx_store.save_tx(vs, votes=votes, tx=tx)
        app_hash, _ = self.tx_executor.apply_tx(self.height, tx, tx_hash, tx_key=tx_key)
        self.app_hash = app_hash
        try:
            self.commitpool.check_tx(tx, key=tx_key)
        except Exception:
            pass  # commitpool dup (e.g. replays) is harmless
        return True

    # ---- block boundary: epoch rotation ----

    def update_state(self, height: int, val_set: ValidatorSet) -> None:
        """New height, possibly with a rotated validator set (or a new
        epoch's committee). All under _mtx, so no step sees a half-rotated
        engine:

        1. the verifier restages in place (new tables on the card, same
           shapes, its field kept, the tally's width chosen for the new
           set's total power); a device verifier past its capacity is
           rebuilt on the same device or mesh, over the same field,
           instead. Only a total power of 2^62 or more raises.
        2. every in-flight TxVoteSet is re-evaluated against the new set
           (TxVoteSet.revalidate): votes of removed validators dropped,
           sums re-weighted, latched certificates untouched, and a set
           that now clears the quorum commits at once.
        3. the address->index map swaps with the verifier.
        """
        with self._mtx:
            # content, not identity: an unchanged set is not restaged
            if val_set is self.val_set or val_set.hash() == self.val_set.hash():
                self.height = height
                return
            base = self.verifier
            restaged = base.restage(val_set)
            # only a device verifier past its capacity declines; its
            # successor (on the same device or mesh) is built before any
            # engine state swaps (the height included), so a failure
            # leaves the old epoch's height, map, set and verifier together
            if restaged:
                verifier = base
            elif base.mesh is not None:
                verifier = DeviceVoteVerifier(val_set, mesh=base.mesh, fe_radix=base.fe_radix)
            else:
                verifier = DeviceVoteVerifier(
                    val_set, device=base.device, fe_radix=base.fe_radix
                )
            self.height = height
            self.val_set = val_set
            self._addr_to_idx = {v.address: i for i, v in enumerate(val_set)}
            self.verifier = verifier
            dropped = 0
            newly_quorate = []
            for vs in list(self.vote_sets.values()):
                d, quorate = vs.revalidate(val_set)
                dropped += d
                if quorate:
                    newly_quorate.append(vs)
            for vs in newly_quorate:
                # a shrinking total power can push a pending tx over 2/3
                # with no new vote: commit it now, on the inline path
                self._commit_tx(vs)
            self.last_rotation = {
                "height": height,
                "restaged": restaged,
                "votes_dropped": dropped,
                "commits_on_rotation": len(newly_quorate),
                "val_set_hash": val_set.hash().hex(),
            }

    # ---- queries ----

    def _verifier_shards(self) -> int:
        """Mesh shard count of the verifier; 1 for a single device or the
        host verifier."""
        return max(1, int(getattr(self.verifier, "_n_shards", 1)))

    def is_tx_committed(self, tx_hash: str) -> bool:
        with self._mtx:
            return _hash_key(tx_hash) in self._committed or self.tx_store.has_tx(
                tx_hash
            )

    def load_commit(self, tx_hash: str):
        return self.tx_store.load_tx_commit(tx_hash)


def _hash_key(tx_hash: str) -> bytes:
    return tx_hash.encode()
