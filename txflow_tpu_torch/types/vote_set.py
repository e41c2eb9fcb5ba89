"""TxVoteSet: the stake-weighted quorum accumulator (reference types/vote_set.go).

This is the scalar golden model: the batched device verifier must produce
bit-identical commit decisions. Exact reference semantics preserved:

- one vote per validator address; an identical re-submission (same signature)
  is a silent duplicate (added=False, no error) — types/vote_set.go:109-112;
- a second vote from the same validator with a DIFFERENT signature is
  rejected with ErrVoteNonDeterministicSignature and never tallied
  (first-signature-wins) — types/vote_set.go:113;
- quorum: maj23 latches once sum >= total*2/3 + 1 — types/vote_set.go:158-163.

Thread-safety: a mutex guards mutation like the reference's ``mtx``; the
aggregation engine calls ``add_verified_vote`` after device batch
verification, which reproduces the decisions of ``add_vote`` exactly.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from .tx_vote import TxVote
from .validator import ValidatorSet


class ErrVoteNil(Exception):
    pass


class ErrVoteInvalidValidatorAddress(Exception):
    pass


class ErrVoteInvalidValidatorIndex(Exception):
    pass


class ErrVoteNonDeterministicSignature(Exception):
    pass


class ErrVoteInvalidSignature(Exception):
    pass


@dataclass
class CommitSig:
    """A vote included in a Commit — field-identical to TxVote (types/tx_vote.go:154-159)."""

    height: int
    tx_hash: str
    tx_key: bytes
    timestamp_ns: int
    validator_address: bytes
    signature: bytes | None

    @classmethod
    def from_vote(cls, vote: TxVote) -> "CommitSig":
        return cls(
            vote.height,
            vote.tx_hash,
            vote.tx_key,
            vote.timestamp_ns,
            vote.validator_address,
            vote.signature,
        )

    def to_vote(self) -> TxVote:
        return TxVote(
            self.height,
            self.tx_hash,
            self.tx_key,
            self.timestamp_ns,
            self.validator_address,
            self.signature,
        )


@dataclass
class Commit:
    """Evidence that a tx was committed by >2/3 stake (types/vote_set.go:263-287)."""

    tx_hash: str
    commits: list[CommitSig]

    def height(self) -> int:
        return self.commits[0].height if self.commits else 0


class TxVoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        tx_hash: str,
        tx_key: bytes,
        val_set: ValidatorSet,
    ):
        self.chain_id = chain_id
        self._height = height
        self.val_set = val_set
        self.tx_hash = tx_hash
        self.tx_key = tx_key
        self._mtx = threading.Lock()
        self.votes: dict[bytes, TxVote] = {}  # validator address -> vote
        self.sum = 0
        self.maj23 = False

    # ---- accessors (reference :53-78, :178-227) ----

    def height(self) -> int:
        return self._height

    def size(self) -> int:
        return self.val_set.size()

    def get_votes(self) -> list[TxVote]:
        # Copies, like the reference's by-value GetVotes — callers must not
        # be able to mutate the stored votes (first-sig-wins state).
        with self._mtx:
            return [v.copy() for v in self.votes.values()]

    def votes_snapshot(self) -> list[TxVote]:
        """Uncopied vote list for a caller that owns the set (the engine,
        after popping it from its in-flight map)."""
        with self._mtx:
            return list(self.votes.values())

    def get_by_address(self, address: bytes) -> TxVote | None:
        with self._mtx:
            return self.votes.get(address)

    def has_two_thirds_majority(self) -> bool:
        with self._mtx:
            return self.maj23

    def stake(self) -> int:
        with self._mtx:
            return self.sum

    # ---- mutation (reference :81-166) ----

    def add_vote(self, vote: TxVote | None) -> tuple[bool, Exception | None]:
        with self._mtx:
            return self._add_vote(vote)

    def _add_vote(
        self, vote: TxVote | None, check_signature: bool = True
    ) -> tuple[bool, Exception | None]:
        """One shared decision path for both the scalar and device routes:
        the batch-verified route is identical minus the signature check, so
        parity between the two can never drift."""
        if vote is None:
            return False, ErrVoteNil()
        if len(vote.validator_address) == 0:
            return False, ErrVoteInvalidValidatorAddress("empty address")
        _, val = self.val_set.get_by_address(vote.validator_address)
        if val is None:
            return False, ErrVoteInvalidValidatorIndex(
                f"cannot find validator {vote.validator_address.hex().upper()} "
                f"in valSet of size {self.val_set.size()}"
            )
        existing = self.votes.get(vote.validator_address)
        if existing is not None:
            if existing.signature == vote.signature:
                return False, None  # duplicate
            return False, ErrVoteNonDeterministicSignature(
                f"existing vote: {existing}; new vote: {vote}"
            )
        if check_signature:
            err = vote.verify(self.chain_id, val.pub_key)
            if err is not None:
                return False, ErrVoteInvalidSignature(
                    f"failed to verify vote with ChainID {self.chain_id}: {err}"
                )
        self._add_verified(vote, val.voting_power)
        return True, None

    def add_verified_vote(self, vote: TxVote) -> tuple[bool, Exception | None]:
        """Add a vote whose signature was already verified (device batch path)."""
        with self._mtx:
            return self._add_vote(vote, check_signature=False)

    def _add_verified(self, vote: TxVote, voting_power: int) -> None:
        self.votes[vote.validator_address] = vote
        self.sum += voting_power
        if self.val_set.quorum_power() <= self.sum:
            self.maj23 = True

    # ---- validator-set churn (epoch rotation) ----

    def revalidate(self, new_val_set: ValidatorSet) -> tuple[int, bool]:
        """Re-evaluate this in-flight set against a NEW validator set.
        Returns ``(dropped, newly_quorate)``:

        - an already-latched certificate is immutable: (0, False), the set
          untouched;
        - votes from validators absent in the new set are discarded;
        - surviving votes are re-weighted to their validator's new power,
          and maj23 latches (True) iff the new quorum is now met -- a
          shrinking total power can push a pending tx over the line."""
        with self._mtx:
            if self.maj23:
                return 0, False
            dropped = 0
            new_sum = 0
            for addr in list(self.votes):
                _, val = new_val_set.get_by_address(addr)
                if val is None:
                    del self.votes[addr]
                    dropped += 1
                else:
                    new_sum += val.voting_power
            self.val_set = new_val_set
            self.sum = new_sum
            if new_val_set.quorum_power() <= new_sum:
                self.maj23 = True
                return dropped, True
            return dropped, False

