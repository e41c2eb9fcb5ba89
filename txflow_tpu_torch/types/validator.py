"""Validator and ValidatorSet (tendermint v0.31 types, the subset TxFlow uses).

The vote-set quorum math keys off ``GetByAddress`` and ``TotalVotingPower``
(reference types/vote_set.go:102, :158). The set is kept sorted by address
ascending, as upstream does, and additionally maintains dense device-side
arrays (pubkeys, powers) so a validator set can be uploaded once per epoch
and indexed by integer validator id inside the batched verifier.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..crypto.hash import address_hash


@dataclass
class Validator:
    address: bytes
    pub_key: bytes  # ed25519, 32 bytes
    voting_power: int
    # carried through the state-store JSON codec (sync snapshots); the
    # port elects no proposers, so it stays as it was decoded
    proposer_priority: int = 0

    @classmethod
    def from_pub_key(cls, pub_key: bytes, voting_power: int) -> "Validator":
        return cls(address_hash(pub_key), pub_key, voting_power)

    def copy(self) -> "Validator":
        return Validator(
            self.address, self.pub_key, self.voting_power, self.proposer_priority
        )


class ValidatorSet:
    def __init__(self, validators: list[Validator]):
        self.validators: list[Validator] = sorted(
            (v.copy() for v in validators), key=lambda v: v.address
        )
        self._by_address = {v.address: i for i, v in enumerate(self.validators)}
        if len(self._by_address) != len(self.validators):
            raise ValueError("duplicate validator address")
        self._total_voting_power = sum(v.voting_power for v in self.validators)
        self._powers_np: np.ndarray | None = None  # built lazily

    def size(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        return self._total_voting_power

    def quorum_power(self) -> int:
        """The 2/3+1 stake threshold (types/vote_set.go:158)."""
        return self._total_voting_power * 2 // 3 + 1

    def has_address(self, address: bytes) -> bool:
        return address in self._by_address

    def get_by_address(self, address: bytes) -> tuple[int, Validator | None]:
        idx = self._by_address.get(address)
        if idx is None:
            return -1, None
        return idx, self.validators[idx]

    def index_of(self, address: bytes) -> int:
        return self._by_address.get(address, -1)

    def copy(self) -> "ValidatorSet":
        return ValidatorSet([v.copy() for v in self.validators])

    def hash(self) -> bytes:
        """Deterministic digest of (address, pub_key, power) triples
        (upstream ValidatorSet.Hash)."""
        from ..crypto.hash import sha256

        acc = bytearray()
        for v in self.validators:
            acc += v.address
            acc += v.pub_key
            acc += v.voting_power.to_bytes(8, "big", signed=True)
        return sha256(bytes(acc))

    def powers_array(self) -> np.ndarray:
        """(n,) int64 voting powers, validator-index order."""
        if self._powers_np is None:
            self._powers_np = np.array(
                [v.voting_power for v in self.validators], dtype=np.int64
            )
        return self._powers_np

    def __iter__(self):
        return iter(self.validators)

    def __len__(self) -> int:
        return len(self.validators)
