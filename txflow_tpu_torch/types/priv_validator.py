"""MockPV (reference types/priv_validator.go), TxVote signing only.

``break_tx_vote_signing`` keeps the reference's breakage switch
(types/priv_validator.go:44-60): a broken signer signs with the wrong
chain id, producing signatures that honest verifiers reject.
"""

from __future__ import annotations

from ..crypto import ed25519
from ..crypto.hash import address_hash
from .tx_vote import TxVote


class MockPV:
    """In-memory signer without safety or persistence — tests only."""

    def __init__(
        self,
        seed: bytes | None = None,
        break_tx_vote_signing: bool = False,
    ):
        self._seed = seed if seed is not None else ed25519.generate_seed()
        self._pub_key = ed25519.public_key_from_seed(self._seed)
        self.break_tx_vote_signing = break_tx_vote_signing

    def get_pub_key(self) -> bytes:
        return self._pub_key

    def get_address(self) -> bytes:
        return address_hash(self._pub_key)

    def sign_tx_vote(self, chain_id: str, vote: TxVote) -> None:
        use_chain_id = (
            "incorrect-chain-id" if self.break_tx_vote_signing else chain_id
        )
        vote.signature = ed25519.sign(self._seed, vote.sign_bytes(use_chain_id))

    def __repr__(self) -> str:
        return f"MockPV{{{self.get_address().hex().upper()}}}"
