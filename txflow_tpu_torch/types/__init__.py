from .tx_vote import (
    MAX_SIGNATURE_SIZE,
    MAX_VOTE_BYTES,
    TxVote,
    canonical_sign_bytes,
    decode_tx_vote,
    encode_tx_vote,
)
from .validator import Validator, ValidatorSet
from .vote_set import (
    Commit,
    CommitSig,
    ErrVoteInvalidSignature,
    ErrVoteInvalidValidatorAddress,
    ErrVoteInvalidValidatorIndex,
    ErrVoteNil,
    ErrVoteNonDeterministicSignature,
    TxVoteSet,
)
from .priv_validator import MockPV

__all__ = [
    "MAX_SIGNATURE_SIZE",
    "MAX_VOTE_BYTES",
    "TxVote",
    "canonical_sign_bytes",
    "decode_tx_vote",
    "encode_tx_vote",
    "Validator",
    "ValidatorSet",
    "Commit",
    "CommitSig",
    "ErrVoteInvalidSignature",
    "ErrVoteInvalidValidatorAddress",
    "ErrVoteInvalidValidatorIndex",
    "ErrVoteNil",
    "ErrVoteNonDeterministicSignature",
    "TxVoteSet",
    "MockPV",
]
