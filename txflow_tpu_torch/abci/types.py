"""ABCI request/response types (subset the framework uses).

Mirrors the tendermint abci/types surface the reference depends on
(mempool CheckTx, consensus BeginBlock/DeliverTx/EndBlock/Commit, Info
handshake, Query) as plain dataclasses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CodeTypeOK = 0


@dataclass
class ResponseCheckTx:
    code: int = CodeTypeOK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    # fast-path eligibility: False = this tx must commit through a BLOCK
    # (EndBlock-coupled semantics like validator updates cannot flow
    # through per-tx fast commits — BeginBlock clears pending updates, so
    # a fast-committed val: tx would silently never rotate the set).
    # Honest validators simply do not sign ineligible txs; without their
    # signatures no 2/3 quorum can form, so the block path carries them.
    fast_path: bool = True

    @property
    def is_ok(self) -> bool:
        return self.code == CodeTypeOK


@dataclass
class ResponseDeliverTx:
    code: int = CodeTypeOK
    data: bytes = b""
    log: str = ""
    tags: list = field(default_factory=list)

    @property
    def is_ok(self) -> bool:
        return self.code == CodeTypeOK


@dataclass
class ResponseCommit:
    data: bytes = b""  # app hash


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseQuery:
    code: int = CodeTypeOK
    key: bytes = b""
    value: bytes = b""
    log: str = ""
    height: int = 0


@dataclass
class ValidatorUpdate:
    pub_key: bytes
    power: int


@dataclass
class RequestBeginBlock:
    hash: bytes = b""
    height: int = 0
    proposer_address: bytes = b""
    last_commit_votes: list = field(default_factory=list)
    byzantine_validators: list = field(default_factory=list)


@dataclass
class RequestEndBlock:
    height: int = 0


@dataclass
class ResponseEndBlock:
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: object | None = None
    tags: list = field(default_factory=list)
