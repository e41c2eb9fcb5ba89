"""Base Application: default no-op handlers, like abci/types BaseApplication."""

from __future__ import annotations

from .types import (
    RequestBeginBlock,
    RequestEndBlock,
    ResponseCheckTx,
    ResponseCommit,
    ResponseDeliverTx,
    ResponseEndBlock,
    ResponseInfo,
    ResponseQuery,
)


class Application:
    """Override any subset; defaults accept everything and do nothing."""

    def info(self) -> ResponseInfo:
        return ResponseInfo()

    def init_chain(self, validators: list) -> None:
        pass

    def check_tx(self, tx: bytes) -> ResponseCheckTx:
        return ResponseCheckTx()

    def deliver_tx(self, tx: bytes) -> ResponseDeliverTx:
        return ResponseDeliverTx()

    def begin_block(self, req: RequestBeginBlock) -> None:
        pass

    def end_block(self, req: RequestEndBlock) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    def query(self, path: str, data: bytes) -> ResponseQuery:
        return ResponseQuery()
