"""ABCI: the application interface (reference: tendermint abci, imported not forked).

The reference talks to the application over an ABCI client connection
(socket/grpc/local, node/node.go:576); test fixtures use
``proxy.NewLocalClientCreator(kvstore.NewApplication())``. Here the same
contract is an abstract ``Application`` plus a thread-safe ``AppConns``
proxy exposing the three logical connections (mempool / consensus / query)
with the same serialization guarantees a local ABCI client gives.
"""

from .types import (
    CodeTypeOK,
    RequestBeginBlock,
    RequestEndBlock,
    ResponseCheckTx,
    ResponseCommit,
    ResponseDeliverTx,
    ResponseEndBlock,
    ResponseInfo,
    ResponseQuery,
    ValidatorUpdate,
)
from .application import Application
from .proxy import AppConnConsensus, AppConnMempool, AppConns
from .kvstore import KVStoreApplication

__all__ = [
    "Application",
    "AppConns",
    "AppConnConsensus",
    "AppConnMempool",
    "CodeTypeOK",
    "KVStoreApplication",
    "RequestBeginBlock",
    "RequestEndBlock",
    "ResponseCheckTx",
    "ResponseCommit",
    "ResponseDeliverTx",
    "ResponseEndBlock",
    "ResponseInfo",
    "ResponseQuery",
    "ValidatorUpdate",
]
