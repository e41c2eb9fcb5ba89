"""Pending-state pools (reference mempool/ and txvotepool/).

- ``Mempool``: raw transactions with keyed ``get_tx`` lookup used by the
  fast-path commit; a second instance serves as the **commitpool** holding
  fast-committed txs (reference node/node.go:627-633).
- ``TxVotePool``: pending TxVotes with signature-keyed dedup and caps.
"""

from .mempool import (
    LANE_BULK, LANE_PRIORITY, ErrMempoolIsFull, ErrTxInCache, ErrTxTooLarge, Mempool, TxInfo,
)
from .txvotepool import TxVotePool, UNKNOWN_PEER_ID

__all__ = [
    "ErrMempoolIsFull",
    "ErrTxInCache",
    "ErrTxTooLarge",
    "LANE_BULK",
    "LANE_PRIORITY",
    "Mempool",
    "TxInfo",
    "TxVotePool",
    "UNKNOWN_PEER_ID",
]
