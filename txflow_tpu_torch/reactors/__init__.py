"""Gossip reactors (counterpart of ``txflow_tpu/reactors/``): the mempool
tx flood (channel 0x30) and the txvote reactor (channel 0x32, with the
``signTxRoutine`` that turns every mempool tx into this validator's
TxVote), over the p2p package with batched frames."""

from .mempool_reactor import MempoolReactor
from .txvote_reactor import StateView, TxVoteReactor

__all__ = ["MempoolReactor", "TxVoteReactor", "StateView"]
