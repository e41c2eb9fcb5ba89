"""P2P gossip layer (counterpart of ``txflow_tpu/p2p/``; reference
tendermint p2p Switch/Peer + reactors).

Reactors, channel ids, priorities, per-peer send loops with backpressure
and sender suppression over two transports: in-memory duplex pipes for
in-process validator networks (the reference's MakeConnectedSwitches
trick, used by ``node.LocalNet`` and the tests) and TCP sockets, plain or
authenticated (``secret.SecretConnection``). Send loops ship batches of
pool entries in one framed message, as in the JAX package: the consumer is
a verify kernel that wants thousands of votes at once.
"""

from .base import (
    CHANNEL_CONSENSUS_DATA,
    CHANNEL_CONSENSUS_STATE,
    CHANNEL_CONSENSUS_VOTE,
    CHANNEL_MEMPOOL,
    CHANNEL_TXVOTE,
    ChannelDescriptor,
    Reactor,
)
from .switch import Peer, Switch, connect_switches, make_connected_switches
from .transport import InMemoryConnection, connection_pair

__all__ = [
    "ChannelDescriptor",
    "Reactor",
    "Peer",
    "Switch",
    "connect_switches",
    "make_connected_switches",
    "InMemoryConnection",
    "connection_pair",
    "CHANNEL_MEMPOOL",
    "CHANNEL_TXVOTE",
    "CHANNEL_CONSENSUS_STATE",
    "CHANNEL_CONSENSUS_DATA",
    "CHANNEL_CONSENSUS_VOTE",
]
