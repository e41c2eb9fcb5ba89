"""Reactor interface + channel descriptors (reference p2p/base_reactor.go).

Channel ids match the reference byte values so the wire layout is
recognizable: consensus 0x20-0x22 (consensus/reactor.go:22-27), mempool
0x30 (mempool/reactor.go:21), txvotes 0x32 (txvotepool/reactor.go:25).
Counterpart of ``txflow_tpu/p2p/base.py``, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

CHANNEL_CONSENSUS_STATE = 0x20
CHANNEL_CONSENSUS_DATA = 0x21
CHANNEL_CONSENSUS_VOTE = 0x22
CHANNEL_MEMPOOL = 0x30
CHANNEL_TXVOTE = 0x32
# catch-up sync (sync/reactor.py). 0x38 is already the evidence channel,
# so the sync channel takes the next free slot in the 0x3x range.
CHANNEL_SYNC = 0x3A


@dataclass(frozen=True)
class ChannelDescriptor:
    """One prioritized byte-channel (reference p2p/conn ChannelDescriptor)."""

    id: int
    priority: int = 1
    send_queue_capacity: int = 64
    recv_message_capacity: int = 1024 * 1024  # 1 MiB (consensus/reactor.go:28)
    # reliable channels are never dropped on queue pressure and are drained
    # ahead of the shared priority queue: consensus proposals/votes are
    # push-once (no retransmit), so one drop stalls the whole round until
    # timeout (ADVICE r2) — unlike txvote/mempool batches, which re-gossip
    reliable: bool = False


class Reactor:
    """Base reactor (reference p2p.BaseReactor). Override the hooks.

    Lifecycle: the switch calls ``set_switch`` at registration,
    ``on_start``/``on_stop`` with its own start/stop, ``add_peer`` after a
    peer's connection is live, ``remove_peer`` after it is torn down, and
    ``receive`` from the peer's recv loop for every inbound message on one
    of this reactor's channels.
    """

    def __init__(self, name: str):
        self.name = name
        self.switch = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return []

    def set_switch(self, switch) -> None:
        self.switch = switch

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    def add_peer(self, peer) -> None:
        pass

    def remove_peer(self, peer, reason: object = None) -> None:
        pass

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        pass
