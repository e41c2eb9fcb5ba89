"""EventBus: in-process pubsub (reference: tendermint libs/pubsub EventBus).

The fast path publishes per-tx commit events (txflowstate/execution.go:
190-195). Thread-safe subscribe with per-subscriber queues (non-blocking
publish drops to slow subscribers beyond capacity, like pubsub's
buffered channels).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field

# event types (reference types/events.go)
EventTx = "Tx"


@dataclass
class Event:
    type: str
    data: object = None


class Subscription:
    def __init__(self, capacity: int = 1000):
        self._q: queue.Queue[Event] = queue.Queue(maxsize=capacity)

    def deliver(self, ev: Event) -> bool:
        try:
            self._q.put_nowait(ev)
            return True
        except queue.Full:
            return False

    def get(self, timeout: float | None = None) -> Event | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> list[Event]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out


class EventBus:
    def __init__(self):
        self._mtx = threading.Lock()
        self._subs: dict[str, list[Subscription]] = {}

    def subscribe(self, event_type: str, capacity: int = 1000) -> Subscription:
        sub = Subscription(capacity)
        with self._mtx:
            self._subs.setdefault(event_type, []).append(sub)
        return sub

    def publish(self, event_type: str, data: object = None) -> None:
        ev = Event(event_type, data)
        with self._mtx:
            subs = list(self._subs.get(event_type, []))
        for s in subs:
            s.deliver(ev)


@dataclass
class EventDataTx:
    """Per-tx commit event payload (reference types.EventDataTx)."""

    height: int
    tx: bytes
    tx_hash: str
    result_code: int = 0
    result_data: bytes = b""
    result_log: str = ""
    tags: list = field(default_factory=list)  # (key, value) byte pairs
