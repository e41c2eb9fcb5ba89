"""The readback ring: each step's packed result crosses to the host on a
side CUDA stream while the caller goes on (counterpart of
``txflow_tpu/parallel/staging.py:StagingRing``, redesigned for CUDA).

The verify pipeline's one device-to-host synchronization is the read of
the packed ``[valid | stake | maj23]`` vector at collect. The JAX ring
moves that read onto a readback thread. Here no thread is needed: the
copy engine runs the transfer beside the compute stream. The ring keeps,
per card, a side ``torch.cuda.Stream`` and ``depth`` slots, each with a
pinned host buffer per part of a ticket (grown to the largest packed
vector it has carried).

How a slot runs: ``submit`` records an event on each part's compute
stream after the step's last launch; the part's card's side stream waits
on it, copies ``packed -> pinned`` with ``non_blocking=True`` between two
timing events, and the part is marked used on the side stream
(``record_stream``) so that the caching allocator does not hand its
memory out under the copy. ``result`` synchronizes the done events and
returns the host bytes, copied out of the pinned buffers before the slot
goes back to the free list: a pinned buffer is reused only after its
previous readback was consumed. On a mesh a ticket has one part per
shard, and each part rides its own card's side stream.

The JAX ring's contract holds (``txflow_tpu/parallel/staging.py:1-48``):

- a submit while all ``depth`` slots are un-awaited reads back
  synchronously on the caller and counts ``sync_readbacks``; it never
  blocks;
- an error is captured in the slot and re-raised at the waiter;
- ``close()`` drains: slots in flight still complete, later submits read
  back synchronously (not counted as overflow);
- ``stats()["hidden_s"]`` is the readback time that did not stall the
  waiter: each slot's copy time from its events, less the time
  ``result`` blocked on it.

CPU tensors (the tests) take the same slots and accounting with a plain
synchronous copy into an ordinary host buffer (``host_readbacks``; their
copy runs on the caller, so none of it is hidden); the stream path runs
only on the card.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch


class StageSlot:
    """One ticket's readback: its parts in, the joined host array (or an
    error) out."""

    __slots__ = ("parts", "host", "error", "bufs", "sizes", "events", "host_copy_s",
                 "queued", "waited")

    def __init__(self, parts):
        self.parts = parts  # device tensors, held until the copy is consumed
        self.host: np.ndarray | None = None
        self.error: BaseException | None = None
        self.bufs = None  # the slot's host buffers, while queued
        self.sizes: list[int] = []
        self.events: list = []  # (start, done) per CUDA part, on the side streams
        self.host_copy_s = 0.0  # CPU parts: the caller's copy time
        self.queued = False
        self.waited = False


def _join_on_host(parts) -> np.ndarray:
    return torch.cat([p.reshape(-1).cpu() for p in parts]).numpy()


class StagingRing:
    """Depth-bounded readback ring over side CUDA streams (one per card)."""

    def __init__(self, depth: int = 2):
        self.depth = max(1, int(depth))
        self._mtx = threading.Lock()
        # free buffer sets, one per slot: a list of 1-D host tensors, one
        # per part, grown on demand (pinned for CUDA parts)
        self._free: list[list[torch.Tensor]] = [[] for _ in range(self.depth)]
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._closed = False
        self._in_flight: list[StageSlot] = []
        self.slots_total = 0
        self.stream_readbacks = 0
        self.host_readbacks = 0
        self.sync_readbacks = 0
        self.readback_s = 0.0
        self.result_wait_s = 0.0
        self.hidden_s = 0.0

    def _side(self, dev: torch.device) -> torch.cuda.Stream:
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def submit(self, parts) -> StageSlot:
        """Enter a ticket's tensors (one per shard) into the ring; returns
        its slot. Never blocks: with every slot un-awaited (or the ring
        closed) the ticket reads back here, on the caller."""
        parts = list(parts)
        slot = StageSlot(parts)
        with self._mtx:
            self.slots_total += 1
            bufs = self._free.pop() if self._free and not self._closed else None
            if bufs is None and not self._closed:
                self.sync_readbacks += 1
        if bufs is None:
            try:
                slot.host = _join_on_host(parts)
            except Exception as exc:  # re-raised at result()
                slot.error = exc
            slot.parts = None
            return slot
        slot.bufs = bufs
        slot.queued = True
        on_card = False
        try:
            for i, p in enumerate(parts):
                n = p.numel()
                on_card = p.device.type == "cuda"
                if i == len(bufs) or bufs[i].numel() < n or bufs[i].dtype != p.dtype:
                    buf = torch.empty(n, dtype=p.dtype)
                    buf = buf.pin_memory() if on_card else buf
                    if i == len(bufs):
                        bufs.append(buf)
                    else:
                        bufs[i] = buf
                slot.sizes.append(n)
                if not on_card:
                    t = time.perf_counter()
                    bufs[i][:n].copy_(p.reshape(-1))
                    slot.host_copy_s += time.perf_counter() - t
                    continue
                side = self._side(p.device)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(p.device))
                start = torch.cuda.Event(enable_timing=True)
                done = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(side):
                    side.wait_event(ready)
                    start.record(side)
                    bufs[i][:n].copy_(p.reshape(-1), non_blocking=True)
                    done.record(side)
                # the copy reads p on the side stream: keep its memory
                # from the allocator until that work is done
                p.record_stream(side)
                slot.events.append((start, done))
        except Exception as exc:  # re-raised at result()
            slot.error = exc
        with self._mtx:
            self._in_flight.append(slot)
            if on_card:
                self.stream_readbacks += 1
            else:
                self.host_readbacks += 1
        return slot

    def result(self, slot: StageSlot) -> np.ndarray:
        """Wait for the slot's copies and return its parts joined on the
        host, in shard order; re-raises a captured error."""
        if not slot.queued or slot.waited:
            if slot.error is not None:
                raise slot.error
            return slot.host
        t0 = time.perf_counter()
        try:
            if slot.error is not None:
                raise slot.error
            for _, done in slot.events:
                done.synchronize()
            wait = time.perf_counter() - t0
            copy_s = sum(s.elapsed_time(d) for s, d in slot.events) * 1e-3
            slot.host = np.concatenate([b[:n].numpy() for b, n in zip(slot.bufs, slot.sizes)])
        finally:
            self._settle(slot)
        with self._mtx:
            self.result_wait_s += wait
            self.readback_s += copy_s + slot.host_copy_s
            self.hidden_s += max(copy_s - wait, 0.0)
        return slot.host

    def _settle(self, slot: StageSlot) -> None:
        """Give the slot's buffers back once no copy can still write them."""
        for _, done in slot.events:
            try:
                done.synchronize()
            except RuntimeError:  # the waiter raises the first error
                pass
        with self._mtx:
            slot.waited = True
            slot.parts = None
            slot.events = []
            self._in_flight.remove(slot)
            self._free.append(slot.bufs)
            slot.bufs = None

    def stats(self) -> dict:
        with self._mtx:
            return {"depth": self.depth, "slots_total": self.slots_total,
                    "stream_readbacks": self.stream_readbacks,
                    "host_readbacks": self.host_readbacks,
                    "sync_readbacks": self.sync_readbacks, "readback_s": self.readback_s,
                    "result_wait_s": self.result_wait_s, "hidden_s": self.hidden_s,
                    "in_flight": len(self._in_flight)}

    def close(self) -> None:
        """Drain: wait for every copy in flight (their waiters still get
        their bytes); later submits read back on the caller. Idempotent."""
        with self._mtx:
            self._closed = True
            pending = list(self._in_flight)
        for slot in pending:
            for _, done in slot.events:
                done.synchronize()
