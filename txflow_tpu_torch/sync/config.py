"""SyncConfig: catch-up knobs (counterpart of ``txflow_tpu/sync/config.py``,
trimmed to the serving side's caps; the lag detector, request size,
window, timeouts, backoff and strike penalties belong to the fetch loop,
which is not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SyncConfig:
    # server-side caps on one response: commits, and served bytes
    # (certificate rows + tx bytes, append-then-check)
    max_range: int = 256
    max_resp_bytes: int = 512 * 1024
