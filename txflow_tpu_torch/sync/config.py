"""SyncConfig: the catch-up client's and server's knobs (counterpart of
``txflow_tpu/sync/config.py``: every field, every default)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SyncConfig:
    # -- lag detection --
    # the client is behind when the best servable advert exceeds its own
    # commit-order seq count by at least this many commits
    lag_threshold: int = 1
    # how often the idle client re-evaluates peer adverts for lag
    poll_interval: float = 0.25
    # how often the server side re-advertises its seq count to every peer
    status_interval: float = 0.5

    # -- fetch pipeline --
    # commits per range request; the server also bounds a response by
    # max_resp_bytes
    batch: int = 64
    # at most this many outstanding range requests to the serving peer
    window: int = 4
    # server-side cap on commits per response, whatever the client asked
    max_range: int = 256
    max_resp_bytes: int = 512 * 1024

    # -- failure handling --
    # per-request timeout before the request counts as stalled
    request_timeout: float = 1.0
    # jittered exponential backoff between failed rounds: base * 2^level,
    # capped, +/- the jitter fraction
    backoff_base: float = 0.25
    backoff_cap: float = 5.0
    backoff_jitter: float = 0.25
    # the jitter stream's seed
    seed: int = 0
    # score penalties for a peer scoreboard (the health layer, which the
    # port does not carry yet: kept so both packages' configs are equal)
    byzantine_penalty: float = 16.0
    stall_penalty: float = 2.0
    # local re-selection ban after a byzantine strike
    byzantine_ban: float = 30.0
    # after this many consecutive failed rounds the client enters the
    # fallback state and waits fallback_cooldown before probing again
    max_rounds: int = 3
    fallback_cooldown: float = 5.0
