"""The serving side of catch-up sync (the logic of
``txflow_tpu/sync/reactor.py:SyncReactor._serve_range``, as a plain
function: the port has no switch, reactor thread or channel yet)."""

from __future__ import annotations

from typing import Callable

from ..store.tx_store import _decode_votes
from ..types.validator import ValidatorSet
from .config import SyncConfig


def serve_range(
    tx_store,
    config: SyncConfig,
    start: int,
    count: int,
    snapshot_of: Callable[[int], ValidatorSet | None] | None = None,
) -> tuple[int, list[tuple[str, bytes, bytes]], dict[int, ValidatorSet]]:
    """Commits [start, start+count) of ``tx_store``'s commit-order log as
    ``(advert, entries, snapshots)``, the body of a RANGE_RESP
    (``wire.encode_range_resp(req_id, start, *serve_range(...))``).

    Bounded by ``config.max_range`` commits and ``config.max_resp_bytes``
    served bytes; ``snapshot_of(height)`` gives the validator set on record
    for a vote height (None: no snapshot for it). ``advert`` is the log
    length, lowered to the first row that cannot be served."""
    advert = tx_store.seq_count()
    count = max(0, min(count, config.max_range))
    entries: list[tuple[str, bytes, bytes]] = []
    snapshots: dict[int, ValidatorSet] = {}
    size = 0
    for seq, tx_hash in tx_store.committed_range(start, count):
        cert = tx_store.load_cert_row(tx_hash)
        tx = tx_store.load_tx_bytes(tx_hash)
        if cert is None or tx is None:
            # stop at the first row we cannot serve, and say so in the
            # advert, so the client can tell honest shortness from a lie
            advert = min(advert, seq)
            break
        entries.append((tx_hash, cert, tx))
        size += len(cert) + len(tx)
        try:
            h = _decode_votes(cert)[0].height
        except Exception:
            h = 0
        if h not in snapshots and snapshot_of is not None:
            vals = snapshot_of(h)
            if vals is not None:
                snapshots[h] = vals
        if size >= config.max_resp_bytes:
            # append-then-check: a byte-capped response always carries >=
            # max_resp_bytes, and the capping entry ships with its
            # height's snapshot (collected above)
            break
    return advert, entries, snapshots
