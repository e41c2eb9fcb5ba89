"""Fee-prefix lane classifier (``txflow_tpu/admission/classifier.py``).

Lanes are a deterministic function of the tx bytes: every honest node
classifies a gossiped tx alike with no coordination. The convention is a
self-describing prefix on the tx bytes,

    b"fee=<n>;<payload>"

-- n at or above the threshold rides the priority lane; anything else (no
prefix, malformed, below threshold) is best-effort bulk.
"""

from __future__ import annotations

from ..pool.mempool import LANE_BULK, LANE_PRIORITY

# the fee prefix is a handful of digits; the bounded scan keeps a hostile
# "fee="-prefixed megabyte tx O(1) to classify
_FEE_SCAN_LIMIT = 24


def parse_fee(tx: bytes) -> int:
    """Fee declared by the tx's ``fee=<n>;`` prefix; 0 when absent or
    malformed (malformed never errors: it rides the bulk lane)."""
    if not tx.startswith(b"fee="):
        return 0
    end = tx.find(b";", 4, _FEE_SCAN_LIMIT)
    if end < 0:
        return 0
    try:
        return int(tx[4:end])
    except ValueError:
        return 0


# sender tags ride the same prefix convention (``fee=<n>;from=<id>;...``
# or ``from=<id>;...``), with a bounded scan too
_SENDER_SCAN_LIMIT = 96


def parse_sender(tx: bytes) -> str:
    """Sender identity declared by a ``from=<id>;`` tag in the tx's prefix
    region; "" when absent or malformed."""
    at = tx.find(b"from=", 0, _SENDER_SCAN_LIMIT)
    if at < 0:
        return ""
    end = tx.find(b";", at + 5, at + 5 + _SENDER_SCAN_LIMIT)
    if end < 0:
        return ""
    try:
        return tx[at + 5 : end].decode("ascii")
    except UnicodeDecodeError:
        return ""


class FeeLaneClassifier:
    """tx -> lane by the fee prefix (the node's default classifier)."""

    def __init__(self, priority_fee_threshold: int = 1):
        self.threshold = priority_fee_threshold

    def __call__(self, tx: bytes) -> int:
        return LANE_PRIORITY if parse_fee(tx) >= self.threshold else LANE_BULK
