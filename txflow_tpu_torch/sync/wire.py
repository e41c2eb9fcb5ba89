"""Sync channel wire format (counterpart of ``txflow_tpu/sync/wire.py``;
byte-identical frames).

Three message kinds, each a 1-byte tag + uvarint/length-prefixed fields:

- STATUS: ``tag | seq_count | height``, the sender's commit-order log
  length and commit height;
- RANGE_REQ: ``tag | req_id | start | count``, fetch commits
  [start, start+count) of the server's commit-order log;
- RANGE_RESP: ``tag | req_id | start | advert | n_entries | entries... |
  n_snapshots | snapshots...``; each entry is ``lp(tx_hash) lp(cert_blob)
  lp(tx_bytes)`` with cert_blob the server's raw TxStore H: row; each
  snapshot is ``height lp(vals_json)``, the validator set the server has
  on record for that vote height (the state store's JSON codec).
  ``advert`` is the server's seq_count at serve time, lowered to the first
  unservable row when rows are missing.
"""

from __future__ import annotations

import json

from ..codec import amino
from ..state.store import _vals_from_obj, _vals_to_obj
from ..types.validator import ValidatorSet

MSG_STATUS = 0
MSG_RANGE_REQ = 1
MSG_RANGE_RESP = 2


def encode_status(seq_count: int, height: int) -> bytes:
    return bytes((MSG_STATUS,)) + amino.uvarint(seq_count) + amino.uvarint(height)


def decode_status(data: bytes) -> tuple[int, int]:
    seq_count, off = amino.read_uvarint(data, 1)
    height, _ = amino.read_uvarint(data, off)
    return seq_count, height


def encode_range_req(req_id: int, start: int, count: int) -> bytes:
    return (
        bytes((MSG_RANGE_REQ,))
        + amino.uvarint(req_id)
        + amino.uvarint(start)
        + amino.uvarint(count)
    )


def decode_range_req(data: bytes) -> tuple[int, int, int]:
    req_id, off = amino.read_uvarint(data, 1)
    start, off = amino.read_uvarint(data, off)
    count, _ = amino.read_uvarint(data, off)
    return req_id, start, count


def encode_range_resp(
    req_id: int,
    start: int,
    advert: int,
    entries: list[tuple[str, bytes, bytes]],
    snapshots: dict[int, ValidatorSet],
) -> bytes:
    out = bytearray((MSG_RANGE_RESP,))
    out += amino.uvarint(req_id)
    out += amino.uvarint(start)
    out += amino.uvarint(advert)
    out += amino.uvarint(len(entries))
    for tx_hash, cert_blob, tx in entries:
        out += amino.length_prefixed(tx_hash.encode())
        out += amino.length_prefixed(cert_blob)
        out += amino.length_prefixed(tx)
    out += amino.uvarint(len(snapshots))
    for height in sorted(snapshots):
        out += amino.uvarint(height)
        out += amino.length_prefixed(
            json.dumps(_vals_to_obj(snapshots[height]), sort_keys=True).encode()
        )
    return bytes(out)


def decode_range_resp(
    data: bytes,
) -> tuple[int, int, int, list[tuple[str, bytes, bytes]], dict[int, ValidatorSet]]:
    req_id, off = amino.read_uvarint(data, 1)
    start, off = amino.read_uvarint(data, off)
    advert, off = amino.read_uvarint(data, off)
    n, off = amino.read_uvarint(data, off)
    entries: list[tuple[str, bytes, bytes]] = []
    for _ in range(n):
        ln, off = amino.read_uvarint(data, off)
        tx_hash = data[off : off + ln].decode()
        off += ln
        ln, off = amino.read_uvarint(data, off)
        cert_blob = data[off : off + ln]
        off += ln
        ln, off = amino.read_uvarint(data, off)
        tx = data[off : off + ln]
        off += ln
        entries.append((tx_hash, cert_blob, tx))
    n_snap, off = amino.read_uvarint(data, off)
    snapshots: dict[int, ValidatorSet] = {}
    for _ in range(n_snap):
        height, off = amino.read_uvarint(data, off)
        ln, off = amino.read_uvarint(data, off)
        vals = _vals_from_obj(json.loads(data[off : off + ln]))
        off += ln
        if vals is not None:
            snapshots[height] = vals
    return req_id, start, advert, entries, snapshots
