"""Minimal amino binary codec — the subset used by TxVote sign bytes and wire.

go-txflow canonicalizes votes with go-amino v0.14 ``MarshalBinaryLengthPrefixed``
(reference: types/tx_vote.go:83-89, types/codec.go:9-18). Commit decisions hinge
on bit-exact sign bytes, so this module reproduces the relevant wire rules:

- unsigned varints (LEB128);
- signed varints as two's-complement uvarint (proto3 ``int64`` style — the
  reference vectors in types/vote_test.go:62 encode the zero-time seconds
  -62135596800 as a 10-byte uvarint, proving amino does NOT zigzag here);
- field keys ``(field_number << 3) | typ3`` with typ3 Varint=0 / 8Byte=1 /
  ByteLength=2;
- ``binary:"fixed64"`` int64 as 8-byte little-endian (typ3 8Byte);
- ``time.Time`` as an embedded struct {1: seconds varint, 2: nanos varint},
  each elided when zero;
- zero-value field elision: ints == 0, empty strings/slices are skipped;
  fixed-size byte arrays are ALWAYS written (amino's isDefaultValue does not
  treat arrays as default — hence CanonicalTxVote.TxKey serializes as 32 zero
  bytes); struct fields are skipped only when their encoded body is empty
  (the vectors show an empty CanonicalBlockID elided but a zero time written).

``canonical_sign_bytes`` (CanonicalTxVote) lives here rather than in
``types.tx_vote`` so that the host-prep worker processes (``prep.py``)
encode sign bytes with this module alone, never importing the crypto
package that ``types`` pulls in.
"""

from __future__ import annotations

TYP3_VARINT = 0
TYP3_8BYTE = 1
TYP3_BYTELEN = 2

_U64_MASK = (1 << 64) - 1


def uvarint(n: int) -> bytes:
    """LEB128 unsigned varint."""
    if 0 <= n < 0x80:
        return _SMALL[n]  # the overwhelmingly common case on this wire
    if n < 0:
        raise ValueError("uvarint of negative value")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


_SMALL = [bytes((i,)) for i in range(0x80)]


def varint(n: int) -> bytes:
    """Signed varint, two's-complement-as-uint64 (proto3 int64 semantics)."""
    return uvarint(n & _U64_MASK)


def field_key(field_num: int, typ3: int) -> bytes:
    return uvarint((field_num << 3) | typ3)


def length_prefixed(payload: bytes) -> bytes:
    return uvarint(len(payload)) + payload


def encode_time_body(unix_ns: int) -> bytes:
    """Body of an amino-embedded time.Time given integer unix nanoseconds.

    seconds = floor(unix_ns / 1e9) (matches Go Time.Unix() for negative
    times), nanos in [0, 1e9). Each field elided when zero. Runs on the
    per-vote encode/sign-bytes paths, hence the inlined varint loops
    (field keys 0x08/0x10 = (fnum << 3) | TYP3_VARINT).
    """
    seconds, nanos = divmod(unix_ns, 1_000_000_000)
    out = bytearray()
    if seconds != 0:
        out.append(0x08)
        n = seconds & _U64_MASK
        while n > 0x7F:
            out.append((n & 0x7F) | 0x80)
            n >>= 7
        out.append(n)
    if nanos != 0:
        out.append(0x10)
        n = nanos
        while n > 0x7F:
            out.append((n & 0x7F) | 0x80)
            n >>= 7
        out.append(n)
    return bytes(out)


def read_uvarint(data: bytes, pos: int = 0) -> tuple[int, int]:
    """(value, new_pos) of the uvarint at ``pos``, with Go binary.Uvarint
    overflow rules: at most 10 bytes, and the 10th byte may only be 0x01."""
    n = 0
    shift = 0
    end = len(data)
    while True:
        if pos >= end:
            raise ValueError("truncated uvarint")
        b = data[pos]
        pos += 1
        if shift == 63 and b > 1:
            raise ValueError("uvarint overflows 64 bits")
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflows 64 bits")


_ZERO_TXKEY = bytes(32)


def canonical_sign_bytes(
    chain_id: str, height: int, tx_hash: str, timestamp_ns: int
) -> bytes:
    """Length-prefixed amino encoding of CanonicalTxVote.

    Hand-tightened: this runs once per vote on the verify path. Field-key
    bytes are the precomputed amino constants -- (fnum << 3) | typ3, all
    < 0x80 -- and the bytes equal the JAX package's (the port's engine
    tests compare certificates byte for byte).
    """
    body = bytearray()
    if height != 0:
        body += b"\x09"  # field 1, TYP3_8BYTE
        body += (height & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
    if tx_hash:
        hb = tx_hash.encode()
        body += b"\x12"  # field 2, TYP3_BYTELEN
        body += uvarint(len(hb))
        body += hb
    # TxKey: fixed-size array, never elided; canonicalization leaves it zero.
    body += b"\x1a\x20"  # field 3, TYP3_BYTELEN, len 32
    body += _ZERO_TXKEY
    ts_body = encode_time_body(timestamp_ns)
    if ts_body:
        body += b"\x22"  # field 4, TYP3_BYTELEN
        body += uvarint(len(ts_body))
        body += ts_body
    if chain_id:
        cb = chain_id.encode()
        body += b"\x2a"  # field 5, TYP3_BYTELEN
        body += uvarint(len(cb))
        body += cb
    return length_prefixed(bytes(body))
