"""TxVote: a per-transaction validator vote (reference types/tx_vote.go).

Sign bytes are amino ``MarshalBinaryLengthPrefixed(CanonicalTxVote)`` where
``CanonicalTxVote{Height fixed64, TxHash, TxKey, Timestamp, ChainID}`` — and,
exactly as in the reference, ``CanonicalizeTxVote`` does NOT copy the vote's
TxKey (types/tx_vote.go:185-192), so field 3 always serializes as 32 zero
bytes. Preserving that quirk is required for signature compatibility.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

from ..codec import amino
from ..codec.amino import _ZERO_TXKEY, canonical_sign_bytes  # noqa: F401  (re-exported)
from ..crypto import ed25519
from ..crypto.hash import ADDRESS_SIZE, address_hash, sha256

# Maximum amino-encoded vote size, including overhead (types/tx_vote.go:17).
MAX_VOTE_BYTES = 223
# tendermint types.MaxSignatureSize (v0.31).
MAX_SIGNATURE_SIZE = 64

_SEMANTIC_FIELDS = frozenset(
    ("height", "tx_hash", "tx_key", "timestamp_ns", "validator_address", "signature")
)


@dataclass
class TxVote:
    height: int
    tx_hash: str  # uppercase hex of sha256(tx)
    tx_key: bytes  # sha256(tx), 32 bytes
    timestamp_ns: int = field(default_factory=_time.time_ns)
    validator_address: bytes = b""
    signature: bytes | None = None
    # encode caches: a signed vote is immutable, so sign bytes and wire
    # bytes are derived once. Signers mutate fields BEFORE the first
    # encode, so lazy first-use caching is safe; copies carry the caches
    # (any later field write clears them via __setattr__).
    _sb_cache: tuple | None = field(
        default=None, repr=False, compare=False
    )
    _wire_cache: bytes | None = field(default=None, repr=False, compare=False)
    _vk_cache: bytes | None = field(default=None, repr=False, compare=False)
    # the length-prefixed wire form (a gossip frame's segment), built once
    # by the pool at ingest; a decoded vote is shared by every co-located
    # node through the reactor's wire map, so one build serves them all
    _seg_cache: bytes | None = field(default=None, repr=False, compare=False)

    def __setattr__(self, name, value):
        # any semantic-field write invalidates the encode caches, so even
        # post-signing tampering (byzantine tests) can never serve stale
        # bytes
        if name in _SEMANTIC_FIELDS:
            object.__setattr__(self, "_sb_cache", None)
            object.__setattr__(self, "_wire_cache", None)
            object.__setattr__(self, "_vk_cache", None)
            object.__setattr__(self, "_seg_cache", None)
        object.__setattr__(self, name, value)

    def sign_bytes(self, chain_id: str) -> bytes:
        c = self._sb_cache
        if c is not None and c[0] == chain_id:
            return c[1]
        sb = canonical_sign_bytes(
            chain_id, self.height, self.tx_hash, self.timestamp_ns
        )
        if self.signature is not None:  # immutable once signed
            self._sb_cache = (chain_id, sb)
        return sb

    def verify(self, chain_id: str, pub_key: bytes) -> str | None:
        """Returns None if valid, else an error string (types/tx_vote.go:110-119)."""
        if address_hash(pub_key) != self.validator_address:
            return "invalid validator address"
        if not self.signature or not ed25519.verify(
            pub_key, self.sign_bytes(chain_id), self.signature
        ):
            return "invalid signature"
        return None

    def copy(self) -> "TxVote":
        # caches travel with the copy: they only describe the semantic
        # fields, and any later field write clears them via __setattr__
        v = TxVote.__new__(TxVote)
        oset = object.__setattr__
        oset(v, "height", self.height)
        oset(v, "tx_hash", self.tx_hash)
        oset(v, "tx_key", self.tx_key)
        oset(v, "timestamp_ns", self.timestamp_ns)
        oset(v, "validator_address", self.validator_address)
        oset(v, "signature", self.signature)
        oset(v, "_sb_cache", self._sb_cache)
        oset(v, "_wire_cache", self._wire_cache)
        oset(v, "_vk_cache", self._vk_cache)
        oset(v, "_seg_cache", self._seg_cache)
        return v

    def vote_key(self) -> bytes:
        """sha256(signature) — dedup cache key (txvotepool/txvotepool.go:467-469).

        Cached: the pool and the engine's purge bookkeeping re-derive it
        for the same immutable vote. __setattr__ clears it on any semantic
        field write, like the encode caches."""
        k = self._vk_cache
        if k is None:
            k = sha256(self.signature or b"")
            object.__setattr__(self, "_vk_cache", k)
        return k


def sign_bytes_many(votes: list["TxVote"], chain_id: str) -> list[bytes]:
    """Sign bytes for a whole drain batch, priming each vote's cache."""
    return [v.sign_bytes(chain_id) for v in votes]


def encode_tx_vote(vote: TxVote) -> bytes:
    """Amino MarshalBinaryBare of the full TxVote struct (WAL/wire form)."""
    if vote._wire_cache is not None:
        return vote._wire_cache
    body = bytearray()
    if vote.height != 0:
        body += amino.field_key(1, amino.TYP3_VARINT)
        body += amino.varint(vote.height)
    if vote.tx_hash:
        body += amino.field_key(2, amino.TYP3_BYTELEN)
        body += amino.length_prefixed(vote.tx_hash.encode())
    body += amino.field_key(3, amino.TYP3_BYTELEN)
    body += amino.length_prefixed(vote.tx_key or _ZERO_TXKEY)
    ts_body = amino.encode_time_body(vote.timestamp_ns)
    if ts_body:
        body += amino.field_key(4, amino.TYP3_BYTELEN)
        body += amino.length_prefixed(ts_body)
    if vote.validator_address:
        body += amino.field_key(5, amino.TYP3_BYTELEN)
        body += amino.length_prefixed(vote.validator_address)
    if vote.signature:
        body += amino.field_key(6, amino.TYP3_BYTELEN)
        body += amino.length_prefixed(vote.signature)
    out = bytes(body)
    if vote.signature is not None:  # immutable once signed
        vote._wire_cache = out
    return out


def _uv(data: bytes, pos: int, end: int) -> tuple[int, int, bool]:
    """Uvarint continuation path (Go binary.Uvarint overflow rules).

    Returns (value, new_pos, minimal): ``minimal`` is False for over-long
    encodings (a trailing 0x00 continuation group). They are ACCEPTED —
    same accept-set as Go — but the caller must refuse the wire cache,
    since our encoder would emit the shorter form."""
    n = 0
    shift = 0
    while True:
        if pos >= end:
            raise ValueError("truncated uvarint")
        b = data[pos]
        pos += 1
        if shift == 63 and b > 1:
            raise ValueError("uvarint overflows 64 bits")
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos, b != 0
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflows 64 bits")


def decode_tx_vote(data: bytes) -> TxVote:
    """Hand-rolled single-pass parser.

    It inlines the one-byte-varint fast path and constructs the TxVote via
    object.__setattr__ instead of the guarded dataclass path; the
    accept-set is the JAX package's (Go amino's).

    ``canonical`` tracks whether the input is exactly the byte string our
    own encoder emits (fields strictly ordered, no unknown fields, no
    explicitly-encoded defaults, minimal varints, normalized time body):
    only then are the input bytes cached as the vote's wire form, so
    re-gossip and TxStore certificate encoding never re-serialize.
    Non-canonical peer encodings fall back to a real re-serialize like
    the reference (Go amino re-marshals from the struct). The cache
    contract is exact -- cached bytes are bit-identical to
    encode_tx_vote's output.
    """
    pos = 0
    end = len(data)
    height = 0
    tx_hash = ""
    tx_key = _ZERO_TXKEY
    timestamp_ns = 0
    validator_address = b""
    signature = None
    canonical = True
    prev_fnum = 0
    try:
        while pos < end:
            b = data[pos]
            if b < 0x80:
                key = b
                pos += 1
            else:
                key, pos, mini = _uv(data, pos, end)
                if not mini:
                    canonical = False
            fnum = key >> 3
            typ3 = key & 7
            if fnum <= prev_fnum:
                canonical = False
            prev_fnum = fnum
            if typ3 == 2:  # BYTELEN
                b = data[pos]
                if b < 0x80:
                    ln = b
                    pos += 1
                else:
                    ln, pos, mini = _uv(data, pos, end)
                    if not mini:
                        canonical = False
                npos = pos + ln
                if npos > end:
                    raise ValueError("truncated byte field")
                seg = data[pos:npos]
                pos = npos
                if fnum == 2:
                    tx_hash = seg.decode()
                    if not tx_hash:
                        canonical = False
                elif fnum == 3:
                    if ln != 32:
                        # Go amino unmarshals into [sha256.Size]byte and
                        # errors on any other length; keep the wire
                        # accept-set identical.
                        raise ValueError(f"TxKey must be 32 bytes, got {ln}")
                    tx_key = seg
                elif fnum == 4:
                    timestamp_ns, ts_canon = _decode_ts_body(seg)
                    if not ts_canon:
                        canonical = False
                elif fnum == 5:
                    validator_address = seg
                    if not seg:
                        canonical = False
                elif fnum == 6:
                    signature = seg
                    if not seg:
                        canonical = False
                else:
                    canonical = False  # unknown BYTELEN field: skipped
            elif typ3 == 0:  # VARINT
                b = data[pos]
                if b < 0x80:
                    v = b
                    pos += 1
                else:
                    v, pos, mini = _uv(data, pos, end)
                    if not mini:
                        canonical = False
                if fnum == 1:
                    height = v - (1 << 64) if v >= 1 << 63 else v
                    if height == 0:
                        canonical = False
                else:
                    canonical = False  # unknown varint field: skipped
            elif typ3 == 1:  # 8BYTE
                if pos + 8 > end:
                    raise ValueError("truncated fixed64")
                pos += 8
                canonical = False  # no fixed64 field in TxVote
            else:
                raise ValueError(f"unknown typ3 {typ3}")
    except IndexError:
        raise ValueError("truncated uvarint") from None
    vote = TxVote.__new__(TxVote)
    oset = object.__setattr__
    oset(vote, "height", height)
    oset(vote, "tx_hash", tx_hash)
    oset(vote, "tx_key", tx_key)
    oset(vote, "timestamp_ns", timestamp_ns)
    oset(vote, "validator_address", validator_address)
    oset(vote, "signature", signature)
    oset(vote, "_sb_cache", None)
    oset(vote, "_vk_cache", None)
    oset(vote, "_seg_cache", None)
    if signature and canonical and tx_key is not _ZERO_TXKEY:
        oset(vote, "_wire_cache", bytes(data))
    else:
        oset(vote, "_wire_cache", None)
    return vote


def _decode_ts_body(body: bytes) -> tuple[int, bool]:
    """(unix_ns, canonical): canonical iff body == encode_time_body(ns)."""
    if not body:
        # encode_time_body(0) elides the whole field — an explicit empty
        # field 4 is never something our encoder emits
        return 0, False
    pos = 0
    end = len(body)
    seconds = 0
    nanos = 0
    canonical = True
    prev = 0
    while pos < end:
        b = body[pos]
        if b < 0x80:
            key = b
            pos += 1
        else:
            key, pos, mini = _uv(body, pos, end)
            if not mini:
                canonical = False
        fnum = key >> 3
        typ3 = key & 7
        if fnum <= prev:
            canonical = False
        prev = fnum
        if typ3 == 0:
            b = body[pos] if pos < end else 0x80
            if b < 0x80:
                v = b
                pos += 1
            else:
                v, pos, mini = _uv(body, pos, end)
                if not mini:
                    canonical = False
            if fnum == 1:
                seconds = v - (1 << 64) if v >= 1 << 63 else v
                if seconds == 0:
                    canonical = False
            elif fnum == 2:
                nanos = v
                if not 0 < v < 1_000_000_000:
                    canonical = False
            else:
                canonical = False
        elif typ3 == 1:
            if pos + 8 > end:
                raise ValueError("truncated fixed64")
            pos += 8
            canonical = False
        elif typ3 == 2:
            b = body[pos] if pos < end else 0x80
            if b < 0x80:
                ln = b
                pos += 1
            else:
                ln, pos, mini = _uv(body, pos, end)
                if not mini:
                    canonical = False
            if pos + ln > end:
                raise ValueError("truncated byte field")
            pos += ln
            canonical = False
        else:
            raise ValueError(f"unknown typ3 {typ3}")
    return seconds * 1_000_000_000 + nanos, canonical
