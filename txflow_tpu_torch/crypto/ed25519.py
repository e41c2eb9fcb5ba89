"""Host-side Ed25519 with Go ``crypto/ed25519``-equivalent verify semantics.

This is the scalar golden model for the batched device verifier
(``ops/ed25519_batch.py``): same accept/reject decisions bit-for-bit.
The reference verifies one vote at a time with Go's ed25519
(types/tx_vote.go:110-119); its exact semantics are:

- signature must be 64 bytes, S = sig[32:] (little-endian) must satisfy S < L
  ("ScMinimal");
- A (pubkey) must decompress onto the curve;
- h = SHA512(R_bytes || A_bytes || msg) reduced mod L;
- compute P = [S]B - [h]A (cofactorless) and accept iff encode(P) equals
  sig[:32] byte-for-byte (Go compares encodings, never decompressing R, so
  non-canonical R encodings are rejected automatically).

Implemented from the RFC 8032 specification with Python integers. When the
``cryptography`` package is importable its OpenSSL backend (same semantics)
is used for the fast host paths ``sign``/``verify``; the pure-Python
``verify_pure`` stays as the audited golden model, and both are cross-tested.
Without that package, signing multiplies the base point through a
fixed-window table (64 additions, no doublings), so that a vote corpus of
tens of thousands of signatures is made in seconds per core.
"""

from __future__ import annotations

import functools
import hashlib

# Curve constants (RFC 8032 section 5.1).
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Base point B.
_BY = (4 * pow(5, P - 2, P)) % P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BASE_AFFINE = (_BX, _BY)

# Extended homogeneous coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z.
IDENTITY = (0, 1, 1, 0)
BASE = (_BX, _BY, 1, (_BX * _BY) % P)


def point_add(Pt, Qt):
    """Unified addition, extended coordinates (RFC 8032 section 5.1.4)."""
    X1, Y1, Z1, T1 = Pt
    X2, Y2, Z2, T2 = Qt
    A = ((Y1 - X1) * (Y2 - X2)) % P
    B = ((Y1 + X1) * (Y2 + X2)) % P
    C = (2 * T1 * T2 * D) % P
    Dv = (2 * Z1 * Z2) % P
    E = B - A
    F = Dv - C
    G = Dv + C
    H = B + A
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def point_double(Pt):
    """Dedicated doubling (independent of d) — also what the device kernel uses."""
    X1, Y1, Z1, _ = Pt
    A = (X1 * X1) % P
    B = (Y1 * Y1) % P
    C = (2 * Z1 * Z1) % P
    H = (A + B) % P
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = (A - B) % P
    F = (C + G) % P
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def point_neg(Pt):
    X, Y, Z, T = Pt
    return ((-X) % P, Y, Z, (-T) % P)


def scalar_mult(k: int, Pt):
    Q = IDENTITY
    while k > 0:
        if k & 1:
            Q = point_add(Q, Pt)
        Pt = point_double(Pt)
        k >>= 1
    return Q


def point_compress(Pt) -> bytes:
    X, Y, Z, _ = Pt
    zinv = pow(Z, P - 2, P)
    x = (X * zinv) % P
    y = (Y * zinv) % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_decompress(s: bytes):
    """Decompress 32 bytes to an extended point, or None if off-curve.

    Mirrors RFC 8032 decoding: y is the low 255 bits, sign bit selects x.
    (Like Go's FeFromBytes, y is not checked for canonicality; values >= p
    wrap implicitly, which only affects adversarial non-canonical pubkeys.)
    """
    if len(s) != 32:
        return None
    n = int.from_bytes(s, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    y2 = (y * y) % P
    u = (y2 - 1) % P
    v = (D * y2 + 1) % P
    # x = sqrt(u/v): candidate x = u * v^3 * (u * v^7)^((p-5)/8)
    v3 = (v * v * v) % P
    v7 = (v3 * v3 * v) % P
    x = (u * v3 * pow(u * v7, (P - 5) // 8, P)) % P
    vx2 = (v * x * x) % P
    if vx2 == u % P:
        pass
    elif vx2 == (-u) % P:
        x = (x * SQRT_M1) % P
    else:
        return None
    # NOTE: like Go's ref10-based ed25519 (and OpenSSL), x=0 with sign bit 1
    # is accepted by negating to zero — RFC 8032's stricter rejection would
    # diverge from the reference's accept set on adversarial encodings.
    if x & 1 != sign:
        x = (P - x) % P
    return (x, y, 1, (x * y) % P)


def sha512_mod_l(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little") % L


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


@functools.lru_cache(maxsize=1)
def _base_windows() -> list:
    """[64][16] table of d * 16^w * B (w = window, d = nibble)."""
    rows = []
    step = BASE
    for _ in range(64):
        row = [IDENTITY]
        for _ in range(15):
            row.append(point_add(row[-1], step))
        rows.append(row)
        step = point_add(row[15], step)  # 16^(w+1) * B
    return rows


def base_mult(k: int):
    """[k]B for 0 <= k < 2^256 by 64 table additions."""
    rows = _base_windows()
    acc = IDENTITY
    for w in range(64):
        d = (k >> (4 * w)) & 15
        if d:
            acc = point_add(acc, rows[w][d])
    return acc


def public_key_from_seed(seed: bytes) -> bytes:
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    return point_compress(base_mult(a))


@functools.lru_cache(maxsize=1024)
def _expand_seed(seed: bytes) -> tuple[int, bytes, bytes]:
    """(secret scalar a, nonce prefix, public key bytes) of a seed."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    return a, h[32:], point_compress(base_mult(a))


def sign_pure(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 deterministic signature (pure Python)."""
    a, prefix, A = _expand_seed(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    Rb = point_compress(base_mult(r))
    k = sha512_mod_l(Rb + A + msg)
    s = (r + k * a) % L
    return Rb + s.to_bytes(32, "little")


def sign_batch(items: list[tuple[bytes, bytes]]) -> list[bytes]:
    """sign(seed, msg) for each (seed, msg) pair: one unit of work for a
    process pool signing a large vote corpus."""
    return [sign(seed, msg) for seed, msg in items]


def verify_pure(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Go crypto/ed25519-equivalent verification (the golden model)."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:  # ScMinimal
        return False
    A = point_decompress(pub)
    if A is None:
        return False
    h = sha512_mod_l(sig[:32] + pub + msg)
    # P = [s]B - [h]A, accept iff encode(P) == sig[:32].
    Pt = point_add(scalar_mult(s, BASE), scalar_mult(h, point_neg(A)))
    return point_compress(Pt) == sig[:32]


# ----------------------------------------------------------------------------
# Fast host paths via the `cryptography` package (OpenSSL), same semantics.

try:  # pragma: no cover - import guard
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.exceptions import InvalidSignature

    HAVE_CRYPTOGRAPHY = True
except Exception:  # pragma: no cover
    HAVE_CRYPTOGRAPHY = False


def sign(seed: bytes, msg: bytes) -> bytes:
    if HAVE_CRYPTOGRAPHY:
        return Ed25519PrivateKey.from_private_bytes(seed).sign(msg)
    return sign_pure(seed, msg)


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if HAVE_CRYPTOGRAPHY:
        if len(pub) != 32 or len(sig) != 64:
            return False
        try:
            Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
            return True
        except (InvalidSignature, ValueError):
            return False
    return verify_pure(pub, msg, sig)


def generate_seed() -> bytes:
    import os

    return os.urandom(32)
