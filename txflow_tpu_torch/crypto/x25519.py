"""X25519 (RFC 7748) Diffie-Hellman over curve25519.

Host-side python-int Montgomery ladder — key agreement happens once per
connection, so this is never a hot path (the hot curve math lives in
ops/, on device, for ed25519 verification). Implemented from the RFC's
pseudocode over the same 2^255-19 field as crypto/ed25519. Counterpart of
``txflow_tpu/crypto/x25519.py``, unchanged.
"""

from __future__ import annotations

import os

P = 2**255 - 19
A24 = 121665  # (486662 - 2) / 4


def _clamp(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def _decode_u(u: bytes) -> int:
    b = bytearray(u)
    b[31] &= 127  # RFC 7748: mask the MSB of the final byte
    return int.from_bytes(bytes(b), "little") % P


def _encode_u(x: int) -> bytes:
    return (x % P).to_bytes(32, "little")


def scalar_mult(k: bytes, u: bytes) -> bytes:
    """X25519(k, u): constant-structure Montgomery ladder (RFC 7748 §5)."""
    x1 = _decode_u(u)
    k_int = _clamp(k)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k_int >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % P
        aa = (a * a) % P
        b = (x2 - z2) % P
        bb = (b * b) % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = (d * a) % P
        cb = (c * b) % P
        x3 = (da + cb) % P
        x3 = (x3 * x3) % P
        z3 = (da - cb) % P
        z3 = (x1 * z3 * z3) % P
        x2 = (aa * bb) % P
        z2 = (e * ((aa + A24 * e) % P)) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return _encode_u((x2 * pow(z2, P - 2, P)) % P)


BASE_POINT = (9).to_bytes(32, "little")


def generate_private() -> bytes:
    return os.urandom(32)


def public_key(priv: bytes) -> bytes:
    return scalar_mult(priv, BASE_POINT)


def shared_secret(priv: bytes, peer_pub: bytes) -> bytes:
    s = scalar_mult(priv, peer_pub)
    if s == bytes(32):  # all-zero output: low-order point (RFC 7748 §6.1)
        raise ValueError("x25519: low-order peer public key")
    return s
