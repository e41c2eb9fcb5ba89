"""Hashing and address derivation (tendermint crypto semantics).

- ``tx_key(tx)``: sha256(tx), the 32-byte map key (reference types/tx_vote.go:38-40).
- ``tx_hash(tx)``: uppercase-hex sha256(tx) — ``fmt.Sprintf("%X", tx.Hash())``
  (reference types/tx_vote.go:43-45; tendermint Tx.Hash is full sha256 in v0.31).
- ``address_hash(pubkey)``: first 20 bytes of sha256 (tendermint v0.31
  ed25519 PubKey.Address / crypto.AddressHash = tmhash.SumTruncated).
"""

from __future__ import annotations

import hashlib

ADDRESS_SIZE = 20


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def tx_key(tx: bytes) -> bytes:
    return sha256(tx)


def tx_hash(tx: bytes) -> str:
    return sha256(tx).hex().upper()


def address_hash(data: bytes) -> bytes:
    return sha256(data)[:ADDRESS_SIZE]
