"""FilePV: file-backed validator signer with double-sign protection
(reference privval/file.go:21-102 wrapping upstream FilePV; counterpart of
``txflow_tpu/privval/file.py``).

Two durable artifacts, like the reference:
- the KEY file (address, pubkey, seed) — written once at generation;
- the STATE file (last signed height/round/step + sign bytes + signature)
  — rewritten (atomically, fsync'd) BEFORE every new signature is
  released, so a crash between sign and use can never lead to signing a
  conflicting message for the same (height, round, step) after restart.

Fast-path TxVotes are NOT height/round/step-monotonic (one per tx, all at
the same height) and are signed without last-sign-state, exactly like the
reference's SignTxVote (privval/file.go:58-102); conflicting tx votes are
detected at the protocol layer (types/vote_set.py) instead.

The port carries the tx-vote signer and the height/round/step guard
(``_sign_hrs``) that block votes and proposals go through. Block-vote and
proposal signing (``txflow_tpu/privval/file.py:126-150``) wait for the
block types of the block path.
"""

from __future__ import annotations

import json
import os
import tempfile

from ..crypto import ed25519
from ..crypto.hash import address_hash
from ..types.tx_vote import TxVote

# canonical sign-step numbering (upstream privval: Propose=1, Prevote=2,
# Precommit=3)
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

class ErrDoubleSign(Exception):
    """Refusing to sign: conflicts with the persisted last-sign-state."""


def _atomic_write(path: str, payload: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".pv-")
    try:
        os.write(fd, payload)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


class FilePV:
    """PrivValidator backed by key + last-sign-state files."""

    def __init__(self, key_path: str, state_path: str, seed: bytes | None = None):
        self.key_path = key_path
        self.state_path = state_path
        if os.path.exists(key_path):
            with open(key_path) as f:
                d = json.load(f)
            self._seed = bytes.fromhex(d["priv_key"])
            self._pub_key = bytes.fromhex(d["pub_key"])
        else:
            self._seed = seed if seed is not None else ed25519.generate_seed()
            self._pub_key = ed25519.public_key_from_seed(self._seed)
            _atomic_write(
                key_path,
                json.dumps(
                    {
                        "address": address_hash(self._pub_key).hex(),
                        "pub_key": self._pub_key.hex(),
                        "priv_key": self._seed.hex(),
                    },
                    indent=1,
                ).encode(),
            )
        # last sign state (height/round/step monotonicity across restarts)
        self.last_height = 0
        self.last_round = 0
        self.last_step = 0
        self.last_sign_bytes: bytes | None = None
        self.last_sign_bytes_no_ts: bytes | None = None
        self.last_timestamp_ns = 0
        self.last_signature: bytes | None = None
        if os.path.exists(state_path):
            with open(state_path) as f:
                d = json.load(f)
            self.last_height = d["height"]
            self.last_round = d["round"]
            self.last_step = d["step"]
            self.last_sign_bytes = (
                bytes.fromhex(d["sign_bytes"]) if d.get("sign_bytes") else None
            )
            self.last_sign_bytes_no_ts = (
                bytes.fromhex(d["sign_bytes_no_ts"])
                if d.get("sign_bytes_no_ts")
                else None
            )
            self.last_timestamp_ns = d.get("timestamp_ns", 0)
            self.last_signature = (
                bytes.fromhex(d["signature"]) if d.get("signature") else None
            )

    @classmethod
    def load_or_generate(cls, directory: str, name: str = "priv_validator") -> "FilePV":
        os.makedirs(directory, exist_ok=True)
        return cls(
            os.path.join(directory, f"{name}_key.json"),
            os.path.join(directory, f"{name}_state.json"),
        )

    # -- identity --

    def get_pub_key(self) -> bytes:
        return self._pub_key

    def get_address(self) -> bytes:
        return address_hash(self._pub_key)

    # -- fast path (no HRS state; see module docstring) --

    def sign_tx_vote(self, chain_id: str, vote: TxVote) -> None:
        vote.signature = ed25519.sign(self._seed, vote.sign_bytes(chain_id))

    # -- HRS-protected signing (the double-sign guard) --

    def _sign_hrs(
        self,
        height: int,
        round_: int,
        step: int,
        sign_bytes: bytes,
        sign_bytes_no_ts: bytes,
        timestamp_ns: int,
    ) -> tuple[bytes, int]:
        """Returns (signature, timestamp_to_use)."""
        hrs = (height, round_, step)
        last = (self.last_height, self.last_round, self.last_step)
        if hrs < last:
            raise ErrDoubleSign(
                f"height/round/step regression: {hrs} < signed {last}"
            )
        if hrs == last:
            if sign_bytes == self.last_sign_bytes and self.last_signature:
                return self.last_signature, timestamp_ns  # idempotent
            if (
                sign_bytes_no_ts == self.last_sign_bytes_no_ts
                and self.last_signature
            ):
                # same message, only the timestamp differs (e.g. consensus
                # rebuilt the vote after a crash): return the STORED
                # signature + timestamp instead of stalling the validator
                # (upstream checkVotesOnlyDifferByTimestamp)
                return self.last_signature, self.last_timestamp_ns
            raise ErrDoubleSign(
                f"conflicting message at height/round/step {hrs}"
            )
        sig = ed25519.sign(self._seed, sign_bytes)
        # persist BEFORE releasing the signature (crash window safety)
        self.last_height, self.last_round, self.last_step = hrs
        self.last_sign_bytes = sign_bytes
        self.last_sign_bytes_no_ts = sign_bytes_no_ts
        self.last_timestamp_ns = timestamp_ns
        self.last_signature = sig
        self._save_state()
        return sig, timestamp_ns

    def _save_state(self) -> None:
        _atomic_write(
            self.state_path,
            json.dumps(
                {
                    "height": self.last_height,
                    "round": self.last_round,
                    "step": self.last_step,
                    "sign_bytes": (self.last_sign_bytes or b"").hex(),
                    "sign_bytes_no_ts": (self.last_sign_bytes_no_ts or b"").hex(),
                    "timestamp_ns": self.last_timestamp_ns,
                    "signature": (self.last_signature or b"").hex(),
                },
                indent=1,
            ).encode(),
        )

    def __repr__(self) -> str:
        return f"FilePV{{{self.get_address().hex().upper()}}}"
