"""kvstore example app (reference test app: abci/example/kvstore).

Accepts ``key=value`` txs (or ``value`` meaning ``value=value``); maintains
a deterministic app hash (running tx count + a merkle-ish digest), and
supports ``val:pubkeyhex!power`` txs for validator-set updates the way the
upstream persistent kvstore does — the consensus tests use those to drive
validator rotation through ABCI EndBlock.
"""

from __future__ import annotations

import hashlib
import struct

from .application import Application
from .types import (
    RequestBeginBlock,
    RequestEndBlock,
    ResponseCheckTx,
    ResponseCommit,
    ResponseDeliverTx,
    ResponseEndBlock,
    ResponseInfo,
    ResponseQuery,
    ValidatorUpdate,
)

VALIDATOR_TX_PREFIX = b"val:"


class KVStoreApplication(Application):
    def __init__(self):
        self.state: dict[bytes, bytes] = {}
        self.tx_count = 0
        self.digest = hashlib.sha256(b"kvstore-genesis").digest()
        self.height = 0
        self.validators: dict[bytes, int] = {}  # pubkey -> power
        self._pending_updates: list[ValidatorUpdate] = []

    # -- handshake --

    def info(self) -> ResponseInfo:
        return ResponseInfo(
            data=f"{{\"size\":{len(self.state)}}}",
            last_block_height=self.height,
            last_block_app_hash=self.app_hash() if self.height else b"",
        )

    def init_chain(self, validators: list) -> None:
        for v in validators:
            self.validators[v.pub_key] = v.power

    # -- mempool --

    def check_tx(self, tx: bytes) -> ResponseCheckTx:
        if tx.startswith(VALIDATOR_TX_PREFIX):
            err = self._parse_val_tx(tx)[0]
            if err:
                return ResponseCheckTx(code=1, log=err)
            # validator updates apply via EndBlock: block-only
            return ResponseCheckTx(gas_wanted=1, fast_path=False)
        return ResponseCheckTx(gas_wanted=1)

    # -- consensus --

    def begin_block(self, req: RequestBeginBlock) -> None:
        self._pending_updates = []

    def deliver_tx(self, tx: bytes) -> ResponseDeliverTx:
        if tx.startswith(VALIDATOR_TX_PREFIX):
            err, pub_key, power = self._parse_val_tx(tx)
            if err:
                return ResponseDeliverTx(code=1, log=err)
            if power == 0:
                self.validators.pop(pub_key, None)
            else:
                self.validators[pub_key] = power
            self._pending_updates.append(ValidatorUpdate(pub_key, power))
        else:
            if b"=" in tx:
                key, value = tx.split(b"=", 1)
            else:
                key, value = tx, tx
            self.state[key] = value
        self.tx_count += 1
        self.digest = hashlib.sha256(self.digest + tx).digest()
        return ResponseDeliverTx(tags=[(b"app.key", tx)])

    def end_block(self, req: RequestEndBlock) -> ResponseEndBlock:
        updates, self._pending_updates = self._pending_updates, []
        return ResponseEndBlock(validator_updates=updates)

    def commit(self) -> ResponseCommit:
        self.height += 1
        return ResponseCommit(data=self.app_hash())

    def app_hash(self) -> bytes:
        return struct.pack(">Q", self.tx_count) + self.digest[:8]

    # -- query --

    def query(self, path: str, data: bytes) -> ResponseQuery:
        if path == "/store" or path == "":
            value = self.state.get(data, b"")
            return ResponseQuery(key=data, value=value, height=self.height)
        return ResponseQuery(code=1, log=f"unknown path {path}")

    @staticmethod
    def _parse_val_tx(tx: bytes):
        body = tx[len(VALIDATOR_TX_PREFIX) :]
        parts = body.split(b"!")
        if len(parts) != 2:
            return "expected 'val:pubkeyhex!power'", None, 0
        try:
            pub_key = bytes.fromhex(parts[0].decode())
            power = int(parts[1])
        except ValueError:
            return "malformed validator tx", None, 0
        if power < 0:
            return "power cannot be negative", None, 0
        return None, pub_key, power
