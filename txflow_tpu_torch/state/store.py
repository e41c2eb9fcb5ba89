"""Per-height validator-set records (counterpart of the validator rows of
``txflow_tpu/state/store.py``; the chain-state and ABCI-response rows
belong to the block path, which the port does not carry yet).

Rows ``validatorsKey:H`` hold the set in force at height H as
deterministic JSON, the same codec the sync wire format uses for its
validator-set snapshots, so both packages write identical bytes.
"""

from __future__ import annotations

import json

from ..store.db import DB
from ..types.validator import Validator, ValidatorSet


def _vals_to_obj(vs: ValidatorSet | None):
    if vs is None:
        return None
    return [
        {
            "address": v.address.hex(),
            "pub_key": v.pub_key.hex(),
            "power": v.voting_power,
            "priority": v.proposer_priority,
        }
        for v in vs
    ]


def _vals_from_obj(obj) -> ValidatorSet | None:
    if obj is None:
        return None
    return ValidatorSet(
        [
            Validator(
                bytes.fromhex(d["address"]),
                bytes.fromhex(d["pub_key"]),
                d["power"],
                d["priority"],
            )
            for d in obj
        ]
    )


class StateStore:
    def __init__(self, db: DB):
        self.db = db

    def save_validators(self, height: int, vals: ValidatorSet) -> None:
        self.db.set(
            b"validatorsKey:%d" % height,
            json.dumps(_vals_to_obj(vals), sort_keys=True).encode(),
        )

    def load_validators(self, height: int) -> ValidatorSet | None:
        raw = self.db.get(b"validatorsKey:%d" % height)
        return _vals_from_obj(json.loads(raw)) if raw is not None else None
