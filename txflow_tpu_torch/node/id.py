"""Node identity + greeting types (reference node/id.go:9-35).

The reference's file is vestigial — ``SignGreeting`` is unimplemented and
returns nil — but the shapes are part of its public surface, so they exist
here too, with the signing actually implemented (a greeting is just a
deterministic byte string under the node key; refusing to leave a stub
costs five lines). Counterpart of ``txflow_tpu/node/id.py``.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

from ..crypto import ed25519


@dataclass
class NodeID:
    name: str
    pub_key: bytes  # ed25519, 32 bytes


@dataclass
class NodeGreeting:
    node_id: NodeID
    version: str
    chain_id: str
    message: str
    time_ns: int = field(default_factory=_time.time_ns)

    def sign_bytes(self) -> bytes:
        # length-prefixed fields: free-form strings must not be able to
        # shift bytes across field boundaries (a '|' join would let
        # version='a|b' collide with chain_id-shifted variants)
        from ..codec import amino

        out = bytearray()
        for f in (
            self.node_id.name.encode(),
            self.node_id.pub_key,
            self.version.encode(),
            self.chain_id.encode(),
            self.message.encode(),
            str(self.time_ns).encode(),
        ):
            out += amino.length_prefixed(f)
        return bytes(out)


@dataclass
class SignedNodeGreeting:
    greeting: NodeGreeting
    signature: bytes

    def verify(self) -> bool:
        return ed25519.verify(
            self.greeting.node_id.pub_key,
            self.greeting.sign_bytes(),
            self.signature,
        )


@dataclass
class PrivNodeID:
    node_id: NodeID
    seed: bytes  # ed25519 seed

    def sign_greeting(
        self, version: str, chain_id: str, message: str = ""
    ) -> SignedNodeGreeting:
        g = NodeGreeting(self.node_id, version, chain_id, message)
        return SignedNodeGreeting(g, ed25519.sign(self.seed, g.sign_bytes()))
