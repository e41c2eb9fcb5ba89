from .hash import address_hash, sha256, tx_hash, tx_key
from . import ed25519

__all__ = ["address_hash", "sha256", "tx_hash", "tx_key", "ed25519"]
