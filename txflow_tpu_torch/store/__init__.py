"""Storage: the in-memory KV backend and the fast-path TxStore."""

from .db import DB, MemDB
from .tx_store import TxStore

__all__ = ["DB", "MemDB", "TxStore"]
