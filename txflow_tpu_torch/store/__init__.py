"""Storage: the in-memory and durable KV backends and the fast-path
TxStore."""

from .db import DB, FileDB, MemDB
from .tx_store import TxStore

__all__ = ["DB", "FileDB", "MemDB", "TxStore"]
