"""Catch-up sync: a lagging node fetches a serving node's committed range
through the sync wire format, re-verifies every certificate (one K6 launch
per epoch group in committee mode) and applies it. The serving side is a
plain function; the fetch loop and its network layer are not ported yet."""

from .config import SyncConfig
from .manager import SyncError, SyncManager
from .reactor import serve_range

__all__ = ["SyncConfig", "SyncError", "SyncManager", "serve_range"]
