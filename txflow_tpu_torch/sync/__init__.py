"""Catch-up sync: wiped, lagging and freshly joined nodes recover the
committed set from their peers over the sync channel. The reactor serves
ranges of the commit-order log and carries adverts and responses; the
manager detects lag, fetches with a bounded window, re-verifies every
certificate (one K6 launch per committee group in committee mode) and
applies it."""

from .config import SyncConfig
from .manager import SyncError, SyncManager
from .reactor import CHANNEL_SYNC, SyncReactor, serve_range

__all__ = ["SyncConfig", "SyncError", "SyncManager", "SyncReactor", "CHANNEL_SYNC",
           "serve_range"]
