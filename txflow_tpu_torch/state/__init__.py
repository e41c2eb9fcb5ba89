"""State persistence: the per-height validator-set records the sync client
verifies certificates under."""

from .store import StateStore

__all__ = ["StateStore"]
