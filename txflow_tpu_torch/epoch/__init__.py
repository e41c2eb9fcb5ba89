"""Epoch configuration: which committee is in force at which height."""

from .config import EpochConfig

__all__ = ["EpochConfig"]
