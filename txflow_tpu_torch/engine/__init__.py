"""Fast-path engine: vote aggregation (TxFlow) and single-tx execution."""

from .execution import TxExecutor
from .txflow import TxFlow

__all__ = ["TxExecutor", "TxFlow"]
