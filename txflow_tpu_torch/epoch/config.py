"""EpochConfig: the epoch and committee tunables (counterpart of
``txflow_tpu/epoch/config.py``, trimmed to what committee sampling reads:
the slashing and scheduled-rotation fields belong to the JAX package's
EpochManager, which the port does not carry).

Everything here must be identical across nodes: every node derives the
committee in force at a height from (config, validator set) alone.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EpochConfig:
    # blocks per epoch; 0 = one epoch forever (a static committee)
    length: int = 0

    # per-epoch tx-vote committee size; 0 disables committee mode (every
    # validator signs, certificates carry 2/3 of the full set's stake)
    committee_size: int = 0

    # safety floors: never fewer than this many members (the full set when
    # it is at or below the floor), and keep drawing until the sample holds
    # this fraction of the full set's power
    committee_min_size: int = 4
    committee_min_stake_frac: float = 0.0

    def committee_enabled(self) -> bool:
        return self.committee_size > 0

    def epoch_of(self, height: int) -> int:
        """Epoch containing ``height`` (0-based; heights start at 1)."""
        if self.length <= 0 or height <= 0:
            return 0
        return (height - 1) // self.length
