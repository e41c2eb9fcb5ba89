"""Deterministic stake-proportional per-epoch committee sampling
(counterpart of ``txflow_tpu/committee/sampler.py``).

Each epoch elects a small stake-proportional voting committee and only its
members sign tx votes; the committee quorum is >2/3 of COMMITTEE stake, so
certificate size and verify cost are flat in validator count.

Election is message-free and identical on every node: weighted draws
WITHOUT replacement over the epoch's address-sorted validator set, each
draw one sha256 of ``seed || counter``, the seed a domain-separated digest
of ``(chain_id, epoch)``. Integer arithmetic only. Members keep their
original powers, so a committee is an ordinary ``ValidatorSet`` and every
tally, quorum, revalidate and restage path works on it unchanged.
"""

from __future__ import annotations

import hashlib

from ..types.validator import ValidatorSet
from ..utils.domains import COMMITTEE_V1

SEED_DOMAIN = COMMITTEE_V1


def committee_seed(chain_id: str, epoch: int) -> bytes:
    """sha256 over the domain tag, chain_id and epoch number."""
    h = hashlib.sha256()
    h.update(SEED_DOMAIN)
    h.update(b"|")
    h.update(chain_id.encode())
    h.update(b"|")
    h.update(int(epoch).to_bytes(8, "big"))
    return h.digest()


def _draw(seed: bytes, counter: int, bound: int) -> int:
    """Deterministic integer in [0, bound): sha256(seed || counter) mod
    bound (the modulo bias over 256 bits is negligible)."""
    d = hashlib.sha256(seed + counter.to_bytes(8, "big")).digest()
    return int.from_bytes(d, "big") % bound


def sample_committee(
    full_set: ValidatorSet,
    chain_id: str,
    epoch: int,
    size: int,
    min_size: int = 4,
    min_stake_frac: float = 0.0,
) -> ValidatorSet:
    """The epoch's committee: stake-proportional draws without replacement
    from ``full_set`` until both floors are met. Returns ``full_set``
    itself when the target covers the whole set."""
    n = full_set.size()
    target = max(int(size), int(min_size), 1)
    if target >= n:
        return full_set
    total = full_set.total_voting_power()
    # integer ceil(frac * total), as the JAX package computes it
    floor_stake = -(-int(min_stake_frac * total * 2**20) // 2**20) if min_stake_frac > 0 else 0
    floor_stake = min(floor_stake, total)

    seed = committee_seed(chain_id, epoch)
    remaining = list(full_set.validators)
    weights = [v.voting_power for v in remaining]
    rem_total = total
    chosen = []
    chosen_stake = 0
    counter = 0
    while remaining and (len(chosen) < target or chosen_stake < floor_stake):
        r = _draw(seed, counter, rem_total)
        counter += 1
        acc = 0
        j = 0
        for j, w in enumerate(weights):
            acc += w
            if r < acc:
                break
        v = remaining.pop(j)
        w = weights.pop(j)
        rem_total -= w
        chosen.append(v)
        chosen_stake += w
    return ValidatorSet(chosen)


class CommitteeSchedule:
    """Per-node committee resolver: (vote height, full set) -> committee.

    A vote at height ``h`` certifies a tx that commits in block ``h+1``, so
    the committee for votes at ``h`` is the one of ``epoch_of(h+1)``. The
    small cache is keyed by (epoch, full-set hash), so a rotated full set
    is never served an old sample, and one object is returned per key (the
    engine's rotation check compares sets by content anyway)."""

    def __init__(self, chain_id: str, cfg):
        self.chain_id = chain_id
        self.cfg = cfg
        self._cache: dict[tuple, ValidatorSet] = {}

    def epoch_for_vote_height(self, height: int) -> int:
        return self.cfg.epoch_of(height + 1)

    def committee_at(self, epoch: int, full_set: ValidatorSet) -> ValidatorSet:
        key = (epoch, full_set.hash())
        c = self._cache.get(key)
        if c is None:
            c = sample_committee(
                full_set,
                self.chain_id,
                epoch,
                self.cfg.committee_size,
                min_size=self.cfg.committee_min_size,
                min_stake_frac=self.cfg.committee_min_stake_frac,
            )
            if len(self._cache) > 8:
                self._cache.clear()
            c = self._cache.setdefault(key, c)
        return c

    def for_vote_height(self, height: int, full_set: ValidatorSet) -> ValidatorSet:
        return self.committee_at(self.epoch_for_vote_height(height), full_set)
