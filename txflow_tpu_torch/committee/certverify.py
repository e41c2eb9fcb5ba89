"""BatchCertVerifier: the scalar verifier's decisions, one K6 launch per
certificate batch (counterpart of ``txflow_tpu/committee/certverify.py``).

Committee certificates are small, so a per-signature host verify loop is
all per-call overhead; this verifier checks a whole batch of certificate
votes with ONE launch of the hand-written verify kernel (``txf_verify``,
``csrc/verify.cu``) over the committee's own device-resident window
tables, and tallies stake on the host in int64. It is a drop-in
``ScalarVoteVerifier``: the sync client builds one per validator-set
fingerprint, and a committee-mode engine mounts it directly (``submit``
routes through ``verify_and_tally``).

Shapes: a batch pads to a power-of-two rung (floor 8); the tables are
[V, 16, 4, NLIMB] and their quarter tables [V, 3, 16, 4, NLIMB] (the
four-lane kernel reads both) with V the committee size, unpadded, in the
field that
``fe_radix`` picks at construction (25 or 13, ``ops/field.py``; None
reads ``TXFLOW_FE_RADIX`` then) and every restage keeps. Below ``min_batch``
rows the parent's host loop runs instead -- a size rule, counted in
``scalar_calls``; a failed launch raises and is never answered by the
host loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ed25519_batch as ops_ed
from ..ops import field
from ..types.validator import ValidatorSet
from ..verifier import (
    ScalarVoteVerifier,
    TallyResult,
    _pad,
    first_occurrence_mask,
    resolve_device,
)


def _rung(n: int) -> int:
    """Power-of-two padding rung, floor 8."""
    target = max(int(n), 8)
    return 1 << (target - 1).bit_length()


class BatchCertVerifier(ScalarVoteVerifier):
    def __init__(self, val_set: ValidatorSet, min_batch: int = 4, device=None,
                 fe_radix: int | None = None):
        self.device = resolve_device(device)
        self.fe_radix = field.resolve(fe_radix)
        self.min_batch = int(min_batch)
        # evidence counters: kernel launches vs host-loop calls, and the
        # rows the launches carried
        self.batch_calls = 0
        self.scalar_calls = 0
        self.batched_votes = 0
        super().__init__(val_set)  # stages the set through restage()

    def restage(self, new_val_set: ValidatorSet) -> bool:
        """Swap in a new validator set. The window tables and their
        quarter tables are built and uploaded once per stage (never per
        call); an unchanged set keeps its staged tables with no upload.
        Everything is built and both tensors uploaded before the one stage
        tuple swaps, so a failed build or upload leaves the old stage
        whole, and the host loop and the kernel path always read the same
        set. The uploads are ordered on the current stream, so every later
        launch on it reads the new tables."""
        old = getattr(self, "_stage", None)
        if old is not None and old[0].hash() == new_val_set.hash():
            return True
        pub_keys = [v.pub_key for v in new_val_set]
        epoch = ops_ed.EpochTables(pub_keys, self.fe_radix)
        tables = epoch.device_tables(self.device)
        quarters = epoch.device_quarter_tables(self.device)
        if tables.shape[0] != new_val_set.size() or quarters.shape[0] != tables.shape[0]:
            raise RuntimeError("staged tables do not match the validator set")
        # (val_set, pub_keys, powers) as the parent reads it, then the
        # kernel path's epoch and tables
        self._stage = (new_val_set, pub_keys, new_val_set.powers_array(), epoch, tables,
                       quarters)
        return True

    def verify_and_tally(
        self,
        msgs,
        sigs,
        val_idx,
        tx_slot,
        n_slots,
        prior_stake=None,
        quorum=None,
    ) -> TallyResult:
        n = len(msgs)
        if n < self.min_batch:
            self.scalar_calls += 1
            return super().verify_and_tally(
                msgs, sigs, val_idx, tx_slot, n_slots,
                prior_stake=prior_stake, quorum=quorum,
            )
        val_set, _, powers, epoch, tables, quarters = self._stage
        val_idx = np.asarray(val_idx, dtype=np.int64)
        tx_slot = np.asarray(tx_slot, dtype=np.int64)
        keep = first_occurrence_mask(tx_slot, val_idx)

        # host prep: nibbles + pre-checks (S < L, key on curve, index in
        # range -- an out-of-range row comes back pre_ok False with its
        # index clipped into [0, V))
        batch = ops_ed.prepare_compact(msgs, sigs, val_idx, epoch)
        vi = batch.val_idx
        if vi.size and (int(vi.max()) >= tables.shape[0] or int(vi.min()) < 0):
            raise RuntimeError("prepared validator index outside the staged tables")
        # a repeated (slot, validator) row is never computed; like the
        # host loop, it comes back invalid and dropped
        pre_ok = batch.pre_ok & keep
        pad = _rung(n) - n

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(_pad(a, pad))).to(self.device)

        # ONE launch for the whole batch; padding rows carry pre_ok False
        out = ops_ed.verify_kernel_gather(
            dev(batch.s_nibbles), dev(batch.h_nibbles), dev(batch.val_idx),
            tables, quarters, dev(batch.r_y), dev(batch.r_sign), dev(pre_ok),
            fe_radix=self.fe_radix,
        )
        self.batch_calls += 1
        self.batched_votes += n
        valid = out[:n].cpu().numpy().copy()
        valid &= keep

        stake = (
            np.zeros(n_slots, dtype=np.int64)
            if prior_stake is None
            else np.asarray(prior_stake, dtype=np.int64).copy()
        )
        ok = valid & (tx_slot >= 0) & (tx_slot < n_slots)
        if ok.any():
            np.add.at(stake, tx_slot[ok], powers[val_idx[ok]].astype(np.int64))
        q = val_set.quorum_power() if quorum is None else quorum
        return TallyResult(valid, stake, stake >= q, ~keep)
