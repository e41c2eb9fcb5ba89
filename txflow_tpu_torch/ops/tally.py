"""Stake-weighted quorum tally and the fused aggregation step (K4).

Counterpart of ``txflow_tpu/ops/tally.py``. One step verifies a compact
batch and adds each valid vote's power into its tx slot on top of the
slot's prior stake, then compares with the quorum; the three results come
back packed in one int32 vector ``[valid (B) | stake (S) | maj23 (S)]``
so the host reads the device once.

Voting power is int32 on the device, as in the JAX package: with per-batch
dedup, per-slot batch stake and prior stake are each at most the total
power, so their sum stays below 2^31 while total power is below 2^30
(``DeviceVoteVerifier`` enforces that bound).
"""

from __future__ import annotations

import torch

from . import _lib, ed25519_batch


def tally_kernel(valid, tx_slot, power, n_slots: int) -> torch.Tensor:
    """Per-slot stake sums (plain version): int32 [n_slots].

    valid: bool [B]; tx_slot: int32 [B] (-1 or >= n_slots = no slot);
    power: int32 [B] voting power of each vote's validator."""
    in_range = (tx_slot >= 0) & (tx_slot < n_slots)
    contrib = torch.where(valid & in_range, power, torch.zeros_like(power))
    slot = tx_slot.to(torch.int64).clamp(0, max(n_slots - 1, 0))
    out = torch.zeros(n_slots, dtype=torch.int32, device=power.device)
    return out.index_add_(0, slot, contrib.to(torch.int32))


def tally_plain(valid, tx_slot, val_idx, powers, prior, quorum: int):
    """Plain version of the tally kernel: (stake int32 [S], maj23 int32 [S])."""
    power = powers[val_idx.to(torch.int64).clamp(0, powers.shape[0] - 1)]
    total = prior + tally_kernel(valid.to(torch.bool), tx_slot, power, prior.shape[0])
    return total, (total >= quorum).to(torch.int32)


def tally_into(stake, maj, valid, tx_slot, val_idx, powers, prior, quorum: int):
    """Launch the CUDA tally kernel: stake = prior + segment-sum of valid
    votes' power, maj = stake >= quorum (int32 CUDA tensors; ``valid`` is
    the int32 validity the verify kernel wrote)."""
    b, s = valid.shape[0], prior.shape[0]
    _lib.check(valid, torch.int32, (b,), "valid")
    _lib.check(tx_slot, torch.int32, (b,), "tx_slot")
    _lib.check(val_idx, torch.int32, (b,), "val_idx")
    _lib.check(powers, torch.int32, (-1,), "powers")
    _lib.check(prior, torch.int32, (s,), "prior")
    _lib.check(stake, torch.int32, (s,), "stake")
    _lib.check(maj, torch.int32, (s,), "maj")
    if powers.shape[0] == 0:
        raise ValueError("powers: empty validator set")
    # the kernel runs over the slots (it writes maj23 even with no votes)
    _lib.launch(
        "tally", "txf_tally", stake, s, valid.data_ptr(), tx_slot.data_ptr(),
        val_idx.data_ptr(), powers.data_ptr(), powers.shape[0], prior.data_ptr(),
        int(quorum), stake.data_ptr(), maj.data_ptr(), b, s,
    )


def compact_step_packed(
    s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, powers,
    prior_stake, quorum: int,
) -> torch.Tensor:
    """The fused aggregation step: int32 [B + 2S] packed
    ``[valid | stake | maj23]``. Two kernel launches on a card (verify,
    then tally, both writing into one buffer); the plain versions for CPU
    tensors."""
    b, s = s_nib.shape[0], prior_stake.shape[0]
    if s_nib.device.type == "cpu":
        valid = ed25519_batch.verify_kernel_gather_plain(
            s_nib, h_nib, val_idx, tables, r_y, r_sign, pre_ok
        )
        stake, maj = tally_plain(valid, tx_slot, val_idx, powers, prior_stake, quorum)
        return torch.cat([valid.to(torch.int32), stake, maj])
    packed = torch.empty((b + 2 * s,), dtype=torch.int32, device=s_nib.device)
    valid = packed[:b]
    ed25519_batch.verify_into(
        valid, s_nib, h_nib, val_idx, tables, r_y, r_sign, pre_ok
    )
    tally_into(
        packed[b : b + s], packed[b + s :], valid, tx_slot, val_idx, powers,
        prior_stake, quorum,
    )
    return packed


def compact_step(
    s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, powers,
    prior_stake, quorum: int,
):
    """The fused step's three results unpacked: (valid bool [B], stake
    int32 [S] including prior, maj23 bool [S])."""
    b, s = s_nib.shape[0], prior_stake.shape[0]
    packed = compact_step_packed(
        s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, powers,
        prior_stake, quorum,
    )
    return packed[:b].to(torch.bool), packed[b : b + s], packed[b + s :].to(torch.bool)
