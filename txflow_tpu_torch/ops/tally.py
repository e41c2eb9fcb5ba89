"""Stake-weighted quorum tally and the fused aggregation step (K4), and
the tally pieces of the sharded step (K7).

Counterpart of ``txflow_tpu/ops/tally.py``. One step verifies a compact
batch and adds each valid vote's power into its tx slot on top of the
slot's prior stake, then compares with the quorum; the three results come
back packed in one int32 vector ``[valid (B) | stake (S) | maj23 (S)]``
so the host reads the device once. Over a mesh (``parallel/mesh.py``)
each shard tallies its votes into a partial (``tally_partial``), the
partials cross cards, and ``reduce_quorum`` adds them and the prior and
compares -- the psum of the JAX step; ``ring_add`` is one hop of the
ring form. ``verify_and_tally`` is the unfused composition of any verify
kernel with the tally, on one device or over a mesh.

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
    _lib.same_card(stake, maj, valid, tx_slot, val_idx, powers, prior)
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


def tally_partial_plain(valid, tx_slot, val_idx, powers, n_slots: int) -> torch.Tensor:
    """Plain version of the partial tally: int32 [n_slots], no prior, no
    compare. ``val_idx`` None: ``powers`` holds each vote's own power."""
    if val_idx is None:
        power = powers
    else:
        power = powers[val_idx.to(torch.int64).clamp(0, powers.shape[0] - 1)]
    return tally_kernel(valid.to(torch.bool), tx_slot, power, n_slots)


def tally_partial(valid, tx_slot, val_idx, powers, n_slots: int) -> torch.Tensor:
    """One shard's partial stake per slot (K7, the K4 kernel with no prior
    and no compare): int32 [n_slots]. ``valid`` is int32 0/1 on a card;
    ``val_idx`` None means ``powers`` is per vote ([B]), else per
    validator, gathered by index."""
    if valid.device.type == "cpu":
        return tally_partial_plain(valid, tx_slot, val_idx, powers, n_slots)
    b = valid.shape[0]
    _lib.check(valid, torch.int32, (b,), "valid")
    _lib.check(tx_slot, torch.int32, (b,), "tx_slot")
    if val_idx is None:
        _lib.check(powers, torch.int32, (b,), "powers")
    else:
        _lib.check(val_idx, torch.int32, (b,), "val_idx")
        _lib.check(powers, torch.int32, (-1,), "powers")
        if powers.shape[0] == 0:
            raise ValueError("powers: empty validator set")
        _lib.same_card(val_idx, valid)
    _lib.same_card(valid, tx_slot, powers)
    out = torch.empty((n_slots,), dtype=torch.int32, device=valid.device)
    _lib.launch(
        "tally_partial", "txf_tally_partial", out, n_slots, valid.data_ptr(),
        tx_slot.data_ptr(), None if val_idx is None else val_idx.data_ptr(),
        powers.data_ptr(), powers.shape[0], out.data_ptr(), b, n_slots,
    )
    return out


def reduce_quorum_plain(parts, prior, quorum: int):
    """Plain version of the reduction: (stake int32 [S], maj23 int32 [S])
    with stake = prior + parts[0] + ... + parts[n-1], in that order."""
    stake = prior.to(torch.int32)
    for k in range(parts.shape[0]):
        stake = stake + parts[k]
    return stake, (stake >= quorum).to(torch.int32)


def reduce_quorum(parts, prior, quorum: int, stake=None, maj=None):
    """The psum's last step on one card (K7): sum the n partials of int32
    [n, S] ``parts`` and the prior, compare with the quorum. Writes into
    ``stake``/``maj`` (int32 [S], e.g. the packed segments) when given;
    returns (stake, maj)."""
    if parts.device.type == "cpu":
        st, mj = reduce_quorum_plain(parts, prior, quorum)
        if stake is None:
            return st, mj
        stake.copy_(st)
        maj.copy_(mj)
        return stake, maj
    s = prior.shape[0]
    _lib.check(parts, torch.int32, (-1, s), "parts")
    _lib.check(prior, torch.int32, (s,), "prior")
    if stake is None:
        stake = torch.empty((s,), dtype=torch.int32, device=parts.device)
        maj = torch.empty((s,), dtype=torch.int32, device=parts.device)
    _lib.check(stake, torch.int32, (s,), "stake")
    _lib.check(maj, torch.int32, (s,), "maj")
    _lib.same_card(parts, prior, stake, maj)
    _lib.launch(
        "reduce_quorum", "txf_reduce_quorum", stake, s, parts.data_ptr(),
        parts.shape[0], prior.data_ptr(), int(quorum), stake.data_ptr(),
        maj.data_ptr(), s,
    )
    return stake, maj


def ring_add_plain(a, b) -> torch.Tensor:
    return a + b


def ring_add(a, b) -> torch.Tensor:
    """One ring hop's accumulate (K7): int32 [S] a + b, on a's card."""
    if a.device.type == "cpu":
        return ring_add_plain(a, b)
    s = a.shape[0]
    _lib.check(a, torch.int32, (s,), "a")
    _lib.check(b, torch.int32, (s,), "b")
    _lib.same_card(a, b)
    out = torch.empty_like(a)
    _lib.launch("ring_add", "txf_add", out, s, a.data_ptr(), b.data_ptr(), out.data_ptr(), s)
    return out


def compact_step_partial(
    s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, powers, n_slots: int
):
    """One shard's half of the sharded fused step: (packed int32
    [B + 2S] with ``valid`` written into its head and the stake/maj23
    segments left for ``reduce_quorum``, partial int32 [S]). Two launches
    on a card (verify, partial tally); the plain versions on the CPU."""
    b = s_nib.shape[0]
    if s_nib.device.type == "cpu":
        valid = ed25519_batch.verify_kernel_gather_plain(
            s_nib, h_nib, val_idx, tables, r_y, r_sign, pre_ok
        ).to(torch.int32)
        packed = torch.cat([valid, torch.zeros(2 * n_slots, dtype=torch.int32)])
        return packed, tally_partial_plain(valid, tx_slot, val_idx, powers, n_slots)
    packed = torch.empty((b + 2 * n_slots,), dtype=torch.int32, device=s_nib.device)
    valid = packed[:b]
    ed25519_batch.verify_into(valid, s_nib, h_nib, val_idx, tables, r_y, r_sign, pre_ok)
    return packed, tally_partial(valid, tx_slot, val_idx, powers, n_slots)


def verify_and_tally(verify_fn, mesh=None):
    """Compose a verify kernel with the quorum tally (unfused).

    Returns f(verify_inputs, tx_slot, power, prior_stake, quorum) ->
    (valid, stake, maj23): ``verify_inputs`` is the tuple ``verify_fn``
    takes, ``power`` int32 [B] each vote's power, ``prior_stake`` int32
    [S]. On one device the three are tensors; over ``mesh`` the vote axis
    is split across its shards and each result is a per-shard list (valid
    per shard, stake and maj23 the global ones on every shard)."""

    def one(verify_inputs, tx_slot, power, prior_stake):
        valid = verify_fn(*verify_inputs)
        partial = tally_partial(
            valid.to(torch.int32), tx_slot, None, power, prior_stake.shape[0]
        )
        return valid, partial

    def f(verify_inputs, tx_slot, power, prior_stake, quorum):
        if mesh is None:
            valid, partial = one(verify_inputs, tx_slot, power, prior_stake)
            stake, maj = reduce_quorum(partial[None], prior_stake, quorum)
            return valid, stake, maj.to(torch.bool)
        from ..parallel.mesh import psum_quorum

        ins = [mesh.shard(x) for x in (*verify_inputs, tx_slot, power)]
        priors = mesh.replicate(prior_stake)
        valid, partials = zip(*(
            one([x[i] for x in ins[:-2]], ins[-2][i], ins[-1][i], priors[i])
            for i in range(mesh.size)
        ))
        stake, maj = psum_quorum(mesh, list(partials), priors, quorum)
        return list(valid), stake, [m.to(torch.bool) for m in maj]

    return f
