"""Stake-weighted quorum tally and the fused aggregation step (K4), and
the tally pieces of the sharded step (K7).

Counterpart of ``txflow_tpu/ops/tally.py``. One step verifies a compact
batch and adds each valid vote's power into its tx slot on top of the
slot's prior stake, then compares with the quorum; the three results come
back packed in one int32 vector ``[valid (B) | stake (S) | maj23 (S)]``
so the host reads the device once. On a card the tally has no launch of
its own: it rides in the verify's encode launch
(``ed25519_batch.verify_tally_into``, ``csrc/verify.cu``), one ctypes
call and two kernel launches a step. Over a mesh (``parallel/mesh.py``)
each shard's fused launch leaves its partial (``compact_step_partial``),
the partials cross to the mesh's first card, and one ``reduce_quorum``
adds them and the prior and compares -- the psum of the JAX step;
``ring_add`` is one hop of the ring form. The standalone kernels
(``tally_into``, ``tally_partial``) stay as the counterparts of the fused
tally and the yardstick of its cost; no served step launches them.
``verify_and_tally`` is the unfused composition of any verify kernel with
the tally, on one device or over a mesh.

Voting power is int32 on the device, as in the JAX package: with per-batch
dedup, per-slot batch stake and prior stake are each at most the total
power, so their sum stays below 2^31 while total power is below 2^30.
A set of total power >= 2^30 runs the same steps in int64 (the JAX engine
serves it on its host verifier): powers, prior and partials are int64
tensors, and every wrapper here takes the int64 kernel when it is given
them (``tally64``, ``tally_partial64``, ``reduce_quorum64``). The packed
readback then holds the stake segment as S int64 in 2S int32 words
(``[valid (B) | stake (2S words) | maj23 (S)]``, ``packed_stake``). The
plain versions are the same functions for both widths.
"""

from __future__ import annotations

import torch

from . import _lib, ed25519_batch


def is_wide(powers) -> bool:
    """The int64 form: powers (per validator, per vote or per shard) are
    int64. A list of per-shard tensors is judged by its first."""
    t = powers[0] if isinstance(powers, (list, tuple)) else powers
    return t.dtype == torch.int64


def packed_size(b: int, s: int, wide: bool) -> int:
    """int32 words of the packed readback ``[valid | stake | maj23]``."""
    return b + (3 if wide else 2) * s


def packed_stake(packed, b: int, s: int, wide: bool):
    """(stake [S] int32 or int64, maj23 int32 [S]) out of a packed vector
    (a tensor or a numpy array, on the host or a card)."""
    sw = 2 * s if wide else s
    stake, maj = packed[b : b + sw], packed[b + sw : b + sw + s]
    if wide:
        if isinstance(stake, torch.Tensor):
            stake = stake.contiguous().view(torch.int64)
        else:
            stake = stake.copy().view("<i8")
    return stake, maj


def tally_kernel(valid, tx_slot, power, n_slots: int) -> torch.Tensor:
    """Per-slot stake sums (plain version): [n_slots] of power's dtype
    (int32, or int64 for the wide form).

    valid: bool [B]; tx_slot: int32 [B] (-1 or >= n_slots = no slot);
    power: [B] voting power of each vote's validator."""
    in_range = (tx_slot >= 0) & (tx_slot < n_slots)
    contrib = torch.where(valid & in_range, power, torch.zeros_like(power))
    slot = tx_slot.to(torch.int64).clamp(0, max(n_slots - 1, 0))
    out = torch.zeros(n_slots, dtype=power.dtype, device=power.device)
    return out.index_add_(0, slot, contrib)


def tally_plain(valid, tx_slot, val_idx, powers, prior, quorum: int):
    """Plain version of the tally kernel: (stake [S] of the powers' dtype,
    maj23 int32 [S])."""
    power = powers[val_idx.to(torch.int64).clamp(0, powers.shape[0] - 1)]
    total = prior + tally_kernel(valid.to(torch.bool), tx_slot, power, prior.shape[0])
    return total, (total >= quorum).to(torch.int32)


def tally_into(stake, maj, valid, tx_slot, val_idx, powers, prior, quorum: int):
    """Launch the standalone CUDA tally kernel: stake = prior +
    segment-sum of valid votes' power, maj = stake >= quorum (int32 CUDA
    tensors; ``valid`` is the int32 validity the verify kernel wrote).
    With int64 ``powers`` and ``prior`` the int64 kernel runs and
    ``stake`` is the int32 [2S] word segment of the packed readback. The
    counterpart of the tally that ``compact_step_packed`` carries in its
    verify launch; no served step calls it."""
    b, s = valid.shape[0], prior.shape[0]
    wide = is_wide(powers)
    acc_t = torch.int64 if wide else torch.int32
    _lib.check_all(
        (stake, torch.int32, (2 * s if wide else s,), "stake"),
        (maj, torch.int32, (s,), "maj"),
        (valid, torch.int32, (b,), "valid"),
        (tx_slot, torch.int32, (b,), "tx_slot"),
        (val_idx, torch.int32, (b,), "val_idx"),
        (powers, acc_t, (-1,), "powers"),
        (prior, acc_t, (s,), "prior"),
    )
    if powers.shape[0] == 0:
        raise ValueError("powers: empty validator set")
    # the kernel runs over the slots (it writes maj23 even with no votes)
    if wide:
        acc = torch.empty((s,), dtype=torch.int64, device=stake.device)
        _lib.launch(
            "tally64", "txf_tally64", stake, s, valid.data_ptr(), tx_slot.data_ptr(),
            val_idx.data_ptr(), powers.data_ptr(), powers.shape[0], prior.data_ptr(),
            int(quorum), acc.data_ptr(), stake.data_ptr(), maj.data_ptr(), b, s,
        )
        return
    _lib.launch(
        "tally", "txf_tally", stake, s, valid.data_ptr(), tx_slot.data_ptr(),
        val_idx.data_ptr(), powers.data_ptr(), powers.shape[0], prior.data_ptr(),
        int(quorum), stake.data_ptr(), maj.data_ptr(), b, s,
    )


def compact_step_packed_plain(
    s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, quarter_tables, powers,
    prior_stake, quorum: int, fe_radix: int = 25,
) -> torch.Tensor:
    """Plain version of the fused step, on the inputs' device: the packed
    ``[valid | stake | maj23]`` of the plain verify and the plain tally."""
    valid = ed25519_batch.verify_kernel_gather_plain(
        s_nib, h_nib, val_idx, tables, quarter_tables, r_y, r_sign, pre_ok, fe_radix=fe_radix,
    )
    stake, maj = tally_plain(valid, tx_slot, val_idx, powers, prior_stake, quorum)
    return torch.cat([valid.to(torch.int32), stake.view(torch.int32), maj])


def compact_step_packed(
    s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, quarter_tables, powers,
    prior_stake, quorum: int, fe_radix: int = 25,
) -> torch.Tensor:
    """The fused aggregation step: int32 packed ``[valid | stake | maj23]``
    (``packed_size``: B + 2S words, or B + 3S in the int64 form that int64
    powers and prior select). On a card one ctypes call and two kernel
    launches (the four-lane verify over the ``fe_radix`` field and the
    epoch's ``tables`` and ``quarter_tables``, its encode launch carrying
    the tally into the same buffer: ``verify[13]_tally[64]`` in
    ``_lib.launches``; ``powers`` one per table row); the plain versions
    for CPU tensors."""
    b, s = s_nib.shape[0], prior_stake.shape[0]
    wide = is_wide(powers)
    if s_nib.device.type == "cpu":
        return compact_step_packed_plain(
            s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, quarter_tables,
            powers, prior_stake, quorum, fe_radix=fe_radix,
        )
    packed = torch.empty((packed_size(b, s, wide),), dtype=torch.int32, device=s_nib.device)
    ed25519_batch.verify_tally_into(
        packed, s_nib, h_nib, val_idx, tables, quarter_tables, r_y, r_sign, pre_ok, tx_slot,
        powers, prior_stake, quorum, fe_radix=fe_radix,
    )
    return packed


def compact_step(
    s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, quarter_tables, powers,
    prior_stake, quorum: int, fe_radix: int = 25,
):
    """The fused step's three results unpacked: (valid bool [B], stake
    [S] including prior (int32, or int64 in the wide form), maj23 bool
    [S])."""
    b, s = s_nib.shape[0], prior_stake.shape[0]
    packed = compact_step_packed(
        s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, quarter_tables, powers,
        prior_stake, quorum, fe_radix=fe_radix,
    )
    stake, maj = packed_stake(packed, b, s, is_wide(powers))
    return packed[:b].to(torch.bool), stake, maj.to(torch.bool)


def tally_partial_plain(valid, tx_slot, val_idx, powers, n_slots: int) -> torch.Tensor:
    """Plain version of the partial tally: [n_slots] of the powers' dtype,
    no prior, no compare. ``val_idx`` None: ``powers`` holds each vote's
    own power."""
    if val_idx is None:
        power = powers
    else:
        power = powers[val_idx.to(torch.int64).clamp(0, powers.shape[0] - 1)]
    return tally_kernel(valid.to(torch.bool), tx_slot, power, n_slots)


def tally_partial(valid, tx_slot, val_idx, powers, n_slots: int) -> torch.Tensor:
    """One shard's partial stake per slot (K7, the K4 kernel with no prior
    and no compare): [n_slots] of the powers' dtype (int64 powers take
    ``txf_tally_partial64``). ``valid`` is int32 0/1 on a card;
    ``val_idx`` None means ``powers`` is per vote ([B]), else per
    validator, gathered by index."""
    if valid.device.type == "cpu":
        return tally_partial_plain(valid, tx_slot, val_idx, powers, n_slots)
    b = valid.shape[0]
    acc_t = torch.int64 if is_wide(powers) else torch.int32
    if val_idx is None:
        _lib.check_all(
            (valid, torch.int32, (b,), "valid"),
            (tx_slot, torch.int32, (b,), "tx_slot"),
            (powers, acc_t, (b,), "powers"),
        )
    else:
        _lib.check_all(
            (valid, torch.int32, (b,), "valid"),
            (tx_slot, torch.int32, (b,), "tx_slot"),
            (val_idx, torch.int32, (b,), "val_idx"),
            (powers, acc_t, (-1,), "powers"),
        )
        if powers.shape[0] == 0:
            raise ValueError("powers: empty validator set")
    out = torch.empty((n_slots,), dtype=acc_t, device=valid.device)
    kernel, fn = (("tally_partial64", "txf_tally_partial64") if acc_t == torch.int64
                  else ("tally_partial", "txf_tally_partial"))
    _lib.launch(
        kernel, fn, out, n_slots, valid.data_ptr(),
        tx_slot.data_ptr(), None if val_idx is None else val_idx.data_ptr(),
        powers.data_ptr(), powers.shape[0], out.data_ptr(), b, n_slots,
    )
    return out


def reduce_quorum_plain(parts, prior, quorum: int):
    """Plain version of the reduction: (stake [S] of the parts' dtype,
    maj23 int32 [S]) with stake = prior + parts[0] + ... + parts[n-1], in
    that order."""
    stake = prior.to(parts.dtype)
    for k in range(parts.shape[0]):
        stake = stake + parts[k]
    return stake, (stake >= quorum).to(torch.int32)


def reduce_quorum(parts, prior, quorum: int, stake=None, maj=None):
    """The psum's last step on one card (K7): sum the n partials of
    ``parts`` [n, S] and the prior, compare with the quorum. int64 parts
    and prior take ``txf_reduce_quorum64``. Writes into ``stake``/``maj``
    when given (e.g. the packed segments: int32 [S], or for int64 the
    int32 [2S] word segment); returns (stake, maj), a new stake being
    int32 or int64 [S]."""
    wide = is_wide(parts)
    if parts.device.type == "cpu":
        st, mj = reduce_quorum_plain(parts, prior, quorum)
        if stake is None:
            return st, mj
        stake.copy_(st.view(torch.int32) if wide else st)
        maj.copy_(mj)
        return stake, maj
    s = prior.shape[0]
    acc_t = torch.int64 if wide else torch.int32
    if stake is None:
        _lib.check_all((parts, acc_t, (-1, s), "parts"), (prior, acc_t, (s,), "prior"))
        stake = torch.empty((s,), dtype=acc_t, device=parts.device)
        maj = torch.empty((s,), dtype=torch.int32, device=parts.device)
    else:
        _lib.check_all(
            (parts, acc_t, (-1, s), "parts"),
            (prior, acc_t, (s,), "prior"),
            (stake, torch.int32, (2 * s if wide else s,), "stake"),
            (maj, torch.int32, (s,), "maj"),
        )
    kernel, fn = ("reduce_quorum64", "txf_reduce_quorum64") if wide else (
        "reduce_quorum", "txf_reduce_quorum")
    _lib.launch(
        kernel, fn, stake, s, parts.data_ptr(),
        parts.shape[0], prior.data_ptr(), int(quorum), stake.data_ptr(),
        maj.data_ptr(), s,
    )
    return stake, maj


def ring_add_plain(acc, b) -> torch.Tensor:
    return acc.add_(b)


def ring_add(acc, b) -> torch.Tensor:
    """One ring hop's accumulate (K7), in place: acc += b over int32 [S]
    on acc's card; returns ``acc``. The caller owns ``acc`` (``ring_tally``
    starts from a copy of each partial). The int64 form has no ring
    kernel: an int64 partial raises on a card."""
    if acc.device.type == "cpu":
        return ring_add_plain(acc, b)
    s = acc.shape[0]
    _lib.check_all((acc, torch.int32, (s,), "acc"), (b, torch.int32, (s,), "b"))
    _lib.launch("ring_add", "txf_add", acc, s, acc.data_ptr(), b.data_ptr(), s)
    return acc


def compact_step_partial(
    s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, quarter_tables, powers,
    n_slots: int, fe_radix: int = 25, partial=None,
):
    """One shard's half of the sharded fused step: (packed int32
    [``packed_size``] with ``valid`` written into its head and the
    stake/maj23 segments left for the psum, partial [S] of the powers'
    dtype). ``partial`` is where the partial goes (e.g. the shard's row of
    the reduce's [n, S] buffer), else a new tensor. On a card one ctypes
    call and two kernel launches (the verify over the ``fe_radix`` field,
    its encode launch carrying the partial tally:
    ``verify[13]_partial[64]``); the plain versions on the CPU."""
    b = s_nib.shape[0]
    size = packed_size(b, n_slots, is_wide(powers))
    if s_nib.device.type == "cpu":
        valid = ed25519_batch.verify_kernel_gather_plain(
            s_nib, h_nib, val_idx, tables, quarter_tables, r_y, r_sign, pre_ok,
            fe_radix=fe_radix,
        ).to(torch.int32)
        packed = torch.cat([valid, torch.zeros(size - b, dtype=torch.int32)])
        part = tally_partial_plain(valid, tx_slot, val_idx, powers, n_slots)
        return packed, part if partial is None else partial.copy_(part)
    packed = torch.empty((size,), dtype=torch.int32, device=s_nib.device)
    if partial is None:
        partial = torch.empty((n_slots,), dtype=powers.dtype, device=s_nib.device)
    ed25519_batch.verify_tally_into(
        packed, s_nib, h_nib, val_idx, tables, quarter_tables, r_y, r_sign, pre_ok, tx_slot,
        powers, partial=partial, fe_radix=fe_radix,
    )
    return packed, partial


def verify_and_tally(verify_fn, mesh=None):
    """Compose a verify kernel with the quorum tally (unfused).

    Returns f(verify_inputs, tx_slot, power, prior_stake, quorum) ->
    (valid, stake, maj23): ``verify_inputs`` is the tuple ``verify_fn``
    takes, ``power`` [B] each vote's power, ``prior_stake`` [S] (both
    int32, or both int64 for the wide form). On one device the three are tensors; over ``mesh`` the vote axis
    is split across its shards and each result is a per-shard list (valid
    per shard, stake and maj23 the global ones on every shard)."""

    def one(verify_inputs, tx_slot, power, n_slots):
        valid = verify_fn(*verify_inputs)
        partial = tally_partial(valid.to(torch.int32), tx_slot, None, power, n_slots)
        return valid, partial

    def f(verify_inputs, tx_slot, power, prior_stake, quorum):
        s = prior_stake.shape[0]
        if mesh is None:
            valid, partial = one(verify_inputs, tx_slot, power, s)
            stake, maj = reduce_quorum(partial[None], prior_stake, quorum)
            return valid, stake, maj.to(torch.bool)
        from ..parallel.mesh import psum_quorum

        ins = [mesh.shard(x) for x in (*verify_inputs, tx_slot, power)]
        valid, partials = zip(*(
            one([x[i] for x in ins[:-2]], ins[-2][i], ins[-1][i], s) for i in range(mesh.size)
        ))
        stake, maj = psum_quorum(mesh, list(partials), prior_stake, quorum)
        return list(valid), stake, [m.to(torch.bool) for m in maj]

    return f
