"""Mesh construction and the sharded verify/tally steps (K7).

Counterpart of ``txflow_tpu/parallel/mesh.py``. The vote axis of a padded
batch is split into equal slices, one per shard; per-epoch constants
(window tables, powers) and the prior stake are replicated on every
shard's device. Each shard runs the verify kernel and a partial tally on
its device's current stream; then every shard gathers all partials by
peer copies and adds them with the prior (``txf_reduce_quorum``), so each
holds the identical global stake and maj23 -- the JAX step's ``psum``.
``ring_tally`` is the explicit ring instead: n-1 hops of copy-then-add.

One process drives all the cards: a function here launches on each card
in turn and returns at once, so the cards run side by side. Work on two
cards is ordered by CUDA events: before a peer copy, the consuming card's
stream waits on an event recorded on the producing card's stream after
the kernel that wrote the tensor. Shards on one device share its stream
and need no event. A mesh of CPU entries runs the plain versions.

Each step is built over one field (``fe_radix``, ``ops/field.py``) and
runs the int64 forms of the tally kernels when it is given int64 powers
and prior (a set of total power >= 2^30).

Results stay per shard, as lists of tensors (``to_host`` joins one into
the layout the JAX package's host sees): the packed step gives per shard
``[valid (B/n) | stake (S) | maj23 (S)]``, seen as ``[B + 2Sn]``; the ring
step gives every shard its own copy of the global stake and maj23.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import ed25519_batch, field, tally

VOTE_AXIS = "votes"


@dataclass(frozen=True)
class Mesh:
    """An ordered list of devices, one per shard of the vote axis. Two
    shards may share a device (a test harness's choice); ``make_mesh``
    only ever gives distinct cards."""

    devices: tuple
    axis_name: str = VOTE_AXIS

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1 or devices[0].type not in ("cpu", "cuda"):
            raise ValueError(f"a mesh is all CUDA cards or all CPU: {devices}")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def shard(self, x) -> list:
        """``x`` split along its first axis into ``size`` equal slices,
        slice i on device i; a list of per-shard tensors passes through."""
        if isinstance(x, (list, tuple)):
            if len(x) != self.size:
                raise ValueError(f"{len(x)} shards for a mesh of {self.size}")
            return list(x)
        if x.shape[0] % self.size:
            raise ValueError(
                f"{x.shape[0]} rows do not split into {self.size} shards"
            )
        return [
            c.to(d, non_blocking=True)
            for c, d in zip(x.split(x.shape[0] // self.size), self.devices)
        ]

    def replicate(self, x) -> list:
        """``x`` on every shard's device, one copy per distinct device; a
        list of per-shard tensors passes through."""
        if isinstance(x, (list, tuple)):
            return self.shard(x)
        copies: dict = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = x.to(d, non_blocking=True)
        return [copies[d] for d in self.devices]


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` visible cards (default: all),
    or ``n_devices`` CPU entries for ``device="cpu"``. Raises when fewer
    cards are visible than asked for: nothing runs on fewer cards, or on
    the CPU, in their place."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * max(1, int(n_devices or 1)))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else int(n_devices)
    if n < 1 or n > count:
        raise RuntimeError(
            f"a mesh of {n} CUDA cards was asked for and {count} are visible"
        )
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def to_host(parts) -> torch.Tensor:
    """Per-shard tensors joined on the host, shard order: the layout the
    JAX package's host reads from a vote-sharded output."""
    return torch.cat([p.cpu() for p in parts])


def _after_producer(t, device) -> None:
    """Order work that ``device``'s current stream issues next after the
    work already issued on ``t``'s card (an event recorded there, waited
    on here). Same device, or the CPU: program order already holds."""
    if t.device.type != "cuda" or t.device == device:
        return
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    torch.cuda.current_stream(device).wait_event(done)


def _peer(t, device):
    """``t`` on ``device``: itself when it is there already, else a peer
    copy ordered after the kernel that wrote it."""
    if t.device == device:
        return t
    _after_producer(t, device)
    return t.to(device, non_blocking=True)


def psum_quorum(mesh: Mesh, partials: list, priors: list, quorum: int, outs=None):
    """All-reduce of per-shard partial stake [S] (int32, or int64 for a
    set of total power >= 2^30) plus the prior, and the quorum compare, on
    every shard: shard i copies every partial into an [n, S] buffer on its
    device and runs ``reduce_quorum`` there. ``outs`` gives per shard the
    (stake, maj23) destinations, e.g. the segments of its packed output.
    Returns (stakes, majs), per-shard lists."""
    n, s = mesh.size, partials[0].shape[0]
    stakes, majs = [], []
    for i, dev in enumerate(mesh.devices):
        parts = torch.empty((n, s), dtype=partials[0].dtype, device=dev)
        for j, p in enumerate(partials):
            _after_producer(p, dev)
            parts[j].copy_(p, non_blocking=True)
        st, mj = tally.reduce_quorum(parts, priors[i], quorum, *(outs[i] if outs else (None, None)))
        stakes.append(st)
        majs.append(mj)
    return stakes, majs


def ring_tally(mesh: Mesh, partials: list) -> list:
    """All-reduce per-shard partials around the ring (counterpart of the
    JAX ``ppermute`` ring): n-1 hops, in each of which every shard copies
    the partial its left neighbour holds (shard i -> i+1 mod n) and adds
    it into its running total (``ring_add``). Every shard ends with the
    global sum; integer addition makes it equal the psum's bit for bit."""
    n = mesh.size
    rotating = list(partials)
    totals = list(partials)
    for _ in range(n - 1):
        rotating = [_peer(rotating[(i - 1) % n], mesh.devices[i]) for i in range(n)]
        totals = [tally.ring_add(t, r) for t, r in zip(totals, rotating)]
    return totals


def _step_partials(mesh, fe_radix, s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot,
                   tables, powers, prior_stake):
    """Shard the per-vote inputs, replicate the constants, and run each
    shard's verify (over the ``fe_radix`` field) + partial tally. Returns
    (packed, partials, priors), per-shard lists; every host->device copy
    is issued before any launch."""
    vote = [mesh.shard(x) for x in (s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot)]
    tables, powers, priors = (mesh.replicate(x) for x in (tables, powers, prior_stake))
    s = priors[0].shape[0]
    packed, partials = [], []
    for i in range(mesh.size):
        p, part = tally.compact_step_partial(
            *(v[i] for v in vote), tables[i], powers[i], s, fe_radix=fe_radix
        )
        packed.append(p)
        partials.append(part)
    return packed, partials, priors


def sharded_compact_step_packed(mesh: Mesh, fe_radix: int | None = None):
    """The fused step sharded over ``mesh`` with the psum tally, its
    verify over the ``fe_radix`` field (25 or 13; None reads
    ``TXFLOW_FE_RADIX`` now, see ``ops/field.py``).

    f(s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, powers,
    prior_stake, quorum) -> per-shard packed int32 ``[B/n + 2S]``
    (``to_host`` gives ``[B + 2Sn]``), or ``[B/n + 3S]`` in the int64
    form that int64 powers and prior select (``ops.tally.packed_stake``).
    Per-vote inputs are full-batch tensors (B divisible by n) or per-shard
    lists; tables, powers and prior are tensors to replicate or per-shard
    lists."""
    fe_radix = field.resolve(fe_radix)

    def f(s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, powers,
          prior_stake, quorum):
        packed, partials, priors = _step_partials(
            mesh, fe_radix, s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables,
            powers, prior_stake,
        )
        s = priors[0].shape[0]
        sw = 2 * s if tally.is_wide(powers) else s
        bs = packed[0].shape[0] - sw - s
        psum_quorum(mesh, partials, priors, quorum,
                    outs=[(p[bs : bs + sw], p[bs + sw :]) for p in packed])
        return packed

    return f


def sharded_compact_step(mesh: Mesh, fe_radix: int | None = None):
    """The sharded step's three results unpacked: f(...) -> (valid bool
    per shard [B/n], stake [S] per shard (int32, or int64 in the wide
    form), maj23 bool [S] per shard), the stake and maj23 lists holding
    the same global values."""
    packed_fn = sharded_compact_step_packed(mesh, fe_radix)

    def f(*args):
        packed = packed_fn(*args)
        prior, wide = args[9], tally.is_wide(args[8])
        s = (prior[0] if isinstance(prior, (list, tuple)) else prior).shape[0]
        bs = packed[0].shape[0] - tally.packed_size(0, s, wide)
        unpacked = [tally.packed_stake(p, bs, s, wide) for p in packed]
        return ([p[:bs].to(torch.bool) for p in packed], [st for st, _ in unpacked],
                [mj.to(torch.bool) for _, mj in unpacked])

    return f


def sharded_ring_step(mesh: Mesh, fe_radix: int | None = None):
    """The fused step sharded over ``mesh`` with ``ring_tally`` in place of
    the psum (int32 only: the ring hop has no int64 kernel): f(...) ->
    (valid bool per shard, stake int32 [S] per shard, maj23 bool [S] per
    shard), each shard holding its own copy of the global stake and maj23
    (``to_host`` gives ``[n·S]``, as the JAX ring step's per-shard
    outputs)."""
    fe_radix = field.resolve(fe_radix)

    def f(s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, powers,
          prior_stake, quorum):
        packed, partials, priors = _step_partials(
            mesh, fe_radix, s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables,
            powers, prior_stake,
        )
        s = priors[0].shape[0]
        totals = ring_tally(mesh, partials)
        stakes, majs = zip(*(
            tally.reduce_quorum(t[None], pr, quorum) for t, pr in zip(totals, priors)
        ))
        return ([p[: p.shape[0] - 2 * s].to(torch.bool) for p in packed], list(stakes),
                [m.to(torch.bool) for m in majs])

    return f


def sharded_verify_and_tally(mesh: Mesh, fe_radix: int | None = None):
    """The gathered-table verify (K5, over the ``fe_radix`` field)
    composed with the tally over ``mesh``: f(verify_inputs, tx_slot,
    power, prior_stake, quorum) -> (valid per shard, stake per shard,
    maj23 per shard); see ``ops.tally.verify_and_tally``."""
    fe_radix = field.resolve(fe_radix)

    def verify(*inputs):
        return ed25519_batch.verify_kernel(*inputs, fe_radix=fe_radix)

    return tally.verify_and_tally(verify, mesh=mesh)
