"""Mesh construction and the sharded verify/tally steps (K7).

Counterpart of ``txflow_tpu/parallel/mesh.py``. The vote axis of a padded
batch is split into equal slices, one per shard; per-epoch constants
(window tables and their quarter tables, powers) are replicated on every
shard's device, the prior stake goes to the mesh's first card (to every
card in the ring step). Each shard runs the fused verify +
partial tally (one ctypes call, two kernel launches) on its device's
current stream, its partial written into its row of an [n, S] buffer on
the mesh's first card when the shard is on that card; the other
partials cross to that card by peer copies, one ``txf_reduce_quorum``
there adds them and the prior and compares, and the result (the packed
``[stake | maj23]`` tail) is copied into every other shard's output, so
each holds the identical global stake and maj23 -- the JAX step's
``psum``: one reduce a step and at most 2(n-1) copies. ``ring_tally`` is
the explicit ring instead: n-1 hops of copy-then-add.

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

# tensor copies the psum has issued, by kind: a partial into the reduce's
# buffer, the reduced tail into another shard's output (the counterpart of
# ops/_lib.launches for the psum's data movement)
copies = {"partial": 0, "tail": 0}


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

    def first(self, x):
        """``x`` on the first shard's device (a tensor moved there, or a
        per-shard list's first entry): what only that device reads."""
        if isinstance(x, (list, tuple)):
            return self.shard(x)[0]
        return x.to(self.devices[0], non_blocking=True)

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


def psum_quorum(mesh: Mesh, partials: list, prior, quorum: int, outs=None, parts=None):
    """All-reduce of per-shard partial stake [S] (int32, or int64 for a
    set of total power >= 2^30) plus the prior, and the quorum compare,
    once for the mesh: the partials go into the rows of ``parts`` (an
    [n, S] buffer on the mesh's first card, new when None; a partial that
    already is its row is not copied, the others cross by peer copies
    ordered after the kernels that wrote them), one ``reduce_quorum``
    runs there with ``prior`` ([S]: a tensor, or a per-shard list, of
    which only that card reads, ``Mesh.first``), and each other shard
    gets a copy of the result. ``outs`` gives per shard the int32 tail ``[stake (S, or 2S
    words) | maj23 (S)]`` of its packed output: the reduce writes shard
    0's, then one copy into each other shard's. Without ``outs`` the
    result is new tensors, one pair per distinct device. Returns
    (stakes, majs), per-shard lists."""
    n, s = mesh.size, partials[0].shape[0]
    dev0, prior = mesh.devices[0], mesh.first(prior)
    if parts is None:
        parts = torch.empty((n, s), dtype=partials[0].dtype, device=dev0)
    for j, p in enumerate(partials):
        row = parts[j]
        if p.device == dev0 and p.data_ptr() == row.data_ptr():
            continue
        _after_producer(p, dev0)
        row.copy_(p, non_blocking=True)
        copies["partial"] += 1
    if outs is None:
        st, mj = tally.reduce_quorum(parts, prior, quorum)
        on = {dev0: (st, mj)}
        for d in mesh.devices:
            if d not in on:
                _after_producer(st, d)
                on[d] = (st.to(d, non_blocking=True), mj.to(d, non_blocking=True))
        return [on[d][0] for d in mesh.devices], [on[d][1] for d in mesh.devices]
    sw = outs[0].shape[0] - s
    tail = outs[0]
    tally.reduce_quorum(parts, prior, quorum, tail[:sw], tail[sw:])
    for out, d in zip(outs[1:], mesh.devices[1:]):
        _after_producer(tail, d)
        out.copy_(tail, non_blocking=True)
        copies["tail"] += 1
    return [o[:sw] for o in outs], [o[sw:] for o in outs]


def ring_tally(mesh: Mesh, partials: list) -> list:
    """All-reduce per-shard partials around the ring (counterpart of the
    JAX ``ppermute`` ring): n-1 hops, in each of which every shard copies
    the partial its left neighbour holds (shard i -> i+1 mod n) and adds
    it into its running total (``ring_add``, in place). The totals start
    as copies of the partials: a hop's rotating partial may be the very
    tensor another shard's total started from (at hop 0, or a shard on the
    same device), and it must not change under that shard. Every shard
    ends with the global sum; integer addition makes it equal the psum's
    bit for bit."""
    n = mesh.size
    rotating = list(partials)
    totals = [p.clone() for p in partials]
    for _ in range(n - 1):
        rotating = [_peer(rotating[(i - 1) % n], mesh.devices[i]) for i in range(n)]
        for t, r in zip(totals, rotating):
            tally.ring_add(t, r)
    return totals


def _step_partials(mesh, fe_radix, s, s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot,
                   tables, quarter_tables, powers, parts=None):
    """Shard the per-vote inputs, replicate the constants, and run each
    shard's fused verify (over the ``fe_radix`` field) + partial tally
    over ``s`` slots, the partial of a shard on the mesh's first card
    written into its row of ``parts`` when given. Returns (packed,
    partials), per-shard lists; every host->device copy is issued before
    any launch."""
    vote = [mesh.shard(x) for x in (s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot)]
    tables, quarters, powers = (
        mesh.replicate(x) for x in (tables, quarter_tables, powers))
    packed, partials = [], []
    for i, d in enumerate(mesh.devices):
        p, part = tally.compact_step_partial(
            *(v[i] for v in vote), tables[i], quarters[i], powers[i], s, fe_radix=fe_radix,
            partial=parts[i] if parts is not None and d == parts.device else None,
        )
        packed.append(p)
        partials.append(part)
    return packed, partials


def _psum_step(mesh, fe_radix, s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables,
               quarter_tables, powers, prior_stake, quorum):
    """One sharded step with the psum tally: (per-shard packed outputs,
    rows a shard, slots)."""
    prior0 = mesh.first(prior_stake)
    s, wide = prior0.shape[0], tally.is_wide(powers)
    parts = torch.empty((mesh.size, s), dtype=torch.int64 if wide else torch.int32,
                        device=mesh.devices[0])
    packed, partials = _step_partials(
        mesh, fe_radix, s, s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables,
        quarter_tables, powers, parts,
    )
    bs = packed[0].shape[0] - tally.packed_size(0, s, wide)
    psum_quorum(mesh, partials, prior0, quorum, outs=[p[bs:] for p in packed], parts=parts)
    return packed, bs, s


def sharded_compact_step_packed(mesh: Mesh, fe_radix: int | None = None):
    """The fused step sharded over ``mesh`` with the psum tally, its
    verify over the ``fe_radix`` field (25 or 13; None reads
    ``TXFLOW_FE_RADIX`` now, see ``ops/field.py``).

    f(s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables,
    quarter_tables, powers, prior_stake, quorum) -> per-shard packed int32
    ``[B/n + 2S]`` (``to_host`` gives ``[B + 2Sn]``), or ``[B/n + 3S]`` in
    the int64 form that int64 powers and prior select
    (``ops.tally.packed_stake``). Per-vote inputs are full-batch tensors
    (B divisible by n) or per-shard lists; tables, quarter tables and
    powers are tensors to replicate or per-shard lists; the prior a
    tensor or a per-shard list, of which only the mesh's first card reads
    (``Mesh.first``: the reduce runs there)."""
    fe_radix = field.resolve(fe_radix)

    def f(*args):
        return _psum_step(mesh, fe_radix, *args)[0]

    return f


def sharded_compact_step(mesh: Mesh, fe_radix: int | None = None):
    """The sharded step's three results unpacked: f(...) -> (valid bool
    per shard [B/n], stake [S] per shard (int32, or int64 in the wide
    form), maj23 bool [S] per shard), the stake and maj23 lists holding
    the same global values."""
    fe_radix = field.resolve(fe_radix)

    def f(*args):
        packed, bs, s = _psum_step(mesh, fe_radix, *args)
        unpacked = [tally.packed_stake(p, bs, s, tally.is_wide(args[9])) for p in packed]
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

    def f(s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables, quarter_tables, powers,
          prior_stake, quorum):
        priors = mesh.replicate(prior_stake)
        s = priors[0].shape[0]
        packed, partials = _step_partials(
            mesh, fe_radix, s, s_nib, h_nib, val_idx, r_y, r_sign, pre_ok, tx_slot, tables,
            quarter_tables, powers,
        )
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
