"""VoteVerifier: the interface between protocol logic and the verify/tally
kernels (counterpart of ``txflow_tpu/verifier.py``).

The reference verifies one vote at a time inside ``TxVoteSet.AddVote``
(reference types/vote_set.go:117-119 -> types/tx_vote.go:110-119). Here
the same decision -- "is this signature valid, and does the tx now have
>2/3 stake" -- is computed for a whole batch at once:

- ``ScalarVoteVerifier`` -- the golden model: host ed25519 + int64 stake
  accumulation, used only when the caller asks for it.
- ``DeviceVoteVerifier`` -- the batched step on one device, or sharded
  over a mesh of devices (``parallel/mesh.py``): the CUDA verify and
  tally kernels on the cards, their plain PyTorch versions when the
  caller passes ``device="cpu"`` or a mesh of CPU entries. A failure
  raises; nothing falls back to the host verifier or to fewer devices.

Both return bit-identical accept/reject masks and quorum decisions.

Co-located engines (a ``node.LocalNet``: several validators on one host
and one card) share one verifier and, with ``shared_cache``, one
``VerifyCache`` (``txflow_tpu/verifier.py:62-239,344-419,1100-1190``):
each distinct vote is verified once, by the engine that claims it, with
the verify kernel alone (``ed25519_batch.verify_into``, the committee
path's launch); its stake is tallied on the host. A vote another engine
has in flight comes back ``dropped`` and is re-offered. Engines attach
to a shared verifier (``attach``/``detach``): the last to leave closes
its ring and host-prep pool.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .crypto import ed25519 as host_ed
from .crypto.hash import sha256
from .ops import ed25519_batch, field, tally
from .parallel.mesh import Mesh, sharded_compact_step_packed, to_host
from .parallel.staging import StagingRing
from .types.validator import ValidatorSet

# Batch-size buckets: padding to the next bucket keeps the set of batch
# shapes small and bounded (one launch configuration per rung).
DEFAULT_BUCKETS = (64, 256, 1024, 4096, 16384, 65536)

# Total voting power from which the device tally runs in int64 (below it,
# prior + batch stake of a slot stays under 2^31 in int32), and the bound
# past which even an int64 sum of prior + batch stake could overflow.
WIDE_TALLY_POWER = 2**30
MAX_TOTAL_POWER = 2**62


def bucket_size(n: int, buckets=DEFAULT_BUCKETS, multiple: int = 1) -> int:
    """Smallest bucket >= n after rounding each bucket up to ``multiple``
    (a mesh's shard count, so every padded batch splits evenly); beyond
    the largest bucket, n rounded up to ``multiple``. Rounding before the
    comparison keeps one shape per rung, as in the JAX package."""
    for b in buckets:
        bb = -(-b // multiple) * multiple
        if bb >= n:
            return bb
    return -(-n // multiple) * multiple


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or defaulted to) and absent --
    the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class VerifyCache:
    """Cross-engine cache of signature verdicts, with claims.

    A verdict is a pure function of (message, signature, public key).
    When several engines share a process and a card, full-mesh gossip
    hands every engine the same votes; the first engine to claim a vote
    verifies it and the rest read its verdict here. Keys bind every input
    -- sha256(len(msg) || msg || len(sig) || sig || pubkey), lengths
    little-endian u32 -- so one signature reused over another payload or
    under another key never aliases a verdict, and a key outlives a
    validator-set change (it binds the resolved key, not an index).

    A miss is claimed by the engine that asked first; another engine that
    misses on it while the claim is live is told the vote is pending and
    defers it. Claims older than ``claim_ttl`` are treated as abandoned
    and handed to the next asker; the owner keeps them fresh while it
    works (``claim_keepalive``) and stores or releases them at the end.
    """

    def __init__(self, capacity: int = 1 << 17, claim_ttl: float = 3.0):
        from collections import OrderedDict

        self.capacity = capacity
        self.claim_ttl = claim_ttl
        self._mtx = threading.Lock()
        self._d: OrderedDict[bytes, bool] = OrderedDict()
        self._inflight: dict[bytes, float] = {}  # key -> claim time
        self.hits = 0
        self.misses = 0
        self.deferrals = 0

    @staticmethod
    def key(msg: bytes, sig: bytes, pub_key: bytes) -> bytes:
        return sha256(
            len(msg).to_bytes(4, "little")
            + msg
            + len(sig).to_bytes(4, "little")
            + sig
            + pub_key
        )

    def lookup_or_claim_many(
        self, keys: list[bytes | None]
    ) -> tuple[list[bool | None], np.ndarray]:
        """One lock hold: resolve hits, claim unclaimed misses for this
        caller, flag misses in flight elsewhere. Returns (vals, pending):
        vals[i] is the cached verdict or None; pending[i] True means
        another caller owns the miss (defer it). A None val with pending
        False is this caller's claim, owed a store_many or release_many.
        A None key is skipped."""
        n = len(keys)
        vals: list[bool | None] = [None] * n
        pending = np.zeros(n, dtype=bool)
        now = time.monotonic()
        stale = now - self.claim_ttl
        with self._mtx:
            d = self._d
            infl = self._inflight
            for i, k in enumerate(keys):
                if k is None:
                    continue
                v = d.get(k)
                if v is not None:
                    d.move_to_end(k)
                    vals[i] = v
                    self.hits += 1
                    continue
                t = infl.get(k)
                if t is not None and t > stale:
                    pending[i] = True
                    self.deferrals += 1
                else:
                    self.misses += 1
                    infl[k] = now  # claimed by this caller
        return vals, pending

    def release_many(self, keys: list[bytes]) -> None:
        """Drop claims without storing verdicts (the verify failed)."""
        with self._mtx:
            for k in keys:
                self._inflight.pop(k, None)

    def store_many(self, pairs: list[tuple[bytes, bool]]) -> None:
        with self._mtx:
            d = self._d
            infl = self._inflight
            for k, v in pairs:
                d[k] = v
                d.move_to_end(k)
                infl.pop(k, None)
            while len(d) > self.capacity:
                d.popitem(last=False)

    def heartbeat_many(self, keys: list[bytes]) -> None:
        """Re-stamp claims still live (released or stored ones stay so)."""
        now = time.monotonic()
        with self._mtx:
            infl = self._inflight
            for k in keys:
                if k in infl:
                    infl[k] = now

    def claim_keepalive(self, keys: list[bytes]) -> "_ClaimKeepalive":
        """A context that heartbeats ``keys`` every claim_ttl/2 until it
        exits: the owner's verify can outlast the TTL, and a stale claim
        would send the same votes to every other engine."""
        return _ClaimKeepalive(self, keys)


class _ClaimKeepalive:
    """Background heartbeat for VerifyCache claims (claim_keepalive)."""

    def __init__(self, cache: VerifyCache, keys: list[bytes]):
        self._cache = cache
        self._keys = keys
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def __enter__(self) -> "_ClaimKeepalive":
        if self._keys:
            self._thread = threading.Thread(
                target=self._run, name="verify-claim-keepalive", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        interval = max(self._cache.claim_ttl / 2, 0.01)
        # a first beat at once: the claims were stamped at lookup, maybe a
        # while before this thread ran
        self._cache.heartbeat_many(self._keys)
        while not self._stop.wait(interval):
            self._cache.heartbeat_many(self._keys)

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


@dataclass
class TallyResult:
    """Outcome of one verify+tally step over a vote batch."""

    valid: np.ndarray  # bool[B]  per-vote signature validity (False for dropped)
    stake: np.ndarray  # int[n_slots] cumulative stake per tx slot (incl. prior)
    maj23: np.ndarray  # bool[n_slots] quorum reached (latched via prior stake)
    dropped: np.ndarray  # bool[B] in-batch (slot, validator) repeat: not processed


class VerifyTicket:
    """Handle to a dispatched verify+tally call (submit/collect split).
    ``result()`` blocks for the readback and returns the ``TallyResult``."""

    def result(self) -> TallyResult:
        raise NotImplementedError


class ReadyTicket(VerifyTicket):
    """Already-completed ticket (the scalar verifier's eager path)."""

    __slots__ = ("_result",)

    def __init__(self, result: TallyResult):
        self._result = result

    def result(self) -> TallyResult:
        return self._result


class _FusedDeviceTicket(VerifyTicket):
    """Dispatched fused step: one readback of each shard's packed
    ``[valid (b/n) | stake | maj23]`` vector (one shard on a single
    device; the stake segment int64 words when ``wide``), through the
    verifier's readback ring when it has one (``slot``), else on the
    caller at result()."""

    __slots__ = ("_parts", "_ring", "_slot", "_n", "_n_slots", "_b", "_b_slots", "_keep",
                 "_wide", "_done")

    def __init__(self, parts, ring, n, n_slots, b, b_slots, keep, wide):
        self._parts = parts  # per-shard device tensors, not yet read back
        self._ring = ring
        self._slot = None if ring is None else ring.submit(parts)
        self._n = n
        self._n_slots = n_slots
        self._b = b
        self._b_slots = b_slots
        self._keep = keep
        self._wide = wide
        self._done: TallyResult | None = None

    def result(self) -> TallyResult:
        if self._done is not None:
            return self._done
        # the device->host copies; the host sees [b + 2 * b_slots * n]
        flat = (to_host(self._parts).numpy() if self._ring is None
                else self._ring.result(self._slot))
        rows = flat.reshape(len(self._parts), -1)
        self._parts = self._slot = None
        bs = self._b // rows.shape[0]
        # valid from every shard; stake and maj23 from shard 0 (each
        # shard holds the same global tally)
        stake, maj = tally.packed_stake(rows[0], bs, self._b_slots, self._wide)
        self._done = TallyResult(
            rows[:, :bs].reshape(-1)[: self._n].astype(bool),
            stake[: self._n_slots].astype(np.int64),
            maj[: self._n_slots].astype(bool),
            ~self._keep,
        )
        return self._done


class _CachedDeviceTicket(VerifyTicket):
    """Dispatched verify of a cache miss set: the kernel's int32 validity
    of the claimed rows rides the readback ring; ``result()`` stores the
    verdicts (or, on a failed readback, releases the claims), merges them
    with the hits and tallies the stake on the host, in int64. The claims
    stay held, kept alive, from dispatch to result."""

    __slots__ = ("_cache", "_out", "_ring", "_slot", "_keepalive", "_miss_idx",
                 "_miss_keys", "_keys", "_valid", "_tx_slot", "_n_slots", "_prior",
                 "_quorum", "_keep", "_pending", "_powers", "_val_idx", "_done")

    def __init__(self, cache, out, ring, keepalive, miss_idx, miss_keys, keys, valid,
                 tx_slot, n_slots, prior, quorum, keep, pending, powers, val_idx):
        self._cache = cache
        self._out = out  # int32 [b] validity, not yet read back
        self._ring = ring
        self._slot = None if ring is None else ring.submit([out])
        self._keepalive = keepalive
        self._miss_idx = miss_idx
        self._miss_keys = miss_keys
        self._keys = keys
        self._valid = valid
        self._tx_slot = tx_slot
        self._n_slots = n_slots
        self._prior = prior
        self._quorum = quorum
        self._keep = keep
        self._pending = pending
        self._powers = powers
        self._val_idx = val_idx
        self._done: TallyResult | None = None

    def result(self) -> TallyResult:
        if self._done is not None:
            return self._done
        # re-stamp from the collecting thread: the readback may start long
        # after the dispatch (the pipelined engine)
        self._cache.heartbeat_many(self._miss_keys)
        try:
            flat = (self._out.cpu().numpy() if self._ring is None
                    else self._ring.result(self._slot))
        except BaseException:
            # claims must not outlive a failed readback: the other engines
            # would wait out the TTL
            self._keepalive.__exit__(None, None, None)
            self._cache.release_many(self._miss_keys)
            raise
        self._out = self._slot = None
        self._keepalive.__exit__(None, None, None)
        sub_valid = flat[: len(self._miss_idx)].astype(bool)
        self._cache.store_many(
            [(self._keys[i], bool(v)) for i, v in zip(self._miss_idx, sub_valid)]
        )
        valid = self._valid
        valid[self._miss_idx] = sub_valid
        self._done = _host_tally(valid, self._tx_slot, self._n_slots, self._prior,
                                 self._quorum, self._keep, self._pending, self._powers,
                                 self._val_idx)
        return self._done


def _host_tally(valid, tx_slot, n_slots, prior, quorum, keep, pending, powers,
                val_idx) -> TallyResult:
    """The cache path's tally: prior plus each valid vote's power in its
    slot, int64 (``txflow_tpu/verifier.py:1170-1190``). A pending vote is
    dropped for re-offer, like an in-batch repeat."""
    stake = (np.zeros(n_slots, dtype=np.int64) if prior is None
             else np.asarray(prior, dtype=np.int64).copy())
    ok = valid & (tx_slot >= 0) & (tx_slot < n_slots)
    np.add.at(stake, tx_slot[ok], powers[val_idx[ok]].astype(np.int64))
    return TallyResult(valid, stake, stake >= quorum, ~keep | pending)


def first_occurrence_mask(tx_slot, val_idx) -> np.ndarray:
    """bool[B]: True for the first occurrence of each (tx_slot, val_idx) pair.

    The reference can never count one validator's stake twice for one tx
    (first-signature-wins under a mutex, types/vote_set.go:109-131); a batch
    holding the same (tx, validator) pair twice would double-count in the
    segment-sum tally. Both verifiers therefore process only the first
    occurrence, in batch (arrival) order; callers re-offer dropped votes in
    a later batch if the validator still hasn't been tallied.
    """
    slot = np.asarray(tx_slot, dtype=np.int64)
    val = np.asarray(val_idx, dtype=np.int64)
    n = len(slot)
    if n == 0:
        return np.zeros(0, dtype=bool)
    # 1-D combined key: shift both axes non-negative, multiply past the
    # validator range -- distinct pairs <-> distinct keys
    vmin, vmax = int(val.min()), int(val.max())
    smin = int(slot.min())
    m = vmax - vmin + 2
    combined = (slot - smin) * m + (val - vmin)
    nb = int(combined.max()) + 1
    mask = np.zeros(n, dtype=bool)
    if nb <= 4 * n + 1024:
        # dense key space (the engine's case): scatter-min of positions
        firstpos = np.full(nb, n, dtype=np.int64)
        np.minimum.at(firstpos, combined, np.arange(n))
        mask[firstpos[firstpos < n]] = True
    else:
        # sparse keys: stable sort + neighbor-compare
        order = np.argsort(combined, kind="stable")
        sc = combined[order]
        firsts = np.empty(n, dtype=bool)
        firsts[0] = True
        np.not_equal(sc[1:], sc[:-1], out=firsts[1:])
        mask[order[firsts]] = True
    return mask


class ScalarVoteVerifier:
    """Golden model: per-vote host verify + int64 tally (reference semantics)."""

    def __init__(self, val_set: ValidatorSet):
        self.restage(val_set)

    @property
    def val_set(self) -> ValidatorSet:
        return self._stage[0]

    def restage(self, new_val_set: ValidatorSet) -> bool:
        """Swap in a new validator set (epoch rotation) in place. A call in
        progress finishes against the stage it read; the next call sees
        the new set."""
        # one tuple, read once per call: never one set's keys with
        # another's powers
        self._stage = (
            new_val_set, [v.pub_key for v in new_val_set], new_val_set.powers_array()
        )
        return True

    def verify_and_tally(
        self,
        msgs: list[bytes],
        sigs: list[bytes],
        val_idx: np.ndarray,
        tx_slot: np.ndarray,
        n_slots: int,
        prior_stake: np.ndarray | None = None,
        quorum: int | None = None,
    ) -> TallyResult:
        n = len(msgs)
        val_set, pub_keys, powers = self._stage[:3]
        keep = first_occurrence_mask(tx_slot, val_idx)
        valid = np.zeros(n, dtype=bool)
        for i in range(n):
            vi = int(val_idx[i])
            if keep[i] and 0 <= vi < len(pub_keys):
                valid[i] = host_ed.verify(pub_keys[vi], msgs[i], sigs[i])
        stake = (
            np.zeros(n_slots, dtype=np.int64)
            if prior_stake is None
            else np.asarray(prior_stake, dtype=np.int64).copy()
        )
        for i in range(n):
            s = int(tx_slot[i])
            if valid[i] and 0 <= s < n_slots:
                stake[s] += int(powers[val_idx[i]])
        q = val_set.quorum_power() if quorum is None else quorum
        return TallyResult(valid, stake, stake >= q, ~keep)

    def submit(
        self, msgs, sigs, val_idx, tx_slot, n_slots, prior_stake=None, quorum=None
    ) -> VerifyTicket:
        """Submit/collect surface on the eager host path: the work runs
        inline and the ticket is already complete."""
        return ReadyTicket(
            self.verify_and_tally(
                msgs, sigs, val_idx, tx_slot, n_slots,
                prior_stake=prior_stake, quorum=quorum,
            )
        )


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class _DeviceStage:
    """One epoch's device constants, bundled so a submit reads a single
    attribute and never mixes one epoch's tables with another's powers.
    ``pub_keys``/``val_set`` are the real set; the tables, their quarter
    tables (the four-lane verify kernel reads both) and the powers are
    padded to the verifier's validator capacity. On a mesh, each device
    tensor is a per-shard list, one copy on each card."""

    __slots__ = ("val_set", "pub_keys", "epoch", "powers", "tables_dev", "quarters_dev",
                 "powers_dev", "wide")

    def __init__(self, val_set, pub_keys, epoch, powers, tables_dev, quarters_dev, powers_dev):
        self.val_set = val_set
        self.pub_keys = pub_keys
        self.epoch = epoch
        self.powers = powers
        self.tables_dev = tables_dev
        self.quarters_dev = quarters_dev
        self.powers_dev = powers_dev
        # the int64 tally: powers (and so prior and stake) are int64
        self.wide = powers.dtype == np.int64


class DeviceVoteVerifier:
    """Batched verify + tally on one device, or sharded over ``mesh``.

    Per-epoch constants (the -A window tables, their quarter tables and
    the voting powers) are uploaded once per validator set -- to every
    card of the mesh -- padded
    to ``capacity`` (the next power of two >= the set size, at least 4),
    so ``restage()`` swaps them for a new set with host->device copies and
    nothing rebuilt. With a mesh of n shards every padded batch is a
    multiple of n and splits evenly over the shards.

    ``fe_radix`` picks the field the verify kernel runs over (25 or 13,
    see ``ops/field.py``; None reads ``TXFLOW_FE_RADIX`` here, once); a
    restage keeps it. A set of total power >= 2^30 is tallied in int64
    (``ops/tally.py``), a smaller one in int32, chosen per stage; only a
    total >= 2^62 raises.

    ``submit`` preps on the host-prep pool once one is attached
    (``ensure_host_pool``) and hands each ticket's output to a readback
    ring of ``staging_ring`` slots (``parallel/staging.py``: a side CUDA
    stream per card into pinned memory); ``warm`` runs one all-padding
    step, ``close`` drains the ring and closes the pool.

    ``shared_cache`` (True: a cache of its own; a ``VerifyCache``: shared
    with other verifiers) turns on the cache path: a batch's misses that
    this caller claims are verified by the verify kernel alone, padded to
    the finer ``miss_buckets`` ladder, and the stake is tallied on the
    host. The cache path runs on one device; with a mesh it raises (the
    JAX sharded verify-only program is not ported). Engines sharing the
    verifier ``attach`` and ``detach``; the last detach closes it.
    """

    def __init__(self, val_set: ValidatorSet, device=None, mesh: Mesh | None = None,
                 fe_radix: int | None = None, staging_ring: int = 2,
                 buckets=DEFAULT_BUCKETS, shared_cache: "VerifyCache | bool | None" = None):
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a device or a mesh, not both")
            if shared_cache:
                raise ValueError("the verify cache runs on one device, not on a mesh")
            resolve_device(mesh.devices[0])
        self.cache: VerifyCache | None = (
            VerifyCache() if shared_cache is True else (shared_cache or None))
        self.mesh = mesh
        self.fe_radix = field.resolve(fe_radix)
        self._n_shards = 1 if mesh is None else mesh.size
        self.device = resolve_device(device) if mesh is None else mesh.devices[0]
        self._step = (None if mesh is None
                      else sharded_compact_step_packed(mesh, fe_radix=self.fe_radix))
        # the batch-size ladder every dispatch pads to (its rungs are the
        # engine's coalescer targets, ``txflow_tpu/verifier.py:683-699``);
        # the engine drains no batch beyond the largest rung
        self.buckets = tuple(buckets)
        self.max_batch = max(self.buckets)
        # the cache path's miss sets are a share of a drain (other engines
        # claim the rest): a finer ladder, each rung's quarter and
        # sixteenth added (``txflow_tpu/verifier.py:701-723``)
        self.miss_buckets = tuple(sorted(
            {max(64, b // 16) for b in self.buckets}
            | {max(64, b // 4) for b in self.buckets}
            | set(self.buckets)
        ))
        self.capacity = _next_pow2(max(val_set.size(), 4))
        self._stage = self._build_stage(val_set)
        # readback ring (parallel/staging.py), made at the first submit;
        # depth <= 1 reads back on the caller at result()
        self.staging_depth = int(staging_ring)
        self._ring: StagingRing | None = None
        self._host_pool = None
        self._mtx = threading.Lock()
        self._users = 0  # attached engines
        self._engines = 0  # engines built over it (bind); more than one: shared
        # the cache path's verify launches and the rows they carried
        # (real rows, before padding): each distinct vote at most once
        self.cache_verify_calls = 0
        self.cache_verify_rows = 0

    @property
    def val_set(self) -> ValidatorSet:
        return self._stage.val_set

    @property
    def epoch(self):
        return self._stage.epoch

    def _build_stage(self, val_set: ValidatorSet) -> _DeviceStage:
        # with dedup, per-slot batch stake and prior stake are each <=
        # total power: their sum stays < 2^31 (int32) below 2^30 and
        # < 2^63 (int64) below 2^62
        total = val_set.total_voting_power()
        if total >= MAX_TOTAL_POWER:
            raise ValueError(
                "total voting power >= 2^62: the int64 device tally could overflow"
            )
        wide = total >= WIDE_TALLY_POWER
        pub_keys = [v.pub_key for v in val_set]
        pad = self.capacity - len(pub_keys)
        if pad < 0:
            raise ValueError(
                f"validator set of {len(pub_keys)} exceeds staged "
                f"capacity {self.capacity}"
            )
        # pad rows carry power 0 and an all-zero pubkey (no known private
        # key), and the engine's address->index map never yields a pad
        # index: a vote can neither verify against nor draw stake from them
        epoch = ed25519_batch.EpochTables(pub_keys + [b"\x00" * 32] * pad, self.fe_radix)
        powers = np.zeros(self.capacity, np.int64 if wide else np.int32)
        powers[: len(pub_keys)] = val_set.powers_array()
        if self.mesh is None:
            tables_dev = epoch.device_tables(self.device)
            quarters_dev = epoch.device_quarter_tables(self.device)
            powers_dev = torch.from_numpy(powers).to(self.device)
        else:
            # every card gets its copy before the caller swaps the stage in
            tables_dev = [epoch.device_tables(d) for d in self.mesh.devices]
            quarters_dev = [epoch.device_quarter_tables(d) for d in self.mesh.devices]
            powers_dev = self.mesh.replicate(torch.from_numpy(powers))
        return _DeviceStage(val_set, pub_keys, epoch, powers, tables_dev, quarters_dev,
                            powers_dev)

    def restage(self, new_val_set: ValidatorSet) -> bool:
        """Swap the per-epoch device constants for a new validator set in
        place, in this verifier's field, the tally's width chosen for the
        new set. Returns False when the set exceeds ``capacity`` (the
        caller builds a fresh verifier); raises past the int64 bound."""
        if new_val_set.size() > self.capacity:
            return False
        if new_val_set.hash() == self._stage.val_set.hash():
            return True
        self._stage = self._build_stage(new_val_set)
        return True

    def ensure_host_pool(self, workers: int, backend: str = "thread"):
        """Attach the host-prep pool that ``submit`` hands to
        ``prepare_compact`` (``txflow_tpu/verifier.py:812``), made by the
        first caller with ``workers`` > 1 (its backend too); later callers
        get the same pool. Returns it (None while prep is serial). A
        process pool that cannot start raises."""
        if workers and workers > 1 and self._host_pool is None:
            with self._mtx:
                if self._host_pool is None:
                    from .engine.hostprep import make_host_pool

                    self._host_pool = make_host_pool(workers, backend, name="hostprep-verify")
        return self._host_pool

    def bind(self, n: int = 1) -> None:
        """An engine is built over this verifier (``n`` = -1: it moved to
        another). With more than one, no engine restages it for its own
        set: the others still serve the old one."""
        with self._mtx:
            self._engines += n

    @property
    def shared(self) -> bool:
        return self._engines > 1

    def attach(self) -> None:
        """An engine starts serving from this verifier."""
        with self._mtx:
            self._users += 1

    def detach(self) -> bool:
        """An engine stops; the last one out closes the verifier (ring and
        host-prep pool). Returns True when it closed. A verifier no engine
        attached to closes at once."""
        with self._mtx:
            self._users = max(self._users - 1, 0)
            last = self._users == 0
        if last:
            self.close()
        return last

    @property
    def warm_ladder(self) -> tuple:
        """The rungs a served step dispatches at: the miss ladder on the
        cache path, else the bucket ladder."""
        return self.miss_buckets if self.cache is not None else self.buckets

    def staging_stats(self) -> dict | None:
        """The readback ring's counters (None before the first submit)."""
        ring = self._ring
        return None if ring is None else ring.stats()

    def close(self) -> None:
        """Drain and drop the readback ring and close the host-prep pool; a
        later submit makes a new ring and preps on its caller."""
        with self._mtx:
            ring, self._ring = self._ring, None
            pool, self._host_pool = self._host_pool, None
        if ring is not None:
            ring.close()
        if pool is not None:
            pool.close()

    def warm(self, rows: int, n_slots: int) -> None:
        """Submit and collect one batch of ``rows`` padding rows (no vote:
        every pre-check false, every slot -1) over ``n_slots`` slots, on
        every card of the mesh: the kernels' first launch on each card (the
        base tables' upload, ``curve.device_base_quarters``), the allocator's growth to these
        shapes and the readback ring's pinned buffers are paid here, not
        by the first served step."""
        st = self._stage
        if self.cache is not None:  # the cache path's launch: verify alone
            b = bucket_size(rows, self.miss_buckets)
            batch = ed25519_batch.CompactBatch(
                np.zeros((b, 64), np.uint8), np.zeros((b, 64), np.uint8),
                np.zeros(b, np.int32), np.zeros((b, 32), np.uint8), np.zeros(b, np.uint8),
                np.zeros(b, bool))
            out = self._dispatch_verify_only(batch, b, st)
            ring = self._staging_ring()
            if ring is None:
                out.cpu()
            else:
                ring.result(ring.submit([out]))
            return
        b = bucket_size(rows, self.buckets, multiple=self._n_shards)
        batch = ed25519_batch.CompactBatch(
            np.zeros((b, 64), np.uint8), np.zeros((b, 64), np.uint8), np.zeros(b, np.int32),
            np.zeros((b, 32), np.uint8), np.zeros(b, np.uint8), np.zeros(b, bool))
        self._dispatch(batch, np.full(b, -1, np.int32), None, 0, n_slots,
                       np.zeros(0, bool), st, st.val_set.quorum_power()).result()

    def verify_and_tally(
        self,
        msgs: list[bytes],
        sigs: list[bytes],
        val_idx: np.ndarray,
        tx_slot: np.ndarray,
        n_slots: int,
        prior_stake: np.ndarray | None = None,
        quorum: int | None = None,
    ) -> TallyResult:
        return self.submit(
            msgs, sigs, val_idx, tx_slot, n_slots,
            prior_stake=prior_stake, quorum=quorum,
        ).result()

    def submit(
        self,
        msgs: list[bytes],
        sigs: list[bytes],
        val_idx: np.ndarray,
        tx_slot: np.ndarray,
        n_slots: int,
        prior_stake: np.ndarray | None = None,
        quorum: int | None = None,
    ) -> VerifyTicket:
        """Prepare the batch on the host, copy it to the device and launch
        the fused step; the readback waits for ``result()``."""
        n = len(msgs)
        val_idx = np.asarray(val_idx, dtype=np.int64)
        tx_slot = np.asarray(tx_slot, dtype=np.int32)
        keep = first_occurrence_mask(tx_slot, val_idx)
        st = self._stage
        if self.cache is not None:
            q = st.val_set.quorum_power() if quorum is None else quorum
            return self._submit_cached(msgs, sigs, val_idx, tx_slot, n_slots, prior_stake,
                                       q, keep, st)
        batch = ed25519_batch.prepare_compact(msgs, sigs, val_idx, st.epoch,
                                              pool=self._host_pool)
        batch.pre_ok &= keep
        slot = np.full(bucket_size(n, self.buckets, multiple=self._n_shards), -1, np.int32)
        slot[:n] = tx_slot
        q = st.val_set.quorum_power() if quorum is None else quorum
        return self._dispatch(batch, slot, prior_stake, n, n_slots, keep, st, q)

    def _dispatch(self, batch, slot, prior_stake, n, n_slots, keep, st, q) -> VerifyTicket:
        """Pad the prepared batch to its bucket (pre_ok False and slot -1
        contribute nothing), copy it to the device, launch the fused step
        and hand its output to the readback ring."""
        b = slot.shape[0]
        b_slots = bucket_size(n_slots, self.buckets)
        pad = b - batch.size
        prior = np.zeros(b_slots, np.int64 if st.wide else np.int32)
        if prior_stake is not None:
            prior[:n_slots] = np.asarray(prior_stake, dtype=np.int64)

        if self.mesh is None:
            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        else:
            def dev(a):  # the sharded step copies each slice to its card
                return torch.from_numpy(np.ascontiguousarray(a))
        args = (
            dev(_pad(batch.s_nibbles, pad)),
            dev(_pad(batch.h_nibbles, pad)),
            dev(_pad(batch.val_idx, pad)),
            dev(_pad(batch.r_y, pad)),
            dev(_pad(batch.r_sign, pad)),
            dev(_pad(batch.pre_ok, pad)),
            dev(slot),
            st.tables_dev,
            st.quarters_dev,
            st.powers_dev,
            dev(prior),
            int(q),
        )
        if self.mesh is None:
            parts = [tally.compact_step_packed(*args, fe_radix=self.fe_radix)]
        else:
            parts = self._step(*args)
        return _FusedDeviceTicket(parts, self._staging_ring(), n, n_slots, b, b_slots, keep,
                                  st.wide)

    def _submit_cached(self, msgs, sigs, val_idx, tx_slot, n_slots, prior_stake, q, keep,
                       st) -> VerifyTicket:
        """The cache path (``txflow_tpu/verifier.py:1098-1190``): verify on
        the device only the misses this caller claims, take hits from the
        cache, defer misses another caller has in flight (dropped, for
        re-offer), and tally on the host. Decisions equal the fused
        step's: the tally is the same prior plus sum over valid
        first-occurrence votes, and a verdict is a pure function the cache
        memoizes. A failed dispatch releases its claims and raises."""
        n = len(msgs)
        n_vals = len(st.pub_keys)  # the real set: a pad index is unknown
        keys: list[bytes | None] = [
            VerifyCache.key(msgs[i], sigs[i], st.pub_keys[int(val_idx[i])])
            if keep[i] and 0 <= val_idx[i] < n_vals
            else None
            for i in range(n)
        ]
        cached, pending = self.cache.lookup_or_claim_many(keys)
        valid = np.zeros(n, dtype=bool)
        miss_idx = []
        for i in range(n):
            if keys[i] is None or pending[i]:
                continue  # unknown validator, in-batch repeat, or in flight
            if cached[i] is None:
                miss_idx.append(i)
            else:
                valid[i] = cached[i]
        if not miss_idx:  # all hits and deferrals: nothing to launch
            return ReadyTicket(_host_tally(valid, tx_slot, n_slots, prior_stake, q, keep,
                                           pending, st.powers, val_idx))
        miss_keys = [keys[i] for i in miss_idx]
        ka = self.cache.claim_keepalive(miss_keys)
        ka.__enter__()
        try:
            m = len(miss_idx)
            batch = ed25519_batch.prepare_compact(
                [msgs[i] for i in miss_idx], [sigs[i] for i in miss_idx], val_idx[miss_idx],
                st.epoch, pool=self._host_pool)
            out = self._dispatch_verify_only(batch, bucket_size(m, self.miss_buckets), st)
            with self._mtx:
                self.cache_verify_calls += 1
                self.cache_verify_rows += m
            ticket = _CachedDeviceTicket(
                self.cache, out, self._staging_ring(), ka, miss_idx, miss_keys, keys, valid,
                tx_slot, n_slots, prior_stake, q, keep, pending, st.powers, val_idx)
        except BaseException:
            # claims must not outlive a failed dispatch: the other engines
            # would wait out the TTL
            ka.__exit__(None, None, None)
            self.cache.release_many(miss_keys)
            raise
        return ticket

    def _dispatch_verify_only(self, batch, b: int, st) -> torch.Tensor:
        """Pad the prepared rows to ``b``, copy them to the device and
        launch the verify kernel alone (``ed25519_batch.verify_into``, one
        ``verify`` launch; its plain version for the CPU). Returns the
        int32 [b] validity, not read back."""
        pad = b - batch.size

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(_pad(a, pad))).to(self.device)

        args = (dev(batch.s_nibbles), dev(batch.h_nibbles), dev(batch.val_idx),
                st.tables_dev, st.quarters_dev, dev(batch.r_y), dev(batch.r_sign),
                dev(batch.pre_ok))
        if self.device.type == "cpu":
            return ed25519_batch.verify_kernel_gather_plain(
                *args, fe_radix=self.fe_radix).to(torch.int32)
        out = torch.empty((b,), dtype=torch.int32, device=self.device)
        ed25519_batch.verify_into(out, *args, fe_radix=self.fe_radix)
        return out

    def _staging_ring(self) -> "StagingRing | None":
        if self.staging_depth < 2:
            return None
        ring = self._ring
        if ring is None:
            with self._mtx:
                if self._ring is None:
                    self._ring = StagingRing(self.staging_depth)
                ring = self._ring
        return ring


def _pad(a: np.ndarray, pad: int) -> np.ndarray:
    if pad == 0:
        return a
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
