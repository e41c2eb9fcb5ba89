"""TxFlow: per-tx vote aggregation + instant commit (reference
txflow/service.go), the serial path of ``txflow_tpu/engine/txflow.py``.

The reference's ``checkMaj23Routine`` walks the vote-pool CList one vote at
a time, verifying each ed25519 signature on the host under a mutex
(:123-166 -> types/vote_set.go:81-131). Here one aggregation **step**:

1. drains a batch of pending votes from the pool (insertion order -- the
   canonical intra-batch order, so replays and the scalar model agree);
2. assigns a tx slot per distinct tx hash and gathers each slot's prior
   accumulated stake from its host TxVoteSet;
3. runs the batched device verify + tally (the CUDA verify and tally
   kernels, one readback);
4. routes each verified vote into its authoritative ``TxVoteSet`` via the
   reference-identical decision path (first-signature-wins, conflict
   rejection) and, for every tx that crossed 2/3: save to TxStore -> fetch
   the tx from the mempool by key -> ApplyTx -> purge the quorum's votes
   from the pool -> push the tx into the commitpool (the sequence of
   txflow/service.go:216-232).

``step()`` runs one round serially. ``start()`` / ``stop()`` serve the
pool from threads instead, on the JAX engine's default served path
(``txflow_tpu/engine/txflow.py:136-664``):

- **Lanes** (``lane_split``): votes whose tx the admission classifier put
  in the priority lane (``TxVotePool.lane_of_vote``, frozen at ingest)
  are drained from the pool's priority log by their own coalescer (short
  ``priority_linger``, targets up to ``priority_bucket_cap``) ahead of
  every bulk dispatch; the bulk lane walks the main log without them.
  Each lane requeues into its own retry list.
- **Coalescing** (``coalesce``): with a verifier that has a bucket ladder
  (``DeviceVoteVerifier.buckets``), the bulk lane dispatches only full
  rungs and holds a partial batch until ``coalesce_linger`` or an idle
  pool; without one it forms batches by ``min_batch``/``batch_wait``.
- **Pipelining**: ``_run_pipelined`` keeps up to ``pipeline_depth`` verify
  calls in flight (``adaptive_depth`` steers that number) and collects
  and routes them in submission order; ``speculative_commit`` routes the
  votes of slots whose device maj23 bit is set first. Certificates are
  byte-identical to the serial loop's; with lanes or speculation only the
  commit order across txs may differ.
- A committer thread takes the store, ABCI and pool-purge effects of each
  decided commit (``pipeline_commits``); a host-prep pool
  (``engine/hostprep.py``, ``host_prep_workers``) encodes sign bytes and
  the verifier's compact prep in worker processes; the device verifier
  reads each step back through its ring (``parallel/staging.py``).

``start()`` first builds the kernels and runs one all-padding step at the
drain bucket (``DeviceVoteVerifier.warm``), so the first served step pays
no build or first launch. A failure in a thread, the coalescers and lanes
included, is kept and raised by ``stop()``; nothing falls back.

At a block boundary ``update_state`` moves the engine to a new height and,
on a rotated set (a new epoch's committee), restages the verifier's tables
and re-evaluates every in-flight vote set; ``apply_synced_commit`` is the
seam through which the catch-up client (``sync/``) applies a fetched,
re-verified certificate.

Divergences from the reference (defects fixed, as in the JAX package):
committed TxVoteSets are dropped from the in-flight map and late votes for
a committed tx are discarded; votes that can never be added (invalid
signature, conflicting signature, unknown validator) are removed from the
pool instead of lingering.
"""

from __future__ import annotations

import hashlib
import queue as _queue
import threading
import time
from collections import deque

import numpy as np

from ..pool.mempool import Mempool
from ..pool.txvotepool import TxVotePool
from ..store.tx_store import TxStore
from ..types import TxVote, TxVoteSet
from ..types.tx_vote import sign_bytes_many
from ..types.validator import ValidatorSet
from ..utils.cache import LRUCache
from ..utils.config import EngineConfig
from ..ops import _lib
from ..parallel.mesh import make_mesh
from ..verifier import DeviceVoteVerifier, ScalarVoteVerifier
from .adaptive import AdaptiveDepthController
from .execution import TxExecutor
from .hostprep import make_host_pool

# below this many drained votes the pool's shard bookkeeping costs more
# than the parallel encode saves
_POOL_MIN_VOTES = 256


class _StepPrep:
    """Host-side product of one pool drain: everything the verify call and
    the routing pass need. In the pipelined loop it is built while the
    previous batch is still in flight, so its dedup and prior stake may be
    one batch stale: routing re-validates every vote against
    vote_sets/_committed, and the host TxVoteSet, never the device's
    maj23, decides each quorum."""

    __slots__ = (
        "keys", "votes", "slots", "n_slots", "prior", "msgs", "sigs",
        "val_idx", "dropped", "verifier", "drain_seq", "t0", "submit_t", "lane",
    )

    def __init__(self, drain_seq: int = 0, t0: float = 0.0, lane: str | None = None):
        self.keys: list[bytes] = []
        self.votes: list[TxVote] = []
        self.slots: list[int] = []
        self.n_slots = 0
        self.prior = None
        self.msgs: list[bytes] = []
        self.sigs: list[bytes] = []
        self.val_idx = None
        self.dropped = 0
        # the verifier of the set whose address->index map built val_idx
        self.verifier = None
        self.drain_seq = drain_seq  # pool seq before the drain
        self.t0 = t0
        self.submit_t = t0
        # the drain that made this batch ("prio", "bulk", or None for the
        # merged drain): a requeue goes back to that lane's retry list
        self.lane = lane


class _BatchCoalescer:
    """Shape-stable batch sizing (``txflow_tpu/engine/txflow.py:111-247``):
    dispatch full rungs of the verifier's bucket ladder, hold a partial
    batch until a linger deadline.

    Only sizes from the ladder (at least ``min_batch``, at most ``cap``)
    are dispatched: when the backlog covers a rung, exactly the largest
    covered rung is drained (no padding; the rest waits for the next
    decision); else the partial backlog lingers until ``linger`` after its
    first vote or an idle pool (``note_idle``), then flushes at whatever
    size it reached, padded to its rung by the verifier. Called from the
    engine thread only; ``full_batches``, ``linger_flushes`` and
    ``wide_full_batches`` count the decisions."""

    __slots__ = (
        "targets", "linger", "full_batches", "linger_flushes", "_deadline", "_idle",
        "_clock", "wide_from", "wide_ok", "wide_full_batches",
    )

    def __init__(self, buckets, cap: int, min_batch: int, linger: float,
                 clock=time.monotonic, multiple: int = 1, wide_from: int | None = None):
        # a mesh pads every dispatch to a multiple of its shard count, so
        # the targets are rounded to it: a full rung splits evenly
        m = max(1, int(multiple))
        targets = sorted({-(-b // m) * m for b in buckets if min_batch <= b <= cap})
        # no rung fits [min_batch, cap]: dispatch at the cap
        self.targets = targets or [-(-cap // m) * m]
        self.linger = linger
        self.full_batches = 0
        self.linger_flushes = 0
        self._deadline: float | None = None
        self._idle = False
        self._clock = clock
        # rungs above wide_from are taken only while wide_ok holds
        # (EngineConfig.wide_buckets; None: no wide rungs, the gate is inert)
        self.wide_from = None if wide_from is None else int(wide_from)
        self.wide_ok = True
        self.wide_full_batches = 0

    def decide(self, pending: int) -> int:
        """Votes to dispatch now: a full rung, the whole backlog on a
        linger or idle flush, or 0 (keep coalescing)."""
        if pending <= 0:
            self._deadline = None
            self._idle = False
            return 0
        full = 0
        for b in self.targets:
            if pending >= b:
                if self.wide_from is not None and b > self.wide_from and not self.wide_ok:
                    break  # wide rungs gated off: stop at the classic cap
                full = b
            else:
                break
        if full:
            self._deadline = None
            self._idle = False
            self.full_batches += 1
            if self.wide_from is not None and full > self.wide_from:
                self.wide_full_batches += 1
            return full
        now = self._clock()
        if self._deadline is None:
            self._deadline = now + self.linger
        if now >= self._deadline or self._idle:
            self._deadline = None
            self._idle = False
            self.linger_flushes += 1
            return pending
        return 0

    def set_wide(self, ok: bool) -> None:
        """Gate the wide rungs."""
        self.wide_ok = bool(ok)

    def note_idle(self) -> None:
        """The pool wait timed out with votes pending and nothing new
        arriving: flush at the next decide instead of riding out the
        linger."""
        if self._deadline is not None:
            self._idle = True

    def wait_budget(self, poll: float, idle_flush: float) -> float:
        """Bound for the engine's pool wait, so that a linger flush fires on
        time and idleness is seen on the idle_flush scale; 0 once the
        deadline has passed (the flush is due now)."""
        budget = poll
        if self._deadline is not None:
            rem = self._deadline - self._clock()
            if rem <= 0:
                return 0.0
            budget = min(budget, max(rem, 0.0005))
            if idle_flush > 0:
                budget = min(budget, idle_flush)
        return budget


class TxFlow:
    def __init__(
        self,
        chain_id: str,
        height: int,
        val_set: ValidatorSet,
        tx_vote_pool: TxVotePool,
        mempool: Mempool,
        commitpool: Mempool,
        tx_executor: TxExecutor,
        tx_store: TxStore,
        config: EngineConfig | None = None,
        verifier=None,
    ):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.tx_vote_pool = tx_vote_pool
        self.mempool = mempool
        self.commitpool = commitpool
        self.tx_executor = tx_executor
        self.tx_store = tx_store
        self.config = config or EngineConfig()
        if verifier is not None:
            self.verifier = verifier
        elif self.config.use_device:
            # no fallback: a device or build failure raises, and so does a
            # mesh of more cards than are visible (the JAX engine falls
            # back to one device there); a set of total power >= 2^30 is
            # tallied in int64 on the device (the JAX engine takes its
            # host verifier there)
            fe_radix = self.config.fe_radix
            ring = int(self.config.staging_ring)
            if int(self.config.mesh_devices or 0) > 1:
                mesh = make_mesh(int(self.config.mesh_devices), device=self.config.device)
                self.verifier = DeviceVoteVerifier(val_set, mesh=mesh, fe_radix=fe_radix,
                                                   staging_ring=ring)
            else:
                self.verifier = DeviceVoteVerifier(
                    val_set, device=self.config.device, fe_radix=fe_radix, staging_ring=ring
                )
        else:
            self.verifier = ScalarVoteVerifier(val_set)
        self._addr_to_idx = {v.address: i for i, v in enumerate(val_set)}
        self._drain_cap = min(
            self.config.max_batch,
            getattr(self.verifier, "max_batch", self.config.max_batch),
        )
        # on a mesh, a full drain splits evenly over the shards: no pad rows
        shards = self._verifier_shards()
        if self._drain_cap >= shards:
            self._drain_cap -= self._drain_cap % shards
        # wide_buckets: the bulk coalescer may reach the ladder's rungs
        # above max_batch; the classic cap stays its wide_from gate line
        self._classic_drain_cap = self._drain_cap
        if self.config.wide_buckets:
            buckets = self._verifier_buckets()
            if buckets:
                self._drain_cap = max(self._drain_cap, max(buckets))
        self.vote_sets: dict[str, TxVoteSet] = {}  # in-flight only
        self._committed = LRUCache(1 << 16)  # recently committed tx hashes
        # ingest-log cursor: each pool entry is visited by step() exactly
        # once (in-batch repeats re-queue on _retry)
        self._drain_cursor = 0
        self._retry: list[tuple[bytes, TxVote]] = []
        # the priority log's cursor; in the merged drain (lane None) the
        # keys drained from the priority log are remembered until the main
        # cursor passes them, so no vote is prepped twice
        self._prio_drain_cursor = 0
        self._prio_drained: set[bytes] = set()
        # the lane-split drain: the priority lane's own retry list (a
        # priority repeat never waits behind the bulk backlog)
        self._retry_prio: list[tuple[bytes, TxVote]] = []
        # built by start(): the bulk coalescer (None without a bucket
        # ladder or with coalesce off), the priority lane (lane_split),
        # and the depth controller (adaptive_depth)
        self._coalescer: _BatchCoalescer | None = None
        self._prio_lane: _BatchCoalescer | None = None
        self._depth_ctrl: AdaptiveDepthController | None = None
        self._lane_prio_batches = 0
        self._lane_prio_votes = 0
        # speculative commit: commits routed on the device's maj23 bit,
        # and the route-tail seconds their early exit saved
        self._spec_commits = 0
        self._spec_saved_s = 0.0
        self._mtx = threading.RLock()
        # quorum-before-tx: a certificate can be decided before the tx
        # bytes reach the local mempool; the apply then waits (tx_hash ->
        # tx_key), as in the JAX package
        self._unapplied: dict[str, bytes] = {}
        self.app_hash = b""
        self.last_rotation: dict | None = None
        # threaded engine (start/stop): the loop and committer threads, the
        # commit queue, and the first error a thread met (stop() raises it)
        self._running = False
        self._thread: threading.Thread | None = None
        self._committer: threading.Thread | None = None
        self._commit_q: _queue.SimpleQueue = _queue.SimpleQueue()
        self._error: BaseException | None = None
        # decided against applied commits: commits_drained() compares them
        self._decided_count = 0
        self._applied_count = 0
        # the host-prep pool the drain encodes sign bytes on: the device
        # verifier's (ensure_host_pool), or the engine's own beside a host
        # verifier
        self._host_pool = None
        self._own_host_pool = False
        self.warm_s: float | None = None  # start()'s build + warm steps
        self.warm_rungs: list[int] = []  # the rows of each warm step
        # pipeline accounting (loop thread; pipeline_stats reads it):
        # busy is the union of the [submit, collect] windows, active the
        # loop's own prep, wait and route seconds
        self._pipe_steps = 0
        self._pipe_prep_s = 0.0
        self._pipe_wait_s = 0.0
        self._pipe_route_s = 0.0
        self._pipe_busy_s = 0.0
        self._pipe_active_s = 0.0
        self._pipe_last_collect = 0.0
        self._pipe_lock_wait_s = 0.0
        self._pipe_prep_sign_s = 0.0
        self._pipe_prep_pool_wait_s = 0.0
        # batches drained and not yet routed (under _mtx): with the drain
        # cursor, what a caller waiting for quiescence reads
        self._pipe_in_flight = 0
        # the last step's (decided, requeued, dropped, batch)
        self.last_step_stats: dict | None = None

    # ---- lifecycle: the threaded engine (reference OnStart :80-87) ----

    def start(self) -> None:
        """Build the kernels, run the warm step, build the bulk coalescer,
        the priority lane and the depth controller as configured, attach
        the host-prep pool, then start the committer (``pipeline_commits``)
        and the run loop (``txflow_tpu/engine/txflow.py:136``). Raises if
        any of it fails."""
        with self._mtx:
            if self._running:
                return
            self._running = True
            self._error = None
            self._commit_q = _queue.SimpleQueue()
        try:
            self._build_lanes()
            self._warm()
            workers = int(self.config.host_prep_workers or 0)
            if workers > 1 and self._host_pool is None:
                backend = str(self.config.host_prep_backend)
                if isinstance(self.verifier, DeviceVoteVerifier):
                    self._host_pool = self.verifier.ensure_host_pool(workers, backend)
                else:
                    self._host_pool = make_host_pool(workers, backend, name="hostprep-engine")
                    self._own_host_pool = True
        except BaseException:
            with self._mtx:
                self._running = False
            raise
        self.tx_vote_pool.enable_txs_available()
        if self.config.pipeline_commits:
            self._committer = threading.Thread(
                target=self._guard, args=(self._committer_run,), name="txflow-commit",
                daemon=True,
            )
            self._committer.start()
        self._thread = threading.Thread(
            target=self._guard, args=(self._run,), name="txflow", daemon=True
        )
        self._thread.start()

    def _build_lanes(self) -> None:
        """The coalescers and the depth controller, as the JAX ``start()``
        builds them (``txflow_tpu/engine/txflow.py:172-253``)."""
        shards = self._verifier_shards()
        buckets = self._verifier_buckets()
        if self.config.coalesce and self._coalescer is None and buckets:
            self._coalescer = _BatchCoalescer(
                buckets, cap=self._drain_cap, min_batch=self.config.min_batch,
                linger=self.config.coalesce_linger, multiple=shards,
                wide_from=(self._classic_drain_cap
                           if self._drain_cap > self._classic_drain_cap else None),
            )
        if self.config.lane_split and self._prio_lane is None:
            # built without a ladder too (cap-sized targets): the lane is
            # about preemption, not shapes
            self._prio_lane = _BatchCoalescer(
                buckets or (),
                cap=min(max(1, int(self.config.priority_bucket_cap)), self._drain_cap),
                min_batch=1, linger=self.config.priority_linger, multiple=shards,
            )
        if self.config.adaptive_depth and self._depth_ctrl is None:
            self._depth_ctrl = AdaptiveDepthController(
                depth=max(2, int(self.config.pipeline_depth)),
                min_depth=self.config.pipeline_depth_min,
                max_depth=self.config.pipeline_depth_max,
            )

    def _warm(self) -> None:
        """The warm step (it replaces the JAX package's shape prewarm,
        ``engine/shapes.py``: nvcc kernels compile once, not per shape):
        build the kernels when the verifier is on CUDA cards, then submit
        and collect one all-padding batch at the drain bucket over
        ``max_slots`` slots on every card of its mesh; with a coalescer or
        a priority lane, one more at each smaller rung of the ladder they
        dispatch (full rungs and padded flushes), so that the first step
        at a rung finds the allocator's blocks of its sizes (on an H100,
        without them, the first step at rungs 64 and 256 took 1.8-2.2x the
        submit time of the rest). ``warm_rungs`` lists them."""
        v = self.verifier
        if not isinstance(v, DeviceVoteVerifier):
            return
        t0 = time.perf_counter()
        if v.device.type == "cuda":
            _lib.build_all()
        rungs = [self._drain_cap]
        if self._coalescer is not None or self._prio_lane is not None:
            rungs += sorted((b for b in set(v.buckets) if b < self._drain_cap), reverse=True)
        for rows in rungs:
            v.warm(rows, self.config.max_slots)
        self.warm_rungs = rungs
        self.warm_s = time.perf_counter() - t0

    def _guard(self, fn) -> None:
        """Run a thread's body; keep its error for stop() and stop the
        engine (no thread dies quietly)."""
        try:
            fn()
        except BaseException as exc:
            with self._mtx:
                if self._error is None:
                    self._error = exc
                self._running = False
            if self._committer is not None and threading.current_thread() is not self._committer:
                self._commit_q.put(None)  # the committer drains and exits too

    @property
    def error(self) -> BaseException | None:
        """The first error a thread of the engine met (None while sound)."""
        return self._error

    def stop(self) -> None:
        """Stop the loop (it collects and routes every ticket in flight),
        drain the commit queue, close the host-prep pool and the readback
        ring, and raise the first error a thread met."""
        with self._mtx:
            self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._committer is not None:
            self._commit_q.put(None)  # after the last decided commit
            self._committer.join()
            self._committer = None
        if self._own_host_pool and self._host_pool is not None:
            self._host_pool.close()
        self._host_pool = None
        self._own_host_pool = False
        if isinstance(self.verifier, DeviceVoteVerifier):
            self.verifier.close()
        if self._error is not None:
            raise self._error

    def _run(self) -> None:
        if self.config.pipeline_depth >= 2:
            self._run_pipelined()
        else:
            self._run_serial()

    def _target_depth(self) -> int:
        ctrl = self._depth_ctrl
        if ctrl is not None:
            return ctrl.depth
        return max(2, int(self.config.pipeline_depth))

    def _prio_pending(self) -> int:
        """Priority backlog estimate: priority ingests not yet walked plus
        the lane's requeues (over-counts only removed entries not yet
        walked)."""
        return self.tx_vote_pool.prio_seq() - self._prio_drain_cursor + len(self._retry_prio)

    def _bulk_pending(self) -> int:
        """Bulk backlog estimate: unvisited ingest of the main log plus the
        retries, less the priority backlog when the priority lane runs
        (the main log's seq counts priority ingests too). Both sides
        over-count dead entries, so the difference stays a safe estimate
        that corrects itself as the cursors advance."""
        pending = self.tx_vote_pool.seq() - self._drain_cursor + len(self._retry)
        if self._prio_lane is not None:
            pending -= max(self.tx_vote_pool.prio_seq() - self._prio_drain_cursor, 0)
        return max(pending, 0)

    def _bulk_quantum(self) -> int:
        """Bulk drain cap a step while the priority lane runs without a
        bucket ladder: one bulk verify is the priority lane's preemption
        gap, so once priority traffic exists bulk drains in shard-rounded
        quanta of 64; a run that never saw a priority ingest keeps the
        min_batch drain."""
        if self.tx_vote_pool.prio_seq() == 0:
            return max(int(self.config.min_batch), 64)
        m = self._verifier_shards()
        return -(-64 // m) * m

    def _lane_wait(self, seq_before: int) -> None:
        """Wait on the pool's ingest counter for at most what the lanes'
        deadlines allow; a wait that saw nothing new marks both lanes
        idle."""
        co, pl = self._coalescer, self._prio_lane
        budget = self.config.poll_interval
        if co is not None:
            budget = co.wait_budget(budget, self.config.idle_flush)
        if pl is not None:
            budget = pl.wait_budget(budget, self.config.idle_flush)
        got = self.tx_vote_pool.wait_for_new(seq_before, timeout=budget)
        if got == seq_before:
            if co is not None:
                co.note_idle()
            if pl is not None:
                pl.note_idle()

    def _run_serial(self) -> None:
        """``txflow_tpu/engine/txflow.py:401``: a dispatchable priority
        batch first, then the bulk lane (a coalescer's rung or flush, else
        a formed batch); on an empty round wait on the pool's ingest
        counter (sampled before the steps, so a vote that lands mid-step
        wakes the loop at once)."""
        co, pl = self._coalescer, self._prio_lane
        lane_bulk = "bulk" if pl is not None else None
        while True:
            with self._mtx:
                if not self._running:
                    return
            seq_before = self.tx_vote_pool.seq()
            processed = 0
            if pl is not None:
                plimit = pl.decide(self._prio_pending())
                if plimit > 0:
                    processed += self.step(plimit, lane="prio")
            if co is not None:
                limit = co.decide(self._bulk_pending())
                if limit > 0:
                    processed += self.step(limit, lane=lane_bulk)
            elif pl is not None:
                # the forming hold ends by the priority lane's deadline, and
                # bulk drains in quanta so priority preempts soon
                self._form_batch(pl.wait_budget(self.config.batch_wait, self.config.idle_flush))
                processed += self.step(self._bulk_quantum(), lane=lane_bulk)
            else:
                self._form_batch()
                processed += self.step()
            if self._committer is None and self._unapplied:
                self._apply_unapplied()
            if processed == 0 and (co is not None or not self._retry):
                self._lane_wait(seq_before)

    def _run_pipelined(self) -> None:
        """``txflow_tpu/engine/txflow.py:465``: prep and submit until the
        target depth of tickets is in flight -- a dispatchable priority
        batch before any bulk one; the bulk lane by its coalescer, or
        without one a formed batch (with a ticket pending, a follow-up
        batch goes only once ``min_batch`` votes wait) -- then collect the
        oldest and route it, in submission order, and feed the depth
        controller. On stop, or an error, every ticket in flight is still
        collected and routed."""
        inflight: deque = deque()
        co, pl = self._coalescer, self._prio_lane
        lane_bulk = "bulk" if pl is not None else None
        ctrl = self._depth_ctrl
        try:
            while True:
                with self._mtx:
                    if not self._running:
                        return
                depth = self._target_depth()
                seq_before = self.tx_vote_pool.seq()
                while len(inflight) < depth:
                    if pl is not None:
                        plimit = pl.decide(self._prio_pending())
                        if plimit > 0:
                            prep = self._prep_batch(plimit, lane="prio")
                            if prep is not None:
                                if prep.votes:
                                    inflight.append((prep, self._submit_prep(prep)))
                                continue
                            # the estimate raced a purge: try the bulk lane
                    if co is not None:
                        limit = co.decide(self._bulk_pending())
                        if limit <= 0:
                            break
                        prep = self._prep_batch(limit, lane=lane_bulk)
                    else:
                        if not inflight:
                            self._form_batch(None if pl is None else pl.wait_budget(
                                self.config.batch_wait, self.config.idle_flush))
                        elif self._bulk_pending() < max(1, self.config.min_batch):
                            break
                        prep = self._prep_batch(None if pl is None else self._bulk_quantum(),
                                                lane=lane_bulk)
                    if prep is None:
                        break
                    if not prep.votes:
                        continue  # a drop-only drain: the cursor moved on
                    inflight.append((prep, self._submit_prep(prep)))
                if not inflight:
                    if self._committer is None and self._unapplied:
                        self._apply_unapplied()
                    if co is not None or pl is not None or not self._retry:
                        self._lane_wait(seq_before)
                    continue
                prep, ticket = inflight.popleft()
                _decided, _requeued, all_deferred = self._route_result(
                    prep, self._collect(prep, ticket)
                )
                if ctrl is not None:
                    ctrl.observe(self._pipe_busy_s, self._pipe_active_s, self._pipe_steps)
                if self._committer is None and self._unapplied:
                    self._apply_unapplied()
                if all_deferred:
                    self.tx_vote_pool.wait_for_new(
                        prep.drain_seq, timeout=self.config.defer_backoff
                    )
        finally:
            err = None
            while inflight:
                prep, ticket = inflight.popleft()
                try:
                    self._route_result(prep, self._collect(prep, ticket))
                except Exception as exc:  # raised below, after the rest settle
                    err = err or exc
            if err is not None:
                raise err

    def _form_batch(self, budget: float | None = None) -> None:
        """Hold up to batch_wait (or ``budget``, if shorter: the priority
        lane's deadline) for min_batch pending votes; with votes pending
        and none arriving for idle_flush, go at once
        (``txflow_tpu/engine/txflow.py:625``)."""
        min_batch = self.config.min_batch
        if min_batch <= 1:
            return
        wait = self.config.batch_wait
        if budget is not None:
            wait = min(wait, max(budget, 0.0))
        deadline = time.monotonic() + wait
        idle_flush = self.config.idle_flush
        while True:
            seq_now = self.tx_vote_pool.seq()
            # unvisited ingest of the main log (priority ingests included)
            pending = seq_now - self._drain_cursor + len(self._retry)
            remaining = deadline - time.monotonic()
            if pending >= min_batch or remaining <= 0:
                return
            timeout = remaining
            if idle_flush > 0 and pending > 0:
                timeout = min(remaining, idle_flush)
            got = self.tx_vote_pool.wait_for_new(seq_now, timeout=timeout)
            if got == seq_now and pending > 0:
                return

    # ---- batched aggregation step ----

    def step(self, limit: int | None = None, lane: str | None = None) -> int:
        """One serial verify+tally+commit round (prep -> submit -> collect
        -> route); returns votes processed this step: votes routed to a
        decision plus votes dropped at drain time. Votes the verifier
        deferred (in-batch repeats) re-enter via their lane's retry list
        and are counted by the step that decides them; ``last_step_stats``
        reconciles decided + requeued with the verified batch. ``limit``
        caps the batch (retries included) below the drain cap; ``lane``
        picks the drain ("prio", "bulk", or None for the merged drain, see
        ``_prep_batch``)."""
        prep = self._prep_batch(limit, lane)
        if prep is None:
            return 0
        if not prep.votes:
            self.last_step_stats = {"decided": 0, "requeued": 0, "dropped": prep.dropped,
                                    "batch": 0}
            return prep.dropped
        # device verify outside the engine lock: routing re-validates
        # against vote_sets/_committed
        ticket = self._submit_prep(prep)
        result = self._collect(prep, ticket)
        decided, _requeued, all_deferred = self._route_result(prep, result)
        if all_deferred:
            self.tx_vote_pool.wait_for_new(prep.drain_seq, timeout=self.config.defer_backoff)
        return decided + prep.dropped

    def _sign_bytes_proc(self, votes, pool) -> list[bytes]:
        """Sign bytes of a drain batch over the process pool
        (``txflow_tpu/engine/txflow.py:1042``): the cache scan inline, the
        misses encoded by the workers, each vote's cache primed with its
        bytes -- the bytes of ``sign_bytes_many``."""
        out: list = [None] * len(votes)
        miss: list[int] = []
        for i, v in enumerate(votes):
            c = v._sb_cache
            if c is not None and c[0] == self.chain_id:
                out[i] = c[1]
            else:
                miss.append(i)
        if miss:
            rows, wait_s = pool.sign_bytes_shm(
                [votes[i].height for i in miss], [votes[i].tx_hash for i in miss],
                [votes[i].timestamp_ns for i in miss], self.chain_id,
            )
            self._pipe_prep_pool_wait_s += wait_s
            for j, i in enumerate(miss):
                out[i] = rows[j]
                if votes[i].signature is not None:  # immutable once signed
                    object.__setattr__(votes[i], "_sb_cache", (self.chain_id, rows[j]))
        return out

    def _drain_lane(self, target: int, lane: str | None) -> list[tuple[bytes, TxVote]]:
        """The (key, vote) pairs of one drain, retries first, under _mtx
        (``txflow_tpu/engine/txflow.py:1111-1160``): "prio" walks only the
        pool's priority log and the lane's retries, "bulk" the main log
        without the ingest-time priority entries -- together an exact
        partition -- and None the merged drain, the priority log first and
        then the main log, skipping keys the priority walk already took."""
        pool = self.tx_vote_pool
        if lane == "prio":
            raw, self._prio_drain_cursor = pool.priority_entries_from(
                self._prio_drain_cursor, limit=max(target - len(self._retry_prio), 0))
            batch = self._retry_prio + [(k, v) for k, v, _h in raw]
            self._retry_prio = []
            return batch
        if lane == "bulk":
            raw, self._drain_cursor = pool.bulk_entries_from(
                self._drain_cursor, limit=max(target - len(self._retry), 0))
            batch = self._retry + [(k, v) for k, v, _h in raw]
            self._retry = []
            return batch
        praw, self._prio_drain_cursor = pool.priority_entries_from(
            self._prio_drain_cursor, limit=max(target - len(self._retry), 0))
        drained = self._prio_drained
        drained.update(k for k, _v, _h in praw)
        raw, self._drain_cursor = pool.entries_from(
            self._drain_cursor, limit=max(target - len(self._retry) - len(praw), 0))
        fresh = []
        for k, v, _h in raw:
            if k in drained:
                drained.discard(k)  # the main log reached it: done
                continue
            fresh.append((k, v))
        if len(drained) > 8192:
            # keys removed before the main cursor reached them would pile
            # up: keep only those the pool still holds
            self._prio_drained = {k for k in drained if pool.has(k)}
        batch = self._retry + [(k, v) for k, v, _h in praw] + fresh
        self._retry = []
        return batch

    def _prep_batch(self, limit: int | None = None,
                    lane: str | None = None) -> "_StepPrep | None":
        """Drain the pool by ``lane`` (``_drain_lane``), dedup against
        committed/held votes, assign tx slots, gather prior stake, and
        build sign bytes (on the host-prep pool from ``_POOL_MIN_VOTES``
        votes). Returns None when nothing was drained; a prep with empty
        ``votes`` when everything drained was dropped."""
        t0 = time.perf_counter()
        target = self._drain_cap if limit is None else min(limit, self._drain_cap)
        drain_seq = self.tx_vote_pool.seq()
        with self._mtx:
            lk = time.perf_counter()
            self._pipe_lock_wait_s += lk - t0
            batch = self._drain_lane(target, lane)
            if not batch:
                return None
            prep = _StepPrep(drain_seq, t0, lane)
            keys, votes, slots = prep.keys, prep.votes, prep.slots
            slot_of: dict[str, int] = {}
            drop_now: list[bytes] = []
            for bi, (key, vote) in enumerate(batch):
                if _hash_key(vote.tx_hash) in self._committed or (
                    vote.tx_hash not in self.vote_sets
                    and self.tx_store.has_tx(vote.tx_hash)
                ):
                    drop_now.append(key)  # late vote for a committed tx
                    continue
                vs = self.vote_sets.get(vote.tx_hash)
                if vs is not None and vs.get_by_address(vote.validator_address) is not None:
                    # the set already holds a vote from this validator:
                    # identical signature = silent dup, different = an
                    # honest re-sign; both dropped first-signature-wins
                    drop_now.append(key)
                    continue
                if (
                    vote.tx_hash not in slot_of
                    and len(slot_of) >= self.config.max_slots
                ):
                    # leave the tail for the next step (the cursor has
                    # passed it, so it re-queues explicitly), in the lane's
                    # own retry list
                    (self._retry_prio if lane == "prio" else self._retry).extend(batch[bi:])
                    break
                slot = slot_of.setdefault(vote.tx_hash, len(slot_of))
                keys.append(key)
                votes.append(vote)
                slots.append(slot)
            if drop_now:
                self.tx_vote_pool.remove(drop_now)
            prep.dropped = len(drop_now)
            if not votes:
                return prep
            self._pipe_in_flight += 1
            prep.n_slots = len(slot_of)
            prior = np.zeros(prep.n_slots, np.int64)
            for tx_hash, s in slot_of.items():
                vs = self.vote_sets.get(tx_hash)
                if vs is not None:
                    prior[s] = vs.stake()
            prep.prior = prior
            # this drain's set epoch: update_state swaps the map and the
            # verifier together under _mtx, so the batch goes to the
            # verifier that matches the indices it was built with
            addr_to_idx = self._addr_to_idx
            prep.verifier = self.verifier
        pool = self._host_pool
        t_sign = time.perf_counter()
        if pool is not None and len(votes) >= _POOL_MIN_VOTES and pool.backend == "process":
            # worker processes over shared memory; a broken pool raises
            prep.msgs = self._sign_bytes_proc(votes, pool)
            prep.sigs = [v.signature or b"" for v in votes]
            prep.val_idx = np.array(
                [addr_to_idx.get(v.validator_address, -1) for v in votes], dtype=np.int64
            )
        elif pool is not None and len(votes) >= _POOL_MIN_VOTES:
            def assemble(lo: int, hi: int):
                part = votes[lo:hi]
                return (sign_bytes_many(part, self.chain_id), [v.signature or b"" for v in part],
                        [addr_to_idx.get(v.validator_address, -1) for v in part])

            parts, wait_s = pool.map_shards(len(votes), assemble)
            prep.msgs = [m for p in parts for m in p[0]]
            prep.sigs = [s for p in parts for s in p[1]]
            prep.val_idx = np.array([i for p in parts for i in p[2]], dtype=np.int64)
            self._pipe_prep_pool_wait_s += wait_s
        else:
            prep.msgs = sign_bytes_many(votes, self.chain_id)
            prep.sigs = [v.signature or b"" for v in votes]
            prep.val_idx = np.array(
                [addr_to_idx.get(v.validator_address, -1) for v in votes], dtype=np.int64
            )
        end = time.perf_counter()
        self._pipe_prep_sign_s += end - t_sign
        self._pipe_prep_s += end - t0
        self._pipe_active_s += end - t0
        return prep

    def _submit_prep(self, prep: "_StepPrep"):
        """Hand the prepped batch to the verifier captured at drain
        (host prep, H2D, launch; no readback)."""
        t0 = time.perf_counter()
        prep.submit_t = t0
        if prep.lane == "prio":
            self._lane_prio_batches += 1
            self._lane_prio_votes += len(prep.votes)
        ticket = prep.verifier.submit(
            prep.msgs, prep.sigs, prep.val_idx,
            np.array(prep.slots, np.int32), prep.n_slots,
            prior_stake=prep.prior,
        )
        dur = time.perf_counter() - t0
        self._pipe_prep_s += dur
        self._pipe_active_s += dur
        return ticket

    def _collect(self, prep: "_StepPrep", ticket):
        """Block for the ticket's readback, and account the device-busy
        window [submit, collect], unioned over overlapping tickets (they
        are collected in order, so the last collect is the watermark)."""
        t0 = time.perf_counter()
        result = ticket.result()
        t1 = time.perf_counter()
        self._pipe_wait_s += t1 - t0
        self._pipe_active_s += t1 - t0
        start = max(prep.submit_t, self._pipe_last_collect)
        if t1 > start:
            self._pipe_busy_s += t1 - start
        self._pipe_last_collect = t1
        return result

    def _route_result(self, prep: "_StepPrep", result) -> tuple[int, int, bool]:
        """Route the verified batch in submission (= pool ingest) order into
        the authoritative vote sets, committing the moment a set crosses
        2/3 -- the reference's per-vote order (service.go:192-234), so
        certificates equal the scalar path's. A decided commit goes to the
        committer thread when there is one, else its effects run here
        after the lock. Returns (decided, requeued, all_deferred);
        decided + requeued == len(prep.votes).

        ``speculative_commit`` (``txflow_tpu/engine/txflow.py:1432-1549``):
        the votes of slots whose maj23 bit (prior stake plus this batch's
        tally over the quorum, in the readback) is set route first, so
        their commits leave before the rest of the batch routes. The bit
        only orders: it may be a batch stale, and the host TxVoteSet
        decides every quorum. All votes of a tx share its slot, so only
        the order across txs moves; certificates stay byte-identical."""
        t0 = time.perf_counter()
        keys, votes = prep.keys, prep.votes
        requeued = 0
        inline_commits: list[tuple[TxVoteSet, list[TxVote], bytes | None]] = []
        purge_votes: list[TxVote] = []  # quorum votes, one pool purge a step
        spec_t: list[float] = []  # decision times of speculative commits
        with self._mtx:
            bad_keys: list[bytes] = []
            valid_l = result.valid.tolist()
            dropped_l = result.dropped.tolist()
            # a requeue goes back to the lane that drained it
            retry_lane = self._retry_prio if prep.lane == "prio" else self._retry
            n = len(votes)
            order = range(n)
            spec_n = 0
            if self.config.speculative_commit:
                maj_l = result.maj23.tolist()
                first = [i for i in range(n) if maj_l[prep.slots[i]]]
                if first and len(first) < n:
                    order = first + [i for i in range(n) if not maj_l[prep.slots[i]]]
                    spec_n = len(first)
            for pos, i in enumerate(order):
                vote = votes[i]
                if dropped_l[i]:
                    # in-batch (slot, validator) repeat: the cursor has
                    # passed this entry, so re-queue it for the next step
                    retry_lane.append((keys[i], vote))
                    requeued += 1
                    continue
                if not valid_l[i]:
                    bad_keys.append(keys[i])
                    continue
                vs = self.vote_sets.get(vote.tx_hash)
                if vs is None:
                    if _hash_key(vote.tx_hash) in self._committed:
                        bad_keys.append(keys[i])  # late: committed this batch
                        continue
                    vs = TxVoteSet(
                        self.chain_id, self.height, vote.tx_hash, vote.tx_key, self.val_set
                    )
                    self.vote_sets[vote.tx_hash] = vs
                added, _err = vs.add_verified_vote(vote)
                if added:
                    if vs.has_two_thirds_majority():
                        if pos < spec_n:
                            spec_t.append(time.perf_counter())
                        # decision under _mtx; store/ABCI effects after it
                        if self._committer is not None:
                            self._enqueue_commit(vs)
                        else:
                            inline_commits.append(self._decide_commit(vs))
                else:
                    bad_keys.append(keys[i])  # dup/conflict: can never add
            if bad_keys:
                self.tx_vote_pool.remove(bad_keys)
        for vs, quorum_votes, tx in inline_commits:
            self._commit_effects(
                vs, quorum_votes, purge_votes, tx=tx, deferred=tx is None
            )
        if purge_votes:
            self.tx_vote_pool.update(self.height, purge_votes)
        t1 = time.perf_counter()
        if spec_t:
            # the saved tail of each speculative commit: route end minus
            # its decision time
            self._spec_commits += len(spec_t)
            self._spec_saved_s += sum(t1 - t for t in spec_t)
        with self._mtx:  # the batch is routed, its effects done
            self._pipe_in_flight -= 1
            self._pipe_steps += 1
        dur = time.perf_counter() - t0
        self._pipe_route_s += dur
        self._pipe_active_s += dur
        decided = len(votes) - requeued
        self.last_step_stats = {"decided": decided, "requeued": requeued,
                                "dropped": prep.dropped, "batch": len(votes)}
        return decided, requeued, requeued == len(votes)

    def pipeline_stats(self) -> dict:
        """The pipeline's accounting (``txflow_tpu/engine/txflow.py:1565``,
        the fields this engine fills): steps; device-busy seconds (the
        union of [submit, collect] windows) over the loop's active seconds
        (prep, readback wait, route); the host-prep split (sign-bytes
        stage, and the part of it spent waiting on pool shards); the
        pool's and the readback ring's counters; the coalescer's, the
        lanes', the speculative route's and the depth controller's."""
        active = self._pipe_active_s
        busy = min(self._pipe_busy_s, active)
        pool = self._host_pool
        co, pl, ctrl = self._coalescer, self._prio_lane, self._depth_ctrl
        stats = {
            "depth": ctrl.depth if ctrl is not None else int(self.config.pipeline_depth),
            "steps": self._pipe_steps,
            "in_flight": self._pipe_in_flight,
            "overlap_ratio": busy / active if active > 0 else None,
            "device_busy_s": self._pipe_busy_s,
            "active_s": active,
            "idle_gap_s": max(active - busy, 0.0),
            "prep_s": self._pipe_prep_s,
            "dispatch_wait_s": self._pipe_wait_s,
            "route_s": self._pipe_route_s,
            "lock_wait_s": self._pipe_lock_wait_s,
            "prep_sign_s": self._pipe_prep_sign_s,
            "prep_pool_wait_s": self._pipe_prep_pool_wait_s,
            "host_prep_workers": pool.workers if pool is not None else 0,
            "host_prep_backend": pool.backend if pool is not None else None,
            "host_prep": pool.stats() if pool is not None else None,
            "mesh_devices": self._verifier_shards(),
            "warm_s": self.warm_s,
            "coalesce": {
                "enabled": co is not None,
                "targets": list(co.targets) if co is not None else None,
                "full_batches": co.full_batches if co is not None else 0,
                "linger_flushes": co.linger_flushes if co is not None else 0,
                "wide_from": co.wide_from if co is not None else None,
                "wide_ok": co.wide_ok if co is not None else None,
                "wide_full_batches": co.wide_full_batches if co is not None else 0,
            },
            "lanes": {
                "enabled": pl is not None,
                "prio_targets": list(pl.targets) if pl is not None else None,
                "prio_batches": self._lane_prio_batches,
                "prio_votes": self._lane_prio_votes,
                "prio_full_batches": pl.full_batches if pl is not None else 0,
                "prio_linger_flushes": pl.linger_flushes if pl is not None else 0,
                "prio_linger_ms": round(pl.linger * 1e3, 4) if pl is not None else None,
                "bulk_linger_ms": round(co.linger * 1e3, 4) if co is not None else None,
            },
            "spec": {
                "enabled": bool(self.config.speculative_commit),
                "commits": self._spec_commits,
                "saved_s": self._spec_saved_s,
            },
        }
        if ctrl is not None:
            stats["adaptive_depth"] = ctrl.stats()
        ring = getattr(self.verifier, "staging_stats", None)
        if ring is not None and ring() is not None:
            stats["staging"] = ring()
        return stats

    # ---- scalar parity API (reference TryAddVote :169-188) ----

    def try_add_vote(self, vote: TxVote) -> tuple[bool, Exception | None]:
        with self._mtx:
            return self._add_vote_scalar(vote)

    def _add_vote_scalar(self, vote: TxVote) -> tuple[bool, Exception | None]:
        """Reference-exact scalar path (the golden engine of the tests)."""
        if _hash_key(vote.tx_hash) in self._committed or (
            vote.tx_hash not in self.vote_sets and self.tx_store.has_tx(vote.tx_hash)
        ):
            return False, None
        vs = self.vote_sets.get(vote.tx_hash)
        if vs is None:
            vs = TxVoteSet(self.chain_id, self.height, vote.tx_hash, vote.tx_key, self.val_set)
            self.vote_sets[vote.tx_hash] = vs
        added, err = vs.add_vote(vote)
        if added and vs.has_two_thirds_majority():
            self._commit_tx(vs)
        return added, err

    # ---- commit (reference addVote :216-232) ----

    def _decide_commit(
        self, vs: TxVoteSet
    ) -> tuple[TxVoteSet, list[TxVote], bytes | None]:
        """Locked half of an inline commit: drop the in-flight set, mark the
        hash committed, and capture the tx bytes (or register the deferred
        apply) atomically with the mark."""
        quorum_votes = vs.get_votes()
        self.vote_sets.pop(vs.tx_hash, None)
        self._committed.push(_hash_key(vs.tx_hash))
        tx = self.mempool.get_tx(vs.tx_key)
        if tx is None:
            self._unapplied[vs.tx_hash] = vs.tx_key
        return vs, quorum_votes, tx

    def _commit_tx(self, vs: TxVoteSet, purge_batch: list | None = None) -> None:
        """Inline commit (scalar golden path)."""
        quorum_votes = vs.get_votes()
        self.vote_sets.pop(vs.tx_hash, None)
        self._committed.push(_hash_key(vs.tx_hash))
        self._commit_effects(vs, quorum_votes, purge_batch)
        if purge_batch is None:
            self.tx_vote_pool.update(self.height, quorum_votes)

    def _enqueue_commit(self, vs: TxVoteSet) -> None:
        """Route-side half of a committer commit
        (``txflow_tpu/engine/txflow.py:1736``): the bookkeeping now, under
        _mtx, the effects on the committer thread in decision order. The tx
        bytes are captured here, and a missing tx is registered unapplied
        the same instant the hash is marked committed."""
        self.vote_sets.pop(vs.tx_hash, None)
        self._committed.push(_hash_key(vs.tx_hash))
        self._decided_count += 1
        tx = self.mempool.get_tx(vs.tx_key)
        if tx is None:
            self._unapplied[vs.tx_hash] = vs.tx_key
        self._commit_q.put((vs, vs.votes_snapshot(), tx))

    def _committer_run(self) -> None:
        """The committer thread (``txflow_tpu/engine/txflow.py:1815``):
        each wake drains the queue's backlog (up to 1024 commits) into one
        ``_commit_batch``; pool purges gather until the queue runs dry.
        ``None`` (queued by stop() after the last decided commit) ends it
        once what came before is committed."""
        purge: list[TxVote] = []
        interval = max(1, int(self.config.commit_interval))

        def flush() -> None:
            if purge:
                self.tx_vote_pool.update(self.height, purge)
                purge.clear()

        stop = False
        while not stop:
            try:
                item = self._commit_q.get(timeout=0.05)
            except _queue.Empty:
                flush()
                self._apply_unapplied()
                continue
            if item is None:
                break
            batch = [item]
            while len(batch) < 1024:
                try:
                    nxt = self._commit_q.get_nowait()
                except _queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            self._commit_batch(batch, purge, interval)
            if stop or len(purge) >= 8192 or self._commit_q.empty():
                flush()
                self._apply_unapplied()
        flush()

    def _commit_batch(self, items: list, purge: list[TxVote], interval: int = 1) -> None:
        """Effects of one wake's decided commits
        (``txflow_tpu/engine/txflow.py:1861``): the certificate rows in one
        store write, then each tx's apply in decision order, the app Commit
        fenced after every ``interval`` txs (1: ``apply_tx`` per tx, the
        reference's path; more: ``apply_tx_batch``), then the commitpool.
        A tx whose bytes had not arrived stays unapplied until they do."""
        self.tx_store.save_txs_batch(items)
        apply_items: list[tuple] = []
        deferred = retired = 0
        for vs, votes, tx in items:
            purge.extend(votes)
            if tx is None:
                with self._mtx:
                    if vs.tx_hash not in self._unapplied:
                        retired += 1  # another path applied it, and counted it
                        continue
                    tx = self.mempool.get_tx(vs.tx_key)
                    if tx is None:
                        deferred += 1  # still waiting for the bytes
                        continue
                    del self._unapplied[vs.tx_hash]
                self.tx_store.save_tx_bytes(vs.tx_hash, tx)
            apply_items.append((vs, tx))
        for base in range(0, len(apply_items), interval):
            group = apply_items[base : base + interval]
            if len(group) == 1:
                vs, tx = group[0]
                app_hash, _ = self.tx_executor.apply_tx(
                    self.height, tx, vs.tx_key.hex().upper(), tx_key=vs.tx_key
                )
            else:
                app_hash, _ = self.tx_executor.apply_tx_batch(
                    self.height, [(tx, vs.tx_key.hex().upper()) for vs, tx in group],
                    keys=[vs.tx_key for vs, _ in group],
                )
            self.app_hash = app_hash
        if apply_items:
            self.commitpool.push_committed_many(
                [tx for _, tx in apply_items], [vs.tx_key for vs, _ in apply_items]
            )
        with self._mtx:
            self._applied_count += len(items) - deferred - retired

    def _commit_effects(
        self,
        vs: TxVoteSet,
        quorum_votes: list[TxVote],
        purge_batch: list | None,
        tx: bytes | None = None,
        deferred: bool = False,
    ) -> None:
        """Store + execute + commitpool effects (reference addVote :216-232
        sequence). deferred=True: the tx bytes were absent at decision time
        and an _unapplied entry was registered; apply only if the bytes
        have arrived since, and never twice."""
        had_tx = tx is not None
        self.tx_store.save_tx(vs, votes=quorum_votes, tx=tx)
        if tx is None:
            with self._mtx:
                if not deferred or vs.tx_hash in self._unapplied:
                    tx = self.mempool.get_tx(vs.tx_key)
                    if tx is None:
                        self._unapplied[vs.tx_hash] = vs.tx_key
                    elif deferred:
                        del self._unapplied[vs.tx_hash]
        if tx is not None and not had_tx:
            self.tx_store.save_tx_bytes(vs.tx_hash, tx)
        if tx is not None:
            # the mempool keys by sha256, so tx_key IS sha256(tx): the hash
            # handed to the app and events describes the tx actually applied
            app_hash, _ = self.tx_executor.apply_tx(
                self.height, tx, vs.tx_key.hex().upper(), tx_key=vs.tx_key
            )
            self.app_hash = app_hash
            try:
                self.commitpool.check_tx(tx, key=vs.tx_key)
            except Exception:
                pass  # commitpool dup (e.g. replays) is harmless
        if purge_batch is not None:
            purge_batch.extend(quorum_votes)

    # ---- catch-up sync commit seam ----

    def apply_synced_commit(
        self, vs: TxVoteSet, votes: list[TxVote], tx: bytes
    ) -> bool:
        """Commit a certificate fetched and already verified by the
        catch-up client (sync/manager.py), through the live commit seam:
        the committed mark is pushed under _mtx as for a fast-path
        decision, so a racing local quorum never double-applies; the
        TxStore save assigns the next local seq, so the commit-order log
        extends in the server's order; store, then apply.

        The caller must have verified the certificate and that sha256(tx)
        is the certified hash: the sign bytes zero TxKey, so a vote's own
        tx_key field is never trusted here. Returns False when the tx is
        already committed locally."""
        tx_key = hashlib.sha256(tx).digest()
        tx_hash = tx_key.hex().upper()
        with self._mtx:
            if _hash_key(tx_hash) in self._committed or self.tx_store.has_tx(tx_hash):
                return False
            live = self.vote_sets.pop(tx_hash, None)
            self._committed.push(_hash_key(tx_hash))
            self._decided_count += 1
        if live is not None:
            # a below-quorum local aggregation was racing the sync apply:
            # release its pool votes
            self.tx_vote_pool.update(self.height, live.votes_snapshot())
        self.tx_store.save_tx(vs, votes=votes, tx=tx)
        app_hash, _ = self.tx_executor.apply_tx(self.height, tx, tx_hash, tx_key=tx_key)
        self.app_hash = app_hash
        try:
            self.commitpool.check_tx(tx, key=tx_key)
        except Exception:
            pass  # commitpool dup (e.g. replays) is harmless
        with self._mtx:
            self._applied_count += 1
        return True

    def commits_drained(self) -> bool:
        """True when every decided commit has been applied: the committer's
        queue is empty, its wake finished, and no tx waits for its bytes
        (``txflow_tpu/engine/txflow.py:2007``; the port's executor publishes
        its events inline, so none are queued)."""
        with self._mtx:
            return self._applied_count >= self._decided_count and not self._unapplied

    def register_unapplied(self, pairs: list[tuple[str, bytes]]) -> None:
        """Adopt decided-but-unapplied txs (tx_hash, tx_key), as after a
        restart: each owes its apply, delivered by the same rules as a
        quorum that beat its tx bytes (``txflow_tpu/engine/txflow.py:2021``)."""
        with self._mtx:
            for tx_hash, tx_key in pairs:
                if tx_hash not in self._unapplied:
                    self._decided_count += 1  # balanced by its eventual apply
                self._unapplied[tx_hash] = tx_key

    def _apply_unapplied(self) -> None:
        """Late delivery: apply decided txs whose bytes have since reached
        the mempool (``txflow_tpu/engine/txflow.py:2038``)."""
        with self._mtx:
            if not self._unapplied:
                return
            pending = list(self._unapplied.items())
        for tx_hash, tx_key in pending:
            tx = self.mempool.get_tx(tx_key)
            if tx is None:
                continue
            with self._mtx:
                if tx_hash not in self._unapplied:
                    continue  # applied by another path meanwhile
                del self._unapplied[tx_hash]
            self.tx_store.save_tx_bytes(tx_hash, tx)
            app_hash, _ = self.tx_executor.apply_tx(
                self.height, tx, tx_key.hex().upper(), tx_key=tx_key
            )
            self.app_hash = app_hash
            self.commitpool.push_committed_many([tx], [tx_key])
            with self._mtx:
                self._applied_count += 1

    # ---- block boundary: epoch rotation ----

    def update_state(self, height: int, val_set: ValidatorSet) -> None:
        """New height, possibly with a rotated validator set (or a new
        epoch's committee). All under _mtx, so no step sees a half-rotated
        engine:

        1. the verifier restages in place (new tables on the card, same
           shapes, its field kept, the tally's width chosen for the new
           set's total power); a device verifier past its capacity is
           rebuilt on the same device or mesh, over the same field,
           instead. Only a total power of 2^62 or more raises.
        2. every in-flight TxVoteSet is re-evaluated against the new set
           (TxVoteSet.revalidate): votes of removed validators dropped,
           sums re-weighted, latched certificates untouched, and a set
           that now clears the quorum commits at once.
        3. the address->index map swaps with the verifier.
        """
        with self._mtx:
            # content, not identity: an unchanged set is not restaged
            if val_set is self.val_set or val_set.hash() == self.val_set.hash():
                self.height = height
                return
            base = self.verifier
            restaged = base.restage(val_set)
            # only a device verifier past its capacity declines; its
            # successor (on the same device or mesh) is built before any
            # engine state swaps (the height included), so a failure
            # leaves the old epoch's height, map, set and verifier together
            if restaged:
                verifier = base
            else:
                if base.mesh is not None:
                    verifier = DeviceVoteVerifier(val_set, mesh=base.mesh, fe_radix=base.fe_radix,
                                                  staging_ring=base.staging_depth,
                                                  buckets=base.buckets)
                else:
                    verifier = DeviceVoteVerifier(val_set, device=base.device,
                                                  fe_radix=base.fe_radix,
                                                  staging_ring=base.staging_depth,
                                                  buckets=base.buckets)
                # the host-prep pool serves the successor
                verifier._host_pool, base._host_pool = base._host_pool, None
            self.height = height
            self.val_set = val_set
            self._addr_to_idx = {v.address: i for i, v in enumerate(val_set)}
            self.verifier = verifier
            dropped = 0
            newly_quorate = []
            for vs in list(self.vote_sets.values()):
                d, quorate = vs.revalidate(val_set)
                dropped += d
                if quorate:
                    newly_quorate.append(vs)
            for vs in newly_quorate:
                # a shrinking total power can push a pending tx over 2/3
                # with no new vote: commit it now, on the inline path
                self._commit_tx(vs)
            self.last_rotation = {
                "height": height,
                "restaged": restaged,
                "votes_dropped": dropped,
                "commits_on_rotation": len(newly_quorate),
                "val_set_hash": val_set.hash().hex(),
            }

    # ---- queries ----

    def _verifier_shards(self) -> int:
        """Mesh shard count of the verifier; 1 for a single device or the
        host verifier."""
        return max(1, int(getattr(self.verifier, "_n_shards", 1)))

    def _verifier_buckets(self):
        """The verifier's bucket ladder (``DeviceVoteVerifier.buckets``; a
        test may attach one to a scalar verifier), or None."""
        return getattr(self.verifier, "buckets", None) or None

    def is_tx_committed(self, tx_hash: str) -> bool:
        with self._mtx:
            return _hash_key(tx_hash) in self._committed or self.tx_store.has_tx(
                tx_hash
            )

    def load_commit(self, tx_hash: str):
        return self.tx_store.load_tx_commit(tx_hash)


def _hash_key(tx_hash: str) -> bytes:
    return tx_hash.encode()
