"""Sharded host-prep pools: the seam that parallelizes a batch's host prep
(counterpart of ``txflow_tpu/engine/hostprep.py``: ``HostPrepPool`` :120,
``ProcHostPrepPool`` :292 with ``prepare_compact_shm`` :408 and
``sign_bytes_shm`` :447, ``make_host_pool`` :667).

Two backends behind ``make_host_pool``:

- **thread** (``HostPrepPool``): worker threads over contiguous shards of
  a batch (``map_shards``). The caller is a worker: it runs the last
  shard itself and, while waiting, takes queued shards off the queue.
  The port's prep is numpy and Python, so threads overlap only what
  releases the interpreter lock.
- **process** (``ProcHostPrepPool``): worker processes past the lock. Its
  two typed tasks, the compact ed25519 prep and the canonical sign bytes,
  go through ``multiprocessing.shared_memory``: the inputs packed once
  into one segment, the outputs written shard by shard into a second (the
  worker half is ``prep.py``). Generic closures cannot cross a process
  boundary, so this backend has no ``map_shards``.

Shards are contiguous and every backend runs the same row functions, so
the assembled batch is byte-identical to a serial prep.

Deliberate differences from the JAX package (``ROADMAP.md`` Queue 3):
a failed spawn raises ``HostPoolSpawnError`` (the JAX ``make_host_pool``
swallows it and hands back a thread pool), and a worker that dies or
fails a shard raises ``HostPoolWorkerError`` at the caller (the JAX pool
recomputes the shard inline and routes later batches to threads). No
path moves work to threads or to the caller on its own.

Start method: ``forkserver`` where the platform has it, else ``spawn``;
never ``fork``. The engine's process holds a CUDA context and PyTorch's
threads, and a child forked from it is a deadlock or a broken context
(the JAX reasoning: ``txflow_tpu/engine/hostprep.py:275``). No segment
outlives the call that made it; ``close()`` joins the workers and
unlinks any segment a failed call left.
"""

from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as np

from .. import prep


class HostPoolSpawnError(RuntimeError):
    """The worker processes could not be started, or never acked ready."""


class HostPoolWorkerError(RuntimeError):
    """A worker process died, timed out or failed a shard."""


class _Job:
    """One queued shard: ``fn(lo, hi)`` and its completion latch."""

    __slots__ = ("fn", "lo", "hi", "done", "result", "error")

    def __init__(self, fn, lo: int, hi: int):
        self.fn = fn
        self.lo = lo
        self.hi = hi
        self.done = threading.Event()
        self.result = None
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            self.result = self.fn(self.lo, self.hi)
        except BaseException as exc:  # re-raised on the caller by map_shards
            self.error = exc
        finally:
            self.done.set()


def shard_bounds(n: int, workers: int) -> list[tuple[int, int]]:
    """Contiguous ``[lo, hi)`` spans covering ``[0, n)``, one per worker;
    early spans take the remainder, empty spans are dropped."""
    w = min(workers, max(1, n))
    base, extra = divmod(n, w)
    bounds = []
    lo = 0
    for i in range(w):
        hi = lo + base + (1 if i < extra else 0)
        if hi > lo:
            bounds.append((lo, hi))
        lo = hi
    return bounds


class HostPrepPool:
    """Thread pool of ``workers`` (the calling thread counted: a pool of 4
    starts 3 threads) for contiguous-shard batch prep."""

    backend = "thread"

    def __init__(self, workers: int, name: str = "hostprep"):
        self.workers = max(1, int(workers))
        self._q: _queue.SimpleQueue = _queue.SimpleQueue()
        self._closed = False
        self._stats_mtx = threading.Lock()
        self.jobs_total = 0
        self.steals_total = 0
        self.pool_wait_s = 0.0
        self._threads = [
            threading.Thread(target=self._worker, name=f"{name}-{i}", daemon=True)
            for i in range(self.workers - 1)
        ]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            job.run()

    def _steal_one(self) -> bool:
        """Run one queued job on the calling thread, if one waits."""
        try:
            job = self._q.get_nowait()
        except _queue.Empty:
            return False
        if job is None:
            self._q.put(None)  # the stop sentinel belongs to a worker
            return False
        job.run()
        return True

    def shard_bounds(self, n: int) -> list[tuple[int, int]]:
        return shard_bounds(n, self.workers)

    def map_shards(self, n: int, fn) -> tuple[list, float]:
        """``fn(lo, hi)`` over contiguous shards of ``[0, n)``. Returns the
        per-shard results in shard order and the seconds this caller spent
        blocked on shards it did not run. A shard's exception re-raises
        here."""
        if self._closed:
            raise RuntimeError("host-prep pool is closed")
        bounds = self.shard_bounds(n)
        if len(bounds) <= 1:
            lo, hi = bounds[0] if bounds else (0, 0)
            return [fn(lo, hi)], 0.0
        jobs = [_Job(fn, lo, hi) for lo, hi in bounds[:-1]]
        for job in jobs:
            self._q.put(job)
        inline = _Job(fn, *bounds[-1])
        inline.run()
        wait_s = 0.0
        steals = 0
        for job in jobs:
            while not job.done.is_set() and self._steal_one():
                steals += 1
            if not job.done.is_set():
                t0 = time.perf_counter()
                job.done.wait()
                wait_s += time.perf_counter() - t0
        results = []
        for job in jobs + [inline]:
            if job.error is not None:
                raise job.error
            results.append(job.result)
        with self._stats_mtx:
            self.jobs_total += len(bounds)
            self.steals_total += steals
            self.pool_wait_s += wait_s
        return results, wait_s

    def stats(self) -> dict:
        with self._stats_mtx:
            return {"backend": self.backend, "workers": self.workers,
                    "jobs_total": self.jobs_total, "steals_total": self.steals_total,
                    "pool_wait_s": self.pool_wait_s}

    def close(self, timeout: float = 5.0) -> None:
        """Stop the threads after the queued jobs (idempotent)."""
        if self._closed:
            return
        self._closed = True
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=timeout)


def default_mp_method() -> str:
    """``forkserver`` (children fork from a clean helper process, cheap
    once it runs), else ``spawn``; never ``fork``."""
    import multiprocessing as mp

    return "forkserver" if "forkserver" in mp.get_all_start_methods() else "spawn"


class ProcHostPrepPool:
    """Process-backed host-prep pool: ``workers`` counts the calling
    thread, so a pool of 8 starts 7 worker processes and the caller runs
    the last shard of every call itself. A failed or slow start raises
    ``HostPoolSpawnError``; a dead worker, a shard that fails or a shard
    that outlives ``shard_timeout`` raises ``HostPoolWorkerError``, and
    every later call then raises too."""

    backend = "process"

    def __init__(self, workers: int, name: str = "hostprep", mp_context: str | None = None,
                 spawn_timeout: float = 60.0, shard_timeout: float = 60.0):
        if int(workers) < 2:
            raise ValueError("a process host-prep pool needs at least 2 workers")
        import multiprocessing as mp

        self.workers = int(workers)
        self._shard_timeout = shard_timeout
        self._closed = False
        self._broken: str | None = None
        self._mtx = threading.Lock()  # stats, call sequence, live segments
        # several callers at once (co-located engines on one verifier):
        # one of them reads the ack queue at a time and files every ack by
        # its call, the others wait on the condition for theirs
        self._ack_cond = threading.Condition()
        self._acks: dict[tuple, tuple] = {}
        self._live_calls: set[int] = set()
        self._ack_reader = False
        self._call_seq = 0
        self._live_segs: dict[str, object] = {}
        self.shm_calls = 0
        self.shm_bytes_total = 0
        self.proc_jobs_total = 0
        self.proc_wait_s = 0.0
        self._procs: list = []
        self.mp_method = method = mp_context or default_mp_method()
        if method == "fork":
            raise ValueError("the fork start method is not used: the parent holds CUDA state")
        try:
            ctx = mp.get_context(method)
            self._task_q = ctx.SimpleQueue()
            self._done_q = ctx.Queue()
            for i in range(self.workers - 1):
                p = ctx.Process(target=prep.worker_main, args=(self._task_q, self._done_q),
                                name=f"{name}-proc-{i}", daemon=True)
                p.start()
                self._procs.append(p)
            deadline = time.perf_counter() + spawn_timeout
            ready = 0
            while ready < len(self._procs):
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise TimeoutError(f"{ready}/{len(self._procs)} workers ready")
                ack = self._done_q.get(timeout=left)
                if isinstance(ack, tuple) and ack[:1] == ("ready",):
                    ready += 1
        except Exception as exc:
            self._terminate()
            raise HostPoolSpawnError(
                f"process host-prep pool failed to start ({method}): {exc!r}"
            ) from exc

    @property
    def healthy(self) -> bool:
        return not self._closed and self._broken is None

    def shard_bounds(self, n: int) -> list[tuple[int, int]]:
        return shard_bounds(n, self.workers)

    # -- typed shared-memory tasks --

    def prepare_compact_shm(self, msgs, sigs, val_idx, epoch) -> tuple:
        """The compact prep (``prep.prep_rows_cat``) over the workers.
        Returns ``(s_nib, h_nib, vidx, r_y, r_sign, pre_ok, wait_s)``."""
        n = len(msgs)
        msg_cat, offs = prep.cat_msgs(msgs)
        sig_arr, sig_ok = prep.cat_sigs(sigs)
        ins = {"msg_cat": msg_cat, "offs": offs, "sig_arr": sig_arr, "sig_ok": sig_ok,
               "vi": np.asarray(val_idx, dtype=np.int64), "pub_arr": epoch.pub_arr,
               "key_ok": epoch.key_ok}
        outs = {"s_nib": ((n, 64), np.uint8), "h_nib": ((n, 64), np.uint8),
                "vidx": ((n,), np.int32), "r_y": ((n, 32), np.uint8),
                "r_sign": ((n,), np.uint8), "pre_ok": ((n,), bool)}
        o, wait_s = self._run_typed("compact", ins, None, outs, n)
        return o["s_nib"], o["h_nib"], o["vidx"], o["r_y"], o["r_sign"], o["pre_ok"], wait_s

    def sign_bytes_shm(self, heights, tx_hashes, ts_ns, chain_id: str) -> tuple[list, float]:
        """Canonical sign bytes over the workers: ``(list of bytes,
        wait_s)``. A row the fixed-stride segment cannot carry -- a hash
        over 1024 bytes, a height or timestamp outside int64 -- is encoded
        by the caller with the same encoder, so a hostile row cannot size
        the segment."""
        n = len(heights)
        hb = [h.encode() for h in tx_hashes]
        lo64, hi64 = -(2**63), 2**63 - 1
        own = [i for i in range(n) if len(hb[i]) > 1024
               or not (lo64 <= heights[i] <= hi64 and lo64 <= ts_ns[i] <= hi64)]
        if own:
            skip = set(own)
            idx = [i for i in range(n) if i not in skip]
        else:
            idx = range(n)
        m = len(idx)
        out: list = [None] * n
        wait_s = 0.0
        if m:
            hs = np.fromiter((heights[i] for i in idx), np.int64, m)
            ts = np.fromiter((ts_ns[i] for i in idx), np.int64, m)
            sub = [hb[i] for i in idx]
            hash_offs = np.zeros(m + 1, np.int64)
            np.cumsum(np.fromiter((len(b) for b in sub), np.int64, m), out=hash_offs[1:])
            stride = prep.sign_bytes_stride(int(np.diff(hash_offs).max()), chain_id)
            ins = {"heights": hs, "ts_ns": ts,
                   "hash_cat": np.frombuffer(b"".join(sub), np.uint8), "hash_offs": hash_offs}
            o, wait_s = self._run_typed("signbytes", ins, {"chain_id": chain_id},
                                        {"rows": ((m, stride), np.uint8),
                                         "lens": ((m,), np.int32)}, m)
            rows, lens = o["rows"], o["lens"].tolist()
            for j, i in enumerate(idx):
                out[i] = rows[j, : lens[j]].tobytes()
        for i in own:
            out[i] = prep.canonical_sign_bytes(chain_id, heights[i], tx_hashes[i], ts_ns[i])
        return out, wait_s

    # -- machinery --

    def _run_typed(self, task: str, ins: dict, extra, outs_spec: dict, n: int):
        """One typed task over contiguous shards: the caller packs the
        inputs, queues every shard but the last, runs the last itself and
        waits for the acks; the outputs are copied out before both
        segments are unlinked. Returns (outputs by name, wait_s)."""
        from multiprocessing import shared_memory

        self._check_workers()
        if not self.healthy:
            raise HostPoolWorkerError(
                "host-prep pool is closed" if self._closed else self._broken)
        if n <= 0:
            return {k: np.zeros(shape, dt) for k, (shape, dt) in outs_spec.items()}, 0.0
        in_layout, in_bytes = prep.pack_layout(ins)
        out_layout, out_bytes = prep.pack_layout(
            {k: np.zeros(shape, dt) for k, (shape, dt) in outs_spec.items()})
        seg_in = shared_memory.SharedMemory(create=True, size=in_bytes)
        try:
            seg_out = shared_memory.SharedMemory(create=True, size=out_bytes)
        except BaseException:
            self._release(seg_in)
            raise
        with self._mtx:
            self._live_segs[seg_in.name] = seg_in
            self._live_segs[seg_out.name] = seg_out
            self._call_seq += 1
            call = self._call_seq
        with self._ack_cond:
            self._live_calls.add(call)
        in_views = out_views = None
        wait_s = 0.0
        bounds = self.shard_bounds(n)
        try:
            prep.write_arrays(seg_in.buf, in_layout, ins)
            pending = set()
            for k, (lo, hi) in enumerate(bounds[:-1]):
                pending.add((call, k))
                self._task_q.put((task, (call, k), seg_in.name, in_layout, seg_out.name,
                                  out_layout, lo, hi, extra))
            in_views = {**prep.views(seg_in.buf, in_layout), **(extra or {})}
            out_views = prep.views(seg_out.buf, out_layout)
            prep.run_task(task, in_views, out_views, *bounds[-1])
            t0 = time.perf_counter()
            try:
                self._await(pending, t0 + self._shard_timeout)
            finally:
                wait_s = time.perf_counter() - t0
            out = {k: np.array(v) for k, v in out_views.items()}
        finally:
            in_views = out_views = None
            with self._ack_cond:
                self._live_calls.discard(call)
                for sid in [s for s in self._acks if s[0] == call]:
                    del self._acks[sid]
            with self._mtx:
                self._live_segs.pop(seg_in.name, None)
                self._live_segs.pop(seg_out.name, None)
            self._release(seg_in)
            self._release(seg_out)
        with self._mtx:
            self.shm_calls += 1
            self.shm_bytes_total += in_bytes + out_bytes
            self.proc_jobs_total += len(bounds)
            self.proc_wait_s += wait_s
        return out, wait_s

    def _await(self, pending: set, deadline: float) -> None:
        """Wait for every shard of ``pending`` to ack; raise on a failed
        shard, a dead worker or the deadline (the last two break the
        pool). With several callers, one reads the ack queue at a time
        and files each ack under its call; acks of a call no longer live
        (an earlier, failed one) are dropped."""
        cond = self._ack_cond
        while True:
            with cond:
                for sid in [s for s in pending if s in self._acks]:
                    pending.discard(sid)
                    _sid, err, _busy = self._acks.pop(sid)
                    if err is not None:
                        raise HostPoolWorkerError(f"host-prep shard {sid} failed: {err}")
                if not pending:
                    return
                reader = not self._ack_reader
                if reader:
                    self._ack_reader = True
                else:
                    cond.wait(0.05)
            ack = None
            if reader:
                try:
                    ack = self._done_q.get(timeout=0.05)
                except _queue.Empty:
                    pass
                finally:
                    with cond:
                        self._ack_reader = False
                        if ack is not None and ack[0][0] in self._live_calls:
                            self._acks[ack[0]] = ack
                        cond.notify_all()
            if ack is None:
                self._check_workers()
                if self._broken is not None:
                    raise HostPoolWorkerError(self._broken) from None
                if time.perf_counter() > deadline:
                    self._broken = f"host-prep shards timed out: {len(pending)} pending"
                    raise HostPoolWorkerError(self._broken) from None

    def _check_workers(self) -> None:
        """Mark the pool broken once any worker has exited."""
        dead = [p.name for p in self._procs if p.exitcode is not None]
        if dead and not self._closed and self._broken is None:
            self._broken = f"host-prep worker died: {dead}"

    @staticmethod
    def _release(seg) -> None:
        try:
            seg.close()
        except BufferError:
            pass  # a view survived; unlinking still reclaims the segment
        try:
            seg.unlink()
        except FileNotFoundError:
            pass

    def _terminate(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5.0)

    def stats(self) -> dict:
        with self._mtx:
            return {"backend": self.backend, "workers": self.workers,
                    "mp_method": self.mp_method, "processes": len(self._procs),
                    "healthy": self.healthy, "shm_calls": self.shm_calls,
                    "shm_bytes_total": self.shm_bytes_total,
                    "proc_jobs_total": self.proc_jobs_total, "proc_wait_s": self.proc_wait_s,
                    "live_segments": len(self._live_segs)}

    def alive_workers(self) -> int:
        return sum(p.is_alive() for p in self._procs)

    def close(self, timeout: float = 5.0) -> None:
        """Stop and join the workers, terminating any that do not stop in
        ``timeout``, and unlink every segment still tracked (idempotent)."""
        if self._closed:
            return
        self._closed = True
        for p in self._procs:
            if p.is_alive():
                self._task_q.put(None)
        # a dead worker may hold the task queue's lock: terminate at once
        deadline = time.perf_counter() + (timeout if self._broken is None else 0.0)
        for p in self._procs:
            while p.is_alive() and time.perf_counter() < deadline:
                # a worker cannot exit while its acks fill the pipe: drain
                try:
                    self._done_q.get(timeout=0.01)
                except _queue.Empty:
                    pass
                p.join(timeout=0.01)
        self._terminate()
        self._done_q.close()
        self._done_q.join_thread()
        self._task_q.close()
        with self._mtx:
            segs = list(self._live_segs.values())
            self._live_segs.clear()
        for seg in segs:
            self._release(seg)


def make_host_pool(workers: int, backend: str = "thread", name: str = "hostprep"):
    """The pool of ``backend`` ("thread" or "process") over ``workers``
    (the calling thread counted). A process pool that cannot start raises;
    nothing hands back another backend in its place."""
    if backend == "process":
        return ProcHostPrepPool(workers, name=name)
    if backend == "thread":
        return HostPrepPool(workers, name=name)
    raise ValueError(f"unknown host-prep backend {backend!r}")
