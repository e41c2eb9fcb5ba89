"""Configuration: the mempool caps and the fast-path engine's knobs.

Defaults mirror tendermint v0.31.2's mempool (txvotepool/txvotepool.go:
198-208 reads config.Mempool) and the JAX package's EngineConfig
(``txflow_tpu/utils/config.py:90-236``: the fields the threaded engine's
loop, lanes, coalescer, committer and host-prep pool read, with the JAX
defaults).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MempoolConfig:
    size: int = 5000
    max_txs_bytes: int = 1024 * 1024 * 1024  # 1GB
    cache_size: int = 10000
    max_msg_bytes: int = 1024 * 1024  # max gossip msg (consensus/reactor.go:28)


@dataclass
class EngineConfig:
    """Fast-path aggregation engine (no reference analog; device batching).

    The reference processes votes one at a time (txflow/service.go:123-166);
    one engine step drains up to ``max_batch`` votes over at most
    ``max_slots`` distinct txs and verifies and tallies them in one device
    call.
    """

    max_batch: int = 16384  # votes per device step
    max_slots: int = 4096  # concurrent in-flight txs per step
    use_device: bool = True  # False = scalar golden verifier (debug)
    # where the device verifier runs: "cuda" unless the caller asks for
    # "cpu" (the plain PyTorch kernels); without CUDA, "cuda" raises
    device: str = "cuda"
    # vote-axis sharding (parallel/mesh.py): split each padded batch over
    # the first N cards (N CPU entries with device="cpu"), one process
    # driving them all. 0 or 1 = one device. Fewer visible cards than N
    # raises: the engine never runs on fewer cards than asked for.
    mesh_devices: int = 0
    # the field the verify kernels run over (ops/field.py): 25 = radix
    # 2^25.5, 13 = radix 2^13 (K8); None reads TXFLOW_FE_RADIX when the
    # engine builds its verifier. Rotations keep the verifier's field.
    fe_radix: int | None = None
    # threaded engine (start()/stop()): seconds the loop waits on an empty
    # pool before it looks again
    poll_interval: float = 0.002
    # batch forming: hold a step up to batch_wait while fewer than
    # min_batch votes are pending; with votes pending and none arriving
    # for idle_flush seconds, go with what there is (0 disables)
    min_batch: int = 256
    batch_wait: float = 0.004
    idle_flush: float = 0.002
    # wait after a step whose every vote was deferred to a later step
    # (in the JAX package, to another engine's verdict cache; the port's
    # first-occurrence rule always keeps one vote, so it waits only once
    # such a cache is ported)
    defer_backoff: float = 0.005
    # verify calls in flight (submit/collect split, collected and routed
    # in submission order); <= 1 runs the serial loop
    pipeline_depth: int = 2
    # adaptive pipeline depth (engine/adaptive.py): grow or shrink the
    # tickets in flight between pipeline_depth_min and pipeline_depth_max
    # from the live overlap of device-busy and loop-active seconds;
    # pipeline_depth stays the starting point. Off by default: the
    # controller needs windows of steps to say anything
    adaptive_depth: bool = False
    pipeline_depth_min: int = 2
    pipeline_depth_max: int = 8
    # shape-stable coalescing (engine/txflow.py _BatchCoalescer): with a
    # verifier that has a bucket ladder, dispatch only full-bucket batches
    # and hold a partial one until coalesce_linger after its first vote
    # (or the pool goes idle), then flush what coalesced, padded to its
    # bucket. A verifier without buckets keeps min_batch/batch_wait
    coalesce: bool = True
    coalesce_linger: float = 0.004
    # let the bulk coalescer target ladder rungs above max_batch (the
    # verifier's ladder runs to 65536); off by default: the classic cap
    wide_buckets: bool = False
    # deadline-aware lanes: drain the pool's priority log in small
    # short-linger batches ahead of the bulk backlog (a second coalescer,
    # min_batch 1), the bulk lane keeping coalesce_linger. With no lane
    # hook on the pool the priority log stays empty and the lane costs
    # one decide(0) a fill pass
    lane_split: bool = True
    # how long a partial priority batch may coalesce before it flushes
    priority_linger: float = 0.001
    # the largest priority dispatch: ladder rungs at or under this
    # (rounded up to the mesh's shard multiple) are the lane's targets;
    # with no ladder the lane dispatches at this cap
    priority_bucket_cap: int = 512
    # speculative commit: at collect, route first the votes whose slot's
    # device maj23 bit is set, so their commits leave for the committer
    # before the rest of the batch routes. The host TxVoteSet still decides
    # every quorum: certificates are unchanged, only the commit order
    # across txs of one batch may differ. Off by default
    speculative_commit: bool = False
    # commit effects (TxStore, ABCI apply, pool purge) on a committer
    # thread; False commits inline inside routing
    pipeline_commits: bool = True
    # the committer fences the app Commit once per this many txs (1 =
    # per tx, as the reference); each tx keeps its own DeliverTx,
    # certificate and event
    commit_interval: int = 1
    # host-prep pool (engine/hostprep.py): workers, the calling thread
    # included (0 or 1 = prep on the engine thread), and the backend,
    # "thread" or "process" (worker processes over shared memory; a
    # failed spawn raises)
    host_prep_workers: int = 0
    host_prep_backend: str = "thread"
    # readback ring depth of the device verifier (parallel/staging.py): a
    # side CUDA stream copies each step's packed result into pinned host
    # memory; <= 1 reads back on the caller at collect
    staging_ring: int = 2
