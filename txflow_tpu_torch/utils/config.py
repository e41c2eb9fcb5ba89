"""Configuration: the mempool caps and the fast-path engine's knobs.

Defaults mirror tendermint v0.31.2's mempool (txvotepool/txvotepool.go:
198-208 reads config.Mempool) and the JAX package's EngineConfig.
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
