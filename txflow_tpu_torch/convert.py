"""Carry the JAX package's per-epoch device state into the port's layout.

The JAX package keeps field elements as 32 radix-2^8 int32 limbs; the port
keeps ten radix-2^25.5 limbs (``ops/fe.py``). These converters take the
JAX package's numpy arrays -- the ``[V, 16, 4, 32]`` window tables of -A
(``EpochTables.tables``), ``curve.BASE_TABLE``, the int32 powers, and the
per-vote gathered tables of a ``PreparedBatch`` -- and return the port's
own arrays, so a test can feed both packages one epoch or one batch.
"""

from __future__ import annotations

import numpy as np

from .ops import ed25519_batch, fe


def limbs8_to_limbs(x: np.ndarray) -> np.ndarray:
    """[..., 32] radix-2^8 limbs with every limb in [0, 256) (the JAX
    package's canonical form) -> [..., 10] int32 port limbs."""
    x = np.asarray(x)
    if x.shape[-1] != 32:
        raise ValueError(f"expected [..., 32] limbs, got {x.shape}")
    if x.size and (x.min() < 0 or x.max() > 255):
        raise ValueError("radix-2^8 limbs must be canonical (each in [0, 256))")
    if x.size and (x[..., 31] > 127).any():
        raise ValueError("value does not fit 255 bits")
    return fe.bytes_to_limbs_np(x.astype(np.uint8))


def base_table_from_jax(table: np.ndarray) -> np.ndarray:
    """JAX ``curve.BASE_TABLE`` [16, 4, 32] -> port layout [16, 4, 10]."""
    return limbs8_to_limbs(table)


def epoch_from_jax(tables: np.ndarray, powers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """JAX epoch tables [V, 16, 4, 32] and powers [V] -> (int32
    [V, 16, 4, 10] tables, int32 [V] powers) in the port's layout."""
    return limbs8_to_limbs(tables), np.asarray(powers, dtype=np.int32)


def prepared_batch_from_jax(batch) -> ed25519_batch.PreparedBatch:
    """A JAX ``PreparedBatch`` (int32 nibbles, per-vote tables
    [B, 16, 4, 32], R as radix-2^8 limbs, i.e. its bytes) -> the port's
    ``PreparedBatch`` (uint8 nibbles and R bytes, tables [B, 16, 4, 10])."""
    return ed25519_batch.PreparedBatch(
        np.asarray(batch.s_nibbles, dtype=np.uint8),
        np.asarray(batch.h_nibbles, dtype=np.uint8),
        limbs8_to_limbs(batch.a_tables),
        np.asarray(batch.r_y, dtype=np.uint8),
        np.asarray(batch.r_sign, dtype=np.uint8),
        np.asarray(batch.pre_ok, dtype=bool),
    )
