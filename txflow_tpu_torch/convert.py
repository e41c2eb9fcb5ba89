"""Carry the JAX package's per-epoch device state into the port's layout.

The JAX package keeps field elements as 32 radix-2^8 int32 limbs by
default; the port keeps ten radix-2^25.5 limbs (``ops/fe.py``) or, for
``fe_radix=13``, twenty radix-2^13 limbs (``ops/fe13.py``). These
converters take the JAX package's numpy arrays -- the ``[V, 16, 4, 32]``
window tables of -A (``EpochTables.tables``), ``curve.BASE_TABLE``, the
int32 powers, and the per-vote gathered tables of a ``PreparedBatch`` --
and return the port's own arrays in the field asked for, through each
canonical value, so a test can feed both packages one epoch or one
batch; the quarter tables the port's verify kernel reads beside the
epoch tables are derived from the JAX tables' entry 1 (-A). The port's radix-2^13 layout is the JAX package's ``fe13`` layout:
its canonical ``[..., 20]`` limbs carry over unchanged.
"""

from __future__ import annotations

import numpy as np

from .crypto import ed25519 as host_ed
from .ops import curve, ed25519_batch, field


def limbs8_to_limbs(x: np.ndarray, fe_radix: int = 25) -> np.ndarray:
    """[..., 32] radix-2^8 limbs with every limb in [0, 256) (the JAX
    package's canonical form) -> [..., NLIMB] int32 limbs of the port's
    ``fe_radix`` field."""
    x = np.asarray(x)
    if x.shape[-1] != 32:
        raise ValueError(f"expected [..., 32] limbs, got {x.shape}")
    if x.size and (x.min() < 0 or x.max() > 255):
        raise ValueError("radix-2^8 limbs must be canonical (each in [0, 256))")
    if x.size and (x[..., 31] > 127).any():
        raise ValueError("value does not fit 255 bits")
    return field.ops(fe_radix).bytes_to_limbs_np(x.astype(np.uint8))


def base_table_from_jax(table: np.ndarray, fe_radix: int = 25) -> np.ndarray:
    """JAX ``curve.BASE_TABLE`` [16, 4, 32] -> port layout [16, 4, NLIMB]."""
    return limbs8_to_limbs(table, fe_radix)


def _limbs8_to_int(x: np.ndarray) -> int:
    return int.from_bytes(np.asarray(x, np.uint8).tobytes(), "little")


def quarter_tables_from_jax(tables: np.ndarray, fe_radix: int = 25) -> np.ndarray:
    """The port's quarter tables (int32 [V, 3, 16, 4, NLIMB], quarters
    1-3 of ``EpochTables.quarter_tables``) from JAX epoch tables
    [V, 16, 4, 32]: entry 1 of each is -A in affine PNiels (Y+X, Y-X, 1,
    2dXY), so y = (YpX + YmX) / 2 and x = (YpX - YmX) / 2, and -A's
    quarters are built from that point (an off-curve key's identity table
    gives the identity's)."""
    P = host_ed.P
    half = (P + 1) // 2
    points = []
    for t in np.asarray(tables):
        ypx, ymx = _limbs8_to_int(t[1, 0]), _limbs8_to_int(t[1, 1])
        x, y = (ypx - ymx) * half % P, (ypx + ymx) * half % P
        points.append((x, y, 1, x * y % P))
    nlimb = field.ops(fe_radix).NLIMB
    if not points:
        return np.zeros((0, curve.QUARTERS - 1, curve.TABLE_SIZE, 4, nlimb), np.int32)
    return np.ascontiguousarray(curve.build_quarter_tables(points, fe_radix)[:, 1:])


def epoch_from_jax(tables: np.ndarray, powers: np.ndarray,
                   fe_radix: int = 25) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """JAX epoch tables [V, 16, 4, 32] and powers [V] -> (int32
    [V, 16, 4, NLIMB] tables, int32 [V, 3, 16, 4, NLIMB] quarter tables,
    int32 [V] powers) in the port's layout: a complete port epoch for the
    four-lane verify kernel."""
    return (limbs8_to_limbs(tables, fe_radix), quarter_tables_from_jax(tables, fe_radix),
            np.asarray(powers, dtype=np.int32))


def prepared_batch_from_jax(batch, fe_radix: int = 25) -> ed25519_batch.PreparedBatch:
    """A JAX ``PreparedBatch`` (int32 nibbles, per-vote tables
    [B, 16, 4, 32], R as radix-2^8 limbs, i.e. its bytes) -> the port's
    ``PreparedBatch`` (uint8 nibbles and R bytes, tables [B, 16, 4, NLIMB])."""
    return ed25519_batch.PreparedBatch(
        np.asarray(batch.s_nibbles, dtype=np.uint8),
        np.asarray(batch.h_nibbles, dtype=np.uint8),
        limbs8_to_limbs(batch.a_tables, fe_radix),
        np.asarray(batch.r_y, dtype=np.uint8),
        np.asarray(batch.r_sign, dtype=np.uint8),
        np.asarray(batch.pre_ok, dtype=bool),
    )
