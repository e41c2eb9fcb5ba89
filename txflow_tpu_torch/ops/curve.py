"""edwards25519 point arithmetic: host table building, the plain PyTorch
version, and the wrapper of the CUDA double-scalar-multiply kernel (K2).

Counterpart of ``txflow_tpu/ops/curve.py``. Points are tuples of four
coordinates, each an int64 limb tensor ``[..., 10]`` (see ``ops/fe.py``):
Extended (X, Y, Z, T) and PNiels (Y+X, Y-X, Z, 2dT). The formulas and
their order are those of ``csrc/ge25519.cuh``. Table selection is an
indexed load on both sides (the TPU's one-hot matrix select has no
counterpart here).
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import ed25519 as host_ed
from . import _lib, fe

TABLE_WINDOW = 4
TABLE_SIZE = 1 << TABLE_WINDOW  # 16
NWINDOWS = 64  # 256 bits / 4

# field multiplies of one [s]B + [h]A' and encode: per window 3 doublings
# without T (7), one with T (8) and two PNiels additions (8 each); then the
# inversion chain and the two affine products
MULS_PER_WINDOW = 3 * 7 + 8 + 2 * 8
MULS_PER_DSM_ENCODE = NWINDOWS * MULS_PER_WINDOW + 265 + 2


def ext_identity(batch_shape, device=None):
    z = torch.zeros((*batch_shape, fe.NLIMB), dtype=torch.int64, device=device)
    one = z.clone()
    one[..., 0] = 1
    return (z, one, one.clone(), z.clone())


def ext_double(p, compute_t: bool = True):
    """Dedicated doubling (dbl-2008-hwcd); T only when ``compute_t``."""
    X1, Y1, Z1, T1 = p
    A = fe.fe_sq(X1)
    B = fe.fe_sq(Y1)
    C = fe.fe_mul_small(fe.fe_sq(Z1), 2)
    H = fe.fe_add(A, B)
    E = fe.fe_sub(H, fe.fe_sq(fe.fe_add(X1, Y1)))
    G = fe.fe_sub(A, B)
    F = fe.fe_add(C, G)
    X3 = fe.fe_mul(E, F)
    Y3 = fe.fe_mul(G, H)
    Z3 = fe.fe_mul(F, G)
    T3 = fe.fe_mul(E, H) if compute_t else T1
    return (X3, Y3, Z3, T3)


def pniels_add(p, n):
    """Extended + PNiels -> Extended (madd-2008-hwcd-3, general Z2)."""
    X1, Y1, Z1, T1 = p
    YpX2, YmX2, Z2, T2d2 = n
    A = fe.fe_mul(fe.fe_sub(Y1, X1), YmX2)
    B = fe.fe_mul(fe.fe_add(Y1, X1), YpX2)
    C = fe.fe_mul(T1, T2d2)
    D = fe.fe_mul_small(fe.fe_mul(Z1, Z2), 2)
    E = fe.fe_sub(B, A)
    F = fe.fe_sub(D, C)
    G = fe.fe_add(D, C)
    H = fe.fe_add(B, A)
    return (fe.fe_mul(E, F), fe.fe_mul(G, H), fe.fe_mul(F, G), fe.fe_mul(E, H))


def _entry(rows: torch.Tensor):
    """[..., 4, 10] table rows -> PNiels tuple of int64 [..., 10]."""
    rows = rows.to(torch.int64)
    return (rows[..., 0, :], rows[..., 1, :], rows[..., 2, :], rows[..., 3, :])


def table_select(table, nibble):
    """Window entries by per-item nibble: ``table`` is shared [16, 4, 10]
    or per item [B, 16, 4, 10]; ``nibble`` int [B] in [0, 16). Returns a
    PNiels tuple of int64 [B, 10] (an indexed load, where the TPU took a
    one-hot contraction)."""
    if table.dim() == 3:
        return _entry(table[nibble])
    return _entry(table[torch.arange(nibble.shape[0], device=nibble.device), nibble])


def _windowed(s_nibbles, h_nibbles, base_table, select_a):
    """64 windows of 4 doublings + [s_w]B + [h_w]A', with ``select_a(h_w)``
    the A' entries of window nibbles h_w."""
    s_nib = s_nibbles.to(torch.int64) & 15
    h_nib = h_nibbles.to(torch.int64) & 15
    acc = ext_identity(s_nib.shape[:-1], device=s_nib.device)
    for w in range(NWINDOWS):
        acc = ext_double(acc, compute_t=False)
        acc = ext_double(acc, compute_t=False)
        acc = ext_double(acc, compute_t=False)
        acc = ext_double(acc, compute_t=True)
        acc = pniels_add(acc, table_select(base_table, s_nib[..., w]))
        acc = pniels_add(acc, select_a(h_nib[..., w]))
    return acc


def double_scalar_mul_indexed(s_nibbles, h_nibbles, base_table, tables, val_idx):
    """[s]B + [h]A' with A' looked up per item in the epoch tables.

    s_nibbles, h_nibbles: [B, 64] MSB-first nibbles; base_table: int32
    [16, 4, 10]; tables: int32 [V, 16, 4, 10]; val_idx: [B] (clamped to
    [0, V)). Returns an Extended point of int64 [B, 10] coordinates."""
    n_vals = tables.shape[0]
    flat = tables.reshape(n_vals * TABLE_SIZE, 4, fe.NLIMB)
    base = val_idx.to(torch.int64).clamp(0, n_vals - 1) * TABLE_SIZE
    return _windowed(s_nibbles, h_nibbles, base_table, lambda h: _entry(flat[base + h]))


def double_scalar_mul(s_nibbles, h_nibbles, base_table, a_tables):
    """[s]B + [h]A' with A' given by one window table per item (K5's
    form): a_tables int32 [B, 16, 4, 10], gathered per vote. Identical
    results to ``double_scalar_mul_indexed`` over the tables it gathered."""
    return _windowed(s_nibbles, h_nibbles, base_table, lambda h: table_select(a_tables, h))


def ext_encode(p):
    """(frozen y [..., 10], parity of frozen x [...])."""
    X, Y, Z, _ = p
    zinv = fe.fe_inv(Z)
    y = fe.fe_freeze(fe.fe_mul(Y, zinv))
    x = fe.fe_freeze(fe.fe_mul(X, zinv))
    return y, fe.fe_parity_frozen(x)


def dsm_encode_plain(s_nibbles, h_nibbles, val_idx, tables, base_table=None):
    """Plain version of the K2 kernel: (y int32 [B, 10], parity int32 [B])."""
    if base_table is None:
        base_table = torch.from_numpy(BASE_TABLE).to(tables.device)
    y, parity = ext_encode(
        double_scalar_mul_indexed(s_nibbles, h_nibbles, base_table, tables, val_idx)
    )
    return y.to(torch.int32), parity.to(torch.int32)


def dsm_encode(s_nibbles, h_nibbles, val_idx, tables):
    """K2 alone: encode([s]B + [h]A') by the CUDA kernel on a card, by the
    plain version on the CPU. s/h nibbles uint8 [B, 64], val_idx int32
    [B], tables int32 [V, 16, 4, 10]."""
    if s_nibbles.device.type == "cpu":
        return dsm_encode_plain(s_nibbles, h_nibbles, val_idx, tables)
    n = s_nibbles.shape[0]
    _lib.check(s_nibbles, torch.uint8, (n, NWINDOWS), "s_nibbles")
    _lib.check(h_nibbles, torch.uint8, (n, NWINDOWS), "h_nibbles")
    _lib.check(val_idx, torch.int32, (n,), "val_idx")
    _lib.check(tables, torch.int32, (-1, TABLE_SIZE, 4, fe.NLIMB), "tables")
    if tables.shape[0] == 0:
        raise ValueError("tables: empty validator set")
    y = torch.empty((n, fe.NLIMB), dtype=torch.int32, device=s_nibbles.device)
    parity = torch.empty((n,), dtype=torch.int32, device=s_nibbles.device)
    _lib.launch(
        "dsm_encode", "txf_dsm_encode", y, n, s_nibbles.data_ptr(),
        h_nibbles.data_ptr(), val_idx.data_ptr(), tables.data_ptr(),
        tables.shape[0], y.data_ptr(), parity.data_ptr(), n,
    )
    return y, parity


# ----------------------------------------------------------------------------
# Host-side table construction (numpy / python ints; once per epoch).


def _affine_pniels(pt) -> np.ndarray:
    """Extended python-int point -> affine PNiels limb block [4, 10]."""
    x, y, z, _ = pt
    zinv = pow(z, host_ed.P - 2, host_ed.P)
    xa, ya = (x * zinv) % host_ed.P, (y * zinv) % host_ed.P
    return np.stack(
        [
            fe.int_to_limbs((ya + xa) % host_ed.P),
            fe.int_to_limbs((ya - xa) % host_ed.P),
            fe.int_to_limbs(1),
            fe.int_to_limbs((2 * host_ed.D * xa * ya) % host_ed.P),
        ]
    )


def build_pniels_table(pt) -> np.ndarray:
    """Window table [16, 4, 10] of {0..15} * pt (entry 0 = identity)."""
    rows = [np.stack([fe.int_to_limbs(v) for v in (1, 1, 1, 0)])]
    acc = host_ed.IDENTITY
    for _ in range(1, TABLE_SIZE):
        acc = host_ed.point_add(acc, pt)
        rows.append(_affine_pniels(acc))
    return np.stack(rows)


BASE_TABLE = build_pniels_table(host_ed.BASE)


def scalar_to_nibbles(s: int) -> np.ndarray:
    """256-bit scalar -> [64] int32 nibbles, most significant first."""
    return np.array(
        [(s >> (4 * (NWINDOWS - 1 - i))) & 0xF for i in range(NWINDOWS)],
        dtype=np.int32,
    )
