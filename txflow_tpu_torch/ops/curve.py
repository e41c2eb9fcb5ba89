"""edwards25519 point arithmetic: host table building, the plain PyTorch
version, and the wrapper of the CUDA double-scalar-multiply kernel (K2),
over either field of ``ops/field.py``.

Counterpart of ``txflow_tpu/ops/curve.py``. Points are tuples of four
coordinates, each a limb tensor ``[..., NLIMB]`` of the field's plain
type (``ops/fe.py``: int64 [..., 10]; ``ops/fe13.py``: int32 [..., 20]):
Extended (X, Y, Z, T) and PNiels (Y+X, Y-X, Z, 2dT). The formulas and
their order are those of ``csrc/ge25519.cuh``. Table selection is an
indexed load on both sides (the TPU's one-hot matrix select has no
counterpart here). Every function takes ``fe_radix`` (25 or 13, see
``ops/field.py``): the field is an argument, never module state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import ed25519 as host_ed
from . import _lib, field

TABLE_WINDOW = 4
TABLE_SIZE = 1 << TABLE_WINDOW  # 16
NWINDOWS = 64  # 256 bits / 4

# field multiplies of one [s]B + [h]A' and encode: per window 3 doublings
# without T (7), one with T (8) and two PNiels additions (8 each); then the
# inversion chain and the two affine products (the same in either field)
MULS_PER_WINDOW = 3 * 7 + 8 + 2 * 8
MULS_PER_DSM_ENCODE = NWINDOWS * MULS_PER_WINDOW + 265 + 2


def ext_identity(batch_shape, device=None, fe_radix: int = 25):
    F = field.ops(fe_radix)
    z = torch.zeros((*batch_shape, F.NLIMB), dtype=F.DTYPE, device=device)
    one = z.clone()
    one[..., 0] = 1
    return (z, one, one.clone(), z.clone())


def ext_double(p, compute_t: bool = True, fe_radix: int = 25):
    """Dedicated doubling (dbl-2008-hwcd); T only when ``compute_t``."""
    F = field.ops(fe_radix)
    X1, Y1, Z1, T1 = p
    A = F.fe_sq(X1)
    B = F.fe_sq(Y1)
    C = F.fe_mul_small(F.fe_sq(Z1), 2)
    H = F.fe_add(A, B)
    E = F.fe_sub(H, F.fe_sq(F.fe_add(X1, Y1)))
    G = F.fe_sub(A, B)
    F_ = F.fe_add(C, G)
    X3 = F.fe_mul(E, F_)
    Y3 = F.fe_mul(G, H)
    Z3 = F.fe_mul(F_, G)
    T3 = F.fe_mul(E, H) if compute_t else T1
    return (X3, Y3, Z3, T3)


def pniels_add(p, n, fe_radix: int = 25):
    """Extended + PNiels -> Extended (madd-2008-hwcd-3, general Z2)."""
    F = field.ops(fe_radix)
    X1, Y1, Z1, T1 = p
    YpX2, YmX2, Z2, T2d2 = n
    A = F.fe_mul(F.fe_sub(Y1, X1), YmX2)
    B = F.fe_mul(F.fe_add(Y1, X1), YpX2)
    C = F.fe_mul(T1, T2d2)
    D = F.fe_mul_small(F.fe_mul(Z1, Z2), 2)
    E = F.fe_sub(B, A)
    F_ = F.fe_sub(D, C)
    G = F.fe_add(D, C)
    H = F.fe_add(B, A)
    return (F.fe_mul(E, F_), F.fe_mul(G, H), F.fe_mul(F_, G), F.fe_mul(E, H))


def _entry(rows: torch.Tensor, fe_radix: int = 25):
    """[..., 4, NLIMB] table rows -> PNiels tuple of [..., NLIMB] limbs."""
    rows = rows.to(field.ops(fe_radix).DTYPE)
    return (rows[..., 0, :], rows[..., 1, :], rows[..., 2, :], rows[..., 3, :])


def table_select(table, nibble, fe_radix: int = 25):
    """Window entries by per-item nibble: ``table`` is shared [16, 4, NLIMB]
    or per item [B, 16, 4, NLIMB]; ``nibble`` int [B] in [0, 16). Returns a
    PNiels tuple of [B, NLIMB] limbs (an indexed load, where the TPU took
    a one-hot contraction)."""
    if table.dim() == 3:
        return _entry(table[nibble], fe_radix)
    return _entry(table[torch.arange(nibble.shape[0], device=nibble.device), nibble], fe_radix)


def _windowed(s_nibbles, h_nibbles, base_table, select_a, fe_radix: int = 25):
    """64 windows of 4 doublings + [s_w]B + [h_w]A', with ``select_a(h_w)``
    the A' entries of window nibbles h_w."""
    s_nib = s_nibbles.to(torch.int64) & 15
    h_nib = h_nibbles.to(torch.int64) & 15
    acc = ext_identity(s_nib.shape[:-1], device=s_nib.device, fe_radix=fe_radix)
    for w in range(NWINDOWS):
        acc = ext_double(acc, compute_t=False, fe_radix=fe_radix)
        acc = ext_double(acc, compute_t=False, fe_radix=fe_radix)
        acc = ext_double(acc, compute_t=False, fe_radix=fe_radix)
        acc = ext_double(acc, compute_t=True, fe_radix=fe_radix)
        acc = pniels_add(acc, table_select(base_table, s_nib[..., w], fe_radix), fe_radix)
        acc = pniels_add(acc, select_a(h_nib[..., w]), fe_radix)
    return acc


def double_scalar_mul_indexed(s_nibbles, h_nibbles, base_table, tables, val_idx,
                              fe_radix: int = 25):
    """[s]B + [h]A' with A' looked up per item in the epoch tables.

    s_nibbles, h_nibbles: [B, 64] MSB-first nibbles; base_table: int32
    [16, 4, NLIMB]; tables: int32 [V, 16, 4, NLIMB]; val_idx: [B] (clamped
    to [0, V)). Returns an Extended point of [B, NLIMB] coordinates."""
    n_vals = tables.shape[0]
    flat = tables.reshape(n_vals * TABLE_SIZE, 4, tables.shape[-1])
    base = val_idx.to(torch.int64).clamp(0, n_vals - 1) * TABLE_SIZE
    return _windowed(s_nibbles, h_nibbles, base_table,
                     lambda h: _entry(flat[base + h], fe_radix), fe_radix)


def double_scalar_mul(s_nibbles, h_nibbles, base_table, a_tables, fe_radix: int = 25):
    """[s]B + [h]A' with A' given by one window table per item (K5's
    form): a_tables int32 [B, 16, 4, NLIMB], gathered per vote. Identical
    results to ``double_scalar_mul_indexed`` over the tables it gathered."""
    return _windowed(s_nibbles, h_nibbles, base_table,
                     lambda h: table_select(a_tables, h, fe_radix), fe_radix)


def ext_encode(p, fe_radix: int = 25):
    """(frozen y [..., NLIMB], parity of frozen x [...])."""
    F = field.ops(fe_radix)
    X, Y, Z, _ = p
    zinv = F.fe_inv(Z)
    y = F.fe_freeze(F.fe_mul(Y, zinv))
    x = F.fe_freeze(F.fe_mul(X, zinv))
    return y, F.fe_parity_frozen(x)


def base_table(device, fe_radix: int = 25) -> torch.Tensor:
    """The base point's window table [16, 4, NLIMB] of the field, on
    ``device``."""
    return torch.from_numpy(BASE_TABLES[fe_radix]).to(device)


def dsm_encode_plain(s_nibbles, h_nibbles, val_idx, tables, base=None, fe_radix: int = 25):
    """Plain version of the K2 kernel: (y int32 [B, NLIMB], parity int32 [B])."""
    if base is None:
        base = base_table(tables.device, fe_radix)
    y, parity = ext_encode(
        double_scalar_mul_indexed(s_nibbles, h_nibbles, base, tables, val_idx, fe_radix),
        fe_radix,
    )
    return y.to(torch.int32), parity.to(torch.int32)


def dsm_encode(s_nibbles, h_nibbles, val_idx, tables, fe_radix: int = 25):
    """K2 alone: encode([s]B + [h]A') by the CUDA kernel of the field's
    verify library on a card, by the plain version on the CPU. s/h
    nibbles uint8 [B, 64], val_idx int32 [B], tables int32
    [V, 16, 4, NLIMB]."""
    F = field.ops(fe_radix)
    if s_nibbles.device.type == "cpu":
        return dsm_encode_plain(s_nibbles, h_nibbles, val_idx, tables, fe_radix=fe_radix)
    n = s_nibbles.shape[0]
    _lib.check(s_nibbles, torch.uint8, (n, NWINDOWS), "s_nibbles")
    _lib.check(h_nibbles, torch.uint8, (n, NWINDOWS), "h_nibbles")
    _lib.check(val_idx, torch.int32, (n,), "val_idx")
    _lib.check(tables, torch.int32, (-1, TABLE_SIZE, 4, F.NLIMB), "tables")
    _lib.same_card(s_nibbles, h_nibbles, val_idx, tables)
    if tables.shape[0] == 0:
        raise ValueError("tables: empty validator set")
    y = torch.empty((n, F.NLIMB), dtype=torch.int32, device=s_nibbles.device)
    parity = torch.empty((n,), dtype=torch.int32, device=s_nibbles.device)
    _lib.launch(
        "dsm_encode" + F.TAG, "txf_dsm_encode", y, n, s_nibbles.data_ptr(),
        h_nibbles.data_ptr(), val_idx.data_ptr(), tables.data_ptr(),
        tables.shape[0], y.data_ptr(), parity.data_ptr(), n,
    )
    return y, parity


# ----------------------------------------------------------------------------
# Host-side table construction (numpy / python ints; once per epoch).


def _affine_pniels(pt, F) -> np.ndarray:
    """Extended python-int point -> affine PNiels limb block [4, NLIMB]."""
    x, y, z, _ = pt
    zinv = pow(z, host_ed.P - 2, host_ed.P)
    xa, ya = (x * zinv) % host_ed.P, (y * zinv) % host_ed.P
    return np.stack(
        [
            F.int_to_limbs((ya + xa) % host_ed.P),
            F.int_to_limbs((ya - xa) % host_ed.P),
            F.int_to_limbs(1),
            F.int_to_limbs((2 * host_ed.D * xa * ya) % host_ed.P),
        ]
    )


def build_pniels_table(pt, fe_radix: int = 25) -> np.ndarray:
    """Window table [16, 4, NLIMB] of {0..15} * pt (entry 0 = identity),
    canonical limbs of the field."""
    F = field.ops(fe_radix)
    rows = [np.stack([F.int_to_limbs(v) for v in (1, 1, 1, 0)])]
    acc = host_ed.IDENTITY
    for _ in range(1, TABLE_SIZE):
        acc = host_ed.point_add(acc, pt)
        rows.append(_affine_pniels(acc, F))
    return np.stack(rows)


# the base point's table in each field ([16, 4, 10] and [16, 4, 20]): the
# __constant__ table of each verify library
BASE_TABLES = {r: build_pniels_table(host_ed.BASE, r) for r in field.FIELDS}
BASE_TABLE = BASE_TABLES[25]


def scalar_to_nibbles(s: int) -> np.ndarray:
    """256-bit scalar -> [64] int32 nibbles, most significant first."""
    return np.array(
        [(s >> (4 * (NWINDOWS - 1 - i))) & 0xF for i in range(NWINDOWS)],
        dtype=np.int32,
    )
