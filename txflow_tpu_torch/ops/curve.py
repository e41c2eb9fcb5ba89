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

Three forms of [s]B + [h]A' live here, one for each way a kernel runs it:
one lane a signature (``_windowed``: the reference every other form is
held against), four lanes by scalar quarter (``double_scalar_mul_quarters``,
K3 and K6) and four lanes by point coordinate (``double_scalar_mul_lanes``,
K5 and K2: one lane a coordinate of the accumulator, ``[..., 4, NLIMB]``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import ed25519 as host_ed
from . import _lib, field

TABLE_WINDOW = 4
TABLE_SIZE = 1 << TABLE_WINDOW  # 16
NWINDOWS = 64  # 256 bits / 4
# the verify kernel splits each scalar into four 64-bit quarters, one lane
# each: quarter j is nibbles [48 - 16j, 64 - 16j) of the MSB-first nibbles
QUARTERS = 4
QUARTER_WINDOWS = NWINDOWS // QUARTERS  # 16

# field multiplies of one [s]B + [h]A' and encode: per window 3 doublings
# without T (7), one with T (8) and two PNiels additions (8 each); then the
# inversion chain and the two affine products (the same in either field)
MULS_PER_DOUBLINGS = 3 * 7 + 8
MULS_PER_WINDOW = MULS_PER_DOUBLINGS + 2 * 8
MULS_PER_ENCODE = 265 + 2
MULS_PER_DSM_ENCODE = NWINDOWS * MULS_PER_WINDOW + MULS_PER_ENCODE
# the four-lane form: every lane runs 16 windows (the first without its
# doublings of the identity) and both combine rounds (each a product by
# 2d and one PNiels addition); then one encode a row
MULS_PER_COMBINE_ROUND = 1 + 8
MULS_PER_QUARTER_DSM_ENCODE = QUARTERS * (
    QUARTER_WINDOWS * MULS_PER_WINDOW - MULS_PER_DOUBLINGS + 2 * MULS_PER_COMBINE_ROUND
) + MULS_PER_ENCODE
# the coordinate split (K5, K2): four lanes a row, lane c holding
# coordinate c of (X, Y, Z, T). Every doubling and addition is two rounds
# of four independent products, one a lane, so a lane's chain is 2
# products a formula, 12 a window, then the encode's 267 (one thread a row,
# in a second launch). The lanes issue 8 products a formula: the one-lane
# body's 45 a window, plus the T product of the three doublings that skip
# it, which lane 3 computes and drops.
COORD_LANES = 4
MULS_PER_COORD_WINDOW = (4 + 2) * 2 * COORD_LANES
MULS_PER_COORD_DSM_ENCODE = NWINDOWS * MULS_PER_COORD_WINDOW + MULS_PER_ENCODE
MULS_CHAIN_COORD_DSM_ENCODE = NWINDOWS * MULS_PER_COORD_WINDOW // COORD_LANES + MULS_PER_ENCODE
# of those products, the squarings: four a doubling (X^2, Y^2, Z^2,
# (X+Y)^2; in the coordinate split one a lane in round 1), none in an
# addition or a combine round, and the inversion chain's 254
SQS_PER_DOUBLINGS = 4 * 4
SQS_PER_ENCODE = 254
SQS_PER_DSM_ENCODE = NWINDOWS * SQS_PER_DOUBLINGS + SQS_PER_ENCODE
SQS_PER_QUARTER_DSM_ENCODE = QUARTERS * (
    QUARTER_WINDOWS * SQS_PER_DOUBLINGS - SQS_PER_DOUBLINGS
) + SQS_PER_ENCODE


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


def ext_to_pniels(p, fe_radix: int = 25):
    """Extended -> PNiels (Y+X, Y-X, Z, 2d T): the form a lane's point
    takes to be added to its partner's in the verify kernel's combine
    rounds (csrc/ge25519.cuh:ge_p3_to_pniels)."""
    F = field.ops(fe_radix)
    X, Y, Z, T = p
    return (F.fe_add(Y, X), F.fe_sub(Y, X), Z, F.fe_mul(T, _d2(fe_radix, T.device)))


def _d2(fe_radix: int, device):
    F = field.ops(fe_radix)
    return torch.from_numpy(F.int_to_limbs(D2_INT)).to(device=device, dtype=F.DTYPE)


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


def _epoch_rows(tables, val_idx):
    """nibbles h [B] -> the [B, 4, NLIMB] entries h of each item's table in
    the epoch tables [V, 16, 4, NLIMB] (val_idx clamped to [0, V))."""
    n_vals = tables.shape[0]
    flat = tables.reshape(n_vals * TABLE_SIZE, 4, tables.shape[-1])
    base = val_idx.to(torch.int64).clamp(0, n_vals - 1) * TABLE_SIZE
    return lambda h: flat[base + h]


def double_scalar_mul_indexed(s_nibbles, h_nibbles, base_table, tables, val_idx,
                              fe_radix: int = 25):
    """[s]B + [h]A' with A' looked up per item in the epoch tables.

    s_nibbles, h_nibbles: [B, 64] MSB-first nibbles; base_table: int32
    [16, 4, NLIMB]; tables: int32 [V, 16, 4, NLIMB]; val_idx: [B] (clamped
    to [0, V)). Returns an Extended point of [B, NLIMB] coordinates."""
    rows = _epoch_rows(tables, val_idx)
    return _windowed(s_nibbles, h_nibbles, base_table, lambda h: _entry(rows(h), fe_radix),
                     fe_radix)


def double_scalar_mul(s_nibbles, h_nibbles, base_table, a_tables, fe_radix: int = 25):
    """[s]B + [h]A' with A' given by one window table per item (K5's
    form): a_tables int32 [B, 16, 4, NLIMB], gathered per vote. Identical
    results to ``double_scalar_mul_indexed`` over the tables it gathered."""
    return _windowed(s_nibbles, h_nibbles, base_table,
                     lambda h: table_select(a_tables, h, fe_radix), fe_radix)


# lane c's source lane in the coordinate split's exchanges: round 1 of a
# doubling (lane 0 takes Y for (X+Y)^2, lane 3 takes X for X^2), and round 1
# of an addition (xor 1: X <-> Y, Z <-> T), which is also the coordinate
# of a table entry that lane c multiplies by
_DBL_SRC = [1, 1, 2, 0]
_XOR1 = [1, 0, 3, 2]


def to_lanes(p) -> torch.Tensor:
    """An Extended point (X, Y, Z, T) of [..., NLIMB] coordinates -> the
    coordinate split's [..., 4, NLIMB], lane c holding coordinate c."""
    return torch.stack(p, dim=-2)


def from_lanes(v: torch.Tensor):
    """[..., 4, NLIMB] lanes -> an Extended point tuple."""
    return tuple(v.unbind(-2))


def _exchange(v: torch.Tensor, src) -> torch.Tensor:
    """Lane c of the result is lane ``src[c]`` of ``v`` (one shuffle of a
    field element within a group of four lanes)."""
    return v[..., src, :]


def _lanes_round2(E, F_, G, H, fe_radix: int):
    """Round 2 of both formulas: lane 0 X3 = E F, lane 1 Y3 = G H, lane 2
    Z3 = F G, lane 3 T3 = E H (every lane holds E, F, G and H: the kernel
    computes them on each lane from the four round-1 products, which every
    lane reads by four shuffles)."""
    F = field.ops(fe_radix)
    return F.fe_mul(torch.stack([E, G, F_, E], dim=-2), torch.stack([F_, H, G, H], dim=-2))


def lane_double(v: torch.Tensor, compute_t: bool = True, fe_radix: int = 25) -> torch.Tensor:
    """``ext_double`` in the coordinate split: v [..., 4, NLIMB]. Round 1:
    one shuffle (lane 0 takes Y, lane 3 takes X), then lane 0 squares
    X + Y, lane 1 Y, lane 2 Z (and doubles it), lane 3 X; round 2 as
    ``_lanes_round2``. Lane 3 keeps its T unless ``compute_t``. The same
    field operations on the same operands as ``ext_double``."""
    F = field.ops(fe_radix)
    r = _exchange(v, _DBL_SRC)
    a = torch.stack([F.fe_add(v[..., 0, :], r[..., 0, :]), v[..., 1, :], v[..., 2, :],
                     r[..., 3, :]], dim=-2)
    q = F.fe_sq(a)
    S, B, C, A = q[..., 0, :], q[..., 1, :], F.fe_mul_small(q[..., 2, :], 2), q[..., 3, :]
    H = F.fe_add(A, B)
    E = F.fe_sub(H, S)
    G = F.fe_sub(A, B)
    F_ = F.fe_add(C, G)
    out = _lanes_round2(E, F_, G, H, fe_radix)  # a new tensor
    if not compute_t:
        out[..., 3, :] = v[..., 3, :]
    return out


def lane_pniels_add(v: torch.Tensor, rows: torch.Tensor, fe_radix: int = 25) -> torch.Tensor:
    """``pniels_add`` in the coordinate split: v [..., 4, NLIMB] plus the
    PNiels entries ``rows`` [..., 4, NLIMB] (Y2+X2, Y2-X2, Z2, 2dT2).
    Round 1: one xor-1 shuffle, then lane 0 computes A = (Y-X)(Y2-X2),
    lane 1 B = (Y+X)(Y2+X2), lane 2 C = T 2dT2, lane 3 D = 2 Z Z2, lane c
    multiplying by coordinate c^1 of the entry; round 2 as
    ``_lanes_round2``. The same field operations on the same operands as
    ``pniels_add``."""
    F = field.ops(fe_radix)
    r = _exchange(v, _XOR1)
    a = torch.stack([F.fe_sub(r[..., 0, :], v[..., 0, :]), F.fe_add(v[..., 1, :], r[..., 1, :]),
                     r[..., 2, :], r[..., 3, :]], dim=-2)
    q = F.fe_mul(a, _exchange(rows.to(F.DTYPE), _XOR1))
    A, B, C, D = q[..., 0, :], q[..., 1, :], q[..., 2, :], F.fe_mul_small(q[..., 3, :], 2)
    E = F.fe_sub(B, A)
    F_ = F.fe_sub(D, C)
    G = F.fe_add(D, C)
    H = F.fe_add(B, A)
    return _lanes_round2(E, F_, G, H, fe_radix)


def _windowed_lanes(s_nibbles, h_nibbles, base_table, rows_a, fe_radix: int = 25):
    """``_windowed`` in the coordinate split, with ``rows_a(h_w)`` the
    [B, 4, NLIMB] A' entries of window nibbles h_w. After every window the
    lanes hold the one-lane accumulator limb for limb."""
    s_nib = s_nibbles.to(torch.int64) & 15
    h_nib = h_nibbles.to(torch.int64) & 15
    acc = to_lanes(ext_identity(s_nib.shape[:-1], device=s_nib.device, fe_radix=fe_radix))
    for w in range(NWINDOWS):
        for k in range(4):
            acc = lane_double(acc, compute_t=k == 3, fe_radix=fe_radix)
        acc = lane_pniels_add(acc, base_table[s_nib[..., w]], fe_radix)
        acc = lane_pniels_add(acc, rows_a(h_nib[..., w]), fe_radix)
    return from_lanes(acc)


def double_scalar_mul_lanes(s_nibbles, h_nibbles, base_table, a_tables, fe_radix: int = 25):
    """[s]B + [h]A' as the coordinate-split kernel K5 computes it, with
    one window table of A' per item (a_tables int32 [B, 16, 4, NLIMB]):
    limb for limb ``double_scalar_mul``'s Extended point."""
    rows = torch.arange(a_tables.shape[0], device=a_tables.device)
    return _windowed_lanes(s_nibbles, h_nibbles, base_table, lambda h: a_tables[rows, h],
                           fe_radix)


def double_scalar_mul_indexed_lanes(s_nibbles, h_nibbles, base_table, tables, val_idx,
                                    fe_radix: int = 25):
    """[s]B + [h]A' as the coordinate-split kernel K2 computes it, A'
    looked up per item in the epoch tables (val_idx clamped to [0, V)):
    limb for limb ``double_scalar_mul_indexed``'s Extended point."""
    return _windowed_lanes(s_nibbles, h_nibbles, base_table, _epoch_rows(tables, val_idx),
                           fe_radix)


def quarter_nibbles(nibbles: torch.Tensor) -> torch.Tensor:
    """[B, 64] MSB-first nibbles -> [B, 4, 16]: row j holds quarter j's
    nibbles [48 - 16j, 64 - 16j), MSB first (a lane's 16 windows)."""
    j = torch.arange(QUARTERS, device=nibbles.device)
    w = torch.arange(QUARTER_WINDOWS, device=nibbles.device)
    cols = (NWINDOWS - QUARTER_WINDOWS * (j + 1))[:, None] + w[None, :]
    return nibbles[:, cols]


def double_scalar_mul_quarters(s_nibbles, h_nibbles, base_quarters, tables, quarter_tables,
                               val_idx, fe_radix: int = 25):
    """[s]B + [h]A' as the four-lane verify kernel computes it: each of
    four lanes j runs 16 windows over quarter j of both scalars with the
    tables of 2^(64j) B and 2^(64j) A' (the first window without its
    doublings of the identity), then two combine rounds add the
    lanes' points pairwise, lane j taking its partner j^1, then j^2, as a
    PNiels entry. Returns lane 0's sum (Q0 + Q1) + (Q2 + Q3) as an Extended
    point of [B, NLIMB] coordinates.

    base_quarters: int32 [4, 16, 4, NLIMB] (``BASE_QUARTER_TABLES``);
    tables: int32 [V, 16, 4, NLIMB] (quarter 0 of A'); quarter_tables:
    int32 [V, 3, 16, 4, NLIMB] (quarters 1-3); val_idx: [B], clamped to
    [0, V)."""
    n_vals, nlimb = tables.shape[0], tables.shape[-1]
    b = s_nibbles.shape[0]
    s_q = quarter_nibbles(s_nibbles.to(torch.int64) & 15).reshape(b * QUARTERS, QUARTER_WINDOWS)
    h_q = quarter_nibbles(h_nibbles.to(torch.int64) & 15).reshape(b * QUARTERS, QUARTER_WINDOWS)
    lane = torch.arange(QUARTERS, device=s_q.device).repeat(b)
    # every validator's four quarters as one [V * 4 * 16] row table
    a_flat = torch.cat([tables[:, None], quarter_tables], dim=1).reshape(-1, 4, nlimb)
    a_base = ((val_idx.to(torch.int64).clamp(0, n_vals - 1).repeat_interleave(QUARTERS)
               * QUARTERS + lane) * TABLE_SIZE)
    b_flat = base_quarters.reshape(-1, 4, nlimb)
    b_base = lane * TABLE_SIZE
    acc = ext_identity((b * QUARTERS,), device=s_q.device, fe_radix=fe_radix)
    for w in range(QUARTER_WINDOWS):
        if w:  # the first window's doublings would double the identity
            acc = ext_double(acc, compute_t=False, fe_radix=fe_radix)
            acc = ext_double(acc, compute_t=False, fe_radix=fe_radix)
            acc = ext_double(acc, compute_t=False, fe_radix=fe_radix)
            acc = ext_double(acc, compute_t=True, fe_radix=fe_radix)
        acc = pniels_add(acc, _entry(b_flat[b_base + s_q[:, w]], fe_radix), fe_radix)
        acc = pniels_add(acc, _entry(a_flat[a_base + h_q[:, w]], fe_radix), fe_radix)
    q = tuple(c.reshape(b, QUARTERS, -1) for c in acc)
    # round 1 on lanes 0 and 2 (partners 1 and 3), round 2 on lane 0
    # (partner 2): the sums lane 0 of the kernel computes
    r = pniels_add(tuple(c[:, 0::2] for c in q),
                   ext_to_pniels(tuple(c[:, 1::2] for c in q), fe_radix), fe_radix)
    return pniels_add(tuple(c[:, 0] for c in r),
                      ext_to_pniels(tuple(c[:, 1] for c in r), fe_radix), fe_radix)


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


_base_quarters: dict[tuple[str, int], torch.Tensor] = {}


def device_base_quarters(device, fe_radix: int = 25) -> torch.Tensor:
    """The base point's four quarter tables [4, 16, 4, NLIMB] of the field
    on ``device``, uploaded once per (device, field) and cached: the verify
    kernel stages them into shared memory per block."""
    key = (str(torch.device(device)), fe_radix)
    t = _base_quarters.get(key)
    if t is None:
        t = _base_quarters.setdefault(key, torch.from_numpy(BASE_QUARTER_TABLES[fe_radix]).to(device))
    return t


def dsm_encode_plain(s_nibbles, h_nibbles, val_idx, tables, base=None, fe_radix: int = 25):
    """Plain version of the K2 kernel, by the kernel's coordinate split
    (``double_scalar_mul_indexed_lanes``): (y int32 [B, NLIMB], parity
    int32 [B])."""
    if base is None:
        base = base_table(tables.device, fe_radix)
    y, parity = ext_encode(
        double_scalar_mul_indexed_lanes(s_nibbles, h_nibbles, base, tables, val_idx, fe_radix),
        fe_radix,
    )
    return y.to(torch.int32), parity.to(torch.int32)


def dsm_encode(s_nibbles, h_nibbles, val_idx, tables, fe_radix: int = 25):
    """K2 alone: encode([s]B + [h]A') by the CUDA kernel of the field's
    verify library on a card, by the plain version on the CPU. s/h
    nibbles uint8 [B, 64], val_idx int32 [B], tables int32
    [V, 16, 4, NLIMB]. One call is two kernel launches (the coordinate
    split, four lanes a row, then one thread a row encodes), counted as
    one in ``_lib.launches``; the base table is the card's cached copy
    (quarter 0 of ``device_base_quarters``)."""
    F = field.ops(fe_radix)
    if s_nibbles.device.type == "cpu":
        return dsm_encode_plain(s_nibbles, h_nibbles, val_idx, tables, fe_radix=fe_radix)
    n = s_nibbles.shape[0]
    _lib.check_all(
        (s_nibbles, torch.uint8, (n, NWINDOWS), "s_nibbles"),
        (h_nibbles, torch.uint8, (n, NWINDOWS), "h_nibbles"),
        (val_idx, torch.int32, (n,), "val_idx"),
        (tables, torch.int32, (-1, TABLE_SIZE, 4, F.NLIMB), "tables"),
    )
    if tables.shape[0] == 0:
        raise ValueError("tables: empty validator set")
    base = device_base_quarters(s_nibbles.device, fe_radix)
    # one scratch: each row's [s]B + [h]A' (X, Y, Z) between the two
    # launches, then y, then the parity
    scratch = torch.empty((n * (4 * F.NLIMB + 1),), dtype=torch.int32, device=s_nibbles.device)
    y = scratch[n * 3 * F.NLIMB:n * 4 * F.NLIMB].view(n, F.NLIMB)
    parity = scratch[n * 4 * F.NLIMB:]
    _lib.launch(
        "dsm_encode" + F.TAG, "txf_dsm_encode", y, n, s_nibbles.data_ptr(),
        h_nibbles.data_ptr(), val_idx.data_ptr(), tables.data_ptr(), tables.shape[0],
        base.data_ptr(), scratch.data_ptr(), y.data_ptr(), parity.data_ptr(), n,
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


D2_INT = (2 * host_ed.D) % host_ed.P


def _double_n(pt, n: int):
    """2^n * pt (n >= 1) by n dedicated doublings, reduced mod p after each
    product; T only from the last (the doubling ignores its input T)."""
    P = host_ed.P
    X, Y, Z = pt[0], pt[1], pt[2]
    for _ in range(n):
        A, B, C = X * X % P, Y * Y % P, 2 * Z * Z % P
        H = A + B
        E = H - (X + Y) * (X + Y) % P
        G = A - B
        F = C + G
        X, Y, Z = E * F % P, G * H % P, F * G % P
    return X, Y, Z, E * H % P


def _batch_inverse(zs: list[int]) -> list[int]:
    """Every z^-1 mod p with one exponentiation (Montgomery's trick)."""
    P = host_ed.P
    prefix, acc = [], 1
    for z in zs:
        prefix.append(acc)
        acc = acc * z % P
    inv = pow(acc, P - 2, P)
    out = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        out[i] = inv * prefix[i] % P
        inv = inv * zs[i] % P
    return out


def ints_to_limbs(vals: list[int], fe_radix: int = 25) -> np.ndarray:
    """Python ints in [0, 2^255) -> int32 [len, NLIMB] canonical limbs of
    the field, in one vectorised pass over their bytes."""
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    return field.ops(fe_radix).bytes_to_limbs_np(np.frombuffer(raw, np.uint8).reshape(-1, 32))


def build_quarter_tables(points, fe_radix: int = 25) -> np.ndarray:
    """Window tables of the four scalar quarters of each point: int32
    [N, 4, 16, 4, NLIMB], entry [n, j, k] = k * 2^(64j) * points[n] as an
    affine PNiels entry in canonical limbs of the field (entry 0 the
    identity). Quarter 0 is ``build_pniels_table`` of the point, bit for
    bit. All 60 affine entries of every point share one inversion."""
    P = host_ed.P
    exts = []
    for pt in points:
        q = pt
        for j in range(QUARTERS):
            if j:
                q = _double_n(q, NWINDOWS)
            acc = host_ed.IDENTITY
            for _ in range(1, TABLE_SIZE):
                acc = host_ed.point_add(acc, q)
                exts.append(acc)
    vals = []
    for (x, y, _z, _t), zinv in zip(exts, _batch_inverse([p[2] for p in exts])):
        xa, ya = x * zinv % P, y * zinv % P
        vals += [(ya + xa) % P, (ya - xa) % P, 1, D2_INT * xa % P * ya % P]
    nlimb = field.ops(fe_radix).NLIMB
    out = np.empty((len(points), QUARTERS, TABLE_SIZE, 4, nlimb), np.int32)
    out[:, :, 0] = ints_to_limbs([1, 1, 1, 0], fe_radix)
    if vals:
        out[:, :, 1:] = ints_to_limbs(vals, fe_radix).reshape(
            len(points), QUARTERS, TABLE_SIZE - 1, 4, nlimb)
    return out


# the base point's quarter tables in each field ([4, 16, 4, 10] and
# [4, 16, 4, 20]): the verify kernels' base tables, uploaded per card by
# device_base_quarters and staged in shared memory per block; quarter 0 is
# the base table, all that the coordinate split (K5, K2) reads
BASE_QUARTER_TABLES = {r: build_quarter_tables([host_ed.BASE], r)[0] for r in field.FIELDS}
BASE_TABLES = {r: np.ascontiguousarray(q[0]) for r, q in BASE_QUARTER_TABLES.items()}
BASE_TABLE = BASE_TABLES[25]


def scalar_to_nibbles(s: int) -> np.ndarray:
    """256-bit scalar -> [64] int32 nibbles, most significant first."""
    return np.array(
        [(s >> (4 * (NWINDOWS - 1 - i))) & 0xF for i in range(NWINDOWS)],
        dtype=np.int32,
    )
