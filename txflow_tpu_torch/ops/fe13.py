"""GF(2^255-19) in twenty radix-2^13 int32 limbs (K8): host helpers, the
plain PyTorch version, and the wrapper of the CUDA field kernel built
over this field (library ``verify13``).

Counterpart of ``txflow_tpu/ops/fe13.py``, limb for limb: the layout is
the JAX package's (limb ``i`` holds bits ``[13 i, 13 i + 13)``, 2^260 =
608 mod p folds the carry out of limb 19), and the plain functions below
run JAX's operations in JAX's order on int32 tensors -- the same carry
passes, the same 128 p offset in ``fe_sub``, the same 3-pass pre-carry of
the high product columns before the x608 fold -- so their limbs equal
JAX's exactly, un-frozen values included. ``csrc/fe25519_13.cuh`` is the
same arithmetic for one CUDA thread: int32 only, no 64-bit product, which
is what sets K8 apart from the radix-2^25.5 field (``ops/fe.py``, K1).

Bounds (JAX's, checked by the port's tests on worst-case inputs): an
input of ``fe_mul`` is normalized, every limb <= 9408, so a column of the
20 x 20 convolution stays below 20 * 9408^2 < 2^31; ``fe_add`` and
``fe_sub`` carry their outputs for that reason.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib

FE_RADIX = 13  # the name of this field in ``fe_radix`` arguments
TAG = "13"  # suffix of this field's kernels in ``_lib.KERNELS``
NLIMB = 20
RADIX = 13
MASK = (1 << RADIX) - 1
DTYPE = torch.int32  # the plain version's limb type, the kernel's own

P_INT = 2**255 - 19
WRAP = 608  # 2^260 mod p


def int_to_limbs(x: int) -> np.ndarray:
    """Python int in [0, 2^260) -> canonical limb vector (int32 [20])."""
    return np.array([(x >> (RADIX * i)) & MASK for i in range(NLIMB)], dtype=np.int32)


def limbs_to_int(limbs) -> int:
    """Limb vector (any bounds) -> python int (not reduced)."""
    return sum(int(v) << (RADIX * i) for i, v in enumerate(np.asarray(limbs).tolist()))


P_LIMBS = int_to_limbs(P_INT)
# the JAX package's bound on a normalized limb (fe_mul's inputs): fe_add
# and fe_sub return at most 8191 plus one carry pass's wrap of 2 * 608
NORM = 9408
OFFSET_P_LIMBS = 128 * P_LIMBS  # dominates any normalized subtrahend limb

# integer multiply-adds of one fe_mul in the CUDA kernel: the 20 x 20
# products, the x608 fold of the 20 high columns, and the x608 wrap of
# each of the seven carry passes
MADS_PER_MUL = NLIMB * NLIMB + NLIMB + 7
# and of one fe_sq (csrc/fe25519_13.cuh:fe13_sq_columns): 20 squares, 190
# cross products (each pair once) and their 19 doublings, then the same
# fold and passes. The plain fe_sq below is fe_mul(a, a): the same columns
MADS_PER_SQ = NLIMB + NLIMB * (NLIMB - 1) // 2 + (NLIMB - 1) + NLIMB + 7
# mul, sq and the 265 of the inversion chain (the kernel's fe_ops work),
# of them squarings: sq and the chain's 254
MULS_PER_FE_OPS = 2 + 265
SQS_PER_FE_OPS = 1 + 254

# 13-bit repack: limb j spans bytes 13j // 8 .. +2 at bit offset 13j % 8
_BYTE0 = (13 * np.arange(NLIMB)) // 8
_OFF = (13 * np.arange(NLIMB)) % 8


def bytes_to_limbs_np(b: np.ndarray) -> np.ndarray:
    """[..., 32] uint8 little-endian -> [..., 20] int32 exact limbs (all
    256 bits; a value >= p stays >= p)."""
    b = np.asarray(b, np.uint8).astype(np.int32)
    bp = np.concatenate([b, np.zeros(b.shape[:-1] + (2,), np.int32)], axis=-1)
    w = bp[..., _BYTE0] | (bp[..., _BYTE0 + 1] << 8) | (bp[..., _BYTE0 + 2] << 16)
    return np.ascontiguousarray((w >> _OFF) & MASK, dtype=np.int32)


def frozen_to_bytes(limbs) -> np.ndarray:
    """[..., 20] frozen (canonical) limbs -> [..., 32] uint8 little-endian."""
    a = np.asarray(limbs, np.int64)
    flat = a.reshape(-1, NLIMB)
    out = np.zeros((flat.shape[0], 32), np.uint8)
    for r, row in enumerate(flat):
        out[r] = np.frombuffer(limbs_to_int(row).to_bytes(32, "little"), np.uint8)
    return out.reshape(a.shape[:-1] + (32,))


# ---------------------------------------------------------------------------
# Plain PyTorch version (int32 tensors [..., 20]); mirrors
# txflow_tpu/ops/fe13.py and csrc/fe25519_13.cuh


def fe_carry(x: torch.Tensor, passes: int = 4) -> torch.Tensor:
    """Data-parallel carry passes with the 2^260 = 608 wraparound."""
    for _ in range(passes):
        hi = x >> RADIX
        lo = x & MASK
        x = lo + torch.cat([WRAP * hi[..., NLIMB - 1 :], hi[..., : NLIMB - 1]], -1)
    return x


def fe_add(a, b):
    """a + b, carried once: a normalized output for fe_mul."""
    return fe_carry(a + b, passes=1)


def fe_sub(a, b):
    """a - b mod p without a borrow (the 128 p offset); normalized."""
    off = torch.from_numpy(OFFSET_P_LIMBS).to(a.device)
    return fe_carry(a + off - b, passes=2)


# anti-diagonal plan of the 20 x 20 convolution: column k takes a[i] *
# b[k - i] for the valid i
_K = np.arange(2 * NLIMB - 1)
_I = np.arange(NLIMB)
_IDX = torch.from_numpy(np.clip(_K[None, :] - _I[:, None], 0, NLIMB - 1))
_VALID = torch.from_numpy((_K[None, :] - _I[:, None] >= 0) & (_K[None, :] - _I[:, None] < NLIMB))


def fe_mul(a, b):
    """a * b mod p. Inputs normalized (limbs <= 9408): the convolution's
    39 columns in int32, a 3-pass pre-carry of the high 19 (with a zero
    20th) before the x608 fold, then 4 carry passes."""
    idx, valid = _IDX.to(b.device), _VALID.to(b.device)
    bsh = torch.where(valid, b[..., idx], torch.zeros((), dtype=b.dtype, device=b.device))
    c = (a.unsqueeze(-1) * bsh).sum(-2, dtype=torch.int32)  # [..., 39]
    lo = c[..., :NLIMB]
    hi = torch.cat([c[..., NLIMB:], torch.zeros_like(c[..., :1])], -1)
    hi = fe_carry(hi, passes=3)
    return fe_carry(lo + WRAP * hi, passes=4)


def fe_sq(a):
    return fe_mul(a, a)


def fe_mul_small(a, c: int):
    """a * c for a small constant (c * 9408 < 2^31), carried."""
    assert c <= (1 << 17)
    return fe_carry(a * c)


def fe_freeze(x):
    """Exact canonical reduction: limbs in [0, 2^13) and value < p (JAX's
    steps: carry, fold bits >= 255 twice, two conditional subtractions of
    p, carry)."""
    x = fe_carry(x, passes=5)
    for _ in range(2):
        t = x[..., NLIMB - 1] >> 8
        x = x.clone()
        x[..., NLIMB - 1] &= 0xFF
        x[..., 0] += 19 * t
        x = fe_carry(x, passes=2)
    p = torch.from_numpy(P_LIMBS).to(x.device)
    for _ in range(2):
        diff = x - p
        borrows = []
        borrow = torch.zeros_like(x[..., 0])
        for i in range(NLIMB):
            d = diff[..., i] - borrow
            borrow = (d < 0).to(x.dtype)
            borrows.append(d + (borrow << RADIX))
        sub = torch.stack(borrows, -1)
        x = torch.where((borrow == 0).unsqueeze(-1), sub, x)
    return fe_carry(x, passes=2)


def _pow2k(x, k: int):
    for _ in range(k):
        x = fe_sq(x)
    return x


def fe_inv(z):
    """z^(p-2): the addition chain of txflow_tpu/ops/_fe_common.py:make_inv."""
    z2 = fe_sq(z)
    z9 = fe_mul(_pow2k(z2, 2), z)
    z11 = fe_mul(z9, z2)
    z2_5_0 = fe_mul(fe_sq(z11), z9)
    z2_10_0 = fe_mul(_pow2k(z2_5_0, 5), z2_5_0)
    z2_20_0 = fe_mul(_pow2k(z2_10_0, 10), z2_10_0)
    z2_40_0 = fe_mul(_pow2k(z2_20_0, 20), z2_20_0)
    z2_50_0 = fe_mul(_pow2k(z2_40_0, 10), z2_10_0)
    z2_100_0 = fe_mul(_pow2k(z2_50_0, 50), z2_50_0)
    z2_200_0 = fe_mul(_pow2k(z2_100_0, 100), z2_100_0)
    z2_250_0 = fe_mul(_pow2k(z2_200_0, 50), z2_50_0)
    return fe_mul(_pow2k(z2_250_0, 5), z11)


def fe_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 20] int32 exact limbs (the kernel's repack
    of R, JAX's ``bytes_to_limbs_device``)."""
    b = b.to(torch.int32)
    bp = torch.cat([b, torch.zeros(b.shape[:-1] + (2,), dtype=torch.int32, device=b.device)], -1)
    b0 = torch.from_numpy(_BYTE0).to(b.device)
    off = torch.from_numpy(_OFF.astype(np.int32)).to(b.device)
    w = bp[..., b0] | (bp[..., b0 + 1] << 8) | (bp[..., b0 + 2] << 16)
    return (w >> off) & MASK


def fe_equal(a, b):
    return (a == b).all(-1)


def fe_parity_frozen(a):
    return a[..., 0] & 1


def fe13_ops_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, 20] int32 inputs -> [n, 5, 20] int32: frozen mul(a, b), sq(a),
    sub(a, b), inv(a) and freeze(a)."""
    a, b = a.to(torch.int32), b.to(torch.int32)
    outs = [
        fe_freeze(fe_mul(a, b)),
        fe_freeze(fe_sq(a)),
        fe_freeze(fe_sub(a, b)),
        fe_freeze(fe_inv(a)),
        fe_freeze(a),
    ]
    return torch.stack(outs, -2)


def fe13_prod_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, 20] int32 normalized inputs (limbs in [0, ``NORM``]) -> [n, 3,
    20] int32 raw carried limbs, not frozen: fe_mul(a, b), fe_sq(a) and
    fe_mul_small(a, 2), the three products the verify kernels chain."""
    a, b = a.to(torch.int32), b.to(torch.int32)
    return torch.stack([fe_mul(a, b), fe_sq(a), fe_mul_small(a, 2)], -2)


def fe13_prod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K8's products alone, limb for limb: the C entry ``txf_fe_prod`` of
    library ``verify13`` on a card, its plain version on the CPU. a, b:
    int32 [n, 20] normalized limbs (``bound_edge_limbs`` gives the edges)."""
    if a.device.type == "cpu":
        return fe13_prod_plain(a, b)
    _lib.check_all((a, torch.int32, (-1, NLIMB), "a"), (b, torch.int32, (a.shape[0], NLIMB), "b"))
    out = torch.empty((a.shape[0], 3, NLIMB), dtype=torch.int32, device=a.device)
    _lib.launch(
        "fe13_prod", "txf_fe_prod", out, a.shape[0], a.data_ptr(), b.data_ptr(),
        out.data_ptr(), a.shape[0],
    )
    return out


EDGE_KINDS = ("max", "zero", "alternating", "normalized", "sums")


def bound_edge_limbs(rng: np.random.Generator, n: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """n pairs (a, b) of int32 [n, 20] normalized limb vectors (every limb
    in [0, ``NORM``]) of one kind: ``max`` (a all NORM; b all NORM in the
    first half, random normalized after), ``zero`` (a all 0, b likewise),
    ``alternating`` (NORM on even or odd limbs and 0 on the others, either
    phase; b of the same kind), ``normalized`` (uniform in [0, NORM]) and
    ``sums`` (fe_add and fe_sub of maximal or random normalized inputs,
    as the curve formulas feed them to a product)."""
    def normalized(m):
        return rng.integers(0, NORM + 1, (m, NLIMB))

    def edge_then_random(value):
        x = np.concatenate([np.full((n - n // 2, NLIMB), value), normalized(n // 2)])
        return np.full((n, NLIMB), value), x

    if kind == "max":
        a, b = edge_then_random(NORM)
    elif kind == "zero":
        a, b = edge_then_random(0)
    elif kind == "alternating":
        phase = np.arange(NLIMB) % 2

        def alt(m):
            odd = rng.integers(0, 2, (m, 1))
            return NORM * (phase[None, :] == odd)

        a, b = alt(n), alt(n)
    elif kind == "normalized":
        a, b = normalized(n), normalized(n)
    elif kind == "sums":
        def side():
            x = np.where(rng.integers(0, 2, (n, 1)) == 1, NORM, normalized(n))
            y = np.where(rng.integers(0, 2, (n, 1)) == 1, NORM, normalized(n))
            # row 0: all NORM plus a limb 0 that leaves 8191 and carries,
            # so fe_add's limb 0 is 8191 + 2 * 608 = 9407
            x[0], y[0] = NORM, NORM
            y[0, 0] = 2 * MASK + 1 - NORM
            x, y = torch.from_numpy(x.astype(np.int32)), torch.from_numpy(y.astype(np.int32))
            h = n // 2
            return torch.cat([fe_add(x[:h], y[:h]), fe_sub(x[h:], y[h:])]).numpy()

        a, b = side(), side()
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return np.ascontiguousarray(a, np.int32), np.ascontiguousarray(b, np.int32)


def fe13_ops(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K8 alone: the CUDA field kernel of library ``verify13`` on a card,
    its plain version on the CPU. a, b: int32 [n, 20] canonical limbs
    (each in [0, 2^13), as ``bytes_to_limbs_np`` gives)."""
    if a.device.type == "cpu":
        return fe13_ops_plain(a, b)
    _lib.check_all((a, torch.int32, (-1, NLIMB), "a"), (b, torch.int32, (a.shape[0], NLIMB), "b"))
    out = torch.empty((a.shape[0], 5, NLIMB), dtype=torch.int32, device=a.device)
    _lib.launch(
        "fe13_ops", "txf_fe_ops", out, a.shape[0], a.data_ptr(), b.data_ptr(),
        out.data_ptr(), a.shape[0],
    )
    return out
