"""GF(2^255-19) field arithmetic: host helpers, the plain PyTorch version,
and the wrapper of the CUDA field kernel (K1).

Counterpart of ``txflow_tpu/ops/fe.py`` + ``ops/_fe_common.py``. The
layout is the CUDA kernel's own, not the TPU's: ten signed limbs in radix
2^25.5 (ref10), limb ``i`` holding bits ``[OFF[i], OFF[i] + W[i])``. The
plain functions below take int64 tensors ``[..., 10]`` and run the same
operations in the same order as ``csrc/fe25519.cuh`` (same products, same
ref10 carry chain, same canonical freeze), so a CPU test of them checks
the kernel's arithmetic, bounds included: every intermediate fits int64
here and int32/int64 there exactly as documented in the header.

Frozen (canonical) limbs are the comparison point with the JAX package:
``frozen_to_bytes`` turns them into the 32 little-endian bytes that the
radix-2^8 frozen limbs of the JAX package are.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib

FE_RADIX = 25  # the name of this field in ``fe_radix`` arguments
TAG = ""  # suffix of this field's kernels in ``_lib.KERNELS``
NLIMB = 10
DTYPE = torch.int64  # the plain version's limb type
W = np.array([26, 25] * 5, dtype=np.int64)
OFF = np.array([(i >> 1) * 51 + (26 if i & 1 else 0) for i in range(NLIMB)])
MASK = (1 << W) - 1

P_INT = 2**255 - 19

# fe_mul's schedule: column k gets f[i] * g[(k - i) % 10] * FACTOR[i, k],
# where the factor is 2 for odd*odd limbs and 19 for wrapped columns.
_I = np.arange(NLIMB)[:, None]
_K = np.arange(NLIMB)[None, :]
_J = (_K - _I) % NLIMB
_MUL_IDX = torch.from_numpy(_J.astype(np.int64))
_MUL_FACTOR = torch.from_numpy(
    (np.where((_I & 1) & (_J & 1), 2, 1) * np.where(_I + _J >= NLIMB, 19, 1)).astype(
        np.int64
    )
)

# integer multiply-adds of one fe_mul in the CUDA kernel: the 10x10
# products plus the 2*f (odd limbs) and 19*g pre-scalings
MADS_PER_MUL = NLIMB * NLIMB + 5 + NLIMB


# ---------------------------------------------------------------------------
# Host helpers (python ints / numpy)


def int_to_limbs(x: int) -> np.ndarray:
    """Python int in [0, 2^255) -> canonical limb vector (int32 [10])."""
    return np.array([(x >> int(o)) & int(m) for o, m in zip(OFF, MASK)], np.int32)


def limbs_to_int(limbs) -> int:
    """Limb vector (any signed bounds) -> python int (not reduced)."""
    return sum(int(v) << int(o) for v, o in zip(np.asarray(limbs).tolist(), OFF))


def bytes_to_limbs_np(b: np.ndarray) -> np.ndarray:
    """[..., 32] uint8 little-endian -> [..., 10] int32 exact limbs of the
    low 255 bits (bit 255 dropped, no reduction mod p)."""
    b = np.asarray(b, np.uint8)
    padded = np.concatenate(
        [b.astype(np.uint64), np.zeros(b.shape[:-1] + (5,), np.uint64)], axis=-1
    )
    out = np.empty(b.shape[:-1] + (NLIMB,), np.int32)
    for i in range(NLIMB):
        byte, sh = int(OFF[i]) >> 3, int(OFF[i]) & 7
        v = np.zeros(b.shape[:-1], np.uint64)
        for k in range(5):
            v |= padded[..., byte + k] << np.uint64(8 * k)
        out[..., i] = ((v >> np.uint64(sh)) & np.uint64(MASK[i])).astype(np.int32)
    return out


def frozen_to_bytes(limbs) -> np.ndarray:
    """[..., 10] frozen (canonical) limbs -> [..., 32] uint8 little-endian."""
    a = np.asarray(limbs, np.int64)
    flat = a.reshape(-1, NLIMB)
    out = np.zeros((flat.shape[0], 32), np.uint8)
    for r, row in enumerate(flat):
        out[r] = np.frombuffer(limbs_to_int(row).to_bytes(32, "little"), np.uint8)
    return out.reshape(a.shape[:-1] + (32,))


# ---------------------------------------------------------------------------
# Plain PyTorch version (int64 tensors [..., 10]); mirrors csrc/fe25519.cuh


def _carry(h: torch.Tensor, i: int, w: int, step: int = 1) -> None:
    """Carry limb i into limb i + 1, in place; with ``step`` 4 the same
    for limb i + 4 at once (two carries that touch disjoint limbs)."""
    lo = h[..., i : i + step + 1 : step]
    hi = h[..., i + 1 : i + step + 2 : step]
    c = (lo + (1 << (w - 1))) >> w
    hi += c
    lo -= c << w


def fe_reduce(t: torch.Tensor) -> torch.Tensor:
    """ref10 carry chain over int64 column sums -> carried limbs. The
    chain's carries 0 and 4, 1 and 5, 2 and 6, 3 and 7, 4 and 8 touch
    disjoint limbs, so each pair runs as one operation: the same sums as
    the kernel's one-at-a-time chain."""
    h = t.clone()
    for i, w in ((0, 26), (1, 25), (2, 26), (3, 25), (4, 26)):
        _carry(h, i, w, step=4)
    c9 = (h[..., 9] + (1 << 24)) >> 25
    h[..., 0] += c9 * 19
    h[..., 9] -= c9 << 25
    _carry(h, 0, 26)
    return h


def fe_add(f, g):
    return f + g


def fe_sub(f, g):
    return f - g


def fe_mul(f, g):
    """f * g mod p; carried output (inputs within 3 carried units)."""
    idx = _MUL_IDX.to(g.device)
    gg = g[..., idx] * _MUL_FACTOR.to(g.device)  # [..., i, k]
    return fe_reduce((f.unsqueeze(-1) * gg).sum(-2))


def fe_sq(f):
    return fe_mul(f, f)


def fe_mul_small(f, c: int):
    return fe_reduce(f * c)


def fe_freeze(f):
    """Exact canonical reduction (ref10 fe_tobytes)."""
    h = list(f.unbind(-1))
    q = (19 * h[9] + (1 << 24)) >> 25
    for i in range(NLIMB):
        q = (h[i] + q) >> int(W[i])
    h[0] = h[0] + 19 * q
    for i in range(NLIMB - 1):
        w = int(W[i])
        c = h[i] >> w
        h[i + 1] = h[i + 1] + c
        h[i] = h[i] - (c << w)
    h[9] = h[9] - ((h[9] >> 25) << 25)
    return torch.stack(h, -1)


def _pow2k(x, k: int):
    for _ in range(k):
        x = fe_sq(x)
    return x


def fe_inv(z):
    """z^(p-2), the addition chain of csrc/fe25519.cuh:fe_inv."""
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


# mul, sq and the 265 of the inversion chain (the kernel's fe_ops work)
MULS_PER_FE_OPS = 2 + 265


def fe_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 10] int64 exact limbs of the low 255 bits."""
    b = b.to(torch.int64)
    pad = torch.zeros(b.shape[:-1] + (5,), dtype=torch.int64, device=b.device)
    b = torch.cat([b, pad], -1)
    out = []
    for i in range(NLIMB):
        byte, sh = int(OFF[i]) >> 3, int(OFF[i]) & 7
        v = b[..., byte]
        for k in range(1, 5):
            v = v | (b[..., byte + k] << (8 * k))
        out.append((v >> sh) & int(MASK[i]))
    return torch.stack(out, -1)


def fe_equal(a, b):
    return (a == b).all(-1)


def fe_parity_frozen(a):
    return a[..., 0] & 1


def fe_ops_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, 10] int32 inputs -> [n, 5, 10] int32: frozen mul(a, b), sq(a),
    sub(a, b), inv(a) and freeze(a)."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    outs = [
        fe_freeze(fe_mul(a64, b64)),
        fe_freeze(fe_sq(a64)),
        fe_freeze(fe_sub(a64, b64)),
        fe_freeze(fe_inv(a64)),
        fe_freeze(a64),
    ]
    return torch.stack(outs, -2).to(torch.int32)


def fe_ops(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 alone: the CUDA field kernel on a card, its plain version on the
    CPU. a, b: int32 [n, 10] limbs (each limb within the canonical range,
    as ``bytes_to_limbs_np`` gives)."""
    if a.device.type == "cpu":
        return fe_ops_plain(a, b)
    _lib.check(a, torch.int32, (-1, NLIMB), "a")
    _lib.check(b, torch.int32, (a.shape[0], NLIMB), "b")
    out = torch.empty((a.shape[0], 5, NLIMB), dtype=torch.int32, device=a.device)
    _lib.launch(
        "fe_ops", "txf_fe_ops", out, a.shape[0], a.data_ptr(), b.data_ptr(),
        out.data_ptr(), a.shape[0],
    )
    return out
