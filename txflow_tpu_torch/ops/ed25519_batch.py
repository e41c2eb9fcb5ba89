"""Batched ed25519 verification: host epoch tables and batch prep, the
plain PyTorch versions of the verify kernels, and their CUDA wrappers:
K3 over device-resident epoch tables (the compact path; four lanes a
signature, one per 64-bit quarter of the scalars) and K5 over one
gathered -A table per vote (``verify_kernel``, ``verify_batch``; one
thread a signature).

Counterpart of ``txflow_tpu/ops/ed25519_batch.py``. The host does the
byte work (S < L, SHA-512 mod L, nibbles, pubkey decompression and the
window tables of -A and of its three scalar quarters per validator per
epoch); the device computes
P = [S]B + [h](-A) and compares encode(P) with R. Decisions are
bit-identical to ``crypto.ed25519.verify_pure``, over either field
(``ops/field.py``): tables are built in the limbs of the epoch's field
(``EpochTables(fe_radix=)``), and every verify function takes
``fe_radix`` and launches the kernel of that field's verify library.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..crypto import ed25519 as host_ed
from .. import prep
from . import _lib, curve, field


def neg_pubkey_point(pub_key: bytes):
    """(-A as an extended point, ok) for one pubkey; an off-curve key gives
    the identity and ok=False (its votes are rejected by pre_ok)."""
    A = host_ed.point_decompress(pub_key)
    if A is None:
        return host_ed.IDENTITY, False
    return host_ed.point_neg(A), True


class EpochTables:
    """Per-validator-set-epoch constants in the limbs of the field
    ``fe_radix`` (25 or 13; None reads ``TXFLOW_FE_RADIX`` now, see
    ``ops/field.py``): one window table of -A per validator (``tables``,
    [V, 16, 4, NLIMB], the JAX package's layout) and the tables of the
    scalar quarters 1-3 (``quarter_tables``, [V, 3, 16, 4, NLIMB], entry
    [v, j-1, k] = k * 2^(64j) * (-A_v)) that the four-lane verify kernel
    reads beside them; an off-curve key gets identity tables. Uploaded to
    a device once by ``device_tables`` and ``device_quarter_tables``."""

    def __init__(self, pub_keys: list[bytes], fe_radix: int | None = None):
        self.fe_radix = field.resolve(fe_radix)
        nlimb = field.ops(self.fe_radix).NLIMB
        # one build per distinct key (a padded set repeats its pad key)
        uniq: dict[bytes, int] = {}
        points, oks, rows = [], [], []
        for pk in pub_keys:
            if pk not in uniq:
                uniq[pk] = len(points)
                pt, ok = neg_pubkey_point(pk)
                points.append(pt)
                oks.append(ok)
            rows.append(uniq[pk])
        quarters = (curve.build_quarter_tables(points, self.fe_radix)[rows]
                    if points else np.zeros((0, curve.QUARTERS, curve.TABLE_SIZE, 4, nlimb),
                                            np.int32))
        self.pub_keys = list(pub_keys)
        self.tables = np.ascontiguousarray(quarters[:, 0])
        self.quarter_tables = np.ascontiguousarray(quarters[:, 1:])
        self.key_ok = np.array([oks[r] for r in rows], dtype=bool)
        # [V, 32] key bytes for the per-vote hash; a malformed key length
        # (already key_ok False) gets a zero row so later rows stay aligned
        self.pub_arr = (
            np.frombuffer(
                b"".join(pk if len(pk) == 32 else bytes(32) for pk in pub_keys),
                np.uint8,
            )
            .reshape(-1, 32)
            .copy()
            if pub_keys
            else np.zeros((0, 32), np.uint8)
        )
        self._device_tables: dict[str, torch.Tensor] = {}
        self._device_quarters: dict[str, torch.Tensor] = {}

    def device_tables(self, device) -> torch.Tensor:
        """The tables as an int32 [V, 16, 4, NLIMB] tensor on ``device``,
        uploaded once per device and cached."""
        key = str(torch.device(device))
        t = self._device_tables.get(key)
        if t is None:
            t = torch.from_numpy(self.tables).to(device)
            self._device_tables[key] = t
        return t

    def device_quarter_tables(self, device) -> torch.Tensor:
        """The quarter tables as an int32 [V, 3, 16, 4, NLIMB] tensor on
        ``device``, uploaded once per device and cached."""
        key = str(torch.device(device))
        t = self._device_quarters.get(key)
        if t is None:
            t = torch.from_numpy(self.quarter_tables).to(device)
            self._device_quarters[key] = t
        return t


@dataclass
class CompactBatch:
    """Host-prepared compact device inputs for a batch of B checks."""

    s_nibbles: np.ndarray  # [B, 64] uint8, MSB-first nibbles of S
    h_nibbles: np.ndarray  # [B, 64] uint8, MSB-first nibbles of h mod L
    val_idx: np.ndarray  # [B] int32 validator index (clipped)
    r_y: np.ndarray  # [B, 32] uint8 low 255 bits of sig[:32]
    r_sign: np.ndarray  # [B] uint8 bit 255 of sig[:32]
    pre_ok: np.ndarray  # [B] bool host pre-checks passed

    @property
    def size(self) -> int:
        return self.s_nibbles.shape[0]


def prepare_compact(
    msgs: list[bytes], sigs: list[bytes], val_idx: np.ndarray, epoch: EpochTables
) -> CompactBatch:
    """Host prep: msgs[i] signed by validator val_idx[i] with sigs[i]."""
    msg_cat, offs = prep.cat_msgs(msgs)
    sig_arr, sig_ok = prep.cat_sigs(sigs)
    return CompactBatch(
        *prep.prep_rows_cat(
            msg_cat, offs, sig_arr, sig_ok,
            np.asarray(val_idx, dtype=np.int64), epoch.pub_arr, epoch.key_ok,
        )
    )


@dataclass
class PreparedBatch:
    """Host-prepared inputs of the gathered-table verify (K5) for B checks:
    the compact batch's fields with the -A window table of each vote's
    validator gathered per vote instead of its index."""

    s_nibbles: np.ndarray  # [B, 64] uint8, MSB-first nibbles of S
    h_nibbles: np.ndarray  # [B, 64] uint8, MSB-first nibbles of h mod L
    a_tables: np.ndarray  # [B, 16, 4, NLIMB] int32 window table of -A per vote
    r_y: np.ndarray  # [B, 32] uint8 low 255 bits of sig[:32]
    r_sign: np.ndarray  # [B] uint8 bit 255 of sig[:32]
    pre_ok: np.ndarray  # [B] bool host pre-checks passed

    @property
    def size(self) -> int:
        return self.s_nibbles.shape[0]


def prepare_batch(
    msgs: list[bytes], sigs: list[bytes], val_idx: np.ndarray, epoch: EpochTables
) -> PreparedBatch:
    """Host prep for K5: the compact prep, then each vote's table gathered
    from the epoch, in the epoch's field (an index outside the set clips
    into it; its pre_ok is False already)."""
    c = prepare_compact(msgs, sigs, val_idx, epoch)
    if len(epoch.pub_keys):
        a_tables = epoch.tables[c.val_idx]
    else:
        a_tables = np.zeros((c.size,) + epoch.tables.shape[1:], np.int32)
    return PreparedBatch(c.s_nibbles, c.h_nibbles, a_tables, c.r_y, c.r_sign, c.pre_ok)


def _match_r(y, parity, r_y, r_sign, fe_radix: int = 25):
    """encode(P) == R on raw bytes: y limbs equal the low 255 bits exactly
    (a non-canonical R never matches) and the sign bit agrees."""
    F = field.ops(fe_radix)
    return F.fe_equal(y.to(F.DTYPE), F.fe_from_bytes(r_y)) & (
        parity == r_sign.to(torch.int32)
    )


def verify_kernel_plain(s_nibbles, h_nibbles, a_tables, r_y, r_sign, pre_ok,
                        fe_radix: int = 25):
    """Plain version of the K5 kernel: bool [B] over per-vote tables
    (int32 [B, 16, 4, NLIMB]); only the rows whose host pre-checks passed
    are computed, as in the kernel."""
    pre_ok = pre_ok.to(torch.bool)
    rows = pre_ok.nonzero().squeeze(-1)
    out = torch.zeros_like(pre_ok)
    if rows.numel() == 0:  # padding only: nothing to compute
        return out
    y, parity = curve.ext_encode(
        curve.double_scalar_mul(
            s_nibbles[rows], h_nibbles[rows], curve.base_table(a_tables.device, fe_radix),
            a_tables[rows], fe_radix,
        ),
        fe_radix,
    )
    out[rows] = _match_r(y, parity.to(torch.int32), r_y[rows], r_sign[rows], fe_radix)
    return out


def verify_kernel(s_nibbles, h_nibbles, a_tables, r_y, r_sign, pre_ok,
                  fe_radix: int = 25) -> torch.Tensor:
    """K5: bool [B] of Go-equivalent signature validity, each vote checked
    against its own gathered -A table (int32 [B, 16, 4, NLIMB] of the
    ``fe_radix`` field). The CUDA kernel runs for CUDA tensors; CPU
    tensors take the plain version."""
    if s_nibbles.device.type == "cpu":
        return verify_kernel_plain(s_nibbles, h_nibbles, a_tables, r_y, r_sign, pre_ok,
                                   fe_radix)
    F = field.ops(fe_radix)
    n = s_nibbles.shape[0]
    _lib.check_all(
        (s_nibbles, torch.uint8, (n, curve.NWINDOWS), "s_nibbles"),
        (h_nibbles, torch.uint8, (n, curve.NWINDOWS), "h_nibbles"),
        (a_tables, torch.int32, (n, curve.TABLE_SIZE, 4, F.NLIMB), "a_tables"),
        (r_y, torch.uint8, (n, 32), "r_y"),
        (r_sign, torch.uint8, (n,), "r_sign"),
        (pre_ok, torch.bool, (n,), "pre_ok"),
    )
    out = torch.empty((n,), dtype=torch.int32, device=s_nibbles.device)
    _lib.launch(
        "verify_tables" + F.TAG, "txf_verify_tables", out, n, s_nibbles.data_ptr(),
        h_nibbles.data_ptr(), a_tables.data_ptr(), r_y.data_ptr(),
        r_sign.data_ptr(), pre_ok.data_ptr(), out.data_ptr(), n,
    )
    return out.to(torch.bool)


def verify_batch(batch: PreparedBatch, device=None, fe_radix: int = 25) -> np.ndarray:
    """Host API: prepared batch (tables in the ``fe_radix`` field) -> bool
    [B] validity by K5 on ``device`` (CUDA unless the caller asks for the
    CPU)."""
    from ..verifier import resolve_device

    dev = resolve_device(device)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return verify_kernel(
        T(batch.s_nibbles), T(batch.h_nibbles), T(batch.a_tables),
        T(batch.r_y), T(batch.r_sign), T(batch.pre_ok), fe_radix=fe_radix,
    ).cpu().numpy()


def verify_kernel_gather_plain(
    s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y, r_sign, pre_ok,
    fe_radix: int = 25,
) -> torch.Tensor:
    """Plain version of the four-lane verify kernel: bool [B], by the same
    quarter split, combine rounds and encode
    (``curve.double_scalar_mul_quarters``). Like the kernel, it computes
    only the rows whose host pre-checks passed."""
    pre_ok = pre_ok.to(torch.bool)
    rows = pre_ok.nonzero().squeeze(-1)
    out = torch.zeros_like(pre_ok)
    if rows.numel() == 0:  # padding only: nothing to compute
        return out
    base = torch.from_numpy(curve.BASE_QUARTER_TABLES[fe_radix]).to(tables.device)
    y, parity = curve.ext_encode(
        curve.double_scalar_mul_quarters(
            s_nibbles[rows], h_nibbles[rows], base, tables, quarter_tables, val_idx[rows],
            fe_radix,
        ),
        fe_radix,
    )
    out[rows] = _match_r(y, parity.to(torch.int32), r_y[rows], r_sign[rows], fe_radix)
    return out


def verify_into(out, s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y, r_sign,
                pre_ok, fe_radix: int = 25):
    """Launch the four-lane CUDA verify kernel of the ``fe_radix`` field's
    library writing int32 0/1 validity into ``out`` (an int32 [B] CUDA
    tensor, e.g. the head of the packed readback). ``tables`` int32
    [V, 16, 4, NLIMB] and ``quarter_tables`` int32 [V, 3, 16, 4, NLIMB]
    are an epoch's (``EpochTables``); the base point's quarter tables are
    the card's cached copy (``curve.device_base_quarters``). One call is
    two kernel launches (``txf_verify_kernel``, then
    ``txf_verify_encode_kernel``), counted as one in ``_lib.launches``."""
    F = field.ops(fe_radix)
    n = s_nibbles.shape[0]
    _lib.check_all(
        (s_nibbles, torch.uint8, (n, curve.NWINDOWS), "s_nibbles"),
        (h_nibbles, torch.uint8, (n, curve.NWINDOWS), "h_nibbles"),
        (val_idx, torch.int32, (n,), "val_idx"),
        (tables, torch.int32, (-1, curve.TABLE_SIZE, 4, F.NLIMB), "tables"),
        (quarter_tables, torch.int32,
         (tables.shape[0], curve.QUARTERS - 1, curve.TABLE_SIZE, 4, F.NLIMB), "quarter_tables"),
        (r_y, torch.uint8, (n, 32), "r_y"),
        (r_sign, torch.uint8, (n,), "r_sign"),
        (pre_ok, torch.bool, (n,), "pre_ok"),
        (out, torch.int32, (n,), "out"),
    )
    if tables.shape[0] == 0:
        raise ValueError("tables: empty validator set")
    base = curve.device_base_quarters(out.device, fe_radix)
    # each row's [S]B + [h](-A) between the kernel's two launches
    points = torch.empty((n, 3, F.NLIMB), dtype=torch.int32, device=out.device)
    _lib.launch(
        "verify" + F.TAG, "txf_verify", out, n, s_nibbles.data_ptr(), h_nibbles.data_ptr(),
        val_idx.data_ptr(), tables.data_ptr(), quarter_tables.data_ptr(), tables.shape[0],
        base.data_ptr(), r_y.data_ptr(), r_sign.data_ptr(), pre_ok.data_ptr(),
        points.data_ptr(), out.data_ptr(), n,
    )


def verify_kernel_gather(
    s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y, r_sign, pre_ok,
    fe_radix: int = 25,
) -> torch.Tensor:
    """bool [B] of Go-equivalent signature validity over device-resident
    epoch tables (int32 [V, 16, 4, NLIMB] and their quarter tables
    [V, 3, 16, 4, NLIMB], of the ``fe_radix`` field). The CUDA kernel
    runs for CUDA tensors; CPU tensors take the plain version."""
    if s_nibbles.device.type == "cpu":
        return verify_kernel_gather_plain(
            s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y, r_sign, pre_ok,
            fe_radix,
        )
    out = torch.empty(
        (s_nibbles.shape[0],), dtype=torch.int32, device=s_nibbles.device
    )
    verify_into(out, s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y, r_sign,
                pre_ok, fe_radix=fe_radix)
    return out.to(torch.bool)


def mads_per_signature(fe_radix: int = 25, four_lanes: bool = True) -> int:
    """Integer multiply-adds a verify kernel of the field spends on one
    signature that passed the host pre-checks (rows that failed them
    return at once): the four-lane ``txf_verify`` (K3, K6) by default, the
    one-lane body of ``txf_verify_tables`` (K5) and ``txf_dsm_encode``
    with ``four_lanes=False``."""
    muls = curve.MULS_PER_QUARTER_DSM_ENCODE if four_lanes else curve.MULS_PER_DSM_ENCODE
    return muls * field.ops(fe_radix).MADS_PER_MUL
