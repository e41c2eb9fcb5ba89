"""Batched ed25519 verification: host epoch tables and batch prep, the
plain PyTorch versions of the verify kernels, and their CUDA wrappers:
K3 over device-resident epoch tables (the compact path; four lanes a
signature, one per 64-bit quarter of the scalars) and K5 over one
gathered -A table per vote (``verify_kernel``, ``verify_batch``; four
lanes a signature, one per coordinate of the accumulator).

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
    # seconds the preparing thread waited on host-pool shards it did not
    # run (0.0 on the serial path): accounting, not part of the batch
    pool_wait_s: float = 0.0

    @property
    def size(self) -> int:
        return self.s_nibbles.shape[0]


# below this many rows a pooled prep loses to its own shard bookkeeping
POOL_MIN_ROWS = 256


def prepare_compact(
    msgs: list[bytes], sigs: list[bytes], val_idx: np.ndarray, epoch: EpochTables,
    pool=None,
) -> CompactBatch:
    """Host prep: msgs[i] signed by validator val_idx[i] with sigs[i].

    ``pool`` (``engine/hostprep.py``) shards the rows contiguously over
    its workers from ``POOL_MIN_ROWS`` rows: worker processes over shared
    memory for the process backend, ``map_shards`` for the thread one.
    Every row is prepared alone by the same row function, so the result
    is byte-identical to the serial prep (as
    ``txflow_tpu/ops/ed25519_batch.py:210``)."""
    n = len(msgs)
    vi = np.asarray(val_idx, dtype=np.int64)
    if pool is not None and n >= POOL_MIN_ROWS:
        if pool.backend == "process":
            return CompactBatch(*pool.prepare_compact_shm(msgs, sigs, vi, epoch))

        def shard(lo: int, hi: int) -> CompactBatch:
            return prepare_compact(msgs[lo:hi], sigs[lo:hi], vi[lo:hi], epoch)

        parts, wait_s = pool.map_shards(n, shard)
        return CompactBatch(
            *(np.concatenate([getattr(p, f) for p in parts]) for f in (
                "s_nibbles", "h_nibbles", "val_idx", "r_y", "r_sign", "pre_ok")),
            pool_wait_s=wait_s,
        )
    msg_cat, offs = prep.cat_msgs(msgs)
    sig_arr, sig_ok = prep.cat_sigs(sigs)
    return CompactBatch(
        *prep.prep_rows_cat(msg_cat, offs, sig_arr, sig_ok, vi, epoch.pub_arr, epoch.key_ok)
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
    (int32 [B, 16, 4, NLIMB]), by the kernel's coordinate split
    (``curve.double_scalar_mul_lanes``); only the rows whose host
    pre-checks passed are computed, as in the kernel."""
    pre_ok = pre_ok.to(torch.bool)
    rows = pre_ok.nonzero().squeeze(-1)
    out = torch.zeros_like(pre_ok)
    if rows.numel() == 0:  # padding only: nothing to compute
        return out
    y, parity = curve.ext_encode(
        curve.double_scalar_mul_lanes(
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
    tensors take the plain version. One call is two kernel launches (the
    coordinate split, four lanes a row, then ``txf_verify_encode_kernel``
    one thread a row), counted as one in ``_lib.launches``; the base table
    is the card's cached copy (quarter 0 of
    ``curve.device_base_quarters``)."""
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
    base = curve.device_base_quarters(s_nibbles.device, fe_radix)
    # one scratch: each row's [S]B + [h](-A) (X, Y, Z) between the two
    # launches, then the validity
    scratch = torch.empty((n * (3 * F.NLIMB + 1),), dtype=torch.int32, device=s_nibbles.device)
    out = scratch[n * 3 * F.NLIMB:]
    _lib.launch(
        "verify_tables" + F.TAG, "txf_verify_tables", out, n, s_nibbles.data_ptr(),
        h_nibbles.data_ptr(), a_tables.data_ptr(), base.data_ptr(), r_y.data_ptr(),
        r_sign.data_ptr(), pre_ok.data_ptr(), scratch.data_ptr(), out.data_ptr(), n,
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


def _verify_specs(s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y, r_sign, pre_ok,
                  F) -> list:
    """The ``check_all`` specs of the four-lane verify's inputs (``F`` the
    field's module)."""
    n = s_nibbles.shape[0]
    return [
        (s_nibbles, torch.uint8, (n, curve.NWINDOWS), "s_nibbles"),
        (h_nibbles, torch.uint8, (n, curve.NWINDOWS), "h_nibbles"),
        (val_idx, torch.int32, (n,), "val_idx"),
        (tables, torch.int32, (-1, curve.TABLE_SIZE, 4, F.NLIMB), "tables"),
        (quarter_tables, torch.int32,
         (tables.shape[0], curve.QUARTERS - 1, curve.TABLE_SIZE, 4, F.NLIMB), "quarter_tables"),
        (r_y, torch.uint8, (n, 32), "r_y"),
        (r_sign, torch.uint8, (n,), "r_sign"),
        (pre_ok, torch.bool, (n,), "pre_ok"),
    ]


def verify_into(out, s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y, r_sign,
                pre_ok, fe_radix: int = 25):
    """Launch the four-lane CUDA verify kernel of the ``fe_radix`` field's
    library writing int32 0/1 validity into ``out`` (an int32 [B] CUDA
    tensor). ``tables`` int32 [V, 16, 4, NLIMB] and ``quarter_tables``
    int32 [V, 3, 16, 4, NLIMB] are an epoch's (``EpochTables``); the base
    point's quarter tables are the card's cached copy
    (``curve.device_base_quarters``). One call is two kernel launches
    (``txf_verify_kernel``, then ``txf_verify_encode_kernel``), counted as
    one in ``_lib.launches``. The verify alone: the committee path (K6);
    the served step carries its tally in the same launches
    (``verify_tally_into``)."""
    F = field.ops(fe_radix)
    n = s_nibbles.shape[0]
    _lib.check_all(*_verify_specs(s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y,
                                  r_sign, pre_ok, F), (out, torch.int32, (n,), "out"))
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


def verify_tally_into(packed, s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y,
                      r_sign, pre_ok, tx_slot, powers, prior=None, quorum: int = 0,
                      partial=None, fe_radix: int = 25):
    """The fused step on a card: the four-lane verify of ``verify_into``
    writing the head of ``packed`` (int32 ``[valid (B) | stake (S, or 2S
    int64 words) | maj23 (S)]``), whose encode launch also tallies each
    valid row's power (``powers[clamp(val_idx)]``, int32 or int64 [V], V
    the tables' count) into its ``tx_slot`` (slots outside [0, S) add
    nothing). One ctypes call, two kernel launches (``txf_verify_tally``,
    or ``txf_verify_tally64`` for int64 powers), counted under
    ``verify[13]_tally[64]`` or ``verify[13]_partial[64]``.

    The quorum form (``partial`` None): the sums start at ``prior`` and
    the launch's last block writes the stake and maj23 segments of
    ``packed``. The partial form: ``partial`` [S] of the powers' dtype
    starts at 0 and ends holding the shard's sums; only the head of
    ``packed`` is written. Scratch (the rows' points, the int64 sums, the
    call's completion counter) is one allocation per call."""
    F = field.ops(fe_radix)
    n, wide = s_nibbles.shape[0], powers.dtype == torch.int64
    acc_t = torch.int64 if wide else torch.int32
    quorum_form = partial is None
    s = (prior if quorum_form else partial).shape[0]
    specs = _verify_specs(s_nibbles, h_nibbles, val_idx, tables, quarter_tables, r_y, r_sign,
                          pre_ok, F)
    specs += [(packed, torch.int32, (n + (3 if wide else 2) * s,), "packed"),
              (tx_slot, torch.int32, (n,), "tx_slot"),
              (powers, acc_t, (tables.shape[0],), "powers"),
              (prior, acc_t, (s,), "prior") if quorum_form else (partial, acc_t, (s,), "partial")]
    _lib.check_all(*specs)
    if tables.shape[0] == 0:
        raise ValueError("tables: empty validator set")
    base = curve.device_base_quarters(packed.device, fe_radix)
    # one scratch: the points [n, 3, NLIMB] (an even count of words), the
    # int64 sums of the wide quorum form (8-byte aligned after them), the
    # completion counter
    pts = n * 3 * F.NLIMB
    sums = 2 * s if wide and quorum_form else 0
    scratch = torch.empty((pts + sums + 2,), dtype=torch.int32, device=packed.device)
    sp, pp = scratch.data_ptr(), packed.data_ptr()
    stake = pp + 4 * n  # the packed segments, by byte offset
    maj = stake + 4 * (2 * s if wide else s)
    head = (s_nibbles.data_ptr(), h_nibbles.data_ptr(), val_idx.data_ptr(), tables.data_ptr(),
            quarter_tables.data_ptr(), tables.shape[0], base.data_ptr(), r_y.data_ptr(),
            r_sign.data_ptr(), pre_ok.data_ptr(), sp, pp, tx_slot.data_ptr(), powers.data_ptr())
    if quorum_form:  # the int64 sums in the scratch after the points; the counter last
        form, prior_p, maj_p, done = "_tally", prior.data_ptr(), maj, sp + 4 * (pts + sums)
        acc, words = (sp + 4 * pts, stake) if wide else (stake, None)
    else:
        form, prior_p, maj_p, done = "_partial", None, None, None
        acc, words = partial.data_ptr(), None
    tail = (acc, words, maj_p, done) if wide else (acc, maj_p, done)
    _lib.launch("verify" + F.TAG + form + ("64" if wide else ""),
                "txf_verify_tally64" if wide else "txf_verify_tally", packed, n + s, *head,
                prior_p, int(quorum), *tail, n, s)


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


def mads_per_signature(fe_radix: int = 25, four_lanes: bool = True, sq_as_mul: bool = False) -> int:
    """Integer multiply-adds of one signature that passed the host
    pre-checks (rows that failed them return at once): the four-lane
    ``txf_verify`` (K3, K6, by scalar quarter) by default; with
    ``four_lanes=False`` the one-lane count (``curve.MULS_PER_DSM_ENCODE``),
    the yardstick of the bound of ``txf_verify_tables`` (K5) and
    ``txf_dsm_encode`` (K2). Those two split each formula over four lanes
    by coordinate and issue ``curve.MULS_PER_COORD_DSM_ENCODE`` products,
    a lane's chain ``curve.MULS_CHAIN_COORD_DSM_ENCODE``; their bound keeps
    the one-lane count, so that times before and after that redesign read
    against one yardstick. Squarings cost the field's ``MADS_PER_SQ``, or
    with ``sq_as_mul`` a full product (``field.mads``)."""
    if four_lanes:
        muls, sqs = curve.MULS_PER_QUARTER_DSM_ENCODE, curve.SQS_PER_QUARTER_DSM_ENCODE
    else:
        muls, sqs = curve.MULS_PER_DSM_ENCODE, curve.SQS_PER_DSM_ENCODE
    return field.mads(fe_radix, muls, sqs, sq_as_mul)
