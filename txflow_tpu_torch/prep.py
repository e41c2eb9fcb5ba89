"""Host prep of a compact verify batch, and the worker half of the process
host-prep pool (numpy; counterpart of ``txflow_tpu/prep_proc.py``, the
worker half its lines 233-380).

Per vote: the S < L check ("ScMinimal"), SHA-512(R || A || msg) mod L,
both scalars as MSB-first nibbles, the R bytes split into low 255 bits and
sign bit, and the clipped validator index. Rows that fail a pre-check stay
all-zero with ``pre_ok`` False, exactly as in the JAX package, so the two
packages hand their kernels byte-identical inputs.

Worker processes (``engine/hostprep.py:ProcHostPrepPool``) import this
module alone: numpy, hashlib and the port's amino codec, never torch (a
worker that imports torch pays seconds at spawn; one that touched CUDA
would break). Per call the parent packs the inputs back to back into one
shared-memory segment and allocates one output segment; each shard
descriptor names both segments and an (offset, dtype, shape) table, and
the worker writes rows ``[lo, hi)`` of the outputs in place with the same
row function the parent uses, so shards assemble byte-identical to a
serial prep.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from .codec.amino import canonical_sign_bytes

# ed25519 group order (crypto.ed25519.L)
L = 2**252 + 27742317777372353535851937790883648493

_L_BE = np.frombuffer(L.to_bytes(32, "big"), np.uint8)

ZERO64 = bytes(64)


def nibbles_from_le_bytes(b: np.ndarray) -> np.ndarray:
    """[B, 32] little-endian uint8 scalars -> [B, 64] MSB-first nibbles."""
    rev = b[:, ::-1]
    out = np.empty((b.shape[0], 64), np.uint8)
    out[:, 0::2] = rev >> 4
    out[:, 1::2] = rev & 15
    return out


def cat_msgs(msgs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Concatenated-bytes form of a message list: (msg_cat u8, offs i64)."""
    n = len(msgs)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter((len(m) for m in msgs), np.int64, n), out=offs[1:])
    msg_cat = np.frombuffer(b"".join(msgs), np.uint8) if n else np.zeros(0, np.uint8)
    return msg_cat, offs


def cat_sigs(sigs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """([n, 64] u8 signature rows, [n] bool length-ok mask).

    Wrong-length signatures become zero rows, so the mask MUST travel with
    the rows: a zero row alone is indistinguishable from an adversarial
    genuinely-all-zero 64-byte signature, which the serial prep treats as
    length-OK (S=0 passes ScMinimal and the hash runs over R=0) — byte
    parity of ``pre_ok``/``h_nibbles`` depends on keeping the two apart.
    """
    n = len(sigs)
    len_ok = np.fromiter((len(s) == 64 for s in sigs), bool, n)
    sig_cat = (
        b"".join(sigs)
        if bool(len_ok.all())
        else b"".join(s if len(s) == 64 else ZERO64 for s in sigs)
    )
    arr = (
        np.frombuffer(sig_cat, np.uint8).reshape(n, 64)
        if n
        else np.zeros((0, 64), np.uint8)
    )
    return arr, len_ok


def prep_rows_cat(
    msg_cat: np.ndarray,
    offs: np.ndarray,
    sig_arr: np.ndarray,
    sig_ok: np.ndarray,
    vi: np.ndarray,
    pub_arr: np.ndarray,
    key_ok: np.ndarray,
    lo: int = 0,
    hi: int | None = None,
) -> tuple[np.ndarray, ...]:
    """Compact ed25519 prep over rows ``[lo, hi)`` of the cat-form batch.

    Returns
    ``(s_nib u8[m,64], h_nib u8[m,64], vidx i32[m], r_y u8[m,32],
    r_sign u8[m], pre_ok bool[m])`` for the ``m = hi - lo`` rows.

    Row semantics (pinned against ``_prepare_compact_py``): a row fails
    pre-check — and stays all-zero — on unknown validator index, bad
    signature length (zero row in ``sig_arr``; the packer zeroed it),
    off-curve/malformed key (``key_ok`` False) or non-minimal S; the
    SHA-512 + mod-L reduction runs only over surviving rows.
    """
    n = int(sig_arr.shape[0])
    if hi is None:
        hi = n
    lo = max(0, int(lo))
    hi = min(n, int(hi))
    m = hi - lo
    n_vals = int(pub_arr.shape[0])
    vi = np.asarray(vi, dtype=np.int64)[lo:hi]
    sig_all = np.ascontiguousarray(sig_arr[lo:hi])
    clipped = np.clip(vi, 0, max(n_vals - 1, 0))
    ok = (vi >= 0) & (vi < n_vals) & np.asarray(sig_ok, bool)[lo:hi]
    if n_vals:
        ok &= np.asarray(key_ok, bool)[clipped]
    else:
        ok &= False
    # ScMinimal (S < L), vectorized: compare big-endian byte rows
    # lexicographically — sign of the first differing byte decides
    s_be = sig_all[:, :31:-1]  # bytes 63..32: S, most-significant first
    diff = s_be.astype(np.int16) - _L_BE.astype(np.int16)
    nz = diff != 0
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), 31)
    ok &= np.take_along_axis(diff, first[:, None], 1)[:, 0] < 0
    s_le = np.where(ok[:, None], sig_all[:, 32:], 0).astype(np.uint8)
    h_le = np.zeros((m, 32), np.uint8)
    sha512 = hashlib.sha512
    offs = np.asarray(offs, dtype=np.int64)
    mc = msg_cat
    for i in np.flatnonzero(ok):
        gi = lo + i
        sig_r = sig_all[i, :32].tobytes()
        pub = pub_arr[clipped[i]].tobytes()
        msg = mc[offs[gi] : offs[gi + 1]].tobytes()
        h = int.from_bytes(sha512(sig_r + pub + msg).digest(), "little") % L
        h_le[i] = np.frombuffer(h.to_bytes(32, "little"), np.uint8)
    # failed rows stay all-zero, matching the per-row oracle
    r_y = np.where(ok[:, None], sig_all[:, :32], 0).astype(np.uint8)
    r_sign = (r_y[:, 31] >> 7).astype(np.uint8)
    r_y[:, 31] &= 0x7F
    return (
        nibbles_from_le_bytes(s_le),
        nibbles_from_le_bytes(h_le),
        clipped.astype(np.int32),
        r_y,
        r_sign,
        ok,
    )


def sign_rows(heights, ts_ns, hash_cat, hash_offs, chain_id: str, lo: int, hi: int,
              out: np.ndarray, out_len: np.ndarray) -> None:
    """Canonical sign bytes of rows ``[lo, hi)`` into fixed-stride rows of
    ``out`` (lengths in ``out_len``): the worker's twin of
    ``types.tx_vote.sign_bytes_many`` (one encoder, ``codec.amino``)."""
    for i in range(lo, hi):
        tx_hash = hash_cat[hash_offs[i] : hash_offs[i + 1]].tobytes().decode()
        row = np.frombuffer(
            canonical_sign_bytes(chain_id, int(heights[i]), tx_hash, int(ts_ns[i])), np.uint8
        )
        out[i, : len(row)] = row
        out_len[i] = len(row)


def sign_bytes_stride(max_hash_len: int, chain_id: str) -> int:
    """Upper bound on one sign-bytes row: the fixed fields and varint
    headroom over the hash and chain-id bytes."""
    return 80 + int(max_hash_len) + len(chain_id.encode())


def pack_layout(arrays: dict) -> tuple[list[tuple], int]:
    """(name, dtype, shape, offset) table and total bytes of ``arrays``
    packed back to back, 8-byte aligned, into one segment."""
    layout = []
    off = 0
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        layout.append((name, a.dtype.str, a.shape, off))
        off += int(a.nbytes + 7) & ~7
    return layout, max(off, 1)


def write_arrays(buf, layout: list[tuple], arrays: dict) -> None:
    for name, dt, shape, off in layout:
        np.ndarray(shape, dtype=np.dtype(dt), buffer=buf, offset=off)[...] = arrays[name]


def views(buf, layout: list[tuple]) -> dict:
    return {name: np.ndarray(shape, dtype=np.dtype(dt), buffer=buf, offset=off)
            for name, dt, shape, off in layout}


def run_task(task: str, ins: dict, outs: dict, lo: int, hi: int) -> None:
    """One typed shard: ``compact`` (the compact prep rows) or
    ``signbytes`` (canonical sign-bytes rows), writing only rows
    ``[lo, hi)`` of the outputs."""
    if task == "compact":
        rows = prep_rows_cat(ins["msg_cat"], ins["offs"], ins["sig_arr"], ins["sig_ok"],
                             ins["vi"], ins["pub_arr"], ins["key_ok"], lo=lo, hi=hi)
        for name, a in zip(("s_nib", "h_nib", "vidx", "r_y", "r_sign", "pre_ok"), rows):
            outs[name][lo:hi] = a
    elif task == "signbytes":
        sign_rows(ins["heights"], ins["ts_ns"], ins["hash_cat"], ins["hash_offs"],
                  ins["chain_id"], lo, hi, outs["rows"], outs["lens"])
    else:
        raise ValueError(f"unknown prep task {task!r}")


def worker_main(task_q, done_q) -> None:
    """Worker-process loop: ack ``("ready", pid)`` once, then for each
    descriptor ``(task, shard_id, in_name, in_layout, out_name,
    out_layout, lo, hi, extra)`` attach both segments by name, run the
    shard and ack ``(shard_id, error or None, busy seconds)``; ``None``
    stops the loop. ``extra`` carries small non-array inputs (the chain
    id). Attachments are closed after each shard: no segment outlives
    the call that made it."""
    import os
    from multiprocessing import shared_memory

    done_q.put(("ready", os.getpid()))
    while True:
        item = task_q.get()
        if item is None:
            return
        task, shard_id, in_name, in_layout, out_name, out_layout, lo, hi, extra = item
        t0 = time.perf_counter()
        err = None
        segs = []
        ins = outs = None
        try:
            segs = [shared_memory.SharedMemory(name=in_name),
                    shared_memory.SharedMemory(name=out_name)]
            ins = {**views(segs[0].buf, in_layout), **(extra or {})}
            outs = views(segs[1].buf, out_layout)
            run_task(task, ins, outs, lo, hi)
        except Exception as exc:  # acked: the caller raises it
            err = f"{type(exc).__name__}: {exc}"
        finally:
            ins = outs = None  # the views go before the segments close
            for seg in segs:
                try:
                    seg.close()
                except BufferError:
                    pass  # a view survived; the caller's unlink reclaims it
        done_q.put((shard_id, err, time.perf_counter() - t0))
