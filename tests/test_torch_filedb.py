"""PyTorch port, the durable KV file (store/db.py FileDB) against the JAX
package's: the same operations write the same bytes, each package reads
the other's file, and a torn tail is truncated to the same length with
the same rows left. Tolerance 0 (bytes)."""

import os
import shutil

import numpy as np
import pytest

from txflow_tpu.store.db import FileDB as JFileDB

from txflow_tpu_torch.store import FileDB, MemDB


def _ops(seed=7, n=40):
    """A seeded mix of set, set_sync, set_many, overwrite and delete."""
    rng = np.random.default_rng(seed)
    keys = [b"k%03d" % i for i in range(12)] + [b"", b"H:" + rng.bytes(8)]
    ops = []
    for _ in range(n):
        r = rng.integers(5)
        k = keys[int(rng.integers(len(keys)))]
        v = rng.bytes(int(rng.integers(0, 300)))
        if r == 0:
            ops.append(("set", k, v))
        elif r == 1:
            ops.append(("set_sync", k, v))
        elif r == 2:
            ops.append(("set_many", [(keys[int(j)], rng.bytes(int(rng.integers(1, 40))))
                                     for j in rng.integers(0, len(keys), 3)]))
        else:
            ops.append(("delete", k))
    return ops


def _apply(db, ops):
    for op in ops:
        if op[0] == "set_many":
            db.set_many(op[1], sync=True)
        else:
            getattr(db, op[0])(*op[1:])


def _mirror(ops):
    m = MemDB()
    _apply(m, ops)
    return dict(m.iterate())


def test_same_operations_write_the_same_bytes(tmp_path):
    ops = _ops()
    a, b = FileDB(str(tmp_path / "port" / "x.db")), JFileDB(str(tmp_path / "jax" / "x.db"))
    _apply(a, ops)
    _apply(b, ops)
    a.close()
    b.close()
    raw = (tmp_path / "port" / "x.db").read_bytes()
    assert raw == (tmp_path / "jax" / "x.db").read_bytes() and len(raw) > 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    ops = _ops(seed=11)
    path = str(tmp_path / "x.db")
    w = FileDB(path) if writer == "port" else JFileDB(path)
    _apply(w, ops)
    w.close()
    want = _mirror(ops)
    for cls in (FileDB, JFileDB):
        db = cls(path)
        assert dict(db.iterate()) == want
        assert list(db.iterate(b"k003", b"k009")) == [
            (k, v) for k, v in sorted(want.items()) if b"k003" <= k < b"k009"]
        db.close()
    # a reader appends after what it read, and the other package sees it
    db = (JFileDB if writer == "port" else FileDB)(path)
    db.set(b"late", b"row")
    db.close()
    assert FileDB(path).get(b"late") == JFileDB(path).get(b"late") == b"row"


TORN = {
    "half_header": lambda good, rec: good + rec[:5],
    "half_body": lambda good, rec: good + rec[: len(rec) - 3],
    "bad_crc": lambda good, rec: good + bytes([rec[0] ^ 0xFF]) + rec[1:],
    "garbage_after_bad": lambda good, rec: good + bytes([rec[0] ^ 1]) + rec[1:] + rec,
}


@pytest.mark.parametrize("case", sorted(TORN))
def test_a_torn_tail_is_truncated_identically(tmp_path, case):
    ops = _ops(seed=3, n=20)
    base = str(tmp_path / "base.db")
    db = FileDB(base)
    _apply(db, ops)
    db.close()
    good = open(base, "rb").read()
    # the record a crash tore: one more set of a fresh key
    probe = str(tmp_path / "probe.db")
    p = FileDB(probe)
    p.set(b"torn-key", b"torn-value" * 3)
    p.close()
    rec = open(probe, "rb").read()
    torn = TORN[case](good, rec)
    sizes, rows = [], []
    for name, cls in (("port", FileDB), ("jax", JFileDB)):
        path = str(tmp_path / f"{name}.db")
        with open(path, "wb") as f:
            f.write(torn)
        db = cls(path)
        rows.append(dict(db.iterate()))
        db.close()
        sizes.append(os.path.getsize(path))
    assert sizes[0] == sizes[1] == len(good)
    assert rows[0] == rows[1] == _mirror(ops)
    assert b"torn-key" not in rows[0]


def test_reopen_keeps_rows_and_tombstones(tmp_path):
    root = tmp_path / "node"
    path = str(root / "state.db")  # the directory is made on open
    db = FileDB(path)
    db.set(b"a", b"1")
    db.set_sync(b"b", b"2")
    db.delete(b"a")
    db.delete(b"missing")  # no record for a key it never held
    db.close()
    db = FileDB(path)
    assert dict(db.iterate()) == {b"b": b"2"} and not db.has(b"a")
    db.close()
    shutil.rmtree(root)
    assert dict(FileDB(path).iterate()) == {}
