"""PyTorch port, the gathered-table verify (K5): ``prepare_batch``'s
per-vote -A tables against the JAX package's (through ``convert.py``), and
the port's ``verify_batch`` / ``verify_kernel`` (the plain version on the
CPU, the operations of csrc/verify.cu:txf_verify_tables_kernel) against
JAX ``verify_batch`` on the kinds of input of tests/test_ed25519_batch.py:
valid votes, flipped R and S bytes, a wrong message, a wrong key, S >= L,
a short signature, an off-curve key, a flipped sign bit, an index outside
the set, and R = 1 against the non-canonical R = p + 1 on the identity.
Tolerance 0 (bool masks). The JAX reference is computed once (one jit
compile). Also the K5 launch on a faked card: it passes the base table of
its own card (a device tensor, like K3's base quarters) and a points
scratch there, one counted launch a call."""

import numpy as np
import pytest
import torch

from test_torch_launch import fake, fake_base_tables, fake_scratch, k5_inputs, on  # noqa: F401
from txflow_tpu.crypto import ed25519 as jed
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu_torch import convert
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import _lib, fe
from txflow_tpu_torch.ops import ed25519_batch as eb

BAD_PUB = (2).to_bytes(32, "little")  # y = 2 is off the curve
N_KEYS = 6
IDENTITY_ROWS = {1: True, fe.P_INT + 1: False}  # R value -> verifies


def _batch():
    """(msgs, sigs, vidx, pubs): every rejection class beside valid votes,
    over 6 keys plus one off-curve key, from a seeded numpy generator."""
    rng = np.random.default_rng(0x5EED)
    seeds = [rng.bytes(32) for _ in range(N_KEYS)]
    pubs = [host_ed.public_key_from_seed(s) for s in seeds] + [BAD_PUB]
    msgs, sigs, vidx = [], [], []

    def add(m, s, v):
        msgs.append(m)
        sigs.append(s)
        vidx.append(v)

    for i in range(N_KEYS):
        m = rng.bytes(int(rng.integers(1, 120)))
        add(m, host_ed.sign(seeds[i], m), i)
    m = b"corrupt"
    good = host_ed.sign(seeds[0], m)
    add(m, good[:5] + bytes([good[5] ^ 1]) + good[6:], 0)  # flipped R byte
    add(m, good[:40] + bytes([good[40] ^ 1]) + good[41:], 0)  # flipped S byte
    add(b"other message", host_ed.sign(seeds[2], b"original"), 2)  # wrong message
    add(m, good, 3)  # wrong key
    s_val = int.from_bytes(good[32:], "little") + host_ed.L
    add(m, good[:32] + s_val.to_bytes(32, "little"), 0)  # S >= L
    add(m, good[:50], 0)  # short signature
    add(m, bytes(64), N_KEYS)  # off-curve key
    r_int = int.from_bytes(good[:32], "little")
    add(m, (r_int ^ (1 << 255)).to_bytes(32, "little") + good[32:], 0)  # sign bit
    add(m, good, N_KEYS + 5)  # index outside the set
    for i in range(10):  # random mix
        vi = int(rng.integers(N_KEYS))
        mm = rng.bytes(40)
        sg = bytearray(host_ed.sign(seeds[vi], mm))
        if i % 3 == 1:
            sg[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
        add(mm, bytes(sg), vi)
    for _ in IDENTITY_ROWS:  # overwritten below: [0]B + [0]A = identity
        add(m, good, 0)
    return msgs, sigs, np.array(vidx), pubs


def _with_identity_rows(batch, r_as):
    """The last rows become s = h = 0 (P = identity, y = 1) with the R
    values of IDENTITY_ROWS, pre-checks passed; ``r_as`` maps bytes to the
    batch's R layout."""
    n = batch.s_nibbles.shape[0]
    for k, r_val in enumerate(IDENTITY_ROWS):
        row = n - len(IDENTITY_ROWS) + k
        batch.s_nibbles[row] = 0
        batch.h_nibbles[row] = 0
        batch.r_y[row] = r_as(np.frombuffer(r_val.to_bytes(32, "little"), np.uint8))
        batch.r_sign[row] = 0
        batch.pre_ok[row] = True
    return batch


@pytest.fixture(scope="module")
def ref():
    """The batch through the JAX package's prep and verify_batch (the one
    jit compile of this file), and through the port's prep."""
    msgs, sigs, vidx, pubs = _batch()
    jbatch = _with_identity_rows(
        jeb.prepare_batch(msgs, sigs, vidx, jeb.EpochTables(pubs)), lambda b: b.astype(np.int32)
    )
    want = np.asarray(jeb.verify_batch(jbatch))
    pbatch = _with_identity_rows(
        eb.prepare_batch(msgs, sigs, vidx, eb.EpochTables(pubs)), lambda b: b
    )
    return msgs, sigs, vidx, pubs, jbatch, pbatch, want


def test_prepare_batch_gathers_the_jax_tables(ref):
    *_, jbatch, pbatch, _want = ref
    conv = convert.prepared_batch_from_jax(jbatch)
    np.testing.assert_array_equal(pbatch.a_tables, conv.a_tables)
    assert pbatch.a_tables.dtype == np.int32 and pbatch.a_tables.shape[1:] == (16, 4, 10)
    np.testing.assert_array_equal(pbatch.pre_ok, conv.pre_ok)
    ok = pbatch.pre_ok  # rows that failed a pre-check may differ in content
    for f in ("s_nibbles", "h_nibbles", "r_y", "r_sign"):
        np.testing.assert_array_equal(getattr(pbatch, f)[ok], getattr(conv, f)[ok], err_msg=f)


def test_verify_batch_matches_jax_and_golden(ref):
    msgs, sigs, vidx, pubs, _jbatch, pbatch, want = ref
    got = eb.verify_batch(pbatch, device="cpu")
    assert got.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    n = len(msgs) - len(IDENTITY_ROWS)
    golden = [0 <= v < len(pubs) and jed.verify_pure(pubs[v], m, s)
              for v, m, s in zip(vidx[:n], msgs[:n], sigs[:n])]
    assert got[:n].tolist() == golden and 0 < sum(golden) < n
    assert got[n:].tolist() == list(IDENTITY_ROWS.values())


def test_verify_kernel_on_the_jax_inputs_matches_jax_and_k3(ref):
    """K5 fed the JAX package's own prepared batch (converted), and K3 on
    the compact form of the same votes: one mask."""
    msgs, sigs, vidx, pubs, jbatch, _pbatch, want = ref
    conv = convert.prepared_batch_from_jax(jbatch)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        conv.s_nibbles, conv.h_nibbles, conv.a_tables, conv.r_y, conv.r_sign, conv.pre_ok)]
    got = eb.verify_kernel(*t).numpy()
    np.testing.assert_array_equal(got, want)
    epoch = eb.EpochTables(pubs)
    c = eb.prepare_compact(msgs, sigs, vidx, epoch)
    k3 = eb.verify_kernel_gather(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        c.s_nibbles, c.h_nibbles, c.val_idx)), torch.from_numpy(epoch.tables),
        torch.from_numpy(epoch.quarter_tables),
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (c.r_y, c.r_sign, c.pre_ok)))
    n = len(msgs) - len(IDENTITY_ROWS)
    np.testing.assert_array_equal(k3.numpy()[:n], want[:n])


def test_verify_batch_without_cuda_raises_unless_cpu_is_asked(ref, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eb.verify_batch(ref[5])


def test_k5_launch_sets_the_base_table_on_its_card(fake, monkeypatch):  # noqa: F811
    """K5 adds [s]B from the base table of its own card and field, quarter
    0 of the card's base quarters (as K3 takes all four): a K5 call on
    card 2 passes card 2's table and a scratch allocated there, and counts
    one launch; the K7 tally kernels take no table."""
    fake_base_tables(monkeypatch)
    asked = fake_scratch(monkeypatch)
    got = []
    monkeypatch.setattr(fake, "txf_verify_tables", lambda *a: got.append(a) or 0, raising=False)
    eb.verify_kernel(*k5_inputs(2))
    _lib.launch("tally_partial", "txf_tally_partial", on(3), 4096, 7)
    _lib.launch("reduce_quorum", "txf_reduce_quorum", on(3), 4096, 7)
    _lib.launch("ring_add", "txf_add", on(3), 4096, 7)
    eb.verify_kernel(*k5_inputs(2))
    assert got == [(101, 102, 103, 7045, 104, 105, 106, 5000, 5000 + 4 * 64 * 30, 64, 1002)] * 2
    assert asked == [((64 * 31,), torch.int32, torch.device("cuda", 2))] * 2
    assert fake.calls == [("txf_tally_partial", 3, 1003), ("txf_reduce_quorum", 3, 1003),
                          ("txf_add", 3, 1003)]
    assert _lib.launches["verify_tables"] == 2 and _lib.launches["verify"] == 0
    assert all(_lib.launches[k] == 1 for k in ("tally_partial", "reduce_quorum", "ring_add"))
