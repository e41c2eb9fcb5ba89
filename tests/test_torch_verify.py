"""PyTorch port, batched ed25519 verify (K3): the port's verify (plain
version on the CPU, the operations of txflow_tpu_torch/csrc/verify.cu)
against the JAX package's compact verify step and the golden model
``verify_pure``, on the adversarial cases of tests/test_ed25519_batch.py.
Tolerance 0 (bool masks)."""

import numpy as np
import jax.numpy as jnp
import torch

from txflow_tpu.crypto import ed25519 as jed
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu.ops import tally as jtally
from txflow_tpu_torch import convert
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import ed25519_batch as eb
from txflow_tpu_torch.ops import fe

RNG = np.random.default_rng(0xED)
BAD_PUB = (2).to_bytes(32, "little")  # y = 2 is off the curve


def make_keys(n):
    seeds = [RNG.bytes(32) for _ in range(n)]
    return seeds, [host_ed.public_key_from_seed(s) for s in seeds]


def adversarial_batch():
    """(msgs, sigs, vidx, pubs): valid votes and every rejection class of
    tests/test_ed25519_batch.py, over 6 keys plus one off-curve key."""
    seeds, pubs = make_keys(6)
    pubs = pubs + [BAD_PUB]
    msgs, sigs, vidx = [], [], []

    def add(m, s, v):
        msgs.append(m)
        sigs.append(s)
        vidx.append(v)

    for i in range(6):
        m = RNG.bytes(int(RNG.integers(1, 120)))
        add(m, host_ed.sign(seeds[i], m), i)
    m = b"corrupt-r"
    s = bytearray(host_ed.sign(seeds[0], m))
    s[5] ^= 1
    add(m, bytes(s), 0)  # corrupted R
    s = bytearray(host_ed.sign(seeds[1], m))
    s[40] ^= 1
    add(m, bytes(s), 1)  # corrupted S
    add(b"other message", host_ed.sign(seeds[2], b"original message"), 2)
    add(m, host_ed.sign(seeds[0], m), 3)  # wrong validator
    good = host_ed.sign(seeds[0], m)
    s_val = int.from_bytes(good[32:], "little") + host_ed.L
    add(m, good[:32] + s_val.to_bytes(32, "little"), 0)  # S >= L
    add(m, good[:50], 0)  # wrong length
    add(m, bytes(64), 6)  # off-curve key
    r_int = int.from_bytes(good[:32], "little")
    add(m, (r_int ^ (1 << 255)).to_bytes(32, "little") + good[32:], 0)  # sign bit
    add(m, host_ed.sign(seeds[0], m), 9)  # unknown validator index
    for i in range(24):  # random mix
        vi = int(RNG.integers(6))
        mm = RNG.bytes(40)
        sg = bytearray(host_ed.sign(seeds[vi], mm))
        if i % 4 == 1:
            sg[int(RNG.integers(64))] ^= 1 << int(RNG.integers(8))
        add(mm, bytes(sg), vi)
    return msgs, sigs, np.array(vidx), pubs


def test_prepare_compact_matches_jax():
    msgs, sigs, vidx, pubs = adversarial_batch()
    got = eb.prepare_compact(msgs, sigs, vidx, eb.EpochTables(pubs))
    want = jeb._prepare_compact_np(msgs, sigs, vidx, jeb.EpochTables(pubs))
    for f in ("s_nibbles", "h_nibbles", "val_idx", "r_y", "r_sign", "pre_ok"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_epoch_from_jax_matches_port_epoch_tables():
    _, pubs = make_keys(5)
    pubs = pubs + [BAD_PUB, bytes(32)]
    jepoch, epoch = jeb.EpochTables(pubs), eb.EpochTables(pubs)
    powers = np.arange(1, 8) * 10
    tables, quarters, pw = convert.epoch_from_jax(jepoch.tables, powers)
    np.testing.assert_array_equal(tables, epoch.tables)
    np.testing.assert_array_equal(quarters, epoch.quarter_tables)
    np.testing.assert_array_equal(jepoch.key_ok, epoch.key_ok)
    np.testing.assert_array_equal(jepoch.pub_arr, epoch.pub_arr)
    assert pw.dtype == np.int32 and pw.tolist() == powers.tolist()


def test_verify_kernel_gather_matches_jax_and_golden():
    msgs, sigs, vidx, pubs = adversarial_batch()
    # the JAX verifier's staging: 7 keys padded to capacity 8 with a zero key
    jepoch = jeb.EpochTables(pubs + [bytes(32)])
    batch = jeb._prepare_compact_np(msgs, sigs, vidx, jepoch)
    n, b = len(msgs), 64

    def pad(a):
        return np.concatenate([a, np.zeros((b - n,) + a.shape[1:], a.dtype)])

    args = [pad(x) for x in (batch.s_nibbles, batch.h_nibbles, batch.val_idx,
                             batch.r_y, batch.r_sign, batch.pre_ok)]
    packed = jtally.compact_step_packed_jit()(
        *(jnp.asarray(a) for a in args), jnp.full(b, -1, jnp.int32),
        jnp.asarray(jepoch.tables), jnp.ones(8, jnp.int32),
        jnp.zeros(64, jnp.int32), jnp.int32(1),
    )
    want_jax = np.asarray(packed)[:n].astype(bool)
    tables, quarters, _ = convert.epoch_from_jax(jepoch.tables, np.ones(8))
    got = eb.verify_kernel_gather(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args[:3]),
        torch.from_numpy(tables), torch.from_numpy(quarters),
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args[3:]),
    ).numpy()
    assert got.dtype == bool and got.shape == (b,)
    assert not got[n:].any()  # padding rows never verify
    np.testing.assert_array_equal(got[:n], want_jax)
    golden = [
        0 <= v < len(pubs) and jed.verify_pure(pubs[v], m, s)
        for v, m, s in zip(vidx, msgs, sigs)
    ]
    assert got[:n].tolist() == golden
    assert 0 < sum(golden) < n


def test_noncanonical_r_rejected():
    """encode([0]B + [0]A) = (y = 1, x = 0): R = 1 verifies, while the
    non-canonical encoding R = p + 1 of the same y does not (the compare is
    on the raw 255 bits, like Go's byte comparison)."""
    _, pubs = make_keys(1)
    epoch = eb.EpochTables(pubs)
    tables, quarters = torch.from_numpy(epoch.tables), torch.from_numpy(epoch.quarter_tables)
    r = np.stack([
        np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in (1, fe.P_INT + 1)
    ])
    zero = torch.zeros((2, 64), dtype=torch.uint8)
    got = eb.verify_kernel_gather(
        zero, zero, torch.zeros(2, dtype=torch.int32), tables, quarters, torch.from_numpy(r),
        torch.zeros(2, dtype=torch.uint8), torch.ones(2, dtype=torch.bool),
    )
    assert got.tolist() == [True, False]
