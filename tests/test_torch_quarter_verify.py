"""PyTorch port, the four-lane verify's plain version
(``ed25519_batch.verify_kernel_gather_plain`` -> ``curve.double_scalar_
mul_quarters``, the operations of csrc/verify.cu:txf_verify_kernel): the
quarter split of both scalars, the two combine rounds and the encode give
the JAX package's ``verify_kernel_gather`` mask on a seeded mix of honest
and byzantine votes -- failed pre-checks, an index outside the set
(clipped by the host prep), scalars with an all-zero quarter, R = 1 and
the non-canonical R = p + 1 on the identity, 45 rows (not a multiple of
a block's 32) -- in both fields; the combine's Extended + Extended
addition (``ext_to_pniels`` + ``pniels_add``) is the golden model's
unified addition on doublings, inverses, the identity and a point of
order 4; and a quarter's nibbles are its 64 bits. Tolerance 0 (bool masks
and integer limbs). One JAX compile (B = 45, V = 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu_torch import convert
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import curve, ed25519_batch as eb, fe, field

BAD_PUB = (2).to_bytes(32, "little")  # y = 2 is off the curve
N_ROWS = 45
ZERO_QUARTER_ROWS = {20: ("s", 0), 21: ("h", 3), 22: ("s", 2), 23: ("h", 1)}  # row: (scalar, j)
IDENTITY_ROWS = {43: 1, 44: fe.P_INT + 1}  # row: R value


def _batch():
    """Compact arrays of 45 rows over 7 keys and an off-curve key (V = 8),
    from a seeded numpy generator, and the golden verdict of each row."""
    rng = np.random.default_rng(0x4A7E)
    seeds = [rng.bytes(32) for _ in range(7)]
    pubs = [host_ed.public_key_from_seed(s) for s in seeds] + [BAD_PUB]
    msgs, sigs, vidx = [], [], []
    for i in range(N_ROWS):
        v = int(rng.integers(7))
        m = rng.bytes(int(rng.integers(1, 90)))
        sg = bytearray(host_ed.sign(seeds[v], m))
        if i % 4 == 1:  # byzantine: a flipped bit anywhere in R or S
            sg[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
        msgs.append(m)
        sigs.append(bytes(sg))
        vidx.append(v)
    s30 = int.from_bytes(sigs[30][32:], "little") + host_ed.L
    sigs[30] = sigs[30][:32] + s30.to_bytes(32, "little")  # S >= L
    sigs[31] = sigs[31][:40]  # short signature
    vidx[32] = 7  # the off-curve key
    vidx[33] = 11  # outside the set: the prep clips it, pre_ok False
    epoch = eb.EpochTables(pubs)
    c = eb.prepare_compact(msgs, sigs, np.array(vidx), epoch)
    golden = np.array([0 <= v < 7 and host_ed.verify_pure(pubs[v], m, s)
                       for v, m, s in zip(vidx, msgs, sigs)])
    for row, (which, j) in ZERO_QUARTER_ROWS.items():
        nib = c.s_nibbles if which == "s" else c.h_nibbles
        nib[row, 48 - 16 * j: 64 - 16 * j] = 0
        golden[row] = False  # [s]B + [h](-A) moved off R
    for row, r_val in IDENTITY_ROWS.items():  # s = h = 0: P = identity, y = 1
        c.s_nibbles[row] = 0
        c.h_nibbles[row] = 0
        c.r_y[row] = np.frombuffer(r_val.to_bytes(32, "little"), np.uint8)
        c.r_sign[row] = 0
        c.pre_ok[row] = True
        golden[row] = r_val == 1
    return c, pubs, golden


@pytest.fixture(scope="module")
def ref():
    c, pubs, golden = _batch()
    jepoch = jeb.EpochTables(pubs)
    want = np.asarray(jax.jit(jeb.verify_kernel_gather)(
        jnp.asarray(c.s_nibbles), jnp.asarray(c.h_nibbles), jnp.asarray(c.val_idx),
        jnp.asarray(jepoch.tables), jnp.asarray(c.r_y), jnp.asarray(c.r_sign),
        jnp.asarray(c.pre_ok)))
    return c, pubs, golden, np.asarray(jepoch.tables), want


@pytest.mark.parametrize("fe_radix", [25, 13])
def test_quarter_split_plain_verify_matches_jax_and_golden(ref, fe_radix):
    c, _pubs, golden, jtables, want = ref
    tables, quarters, _ = convert.epoch_from_jax(jtables, np.ones(8), fe_radix)

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    got = eb.verify_kernel_gather(
        T(c.s_nibbles), T(c.h_nibbles), T(c.val_idx), T(tables), T(quarters), T(c.r_y),
        T(c.r_sign), T(c.pre_ok), fe_radix=fe_radix,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, golden)
    assert got[43] and not got[44] and not got[30:34].any()
    assert 10 < got.sum() < N_ROWS - 10


def test_plain_verify_clamps_an_index_outside_the_set(ref):
    """The kernel clamps val_idx into [0, V) (csrc/verify.cu:clamp_val);
    so does the plain version: an index past the set reads the last
    validator's tables, a negative one the first's."""
    c, _pubs, _golden, _jt, _want = ref
    epoch = eb.EpochTables(_pubs)
    rows = np.arange(12)
    ok = np.ones(12, bool)

    def run(vi):
        t = [torch.from_numpy(np.ascontiguousarray(x[rows])) for x in (c.s_nibbles, c.h_nibbles)]
        return eb.verify_kernel_gather_plain(
            *t, torch.from_numpy(vi.astype(np.int32)), torch.from_numpy(epoch.tables),
            torch.from_numpy(epoch.quarter_tables), torch.from_numpy(c.r_y[rows]),
            torch.from_numpy(c.r_sign[rows]), torch.from_numpy(ok)).numpy()

    vi = c.val_idx[rows].copy()
    base = run(vi)
    assert base.any()
    np.testing.assert_array_equal(run(np.where(vi == 7, 99, vi)), base)
    np.testing.assert_array_equal(run(np.where(vi == 0, -5, vi)), base)


def _limbs(vals, fe_radix):
    F = field.ops(fe_radix)
    return torch.from_numpy(curve.ints_to_limbs([v % host_ed.P for v in vals], fe_radix)).to(F.DTYPE)


def _ext(points, fe_radix):
    return tuple(_limbs([p[c] for p in points], fe_radix) for c in range(4))


@pytest.mark.parametrize("fe_radix", [25, 13])
def test_combine_addition_is_the_unified_addition(fe_radix):
    """ext_to_pniels + pniels_add (the combine round's Extended + Extended
    addition) against the golden point_add: random pairs, P + P, P + (-P),
    P + identity, identity + identity and a point of order 4 (the zero
    key decompresses to (sqrt(-1), 0))."""
    F = field.ops(fe_radix)
    rng = np.random.default_rng(0xADD)

    def rand_point():
        return host_ed.scalar_mult(int.from_bytes(rng.bytes(32), "little") % host_ed.L, host_ed.BASE)

    order4 = host_ed.point_decompress(bytes(32))
    ps = [rand_point() for _ in range(4)]
    qs = [rand_point() for _ in range(4)]
    pairs = list(zip(ps, qs)) + [(ps[0], ps[0]), (ps[1], host_ed.point_neg(ps[1])),
                                 (ps[2], host_ed.IDENTITY), (host_ed.IDENTITY, host_ed.IDENTITY),
                                 (order4, ps[3]), (order4, order4)]
    a, b = _ext([p for p, _ in pairs], fe_radix), _ext([q for _, q in pairs], fe_radix)
    X, Y, Z, T = curve.pniels_add(a, curve.ext_to_pniels(b, fe_radix), fe_radix)
    for i, (p, q) in enumerate(pairs):
        want = host_ed.point_add(p, q)
        x, y, z, t = (F.limbs_to_int(c[i].numpy()) % host_ed.P for c in (X, Y, Z, T))
        assert z != 0
        assert (x * want[2] - want[0] * z) % host_ed.P == 0
        assert (y * want[2] - want[1] * z) % host_ed.P == 0
        assert (x * y - t * z) % host_ed.P == 0  # T stays XY/Z for the next round


def test_quarter_nibbles_are_the_64_bit_quarters():
    rng = np.random.default_rng(0x64)
    scalars = [int.from_bytes(rng.bytes(32), "little") >> 3 for _ in range(5)] + [0, host_ed.L - 1]
    nib = torch.from_numpy(np.stack([curve.scalar_to_nibbles(s) for s in scalars]))
    q = curve.quarter_nibbles(nib)
    assert q.shape == (len(scalars), 4, 16)
    for i, s in enumerate(scalars):
        for j in range(4):
            got = sum(int(v) << (4 * (15 - w)) for w, v in enumerate(q[i, j].tolist()))
            assert got == (s >> (64 * j)) & ((1 << 64) - 1)
