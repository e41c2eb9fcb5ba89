"""PyTorch port, curve arithmetic (K2): the port's plain double-scalar
multiply over indexed epoch tables + encode -- the operations of
txflow_tpu_torch/csrc/ge25519.cuh -- against the JAX package's
ops/curve.py and the pure-python golden model, on the cases of
tests/test_curve.py. Tolerance 0 (frozen integers and parity bits)."""

import numpy as np
import jax.numpy as jnp
import torch

from txflow_tpu.crypto import ed25519 as jed
from txflow_tpu.ops import curve as jcurve
from txflow_tpu_torch import convert
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import curve, fe

RNG = np.random.default_rng(0xC0)


def rand_scalar(bound=host_ed.L):
    return int.from_bytes(RNG.bytes(32), "little") % bound


def rand_point():
    return host_ed.base_mult(rand_scalar())


def ext_to_limbs(points):
    return tuple(
        torch.from_numpy(np.stack([fe.int_to_limbs(p[c]) for p in points])).to(torch.int64)
        for c in range(4)
    )


def assert_points_equal(dev_ext, host_points):
    X, Y, Z, _ = (c.numpy() for c in dev_ext)
    for i, (hx, hy, hz, _) in enumerate(host_points):
        x, y, z = (fe.limbs_to_int(c[i]) for c in (X, Y, Z))
        assert (x * hz - hx * z) % host_ed.P == 0
        assert (y * hz - hy * z) % host_ed.P == 0


def test_tables_match_jax_layout():
    np.testing.assert_array_equal(
        convert.base_table_from_jax(jcurve.BASE_TABLE), curve.BASE_TABLE
    )
    pts = [rand_point() for _ in range(3)]
    jt = np.stack([jcurve.build_pniels_table(p) for p in pts])
    pt = np.stack([curve.build_pniels_table(p) for p in pts])
    tables, powers = convert.epoch_from_jax(jt, np.array([10, 20, 30]))
    np.testing.assert_array_equal(tables, pt)
    assert powers.dtype == np.int32 and powers.tolist() == [10, 20, 30]


def test_double_and_pniels_add_match_golden():
    pts = [rand_point() for _ in range(8)] + [host_ed.IDENTITY]
    assert_points_equal(
        curve.ext_double(ext_to_limbs(pts)), [host_ed.point_double(p) for p in pts]
    )
    qs = [rand_point() for _ in range(9)]
    tables = np.stack([curve.build_pniels_table(q) for q in qs])
    for k in (0, 1, 7):  # entry 0 is the identity
        n = tuple(torch.from_numpy(tables[:, k, c, :]).to(torch.int64) for c in range(4))
        want = [host_ed.point_add(p, host_ed.scalar_mult(k, q)) for p, q in zip(pts, qs)]
        assert_points_equal(curve.pniels_add(ext_to_limbs(pts), n), want)


def test_double_scalar_mul_indexed_and_encode_match_jax():
    B, V = 6, 3
    As = [rand_point() for _ in range(V)]
    ss = [rand_scalar() for _ in range(B - 2)] + [0, host_ed.L - 1]
    hs = [rand_scalar() for _ in range(B - 2)] + [0, 2**252 + 5]
    vidx = np.array([0, 1, 2, 1, 0, 2], np.int32)
    s_nib = np.stack([curve.scalar_to_nibbles(s) for s in ss])
    h_nib = np.stack([curve.scalar_to_nibbles(h) for h in hs])
    jtables = np.stack([jcurve.build_pniels_table(a) for a in As])
    # JAX reference
    jp = jcurve.double_scalar_mul_indexed(
        jnp.asarray(s_nib), jnp.asarray(h_nib), jnp.asarray(jcurve.BASE_TABLE),
        jnp.asarray(jtables), jnp.asarray(vidx),
    )
    jy, jpar = jcurve.ext_encode(jp)
    # port, over the converted epoch tables
    tables, _ = convert.epoch_from_jax(jtables, np.ones(V))
    y, par = curve.dsm_encode(
        torch.from_numpy(s_nib.astype(np.uint8)), torch.from_numpy(h_nib.astype(np.uint8)),
        torch.from_numpy(vidx), torch.from_numpy(tables),
    )
    np.testing.assert_array_equal(
        fe.frozen_to_bytes(y.numpy()), np.asarray(jy).astype(np.uint8)
    )
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
    # and the golden model's compressed encoding
    for i in range(B):
        want = jed.point_compress(
            jed.point_add(jed.scalar_mult(ss[i], jed.BASE), jed.scalar_mult(hs[i], As[vidx[i]]))
        )
        assert fe.frozen_to_bytes(y.numpy()[i]).tobytes()[:31] == want[:31]
        assert fe.frozen_to_bytes(y.numpy()[i])[31] == want[31] & 0x7F
        assert int(par[i]) == want[31] >> 7


def test_scalar_edge_cases_identity():
    # s = 0, h = 0 -> identity; encode(identity) = (y = 1, parity 0)
    zero = torch.zeros((1, curve.NWINDOWS), dtype=torch.uint8)
    tab = torch.from_numpy(curve.build_pniels_table(rand_point())[None])
    y, par = curve.dsm_encode(zero, zero, torch.zeros(1, dtype=torch.int32), tab)
    assert fe.limbs_to_int(y[0].numpy()) == 1
    assert int(par[0]) == 0
