"""PyTorch port, field arithmetic (K1): the port's plain field functions --
the same operations, in the same order, as the CUDA kernel
(txflow_tpu_torch/csrc/fe25519.cuh) -- against the JAX package's
ops/fe.py and python-int arithmetic. Outputs are compared as frozen
canonical values (bytes), with tolerance 0: they are integers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from txflow_tpu.ops import fe as jfe
from txflow_tpu_torch.ops import fe

P = fe.P_INT
RNG = np.random.default_rng(0xFE)

# the bounds cases of tests/test_fe.py, plus the raw (non-reduced)
# encodings >= p that a 255-bit input can carry
EDGE = [0, 1, 2, 19, 38, P - 1, P - 2, 2**255 - 1, 2**254, 0xFF, 1 << 248,
        P, P + 1, P + 18]


def rand_vals(n):
    return [int.from_bytes(RNG.bytes(32), "little") & (2**255 - 1) for _ in range(n)]


def port_limbs(vals):
    return torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in vals]))


def jax_limbs(vals):
    return jnp.asarray(np.stack([jfe.int_to_limbs(v % P) for v in vals]))


def jax_frozen_ints(x):
    return [jfe.limbs_to_int(r) for r in np.asarray(jfe.fe_freeze(x))]


def test_limb_roundtrip_and_bytes():
    vals = EDGE + rand_vals(32)
    for v in vals:
        assert fe.limbs_to_int(fe.int_to_limbs(v)) == v
    raw = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals])
    np.testing.assert_array_equal(
        fe.bytes_to_limbs_np(raw), np.stack([fe.int_to_limbs(v) for v in vals])
    )
    t = fe.fe_from_bytes(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(t, fe.bytes_to_limbs_np(raw))
    # bit 255 is the sign bit, never part of the field element
    top = raw.copy()
    top[:, 31] |= 0x80
    np.testing.assert_array_equal(fe.bytes_to_limbs_np(top), fe.bytes_to_limbs_np(raw))


@pytest.mark.parametrize("op", ["mul", "sq", "sub", "inv", "freeze"])
def test_ops_match_jax_and_ints(op):
    a_vals = EDGE + rand_vals(34)
    b_vals = list(reversed(EDGE)) + rand_vals(34)
    out = fe.fe_ops_plain(port_limbs(a_vals), port_limbs(b_vals)).numpy()
    k = ["mul", "sq", "sub", "inv", "freeze"].index(op)
    got = [fe.limbs_to_int(r) for r in out[:, k]]
    # canonical limbs: each within its width, value < p
    assert (out[:, k] >= 0).all() and (out[:, k] < (1 << fe.W)).all()
    assert all(g < P for g in got)
    ja, jb = jax_limbs(a_vals), jax_limbs(b_vals)
    jax_out = {
        "mul": lambda: jfe.fe_mul(ja, jb),
        "sq": lambda: jfe.fe_sq(ja),
        "sub": lambda: jfe.fe_sub(ja, jb),
        "inv": lambda: jfe.fe_inv(ja),
        "freeze": lambda: ja,
    }[op]()
    assert got == jax_frozen_ints(jax_out)
    ints = {
        "mul": [(a * b) % P for a, b in zip(a_vals, b_vals)],
        "sq": [(a * a) % P for a in a_vals],
        "sub": [(a - b) % P for a, b in zip(a_vals, b_vals)],
        "inv": [pow(a, P - 2, P) for a in a_vals],
        "freeze": [a % P for a in a_vals],
    }[op]
    assert got == ints
    # frozen limbs -> bytes equal the JAX package's frozen radix-2^8 limbs
    jbytes = np.asarray(jfe.fe_freeze(jax_out)).astype(np.uint8)
    np.testing.assert_array_equal(fe.frozen_to_bytes(out[:, k]), jbytes)


def test_mul_worst_case_bounds():
    """The largest inputs fe_mul accepts (3 carried units: 1.65*2^26 /
    1.65*2^25 per even / odd limb, either sign) keep every int32 quantity
    of the CUDA kernel inside int32 and give a carried output."""
    lim = np.where(np.arange(10) % 2 == 0, int(1.65 * 2**26), int(1.65 * 2**25))
    for sign in (1, -1):
        f = torch.from_numpy(sign * lim).to(torch.int64)[None]
        assert int((19 * f).abs().max()) < 2**31  # g19 in int32
        assert int((2 * f).abs().max()) < 2**31  # f2 in int32
        out = fe.fe_mul(f, f)
        assert int(out.abs().max()) < int(1.1 * 2**25) + 1
        v = fe.limbs_to_int(f[0].numpy())
        assert fe.limbs_to_int(out[0].numpy()) % P == (v * v) % P
        assert fe.limbs_to_int(fe.fe_freeze(out)[0].numpy()) == (v * v) % P


def test_freeze_signed_and_noncanonical():
    """Non-canonical representations of known values freeze exactly."""
    cases = [(fe.int_to_limbs(v), v % P) for v in (0, 1, 19, P - 1, P, P + 1, P + 18)]
    neg = fe.int_to_limbs(0).astype(np.int64)
    neg[0] = -1  # -1 == p - 1
    cases.append((neg, P - 1))
    mixed = fe.int_to_limbs(5).astype(np.int64)
    mixed[9] = -(1 << 24)  # 5 - 2^254
    cases.append((mixed, (5 - (1 << 254)) % P))
    arr = torch.from_numpy(np.stack([c[0] for c in cases]).astype(np.int64))
    out = fe.fe_freeze(arr).numpy()
    assert [fe.limbs_to_int(r) for r in out] == [c[1] for c in cases]
    assert (out >= 0).all() and (out < (1 << fe.W)).all()


def test_mul_small_and_add_chain():
    a_vals, b_vals = rand_vals(16), rand_vals(16)
    a, b = port_limbs(a_vals).to(torch.int64), port_limbs(b_vals).to(torch.int64)
    s = fe.fe_mul(fe.fe_add(a, b), fe.fe_sub(fe.fe_add(a, b), b))
    for av, bv, o in zip(a_vals, b_vals, s.numpy()):
        assert fe.limbs_to_int(o) % P == ((av + bv) * av) % P
    m = fe.fe_mul_small(a, 2)
    for av, o in zip(a_vals, m.numpy()):
        assert fe.limbs_to_int(o) % P == (2 * av) % P


def test_fe_ops_wrapper_uses_plain_version_on_cpu():
    vals = EDGE[:6]
    a = port_limbs(vals)
    out = fe.fe_ops(a, a)
    assert out.dtype == torch.int32 and out.shape == (6, 5, fe.NLIMB)
    np.testing.assert_array_equal(out.numpy(), fe.fe_ops_plain(a, a).numpy())
