"""PyTorch port, K8: the radix-2^13 field (``txflow_tpu_torch/ops/fe13.py``)
against the JAX package's ``txflow_tpu/ops/fe13.py``, in process.

The port's plain version runs JAX's operations in JAX's order on int32
tensors, so every op is compared limb for limb on the same inputs (made
from a seed with numpy), un-frozen results included; frozen results are
also held to python ints. The worst-case bounds of
``tests/test_fe13.py`` (normalized limbs up to 9408 into a product,
freeze inputs that need both folds and both subtractions) run through the
port too. Tolerance 0 everywhere. The JAX field is imported directly: no
test here touches ``TXFLOW_FE_RADIX`` or reloads a module."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from txflow_tpu.ops import fe13 as jfe13

from txflow_tpu_torch import convert
from txflow_tpu_torch.ops import _lib, fe13, field

P = fe13.P_INT


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _limbs(vals):
    return np.stack([fe13.int_to_limbs(v) for v in vals])


def _worst():
    """Normalized limbs at the bound: all 9408, alternating 9408/0, and the
    canonical maximum 8191."""
    w = np.full((3, fe13.NLIMB), 9408, np.int32)
    w[1, ::2] = 0
    w[2] = fe13.MASK
    return w


def _both(fn_p, fn_j, *arrays):
    got = fn_p(*(torch.from_numpy(a) for a in arrays))
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays)))
    return got.numpy(), want


def test_host_helpers_match_jax():
    vals = _ints(16, 1) + [0, 1, 19, P - 1, P, 2**255 - 1]
    for v in vals:
        np.testing.assert_array_equal(fe13.int_to_limbs(v), jfe13.int_to_limbs(v))
        assert fe13.limbs_to_int(fe13.int_to_limbs(v)) == v
    np.testing.assert_array_equal(fe13.P_LIMBS, jfe13.P_LIMBS)
    np.testing.assert_array_equal(fe13.OFFSET_P_LIMBS, jfe13.OFFSET_P_LIMBS)
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 256, size=(64, 32), dtype=np.uint8)
    want = np.asarray(jfe13.bytes_to_limbs_device(jnp.asarray(raw)))
    np.testing.assert_array_equal(fe13.bytes_to_limbs_np(raw), want)
    np.testing.assert_array_equal(fe13.fe_from_bytes(torch.from_numpy(raw)).numpy(), want)
    # the port's radix-13 layout is JAX fe13's: canonical limbs carry over
    low = raw.copy()
    low[:, 31] &= 0x7F
    np.testing.assert_array_equal(convert.limbs8_to_limbs(low.astype(np.int32), 13),
                                  np.asarray(jfe13.bytes_to_limbs_device(jnp.asarray(low))))


@pytest.mark.parametrize("passes", [1, 2, 3, 4, 5])
def test_carry_matches_jax_limb_for_limb(passes):
    rng = np.random.default_rng(10 + passes)
    x = rng.integers(0, 2**30, size=(32, fe13.NLIMB)).astype(np.int32)
    got, want = _both(lambda t: fe13.fe_carry(t, passes), lambda t: jfe13.fe_carry(t, passes), x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sq", "mul_small"])
def test_ops_match_jax_limb_for_limb(op):
    """Random canonical inputs and the worst-case normalized ones; the
    port's un-frozen limbs equal JAX's, and their value is the python
    int's mod p."""
    a_vals, b_vals = _ints(40, 3), _ints(40, 4)
    a = np.concatenate([_limbs(a_vals), _worst()])
    b = np.concatenate([_limbs(b_vals), _worst()[::-1].copy()])
    fns = {
        "add": (fe13.fe_add, jfe13.fe_add, lambda x, y: x + y),
        "sub": (fe13.fe_sub, jfe13.fe_sub, lambda x, y: x - y),
        "mul": (fe13.fe_mul, jfe13.fe_mul, lambda x, y: x * y),
        "sq": (lambda x, _y: fe13.fe_sq(x), lambda x, _y: jfe13.fe_sq(x), lambda x, _y: x * x),
        "mul_small": (lambda x, _y: fe13.fe_mul_small(x, 2), lambda x, _y: jfe13.fe_mul_small(x, 2),
                      lambda x, _y: 2 * x),
    }
    fp, fj, fi = fns[op]
    got, want = _both(fp, fj, a, b)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= 9408  # normalized: a legal fe_mul input
    for i in range(len(a)):
        x, y = fe13.limbs_to_int(a[i]), fe13.limbs_to_int(b[i])
        assert fe13.limbs_to_int(got[i]) % P == fi(x, y) % P


def test_mul_bounds_after_add_chain():
    """tests/test_fe13.py's chain (carried sum, difference, product) on
    the port: every output stays normalized and exact."""
    a_vals, b_vals = _ints(16, 5), _ints(16, 6)
    a, b = torch.from_numpy(_limbs(a_vals)), torch.from_numpy(_limbs(b_vals))
    s = fe13.fe_add(a, b)
    d = fe13.fe_sub(s, b)
    m = fe13.fe_mul(s, d)
    for t in (s, d, m):
        assert int(t.max()) <= 9408 and int(t.min()) >= 0
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jfe13.fe_mul(jfe13.fe_add(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())),
                                           jfe13.fe_sub(jfe13.fe_add(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())),
                                                        jnp.asarray(b.numpy())))))
    for i, (x, y) in enumerate(zip(a_vals, b_vals)):
        assert fe13.limbs_to_int(m[i]) % P == ((x + y) * x) % P


def test_freeze_edge_values_and_ints():
    """Values that need both top-bit folds and both conditional
    subtractions of p, in unreduced limb form, and the worst-case
    normalized limbs: frozen limbs equal JAX's and the python int mod p."""
    edge = [P - 1, P, P + 1, 2 * P - 1, 2**255 - 1, 2**255, 19, 0, 2**260 - 1]
    x = np.concatenate([
        np.stack([np.array([(v >> (13 * i)) & fe13.MASK for i in range(fe13.NLIMB)], np.int32)
                  for v in edge]),
        _worst(),
    ])
    got, want = _both(fe13.fe_freeze, jfe13.fe_freeze, x)
    np.testing.assert_array_equal(got, want)
    for i in range(len(x)):
        assert fe13.limbs_to_int(got[i]) == fe13.limbs_to_int(x[i]) % P
        assert got[i].min() >= 0 and got[i].max() <= fe13.MASK
    np.testing.assert_array_equal(fe13.fe_parity_frozen(torch.from_numpy(got)).numpy(), got[:, 0] & 1)


def test_inv_matches_jax_and_ints():
    vals = _ints(6, 7) + [1, P - 1, 19]
    a = _limbs(vals)
    got, want = _both(fe13.fe_inv, jfe13.fe_inv, a)
    np.testing.assert_array_equal(got, want)
    frozen = fe13.fe_freeze(torch.from_numpy(got)).numpy()
    for i, v in enumerate(vals):
        assert fe13.limbs_to_int(frozen[i]) == pow(v, P - 2, P)
        assert (fe13.limbs_to_int(frozen[i]) * v) % P == 1


def test_fe13_ops_on_cpu_is_the_plain_version():
    """The wrapper takes its plain version only for CPU tensors, launching
    nothing; its frozen rows equal the python ints."""
    vals = _ints(6, 8) + [0, P - 1]
    other = vals[1:] + vals[:1]
    a, b = torch.from_numpy(_limbs(vals)), torch.from_numpy(_limbs(other))
    _lib.reset_launches()
    out = fe13.fe13_ops(a, b)
    assert sum(_lib.launches.values()) == 0
    assert out.shape == (len(vals), 5, fe13.NLIMB) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), fe13.fe13_ops_plain(a, b).numpy())
    for i, (x, y) in enumerate(zip(vals, other)):
        want = [(x * y) % P, (x * x) % P, (x - y) % P, pow(x, P - 2, P), x % P]
        assert [fe13.limbs_to_int(r) for r in out[i].numpy()] == want
    assert field.ops(13) is fe13 and _lib.KERNELS["fe13_ops"] == "verify13"


def test_fe13_ops_on_a_card_tensor_checks_its_inputs():
    """A CUDA-shaped call with the wrong limb count raises before any
    launch (no fallback to the plain version)."""
    from types import SimpleNamespace

    fake = SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.int32, shape=(4, 10),
                           is_contiguous=lambda: True)
    with pytest.raises(ValueError, match="expected shape"):
        fe13.fe13_ops(fake, fake)
