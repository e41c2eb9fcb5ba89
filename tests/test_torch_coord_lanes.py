"""PyTorch port, the coordinate split of K5 (``txf_verify_tables``) and K2
(``txf_dsm_encode``): four lanes a row, lane c holding coordinate c of the
Extended accumulator, each point formula two rounds of one field product
a lane (``csrc/verify.cu:txf_coord_dsm_kernel``). Its plain version
(``ops/curve.py``: ``lane_double``, ``lane_pniels_add``,
``double_scalar_mul_lanes``, ``double_scalar_mul_indexed_lanes``), the
kernel's operations step by step with each exchange an index permutation
on the lane axis, is held in both fields, at tolerance 0:

- limb for limb against the one-lane formulas (``ext_double`` with and
  without T, ``pniels_add``) on random points and the identity, and
  against the one-lane accumulator (``_windowed``) after the first
  windows and after all 64;
- y and parity against JAX ``curve.double_scalar_mul`` + ``ext_encode``
  (K5's gathered form and K2's indexed form alike), and K5's mask against
  JAX ``verify_kernel``'s compare of them, on the adversarial batch of
  ``tests/test_torch_verify_tables.py``, the edge scalars 0, 1, L - 1 and
  all-15 nibbles, and seeded random nibbles (one jit compile: the JAX
  package's default field; the radix-13 y compare as frozen bytes).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_verify_tables import _batch, _with_identity_rows
from txflow_tpu.ops import curve as jcurve
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu.ops import fe as jfe
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import curve, ed25519_batch as eb, field

FIELDS = [25, 13]
EDGE = [0, 1, host_ed.L - 1, 2**256 - 1]  # 2^256 - 1: all 64 nibbles 15
N_RANDOM = 8


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows():
    """(batch rows, edge and random rows) on the keys of ``_batch``: the
    adversarial batch's msgs, sigs, vidx and pubs, then [s, h nibbles,
    val_idx] of the 16 edge pairs and N_RANDOM seeded random pairs."""
    msgs, sigs, vidx, pubs = _batch()
    rng = np.random.default_rng(0xC00D)
    pairs = [(a, b) for a in EDGE for b in EDGE]
    s = np.stack([curve.scalar_to_nibbles(a) for a, _ in pairs]
                 + list(rng.integers(0, 16, (N_RANDOM, 64))))
    h = np.stack([curve.scalar_to_nibbles(b) for _, b in pairs]
                 + list(rng.integers(0, 16, (N_RANDOM, 64))))
    vi = (np.arange(len(s)) % len(pubs)).astype(np.int32)  # the off-curve key included
    return (msgs, sigs, vidx, pubs), (s.astype(np.uint8), h.astype(np.uint8), vi)


def _port_inputs(fe_radix):
    """The port's K5 inputs over all rows (the batch prepared by the port,
    its identity rows set, then the extra rows, pre-checks passed, R = 0)
    and each row's clamped validator index with the epoch tables."""
    (msgs, sigs, vidx, pubs), (s, h, vi) = _rows()
    epoch = eb.EpochTables(pubs, fe_radix=fe_radix)
    pb = _with_identity_rows(eb.prepare_batch(msgs, sigs, vidx, epoch), lambda b: b)
    n = len(s)
    k5 = [np.concatenate(p) for p in (
        (pb.s_nibbles, s), (pb.h_nibbles, h), (pb.a_tables, epoch.tables[vi]),
        (pb.r_y, np.zeros((n, 32), np.uint8)), (pb.r_sign, np.zeros(n, np.uint8)),
        (pb.pre_ok, np.ones(n, bool)))]
    val_idx = np.concatenate([np.clip(vidx, 0, len(pubs) - 1), vi]).astype(np.int32)
    return [T(x) for x in k5], T(val_idx), T(epoch.tables)


@jax.jit
def _jax_reference(s, h, a_tables, r_y, r_sign, pre_ok):
    """JAX ``verify_kernel``'s steps, keeping y and parity: one loop to
    compile (``double_scalar_mul_indexed`` gives the same points over the
    tables it gathers, its own docstring says, and
    ``tests/test_torch_verify_tables.py`` holds K5 to JAX ``verify_batch``
    itself)."""
    y, parity = jcurve.ext_encode(
        jcurve.double_scalar_mul(s, h, jnp.asarray(jcurve.BASE_TABLE), a_tables))
    return y, parity, jfe.fe_is_equal_frozen(y, r_y) & (parity == r_sign) & pre_ok


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's y, parity and K5 mask over every row."""
    (msgs, sigs, vidx, pubs), (s, h, vi) = _rows()
    jepoch = jeb.EpochTables(pubs)
    jb = _with_identity_rows(jeb.prepare_batch(msgs, sigs, vidx, jepoch),
                             lambda b: b.astype(np.int32))
    n = len(s)
    args = [np.concatenate(p) for p in (
        (np.asarray(jb.s_nibbles, np.int32), s.astype(np.int32)),
        (np.asarray(jb.h_nibbles, np.int32), h.astype(np.int32)),
        (np.asarray(jb.a_tables), np.asarray(jepoch.tables)[vi]),
        (np.asarray(jb.r_y, np.int32), np.zeros((n, 32), np.int32)),
        (np.asarray(jb.r_sign, np.int32), np.zeros(n, np.int32)),
        (np.asarray(jb.pre_ok), np.ones(n, bool)))]
    y, parity, mask = (np.asarray(o) for o in _jax_reference(*(jnp.asarray(a) for a in args)))
    return {"y": y.astype(np.uint8), "parity": parity, "mask": mask}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain radix-13 products here ([rows, 4, 20, 39] int32) cross
    torch's intra-op parallel grain; beside other test workers on a few
    cores its threads oversubscribe them (minutes instead of seconds), so
    each test runs on one thread and gives the count back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_points(rng, n):
    return [host_ed.base_mult(int.from_bytes(rng.bytes(32), "little") % host_ed.L)
            for _ in range(n)]


def _extended(points, fe_radix):
    """Python-int Extended points -> a tuple of [n, NLIMB] limb tensors of
    the field's plain type, each coordinate reduced mod p."""
    F = field.ops(fe_radix)
    return tuple(T(np.stack([F.int_to_limbs(p[c] % host_ed.P) for p in points])).to(F.DTYPE)
                 for c in range(4))


def _assert_lanes_equal(lanes, point):
    for c, (got, want) in enumerate(zip(curve.from_lanes(lanes), point)):
        assert torch.equal(got, want), f"coordinate {'XYZT'[c]}"


@pytest.mark.parametrize("compute_t", [True, False])
@pytest.mark.parametrize("fe_radix", FIELDS)
def test_lane_double_equals_ext_double(fe_radix, compute_t):
    """One lane-form doubling (limbs of random points, of a point that is
    itself a doubling's output, and of the identity) is ext_double's,
    limb for limb; without T lane 3 keeps its input T."""
    rng = np.random.default_rng(11)
    p = _extended(_random_points(rng, 7) + [host_ed.IDENTITY], fe_radix)
    for _ in range(2):  # canonical limbs, then product outputs
        want = curve.ext_double(p, compute_t=compute_t, fe_radix=fe_radix)
        _assert_lanes_equal(curve.lane_double(curve.to_lanes(p), compute_t, fe_radix), want)
        p = want


@pytest.mark.parametrize("fe_radix", FIELDS)
def test_lane_pniels_add_equals_pniels_add(fe_radix):
    """One lane-form addition is pniels_add's, limb for limb, over table
    entries 0 (the identity), 1 and 15, on random points, the identity
    and a doubling's output."""
    rng = np.random.default_rng(12)
    pts = _random_points(rng, 7) + [host_ed.IDENTITY]
    p = _extended(pts, fe_radix)
    q = curve.ext_double(p, fe_radix=fe_radix)
    tables = T(np.stack([curve.build_pniels_table(a, fe_radix) for a in _random_points(rng, 8)]))
    for k in (0, 1, 15):
        rows = tables[:, k]
        n = curve._entry(rows, fe_radix)
        for acc in (p, q):
            _assert_lanes_equal(curve.lane_pniels_add(curve.to_lanes(acc), rows, fe_radix),
                                curve.pniels_add(acc, n, fe_radix))


@pytest.mark.parametrize("form", ["gathered", "indexed"])
@pytest.mark.parametrize("fe_radix", FIELDS)
def test_lanes_accumulator_equals_one_lane(fe_radix, form):
    """The lane form's Extended accumulator is the one-lane body's limb
    for limb: window by window over the first two windows, and after all
    64 (K5's gathered tables, or K2's epoch tables by validator)."""
    k5, val_idx, tables = _port_inputs(fe_radix)
    s, h, a_tables = k5[0], k5[1], k5[2]
    base = curve.base_table("cpu", fe_radix)
    if form == "gathered":
        got = curve.double_scalar_mul_lanes(s, h, base, a_tables, fe_radix)
        want = curve.double_scalar_mul(s, h, base, a_tables, fe_radix)
    else:
        got = curve.double_scalar_mul_indexed_lanes(s, h, base, tables, val_idx, fe_radix)
        want = curve.double_scalar_mul_indexed(s, h, base, tables, val_idx, fe_radix)
    for c in range(4):
        assert torch.equal(got[c], want[c]), f"coordinate {'XYZT'[c]}"
    one = curve.ext_identity((s.shape[0],), fe_radix=fe_radix)
    lanes = curve.to_lanes(one)
    rows = torch.arange(s.shape[0])
    for w in range(2):
        for k in range(4):
            one = curve.ext_double(one, compute_t=k == 3, fe_radix=fe_radix)
            lanes = curve.lane_double(lanes, k == 3, fe_radix)
        for entry in (base[s[:, w].long() & 15], a_tables[rows, h[:, w].long() & 15]):
            one = curve.pniels_add(one, curve._entry(entry, fe_radix), fe_radix)
            lanes = curve.lane_pniels_add(lanes, entry, fe_radix)
        _assert_lanes_equal(lanes, one)


@pytest.mark.parametrize("form", ["gathered", "indexed"])
@pytest.mark.parametrize("fe_radix", FIELDS)
def test_y_and_parity_match_jax(jax_ref, fe_radix, form):
    """encode([s]B + [h]A') by the lane form, over K5's gathered tables
    or K2's epoch tables by validator (dsm_encode's plain version), equals
    JAX double_scalar_mul + ext_encode on every row: the batch, the edge
    scalars and the random pairs."""
    F = field.ops(fe_radix)
    k5, val_idx, tables = _port_inputs(fe_radix)
    if form == "gathered":
        y, parity = curve.ext_encode(curve.double_scalar_mul_lanes(
            k5[0], k5[1], curve.base_table("cpu", fe_radix), k5[2], fe_radix), fe_radix)
    else:
        y, parity = curve.dsm_encode(k5[0], k5[1], val_idx, tables, fe_radix=fe_radix)
    np.testing.assert_array_equal(F.frozen_to_bytes(y.numpy()), jax_ref["y"])
    np.testing.assert_array_equal(parity.numpy(), jax_ref["parity"])
    n_edge = len(EDGE) ** 2
    zero = F.frozen_to_bytes(F.int_to_limbs(1))  # s = h = 0: the identity, y = 1
    np.testing.assert_array_equal(F.frozen_to_bytes(y.numpy()[-N_RANDOM - n_edge]), zero)


@pytest.mark.parametrize("fe_radix", FIELDS)
def test_k5_mask_matches_jax(jax_ref, fe_radix):
    """K5's plain version (the wrapper on CPU tensors, and verify_batch
    asked for the CPU) gives JAX verify_kernel's mask on every row."""
    k5, _val_idx, _tables = _port_inputs(fe_radix)
    got = eb.verify_kernel(*k5, fe_radix=fe_radix).numpy()
    np.testing.assert_array_equal(got, jax_ref["mask"])
    batch = eb.PreparedBatch(*(x.numpy() for x in k5))
    np.testing.assert_array_equal(eb.verify_batch(batch, device="cpu", fe_radix=fe_radix),
                                  jax_ref["mask"])
    assert 0 < got.sum() < len(got)
