"""PyTorch port, the radix-2^13 field's product (K8): the dedicated
``fe_sq`` of txflow_tpu_torch/csrc/fe25519_13.cuh (20 squares and 190
doubled cross products, one running sum a column) and its column sums
give exactly the limbs of ``fe_mul(f, f)`` and of the JAX package's
``fe13.fe_mul`` for every normalized input -- the bound edges
included (limbs at 0 and at 9408), not only canonical values. The
header's squaring schedule, read from its source, is held column for
column against the plain product; the plain squaring (``fe_mul(f, f)``)
against the JAX package through bytes; and the CUDA header itself is
compiled by the host C++ compiler under the undefined-behaviour sanitizer
and held against the plain versions on a few thousand bound-edge inputs.
Tolerance 0: limbs are integers."""

import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fe_sq import _cxx
from test_torch_launch import FakeTensor, fake, fake_scratch  # noqa: F401  (fixture)
from txflow_tpu.ops import fe13 as jfe13
from txflow_tpu_torch.ops import _lib, fe13

P = fe13.P_INT
N = fe13.NLIMB
NCOL = 2 * N - 1
CSRC = Path(fe13.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain products here cross torch's intra-op parallel grain;
    beside other test workers each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _body(name):
    src = (CSRC / "fe25519_13.cuh").read_text()
    m = re.search(r"TXF_DEV void %s\([^)]*\) \{(.*?)\n\}" % name, src, re.S)
    assert m, f"{name} not found in fe25519_13.cuh"
    return m.group(1)


def header_sq_schedule():
    """fe13_sq_columns' schedule as fe25519_13.cuh writes it: {operand:
    (limb, scale)} for the limbs f0..f19 and the doublings (``d3 = 2 *
    f3``), and for each column k its running sum's terms ``x * y`` as
    operand pairs, in the header's order."""
    body = _body("fe13_sq_columns")
    operands = {}
    for name, limb in re.findall(r"\b(f\d+) = f\[(\d+)\]", body):
        operands[name] = (int(limb), 1)
    for name, c, x in re.findall(r"\b(d\d+) = (\d+) \* (f\d+)", body):
        operands[name] = (operands[x][0], int(c) * operands[x][1])
    cols = {}
    for k, rhs in re.findall(r"c\[(\d+)\] = (.*?);", body, re.S):
        assert not re.search(r"[()]", rhs), f"column {k} is not one running sum"
        cols[int(k)] = re.findall(r"(\w+) \* (\w+)", rhs)
    assert sorted(cols) == list(range(NCOL)), "fe13_sq_columns' 39 column sums not found"
    return operands, [cols[k] for k in range(NCOL)]


def mul_columns(a, b):
    """[..., 20] int64 limbs -> [..., 39] column sums of the plain product
    (sum of a_i b_j over i + j = k), exact in int64."""
    a, b = a.long(), b.long()
    c = torch.zeros(a.shape[:-1] + (NCOL,), dtype=torch.int64)
    for i in range(N):
        c[..., i:i + N] += a[..., i:i + 1] * b
    return c


def sq_running_sums(f):
    """[..., 20] limbs -> for each column the header's running sums, one a
    term in its order ([..., terms], the last the column's total), and its
    largest term, exact in int64."""
    operands, cols = header_sq_schedule()
    val = {n: f[..., i].long() * s for n, (i, s) in operands.items()}
    sums, tops = [], []
    for col in cols:
        terms = torch.stack([val[x] * val[y] for x, y in col], -1)
        sums.append(terms.cumsum(-1))
        tops.append(int(terms.max()))
    return sums, tops


def reduce_columns(c):
    """The plain fe_mul's carry of 39 column sums: the high 19 (and a zero
    20th) carried 3 passes, folded x608, then 4 passes."""
    c = c.to(torch.int32)
    hi = fe13.fe_carry(torch.cat([c[..., N:], torch.zeros_like(c[..., :1])], -1), passes=3)
    return fe13.fe_carry(c[..., :N] + fe13.WRAP * hi, passes=4)


def edge(kind, n, seed=0x13):
    a, b = fe13.bound_edge_limbs(np.random.default_rng(seed), n, kind)
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("kind", fe13.EDGE_KINDS)
def test_sq_columns_equal_mul_of_itself(kind):
    """The header's squaring schedule forms fe_mul(f, f)'s 39 column sums
    exactly on every bound-edge kind, so after the plain carry its limbs
    are fe_mul(f, f)'s; and the plain fe_sq returns those limbs."""
    a, _ = edge(kind, 128)
    assert int(a.min()) >= 0 and int(a.max()) <= fe13.NORM
    sums, _ = sq_running_sums(a)
    cols = torch.stack([s[..., -1] for s in sums], -1)
    assert torch.equal(cols, mul_columns(a, a))
    sq = reduce_columns(cols)
    assert torch.equal(sq, fe13.fe_mul(a, a)) and torch.equal(fe13.fe_sq(a), sq)
    assert torch.equal(reduce_columns(mul_columns(a, a)), fe13.fe_mul(a, a))
    assert int(sq.max()) <= fe13.NORM and int(sq.min()) >= 0  # normalized again


def test_sq_schedule_is_each_pair_once():
    """The header's schedule: 210 products -- each unordered limb pair
    (i, j), i < j, once, at factor 2, in column i + j, and each square once
    at factor 1 -- from the 20 limbs and 19 doublings."""
    operands, cols = header_sq_schedule()
    seen = {}
    for k, col in enumerate(cols):
        for x, y in col:
            (i, sx), (j, sy) = operands[x], operands[y]
            assert i + j == k
            pair = (min(i, j), max(i, j))
            assert pair not in seen
            seen[pair] = sx * sy
    assert len(seen) == N * (N + 1) // 2 == 210
    assert all(f == (2 if i < j else 1) for (i, j), f in seen.items())
    assert len(operands) == N + N - 1  # the limbs and d0..d18
    assert sorted(operands[f"d{i}"] for i in range(N - 1)) == [(i, 2) for i in range(N - 1)]


def test_terms_and_partial_sums_fit_int32_at_the_bound():
    """At the normalized limit (every limb 9408) every term of the
    squaring (a doubled cross term at most 2 * 9408^2), every running sum
    and every column stays inside int32; so does every column of fe_mul
    (a running sum is at most its column, all terms non-negative), the
    largest 20 * 9408^2 = 1.770e9. At limbs of 10363, 10% past the limit,
    the middle column overflows int32: the bound is what keeps it exact."""
    top = torch.full((1, N), fe13.NORM, dtype=torch.int32)
    sums, tops = sq_running_sums(top)
    assert max(tops) == 2 * fe13.NORM**2 < 2**31
    assert max(int(s.max()) for s in sums) < 2**31
    cols = mul_columns(top, top)
    assert int(cols.max()) == N * fe13.NORM**2 < 2**31
    assert torch.equal(torch.stack([s[..., -1] for s in sums], -1), cols)
    over = torch.full((1, N), 10363, dtype=torch.int32)
    assert int(mul_columns(over, over).max()) >= 2**31 > N * 10362**2


@pytest.mark.parametrize("kind", ["max", "alternating", "sums"])
def test_frozen_sq_matches_jax(kind):
    """The plain squaring's limbs equal the JAX package's fe13.fe_sq
    limb for limb (un-frozen), and frozen they are the same bytes and
    the python square mod p."""
    a, _ = edge(kind, 32, seed=0x14)
    vals = [fe13.limbs_to_int(r) % P for r in a.numpy()]
    got = fe13.fe_sq(a)
    want = jfe13.fe_sq(jnp.asarray(a.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    frozen = fe13.frozen_to_bytes(fe13.fe_freeze(got).numpy())
    jfrozen = fe13.frozen_to_bytes(np.asarray(jfe13.fe_freeze(want)))
    np.testing.assert_array_equal(frozen, jfrozen)
    assert [int.from_bytes(r.tobytes(), "little") for r in frozen] == [v * v % P for v in vals]


def test_bound_counts_the_dedicated_squaring():
    """``fe13.MADS_PER_SQ`` is the header's own count: its products and
    doublings, then the fold's 20 and the seven passes' wraps (256); the
    product keeps 427, and ``sq_as_mul`` the old yardstick of a squaring at
    a product's cost."""
    from txflow_tpu_torch.ops import ed25519_batch, field

    operands, cols = header_sq_schedule()
    products = sum(len(col) for col in cols)
    doublings = sum(1 for _, s in operands.values() if s == 2)
    assert fe13.MADS_PER_SQ == products + doublings + N + 7 == 256
    assert fe13.MADS_PER_MUL == 427
    assert field.mads(13, 10, 4) == 6 * 427 + 4 * 256
    assert field.mads(13, 10, 4, sq_as_mul=True) == 10 * 427
    assert ed25519_batch.mads_per_signature(13) == 1889 * 427 + 1214 * 256
    assert ed25519_batch.mads_per_signature(13, sq_as_mul=True) == 3103 * 427


SHIM = textwrap.dedent("""
    #define TXF_DEV static inline
    #define __device__
    #define __noinline__ __attribute__((noinline))
    #include "fe25519_13.cuh"
    extern "C" {
    void shim_mul(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_mul(o + 20 * r, a + 20 * r, b + 20 * r);
    }
    void shim_sq(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_sq(o + 20 * r, a + 20 * r);
    }
    void shim_mul_small(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_mul_small(o + 20 * r, a + 20 * r, b[20 * r]);
    }
    void shim_freeze(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_freeze(o + 20 * r, a + 20 * r);
    }
    void shim_inv(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_inv(o + 20 * r, a + 20 * r);
    }
    // the column sums, 39 a row, into the first 39 of 40 outputs
    void shim_mul_columns(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe13_mul_columns(o + 40 * r, a + 20 * r, b + 20 * r);
    }
    void shim_sq_columns(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe13_sq_columns(o + 40 * r, a + 20 * r);
    }
    }
""")

# loads the shim with ctypes in a process of its own (a sanitizer report
# aborts it) and runs each function over the .npy inputs it is given
RUNNER = textwrap.dedent("""
    import ctypes, json, sys
    import numpy as np
    lib = ctypes.CDLL(sys.argv[1])
    for fn, a, b, out, width in json.loads(sys.argv[2]):
        a, b = np.load(a), np.load(b)
        o = np.zeros((a.shape[0], width), np.int32)
        getattr(lib, "shim_" + fn)(*(ctypes.c_void_p(x.ctypes.data) for x in (a, b, o)),
                                   ctypes.c_int(a.shape[0]))
        np.save(out, o)
""")


@pytest.fixture(scope="module")
def header_shim(tmp_path_factory):
    """fe25519_13.cuh built by the host C++ compiler into a shared
    library, every signed overflow and other undefined behaviour fatal."""
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp("fe13_shim")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libfe13_shim.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                    "-fsanitize=signed-integer-overflow,undefined", "-fno-sanitize-recover",
                    "-o", str(so), str(d / "shim.cpp")], check=True, capture_output=True)
    return d, so


def _run_shim(d, so, calls):
    """calls: [(fn, a, b)] int32 [n, 20] arrays -> the shim's outputs
    ([n, 20], or [n, 39] for the column sums)."""
    spec = []
    for k, (fn, a, b) in enumerate(calls):
        np.save(d / f"a{k}.npy", np.ascontiguousarray(a, np.int32))
        np.save(d / f"b{k}.npy", np.ascontiguousarray(b, np.int32))
        spec.append((fn, str(d / f"a{k}.npy"), str(d / f"b{k}.npy"), str(d / f"o{k}.npy"),
                     2 * N if fn.endswith("columns") else N))
    run = subprocess.run([sys.executable, "-c", RUNNER, str(so), json.dumps(spec)],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-3000:]
    return [np.load(s[3])[:, :NCOL] if s[0].endswith("columns") else np.load(s[3]) for s in spec]


def test_header_rehearsal_matches_plain(header_shim):
    """The CUDA header compiled as host C++ under
    -fsanitize=signed-integer-overflow,undefined: its column sums, fe_mul,
    fe_sq, fe_mul_small (by 2 and by 121666) and fe_freeze limb for limb
    against the plain versions on 4096 bound-edge inputs, fe_inv on some of
    them; and the raw products that the check entry txf_fe_prod returns."""
    d, so = header_shim
    rng = np.random.default_rng(0x15)
    sizes = [1024, 512, 768, 1024, 768]
    pairs = [fe13.bound_edge_limbs(rng, n, k) for n, k in zip(sizes, fe13.EDGE_KINDS)]
    a = np.concatenate([p[0] for p in pairs])
    b = np.concatenate([p[1] for p in pairs])
    assert a.shape[0] == 4096 and a.min() >= 0 and max(a.max(), b.max()) == fe13.NORM
    A, B = torch.from_numpy(a), torch.from_numpy(b)
    m = fe13.fe_mul(A, B)
    # fe_freeze takes limbs in [0, 2^31): products, sums and the edge itself
    frz = np.concatenate([m.numpy(), (m + fe13.fe_sq(B)).numpy(), a[:1024]]).astype(np.int32)
    small = lambda c: np.full_like(a, c)  # noqa: E731 -- the constant in b's first limb
    inv_rows = np.concatenate([a[:16], a[1024:1032], m[2000:2024].numpy()])
    got = _run_shim(d, so, [("mul_columns", a, b), ("sq_columns", a, a), ("mul", a, b),
                            ("sq", a, b), ("mul_small", a, small(2)),
                            ("mul_small", a, small(121666)), ("freeze", frz, frz),
                            ("inv", inv_rows, inv_rows)])
    want = [mul_columns(A, B).numpy(), mul_columns(A, A).numpy(), m.numpy(), fe13.fe_sq(A).numpy(),
            fe13.fe_mul_small(A, 2).numpy(), fe13.fe_mul_small(A, 121666).numpy(),
            fe13.fe_freeze(torch.from_numpy(frz)).numpy(),
            fe13.fe_inv(torch.from_numpy(inv_rows)).numpy()]
    names = ("mul columns", "sq columns", "mul", "sq", "mul_small 2", "mul_small 121666", "freeze",
             "inv")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(np.stack(got[2:5], 1), fe13.fe13_prod_plain(A, B).numpy())


def test_fe13_prod_wrapper_cpu_plain_and_card_launch(fake, monkeypatch):
    """fe13_prod (K8's check entry): CPU tensors take the plain version;
    on a card one C call of verify13's txf_fe_prod on the tensors' card
    and stream, into one [n, 3, 20] int32 output, counted once -- the
    entry K1's fe_prod calls in the verify library, no kernel of its own."""
    a, b = edge("normalized", 16)
    np.testing.assert_array_equal(fe13.fe13_prod(a, b).numpy(), fe13.fe13_prod_plain(a, b).numpy())
    asked = fake_scratch(monkeypatch)
    out = fe13.fe13_prod(FakeTensor((16, 20), torch.int32, 11, 1),
                         FakeTensor((16, 20), torch.int32, 12, 1))
    assert fake.calls == [("txf_fe_prod13", 1, 1001)]
    assert asked == [((16, 3, 20), torch.int32, torch.device("cuda", 1))] and out.data_ptr() == 5000
    assert _lib.launches["fe13_prod"] == 1 and _lib.KERNELS["fe13_prod"] == "verify13"
    assert _lib.launches["fe_prod"] == 0
    with pytest.raises(ValueError, match="expected shape"):
        fe13.fe13_prod(FakeTensor((16, 10), torch.int32, 11, 1), FakeTensor((16, 10), torch.int32, 12, 1))
