"""PyTorch port, the radix-2^25.5 field's squaring and carry (K1): the
dedicated ``fe_sq`` (ref10's 55 products) and the biased carry chain of
txflow_tpu_torch/csrc/fe25519.cuh give exactly the limbs of ``fe_mul(f,
f)`` and of the plain ``fe_reduce`` for every input within the documented
bounds -- the bound edges included, not only canonical values. The
header's squaring schedule, read from its source, is held column for
column against the plain product; the plain squaring (``fe_mul(f, f)``)
against the JAX package through bytes; and the CUDA header itself is
compiled by the host C++ compiler under the undefined-behaviour sanitizer
and held against the plain versions on a few thousand bound-edge inputs.
Tolerance 0: limbs are integers."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_launch import FakeTensor, fake, fake_scratch  # noqa: F401  (fixture)
from txflow_tpu.ops import fe as jfe
from txflow_tpu_torch.ops import _lib, fe

P = fe.P_INT
CSRC = Path(fe.__file__).resolve().parent.parent / "csrc"


def header_sq_schedule():
    """fe_sq's schedule as fe25519.cuh writes it: {operand: (limb, scale)}
    for the limbs f0..f9 and the int32 prescales (``f5_38 = 38 * f5``),
    and for each column k its terms TXF_M(x, y) as operand pairs."""
    src = (CSRC / "fe25519.cuh").read_text()
    body = re.search(r"TXF_DEV void fe_sq\(fe h, const fe f\) \{(.*?)\n\}", src, re.S).group(1)
    operands = {f"f{i}": (i, 1) for i in range(fe.NLIMB)}
    for name, c, limb in re.findall(r"(f\d_\d+) = (\d+) \* f(\d)", body):
        operands[name] = (int(limb), int(c))
    cols = {}
    for k, terms in re.findall(r"t\[(\d)\] = TXF_BIAS\(\1\)((?:\s*\+\s*TXF_M\(\w+, \w+\))+);", body):
        cols[int(k)] = re.findall(r"TXF_M\((\w+), (\w+)\)", terms)
    assert sorted(cols) == list(range(fe.NLIMB)), "fe_sq's ten column sums not found"
    return operands, [cols[k] for k in range(fe.NLIMB)]


def sq_columns(f):
    """[..., 10] int64 limbs -> [..., 10] column sums of the header's
    schedule (unbiased)."""
    operands, cols = header_sq_schedule()
    val = {n: f[..., i] * c for n, (i, c) in operands.items()}
    return torch.stack([sum(val[x] * val[y] for x, y in col) for col in cols], -1)


def edge(kind, n, seed=0x5C):
    a, b = fe.bound_edge_limbs(np.random.default_rng(seed), n, kind)
    return torch.from_numpy(a).long(), torch.from_numpy(b).long()


@pytest.mark.parametrize("kind", fe.EDGE_KINDS)
def test_sq_limbs_equal_mul_of_itself(kind):
    """(a) The header's squaring schedule forms fe_mul(f, f)'s column sums
    exactly, so after the plain carry its limbs are fe_mul(f, f)'s; and
    the plain fe_sq returns those limbs."""
    a, _ = edge(kind, 256)
    assert a.abs().le(torch.from_numpy(fe.BOUND3)).all()
    gg = a[:, fe._MUL_IDX] * fe._MUL_FACTOR
    cols = sq_columns(a)
    assert torch.equal(cols, (a.unsqueeze(-1) * gg).sum(-2))
    sq = fe.fe_reduce(cols)
    assert torch.equal(sq, fe.fe_mul(a, a)) and torch.equal(fe.fe_sq(a), sq)
    assert sq.abs().max() <= int(1.1 * 2**25) + 1  # carried: 1 unit


def test_sq_schedule_is_each_pair_once():
    """(a) The header's schedule: 55 products, each unordered limb pair
    (i, j) once, in column (i + j) mod 10, at fe_mul's factor times 2 when
    i < j; 13 prescales."""
    operands, cols = header_sq_schedule()
    seen = {}
    for k, col in enumerate(cols):
        for x, y in col:
            (i, sx), (j, sy) = operands[x], operands[y]
            assert (i + j) % 10 == k
            pair = (min(i, j), max(i, j))
            assert pair not in seen
            seen[pair] = sx * sy
    assert len(seen) == 55 and len(operands) == 10 + 13
    assert 55 + 13 == fe.MADS_PER_SQ
    for (i, j), factor in seen.items():
        want = (2 if i & j & 1 else 1) * (19 if i + j >= 10 else 1) * (2 if i < j else 1)
        assert factor == want, (i, j)


@pytest.mark.parametrize("kind", ["canonical", "signs3", "sums"])
def test_frozen_sq_matches_jax(kind):
    """(b) The frozen squaring equals the JAX package's fe_sq of the same
    integers (reduced mod p for its radix-2^8 limbs), through bytes."""
    a, _ = edge(kind, 48, seed=0x5D)
    vals = [fe.limbs_to_int(r) % P for r in a.numpy()]
    got = fe.frozen_to_bytes(fe.fe_freeze(fe.fe_sq(a)).numpy())
    ja = jnp.asarray(np.stack([jfe.int_to_limbs(v) for v in vals]))
    want = np.asarray(jfe.fe_freeze(jfe.fe_sq(ja))).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert [int.from_bytes(r.tobytes(), "little") for r in got] == [v * v % P for v in vals]


def test_prescales_fit_int32_at_the_bound():
    """(c) Every prescaled operand of the header's squaring, and fe_mul's
    2 f / 19 g, stays inside int32 at the 3-unit bound, either sign. The
    bound is tight: the 19 and 38 prescales come within 2.5% of int32's
    edge there, and at 4 units they overflow it."""
    operands, _ = header_sq_schedule()

    def largest(lim):
        return max(abs(int(lim[i])) * c for i, c in operands.values())

    lim = fe.BOUND3
    assert 0.975 * 2**31 < largest(lim) < 2**31
    assert int((19 * lim).max()) < 2**31 and int((2 * lim).max()) < 2**31
    assert largest((44 << (fe.W - 1)) // 10) >= 2**31


def test_bound_counts_squarings_as_the_formulas_do(monkeypatch):
    """The bounds' counts of products and squarings (``curve.SQS_*``,
    ``fe.SQS_PER_FE_OPS``) are the plain formulas' calls: a doubling
    squares four times, the inversion 254 times in 265 products; a
    squaring costs ``MADS_PER_SQ``, and with ``sq_as_mul`` a product."""
    from txflow_tpu_torch.ops import curve, ed25519_batch, field

    calls = {"sq": 0, "mul": 0}
    mul = fe.fe_mul

    def count(kind):
        def f(*x):
            calls[kind] += 1
            return mul(x[0], x[0] if kind == "sq" else x[1])
        return f

    monkeypatch.setattr(fe, "fe_sq", count("sq"))
    monkeypatch.setattr(fe, "fe_mul", count("mul"))
    p = curve.ext_identity((1,))
    for k in range(4):  # a window's four doublings, T on the last
        p = curve.ext_double(p, compute_t=k == 3)
    assert calls["sq"] == curve.SQS_PER_DOUBLINGS
    assert calls["sq"] + calls["mul"] == curve.MULS_PER_DOUBLINGS
    calls.update(sq=0, mul=0)
    fe.fe_inv(torch.ones((1, fe.NLIMB), dtype=torch.int64))
    assert calls == {"sq": curve.SQS_PER_ENCODE, "mul": curve.MULS_PER_ENCODE - 2 - curve.SQS_PER_ENCODE}
    assert fe.SQS_PER_FE_OPS == 1 + curve.SQS_PER_ENCODE
    assert curve.SQS_PER_QUARTER_DSM_ENCODE == 1214 and curve.SQS_PER_DSM_ENCODE == 1278
    assert ed25519_batch.mads_per_signature(25) == 1889 * fe.MADS_PER_MUL + 1214 * fe.MADS_PER_SQ
    assert ed25519_batch.mads_per_signature(25, sq_as_mul=True) == 3103 * fe.MADS_PER_MUL
    assert field.mads(25, 10, 4) == 6 * fe.MADS_PER_MUL + 4 * fe.MADS_PER_SQ
    assert field.mads(25, 10, 4, sq_as_mul=True) == 10 * fe.MADS_PER_MUL


SHIM = textwrap.dedent("""
    #define TXF_DEV static inline
    #define __device__
    #define __noinline__ __attribute__((noinline))
    #include "fe25519.cuh"
    extern "C" {
    void shim_mul(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_mul(o + 10 * r, a + 10 * r, b + 10 * r);
    }
    void shim_sq(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_sq(o + 10 * r, a + 10 * r);
    }
    void shim_mul_small(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_mul_small(o + 10 * r, a + 10 * r, b[10 * r]);
    }
    void shim_freeze(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_freeze(o + 10 * r, a + 10 * r);
    }
    void shim_inv(const int32_t* a, const int32_t* b, int32_t* o, int n) {
      for (int r = 0; r < n; ++r) fe_inv(o + 10 * r, a + 10 * r);
    }
    }
""")

# loads the shim with ctypes in a process of its own (a sanitizer report
# aborts it) and runs each function over the .npy inputs it is given
RUNNER = textwrap.dedent("""
    import ctypes, json, sys
    import numpy as np
    lib = ctypes.CDLL(sys.argv[1])
    for fn, a, b, out in json.loads(sys.argv[2]):
        a, b = np.load(a), np.load(b)
        o = np.zeros_like(a)
        getattr(lib, "shim_" + fn)(*(ctypes.c_void_p(x.ctypes.data) for x in (a, b, o)),
                                   ctypes.c_int(a.shape[0]))
        np.save(out, o)
""")


def _cxx():
    return shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")


@pytest.fixture(scope="module")
def header_shim(tmp_path_factory):
    """fe25519.cuh built by the host C++ compiler into a shared library,
    every signed overflow and other undefined behaviour fatal."""
    cxx = _cxx()
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp("fe_shim")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libfe_shim.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                    "-fsanitize=signed-integer-overflow,undefined", "-fno-sanitize-recover",
                    "-o", str(so), str(d / "shim.cpp")], check=True, capture_output=True)
    return d, so


def _run_shim(d, so, calls):
    """calls: [(fn, a, b)] int32 [n, 10] arrays -> the shim's outputs."""
    spec = []
    for k, (fn, a, b) in enumerate(calls):
        np.save(d / f"a{k}.npy", np.ascontiguousarray(a, np.int32))
        np.save(d / f"b{k}.npy", np.ascontiguousarray(b, np.int32))
        spec.append((fn, str(d / f"a{k}.npy"), str(d / f"b{k}.npy"), str(d / f"o{k}.npy")))
    run = subprocess.run([sys.executable, "-c", RUNNER, str(so), json.dumps(spec)],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-3000:]
    return [np.load(s[3]) for s in spec]


def _ints(x):
    return x.to(torch.int32).numpy()


def test_header_rehearsal_matches_plain(header_shim):
    """(d) The CUDA header compiled as host C++ under
    -fsanitize=signed-integer-overflow,undefined: fe_mul, fe_sq,
    fe_mul_small (by 2 and by -19) and fe_freeze limb for limb against the
    plain versions on 4096 bound-edge inputs, fe_inv on some of them."""
    d, so = header_shim
    rng = np.random.default_rng(0x5E)
    pairs = [fe.bound_edge_limbs(rng, 1024 if k == "signs3" else 768, k) for k in fe.EDGE_KINDS]
    a = np.concatenate([p[0] for p in pairs])
    b = np.concatenate([p[1] for p in pairs])
    assert a.shape[0] == 4096
    A, B = torch.from_numpy(a).long(), torch.from_numpy(b).long()
    # fe_freeze takes 2 units: fe_mul outputs, sums of two, and the corners
    m = fe.fe_mul(A, B)
    corners = fe.BOUND2 * rng.choice(np.array([-1, 1]), (1024, 10))
    frz = np.concatenate([_ints(m), _ints(m + fe.fe_sq(B)), corners]).astype(np.int32)
    small = lambda c: np.full_like(a, c)  # noqa: E731 -- the constant in b's first limb
    inv_rows = np.concatenate([a[:24], _ints(m[1000:1024]), _ints(m[3000:3024])])
    got = _run_shim(d, so, [("mul", a, b), ("sq", a, b), ("mul_small", a, small(2)),
                            ("mul_small", a, small(-19)), ("freeze", frz, frz),
                            ("inv", inv_rows, inv_rows)])
    want = [_ints(m), _ints(fe.fe_sq(A)), _ints(fe.fe_mul_small(A, 2)),
            _ints(fe.fe_mul_small(A, -19)), _ints(fe.fe_freeze(torch.from_numpy(frz).long())),
            _ints(fe.fe_inv(torch.from_numpy(inv_rows).long()))]
    for name, g, w in zip(("mul", "sq", "mul_small 2", "mul_small -19", "freeze", "inv"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # and the raw products that the K1 check entry txf_fe_prod returns
    np.testing.assert_array_equal(np.stack(got[:3], 1), fe.fe_prod_plain(A.int(), B.int()).numpy())


def test_fe_prod_wrapper_cpu_plain_and_card_launch(fake, monkeypatch):
    """fe_prod (the K1 check entry): CPU tensors take the plain version;
    on a card one C call of txf_fe_prod on the tensors' card and stream,
    into one [n, 3, 10] int32 output, counted once."""
    a, b = edge("signs3", 32)
    np.testing.assert_array_equal(fe.fe_prod(a.int(), b.int()).numpy(),
                                  fe.fe_prod_plain(a.int(), b.int()).numpy())
    asked = fake_scratch(monkeypatch)
    out = fe.fe_prod(FakeTensor((32, 10), torch.int32, 11, 1), FakeTensor((32, 10), torch.int32, 12, 1))
    assert fake.calls == [("txf_fe_prod", 1, 1001)]
    assert asked == [((32, 3, 10), torch.int32, torch.device("cuda", 1))] and out.data_ptr() == 5000
    assert _lib.launches["fe_prod"] == 1 and _lib.KERNELS["fe_prod"] == "verify"
    assert _lib.LIBS["verify"][2]["txf_fe_prod"] == _lib.LIBS["verify"][2]["txf_fe_ops"]
