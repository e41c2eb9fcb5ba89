"""Parent-against-this comparisons of the port on one NVIDIA GPU.

Unpack the commit to compare with into a directory that .gitignore
lists, then run from the repo root:

    mkdir -p txflow_tpu_torch/_build/parent
    git archive PARENT_COMMIT | tar -x -C txflow_tpu_torch/_build/parent
    python3 -m txflow_tpu_torch.parent_ab --launch-ab txflow_tpu_torch/_build/parent
    python3 -m txflow_tpu_torch.parent_ab --kernels-ab txflow_tpu_torch/_build/parent
    python3 -m txflow_tpu_torch.parent_ab --fingerprints txflow_tpu_torch/_build/parent

``--launch-ab PARENT`` times the small kernels' wrappers (K4, the K7
partial, reduce and ring hop, and torch.add beside them) of the checkout
at PARENT and of this one in turns (parent, this, this, parent), one
process each that imports its tree's package and builds its tree's tally
library; writes chiprun_out/parent_ab_launch.json.

``--kernels-ab PARENT`` times the kernels of both verify libraries through
their wrappers -- over radix 2^25.5 (``verify``) K1 ``fe_ops`` (4096
elements), K3 at rungs 64, 256, 4096 and 16384, K6 at rungs 8 and 16384 (a
32-key committee's tables), K5 (16384 rows), K2 (256 pairs) and the fused
K7 partial (4096 rows, 4096 slots); over radix 2^13 (``verify13``, K8)
``fe13_ops`` and the raw products ``txf_fe_prod`` (4096 elements each, the
products on bound-edge inputs), K3 at rungs 64 and 16384, K6 at rungs 8
and 16384, K5 and K2 -- of the checkout at PARENT and of this one in turns
(parent, this, this, parent), one process each that builds its tree's two
verify libraries alone, on the same seeded inputs (random nibbles over
seeded keys; R is the plain version's encoding of each row's point, every
8th row's corrupted; the bound-edge limbs are made once, by this tree, and
read by every process). Each process also launches each kernel's C entry
once into zeroed buffers of its own; the first launch's points buffers,
K2's y and parity, the field kernels' limbs, every mask and the K7 partial
must be bitwise equal between the trees (the run raises otherwise). Beside
the times: each tree's ptxas registers and spills, and the SASS of both
fields (instructions and multiply-adds of one product, one squaring and
one mul_small in probe kernels built from the tree's fe25519.cuh and
fe25519_13.cuh, and of every kernel of its verify libraries, by
``cuobjdump -sass``); writes chiprun_out/parent_ab_kernels.json.

``--fingerprints PARENT`` runs the default run of ``chip_smoke.py`` of
the checkout at PARENT and of this one, one process each, and requires
every phase's certificate rows and app digest (slice, radix 13, int64,
the committee server and both followers, the mesh and one-card engines)
to be equal; writes chiprun_out/parent_ab_fingerprints.json. It takes
two default runs' time.

Nothing runs on import: the module only reads this tree's chip_smoke.py
when a mode starts.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.abspath(__file__)


def _chip_smoke():
    """This tree's chip_smoke.py as a module (its kernels' timing window
    and the main path's shapes). It imports ``txflow_tpu_torch`` from the
    first tree on ``sys.path``: in ``--launch-only``, the measured one."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_kernel_times(cs) -> dict:
    """Milliseconds a launch of each small kernel's wrapper, at the main
    path's shapes on seeded inputs, each 500 launches in one CUDA-event
    window after 5 of warmup: K4 ``tally_into`` (16384 votes, 4096
    slots), K7 ``tally_partial`` (4096 votes, one of 4 shards),
    ``reduce_quorum`` (4 partials x 4096 slots), the ring hop ``ring_add``
    (4096 slots, as the tree's ring uses it) and ``torch.add`` beside it.
    Only wrapper names and signatures that both trees have."""
    import numpy as np
    import torch

    from txflow_tpu_torch.ops import tally

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 23)
    b, s = cs.MAX_BATCH, cs.N_TXS

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    valid = T(rng.integers(0, 2, b).astype(np.int32))
    slot = T(rng.integers(-1, s, b).astype(np.int32))
    vidx = T(rng.integers(0, cs.N_VALS, b).astype(np.int32))
    powers = T((10 * (1 + np.arange(32) % 4)).astype(np.int32))
    prior = T(rng.integers(0, 200, s).astype(np.int32))
    stake = torch.empty(s, dtype=torch.int32, device=dev)
    maj = torch.empty(s, dtype=torch.int32, device=dev)
    q = b // cs.MESH_SHARDS
    parts = torch.stack([tally.tally_partial(valid[i * q:(i + 1) * q], slot[i * q:(i + 1) * q],
                                             vidx[i * q:(i + 1) * q], powers, s)
                         for i in range(cs.MESH_SHARDS)])
    acc, hop = parts[0].clone(), parts[1]
    fns = {
        "tally_into": lambda: tally.tally_into(stake, maj, valid, slot, vidx, powers, prior, 267),
        "tally_partial": lambda: tally.tally_partial(valid[:q], slot[:q], vidx[:q], powers, s),
        "reduce_quorum": lambda: tally.reduce_quorum(parts, prior, 267),
        "ring_add": lambda: tally.ring_add(acc, hop),
        "torch_add": lambda: torch.add(acc, hop),
    }
    return {k: cs.cuda_ms_window(fn, 500, warmup=5) for k, fn in fns.items()}


def launch_only() -> None:
    """``--launch-only``, run with a tree's root first on ``sys.path``:
    build that tree's tally library alone through its own ``_lib``, then
    print ``small_kernel_times`` as one JSON line."""
    from txflow_tpu_torch.ops import _lib

    _lib.LIBS = {"tally": _lib.LIBS["tally"]}  # build_all then builds tally alone
    _lib.library("tally")
    print(json.dumps({"tree": str(_lib.PKG.parent), "ms": small_kernel_times(_chip_smoke())}),
          flush=True)


K3_RUNGS = (64, 256, 4096, 16384)
K6_RUNGS = (8, 16384)
K8_RUNGS = {"k3": (64, 16384), "k6": (8, 16384)}  # K3 and K6 over the radix-2^13 field
KERNEL_ROWS = 16384


def kernel_inputs(cs, dev, edge13: str) -> dict:
    """The kernel A/B's inputs, made from a seed by numpy and the tree's
    host code (identical in both trees; their digest is compared): 16384
    rows of random nibbles over 16 seeded keys (K3, K5, K2, K7) and over a
    32-key committee (K6), 1 row in 16 failing its pre-checks, with each
    key set's tables over both fields; R and its sign the plain version's
    encoding of each row's point, so the rows verify, except every 8th
    row's, whose R has a flipped byte. Field elements: N_FE random values
    as limbs of each field, and the radix-2^13 bound-edge pairs of the
    ``.npz`` at ``edge13``."""
    import numpy as np
    import torch

    from txflow_tpu_torch.crypto import ed25519 as host_ed
    from txflow_tpu_torch.ops import curve, ed25519_batch, fe, fe13

    rng = np.random.default_rng(cs.SEED + 31)
    n = KERNEL_ROWS

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    s_nib = T(rng.integers(0, 16, (n, 64), dtype=np.uint8))
    h_nib = T(rng.integers(0, 16, (n, 64), dtype=np.uint8))
    pre_ok = np.ones(n, bool)
    pre_ok[::16] = False
    sets, sets13 = {}, {}
    for name, v in (("k3", 16), ("k6", 32)):
        keys = [host_ed.public_key_from_seed(rng.bytes(32)) for _ in range(v)]
        epoch = ed25519_batch.EpochTables(keys, fe_radix=25)
        tables, quarters = epoch.device_tables(dev), epoch.device_quarter_tables(dev)
        vidx = T(rng.integers(0, v, n).astype(np.int32))
        y, parity = curve.dsm_encode_plain(s_nib, h_nib, vidx, tables)
        r_y = fe.frozen_to_bytes(y.cpu().numpy())
        r_y[::8, 3] ^= 0x40
        sets[name] = (s_nib, h_nib, vidx, tables, quarters, T(r_y),
                      T(parity.cpu().numpy().astype(np.uint8)), T(pre_ok))
        epoch13 = ed25519_batch.EpochTables(keys, fe_radix=13)
        sets13[name] = (*sets[name][:3], epoch13.device_tables(dev), epoch13.device_quarter_tables(dev),
                        *sets[name][5:])
    vals = [int.from_bytes(rng.bytes(32), "little") & (2**255 - 1) for _ in range(2 * cs.N_FE)]
    raw = np.stack([np.frombuffer(x.to_bytes(32, "little"), np.uint8) for x in vals])
    limbs, limbs13 = T(fe.bytes_to_limbs_np(raw)), T(fe13.bytes_to_limbs_np(raw))
    with np.load(edge13) as z:
        edge = (T(z["a"]), T(z["b"]))
    q = n // cs.MESH_SHARDS
    return {"k3": sets["k3"], "k6": sets["k6"], "fe": (limbs[:cs.N_FE], limbs[cs.N_FE:]),
            "k3_13": sets13["k3"], "k6_13": sets13["k6"],
            "fe13": (limbs13[:cs.N_FE], limbs13[cs.N_FE:]), "fe13_edge": edge,
            "slot": T(rng.integers(-1, q, q).astype(np.int32)),
            "powers": T((10 * (1 + np.arange(16) % 4)).astype(np.int32)), "partial_rows": q}


def _rows(args, rung: int):
    """The first ``rung`` rows of a verify argument tuple, the tables whole."""
    return tuple(a if i in (3, 4) else a[:rung] for i, a in enumerate(args))


def _digest(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _field_outputs(inp, dev, radix: int) -> dict:
    """sha256 of what the verify library of one field writes, each C entry
    launched once into zeroed buffers (the points of the first launch,
    then the second launch's output): K3 and K6 at each rung, K5, K2
    (points, y, parity)."""
    import torch

    from txflow_tpu_torch.ops import _lib, curve

    sfx, tag = ("", "") if radix == 25 else ("13", "_13")
    nl = 10 if radix == 25 else 20
    base = curve.device_base_quarters(dev, radix)
    out = {}
    rungs = {"k3": K3_RUNGS, "k6": K6_RUNGS} if radix == 25 else K8_RUNGS
    for name in ("k3", "k6"):
        for rung in rungs[name]:
            a = _rows(inp[name + tag], rung)
            points = torch.zeros((rung, 3, nl), dtype=torch.int32, device=dev)
            mask = torch.zeros((rung,), dtype=torch.int32, device=dev)
            _lib.launch("verify" + sfx, "txf_verify", mask, rung, *(t.data_ptr() for t in a[:5]),
                        a[3].shape[0], base.data_ptr(), *(t.data_ptr() for t in a[5:]),
                        points.data_ptr(), mask.data_ptr(), rung)
            out[f"{name}{tag}_rung{rung}"] = _digest(points, mask)
            out[f"{name}{tag}_rung{rung}_valid"] = int(mask.sum())
    a = inp["k3" + tag]
    n = a[0].shape[0]
    gathered = a[3][a[2].long()].contiguous()
    scratch = torch.zeros((n * (3 * nl + 1),), dtype=torch.int32, device=dev)
    _lib.launch("verify_tables" + sfx, "txf_verify_tables", scratch, n, a[0].data_ptr(),
                a[1].data_ptr(), gathered.data_ptr(), base.data_ptr(), *(t.data_ptr() for t in a[5:]),
                scratch.data_ptr(), scratch[n * 3 * nl:].data_ptr(), n)
    out["k5" + tag] = _digest(scratch)
    m = 256
    scratch = torch.zeros((m * (4 * nl + 1),), dtype=torch.int32, device=dev)
    _lib.launch("dsm_encode" + sfx, "txf_dsm_encode", scratch, m, a[0].data_ptr(), a[1].data_ptr(),
                a[2].data_ptr(), a[3].data_ptr(), a[3].shape[0], base.data_ptr(),
                scratch.data_ptr(), scratch[m * 3 * nl:].data_ptr(),
                scratch[m * 4 * nl:].data_ptr(), m)
    out["k2_points_y_parity" + tag] = _digest(scratch)
    return out


def _fe13_prod(a, b):
    """verify13's ``txf_fe_prod`` on [n, 20] limbs: ``fe13.fe13_prod``,
    or, in a tree whose fe13 has no such wrapper, its C entry (which both
    trees build) under a ``fe13_prod`` key registered here."""
    import torch

    from txflow_tpu_torch.ops import _lib, fe13

    if hasattr(fe13, "fe13_prod"):
        return fe13.fe13_prod(a, b)
    _lib.KERNELS.setdefault("fe13_prod", "verify13")
    _lib.launches.setdefault("fe13_prod", 0)
    out = torch.empty((a.shape[0], 3, 20), dtype=torch.int32, device=a.device)
    _lib.launch("fe13_prod", "txf_fe_prod", out, a.shape[0], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), a.shape[0])
    return out


def kernel_outputs(inp, dev) -> dict:
    """sha256 of what each kernel's C entry writes, in both fields (see
    ``_field_outputs``), with K1's and K8's field kernels (K8's raw
    products on the bound edges too) and the fused K7 partial (packed head
    and partial)."""
    import torch

    from txflow_tpu_torch.ops import fe, fe13, tally

    out = {**_field_outputs(inp, dev, 25), **_field_outputs(inp, dev, 13)}
    out["k1_fe_ops"] = _digest(fe.fe_ops(*inp["fe"]))
    out["k8_fe13_ops"] = _digest(fe13.fe13_ops(*inp["fe13"]))
    out["k8_fe13_prod_edges"] = _digest(_fe13_prod(*inp["fe13_edge"]))
    a = inp["k3"]
    q = inp["partial_rows"]
    packed, part = tally.compact_step_partial(*_rows(a, q)[:3], *_rows(a, q)[5:], inp["slot"],
                                              a[3], a[4], inp["powers"], q)
    out["k7_partial"] = _digest(packed[:q], part)
    torch.cuda.synchronize()
    return out


def kernel_times(cs, inp) -> dict:
    """Milliseconds a wrapper call of each kernel: many calls between one
    pair of CUDA events (``cs.cuda_ms_window``), after warmup."""
    from txflow_tpu_torch.ops import curve, ed25519_batch, fe, fe13, tally

    a = inp["k3"]
    gathered = a[3][a[2].long()].contiguous()
    q = inp["partial_rows"]
    acc = tally.compact_step_partial(*_rows(a, q)[:3], *_rows(a, q)[5:], inp["slot"], a[3], a[4],
                                     inp["powers"], q)[1]
    fns = {"k1_fe_ops_4096": (lambda: fe.fe_ops(*inp["fe"]), 50)}
    for name, rungs in (("k3", K3_RUNGS), ("k6", K6_RUNGS)):
        for rung in rungs:
            args = _rows(inp[name], rung)
            fns[f"{name}_rung{rung}"] = (
                lambda args=args: ed25519_batch.verify_kernel_gather(*args),
                200 if rung <= 8 else 50 if rung <= 4096 else 10)
    fns["k5_16384"] = (lambda: ed25519_batch.verify_kernel(a[0], a[1], gathered, *a[5:]), 10)
    fns["k2_256"] = (lambda: curve.dsm_encode(a[0][:256], a[1][:256], a[2][:256], a[3]), 10)
    fns["k7_partial_4096"] = (
        lambda: tally.compact_step_partial(*_rows(a, q)[:3], *_rows(a, q)[5:], inp["slot"], a[3],
                                           a[4], inp["powers"], q, partial=acc), 20)
    a13 = inp["k3_13"]
    gathered13 = a13[3][a13[2].long()].contiguous()
    fns["k8_fe13_ops_4096"] = (lambda: fe13.fe13_ops(*inp["fe13"]), 50)
    fns["k8_fe13_prod_4096"] = (lambda: _fe13_prod(*inp["fe13_edge"]), 200)
    for name, rungs in K8_RUNGS.items():
        for rung in rungs:
            args = _rows(inp[name + "_13"], rung)
            fns[f"k8_{name}_rung{rung}"] = (
                lambda args=args: ed25519_batch.verify_kernel_gather(*args, fe_radix=13),
                100 if rung <= 64 else 10)
    fns["k8_k5_16384"] = (
        lambda: ed25519_batch.verify_kernel(a13[0], a13[1], gathered13, *a13[5:], fe_radix=13), 10)
    fns["k8_k2_256"] = (
        lambda: curve.dsm_encode(a13[0][:256], a13[1][:256], a13[2][:256], a13[3], fe_radix=13), 10)
    return {k: cs.cuda_ms_window(fn, reps) for k, (fn, reps) in fns.items()}


def kernels_only(edge13: str) -> None:
    """``--kernels-only EDGE13``, run with a tree's root first on
    ``sys.path``: build that tree's two verify libraries alone, then print
    one JSON line of its kernels' times, output digests, input digest and
    ptxas registers."""
    import torch

    from txflow_tpu_torch.ops import _lib

    # build_all then builds these two alone, in parallel
    _lib.LIBS = {k: _lib.LIBS[k] for k in ("verify", "verify13")}
    _lib.library("verify")
    _lib.library("verify13")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    inp = kernel_inputs(cs, dev, edge13)
    digest_in = _digest(*inp["k3"], *inp["k6"][2:], *inp["k3_13"][3:5], *inp["k6_13"][3:5],
                        *inp["fe"], *inp["fe13"], *inp["fe13_edge"], inp["slot"], inp["powers"])
    outs = kernel_outputs(inp, dev)
    ptx = cs.ptxas_info()
    print(json.dumps({"tree": str(_lib.PKG.parent), "inputs": digest_in, "outputs": outs,
                      "ms": kernel_times(cs, inp),
                      "ptxas": {k: ptx[k] for k in ("verify", "verify13")}}), flush=True)


# probe kernels of one field function each, built from a tree's field
# header: load f and g, t = the function, store t + g; probe_add's
# function is a copy, so a probe less probe_add is the function's own
_PROBE = r"""
#include "%s"
#define TXF_PROBE(name, body)                                                 \
  extern "C" __global__ void name(const int32_t* a, const int32_t* b,       \
                                  int32_t* o) {                             \
    const int64_t e = (int64_t)blockIdx.x * TXF_NLIMB;                      \
    a += e;                                                                 \
    b += e;                                                                 \
    o += e;                                                                 \
    fe f, g, h, t;                                                          \
    for (int l = 0; l < TXF_NLIMB; ++l) {                                   \
      f[l] = a[l];                                                          \
      g[l] = b[l];                                                          \
    }                                                                       \
    body;                                                                   \
    fe_add(h, t, g);                                                        \
    for (int l = 0; l < TXF_NLIMB; ++l) o[l] = h[l];                        \
  }
TXF_PROBE(probe_add, fe_copy(t, f))
TXF_PROBE(probe_mul, fe_mul(t, f, g))
TXF_PROBE(probe_sq, fe_sq(t, f))
TXF_PROBE(probe_mul_small, fe_mul_small(t, f, 2))
"""
# field header -> the name of its probes' set
PROBE_HEADERS = {"fe25519.cuh": "probes", "fe25519_13.cuh": "probes13"}


def _sass_text(path: str) -> str:
    """``cuobjdump -sass`` of a cubin or shared library."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True).stdout


def sass_opcodes(path: str) -> dict:
    """{function: {opcode: count}} of every function in the SASS of a
    cubin or shared library (``cuobjdump -sass``), NOPs left out."""
    import re

    funcs, cur = {}, None
    for ln in _sass_text(path).splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and cur is not None and not m.group(1).startswith("NOP"):
            op = m.group(1)
            cur[op] = cur.get(op, 0) + 1
    return funcs


def _summary(ops: dict) -> dict:
    """Instruction counts of one function: total, signed wide multiply-adds
    (``IMAD.WIDE``: radix 2^25.5's 32x32->64 products; ``IMAD.WIDE.U32``
    is address arithmetic and the carry's x19) and 32-bit multiply-adds
    (``IMAD``: radix 2^13's products, the x608 wraps and moves the
    compiler writes as multiply-adds by one)."""
    return {"total": sum(ops.values()), "imad_wide": ops.get("IMAD.WIDE", 0),
            "imad": ops.get("IMAD", 0),
            "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def sass_counts(tree: str) -> dict:
    """The SASS of a tree's fields and kernels: each probe kernel of each
    field (one fe_mul, fe_sq or fe_mul_small between the same loads, add
    and stores; ``op``, ``op_imad_wide`` and ``op_imad`` are its
    instructions and multiply-adds less probe_add's, the function's own),
    and every kernel and device function of the tree's built verify
    libraries."""
    import tempfile

    from txflow_tpu_torch.ops import _lib

    csrc = os.path.join(tree, "txflow_tpu_torch", "csrc")
    out = {}
    tag = "this" if os.path.samefile(tree, HERE) else os.path.basename(os.path.normpath(tree))
    os.makedirs("chiprun_out", exist_ok=True)
    for header, key in PROBE_HEADERS.items():
        with tempfile.TemporaryDirectory() as d:
            src, cubin = os.path.join(d, "probe.cu"), os.path.join(d, "probe.cubin")
            with open(src, "w") as f:
                f.write(_PROBE % header)
            subprocess.run([_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                            "-std=c++17", "-cubin", "-I", csrc, "-o", cubin, src], check=True,
                           capture_output=True)
            probes = {k: _summary(v) for k, v in sass_opcodes(cubin).items() if k.startswith("probe_")}
            with open(os.path.join("chiprun_out", f"parent_ab_{key}_sass_{tag}.txt"), "w") as f:
                f.write(_sass_text(cubin))
        base = probes["probe_add"]
        for p in probes.values():
            for x in ("total", "imad_wide", "imad"):
                p["op" if x == "total" else "op_" + x] = p[x] - base[x]
        out[key] = probes
    out["library"] = {}
    for lib in ("verify", "verify13"):
        path = os.path.join(tree, "txflow_tpu_torch", "_build", f"lib{lib}.so")
        out["library"][lib] = {_short(k): {x: v for x, v in _summary(ops).items() if x != "by_opcode"}
                               for k, ops in sass_opcodes(path).items()}
    return out


def _short(name: str) -> str:
    """A kernel's name without its mangling (``txf_verify_encode_kernel<int32>``),
    as ``chip_smoke.ptxas_info`` names it; any other function's as it is."""
    import re

    k = re.search(r"(txf_\w+?_kernel)(I[il]E)?", name)
    return k.group(1) + {"IiE": "<int32>", "IlE": "<int64>"}.get(k.group(2), "") if k else name


def _edge13(path: str) -> None:
    """Write the radix-2^13 bound-edge pairs (4096, every kind of
    ``fe13.EDGE_KINDS`` alike) that every tree's process reads."""
    import numpy as np

    from txflow_tpu_torch.ops import fe13

    rng = np.random.default_rng(_chip_smoke().SEED + 37)
    n = 4096 // len(fe13.EDGE_KINDS)
    sizes = [n] * (len(fe13.EDGE_KINDS) - 1) + [4096 - n * (len(fe13.EDGE_KINDS) - 1)]
    pairs = [fe13.bound_edge_limbs(rng, m, k) for m, k in zip(sizes, fe13.EDGE_KINDS)]
    np.savez(path, a=np.concatenate([p[0] for p in pairs]), b=np.concatenate([p[1] for p in pairs]))


def kernels_ab(parent: str) -> dict:
    """The kernels of both verify libraries of the checkout at PARENT and
    of this one, in turns (parent, this, this, parent): times, registers
    and SASS; raises unless every output is bitwise equal between the
    trees."""
    import tempfile

    if os.path.samefile(parent, HERE):
        raise RuntimeError(f"{parent} is this tree: nothing to compare")
    runs = []
    with tempfile.TemporaryDirectory() as d:
        edge13 = os.path.join(d, "edge13.npz")
        _edge13(edge13)
        for tree in (parent, HERE, HERE, parent):
            code = ("import runpy, sys; sys.path.insert(0, %r); sys.argv = [%r, '--kernels-only', %r]; "
                    "runpy.run_path(%r, run_name='__main__')" % (tree, SCRIPT, edge13, SCRIPT))
            got = _run(tree, code)
            if got["tree"] != tree:
                raise RuntimeError(f"the run in {tree} imported the package of {got['tree']}")
            print(json.dumps({"tree": tree, "ms": got["ms"]}), flush=True)
            runs.append(got)
    if len({r["inputs"] for r in runs}) != 1:
        raise RuntimeError("the trees made different inputs")
    diff = sorted(k for r in runs[1:] for k in r["outputs"] if r["outputs"][k] != runs[0]["outputs"][k])
    if diff:
        raise RuntimeError(f"outputs differ from the parent's: {sorted(set(diff))}")
    ms = {k: {"parent": [runs[0]["ms"][k], runs[3]["ms"][k]], "this": [runs[1]["ms"][k], runs[2]["ms"][k]],
              "this_over_parent": (runs[1]["ms"][k] + runs[2]["ms"][k]) / (runs[0]["ms"][k] + runs[3]["ms"][k])}
          for k in runs[0]["ms"]}
    return {"ms": ms, "outputs": runs[0]["outputs"],
            "ptxas": {"parent": runs[0]["ptxas"], "this": runs[1]["ptxas"]},
            "sass": {"parent": sass_counts(parent), "this": sass_counts(HERE)}}


def _run(tree: str, code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"the run in {tree} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def launch_ab(parent: str) -> dict:
    """The small kernels' launch times of the checkout at PARENT and of
    this one, in turns (parent, this, this, parent)."""
    runs = []
    for tree in (parent, HERE, HERE, parent):
        code = ("import runpy, sys; sys.path.insert(0, %r); sys.argv = [%r, '--launch-only']; "
                "runpy.run_path(%r, run_name='__main__')" % (tree, SCRIPT, SCRIPT))
        got = _run(tree, code)
        if got["tree"] != tree:
            raise RuntimeError(f"the run in {tree} imported the package of {got['tree']}")
        runs.append(got)
    return {k: {"parent": [runs[0]["ms"][k], runs[3]["ms"][k]], "this": [runs[1]["ms"][k], runs[2]["ms"][k]]}
            for k in runs[0]["ms"]}


# Run in a process of its own with a checkout's root first on sys.path:
# that checkout's chip_smoke.main() (its default run), with every TxStore
# and KVStoreApplication the run makes recorded; then one JSON line of a
# sha256 per store over its certificate rows in commit order, and each
# app's digest, in the order the run made them.
_FINGERPRINT_RUN = """
import hashlib, json, sys
sys.path.insert(0, {tree!r})
sys.argv = ["chip_smoke.py"]
import chip_smoke as cs
stores, apps = [], []
class Store(cs.TxStore):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        stores.append(self)
class App(cs.KVStoreApplication):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        apps.append(self)
cs.TxStore, cs.KVStoreApplication = Store, App
rc = cs.main()
def rows(st):
    return hashlib.sha256(b"".join(h.encode() + st.load_cert_row(h)
                                   for h in st.committed_hashes_in_order())).hexdigest()
print(json.dumps({{"tree": cs.__file__, "rc": rc, "stores": [rows(st) for st in stores],
                  "commits": [st.seq_count() for st in stores],
                  "apps": [a.digest.hex() for a in apps]}}))
"""


def fingerprints(parent: str) -> dict:
    """The default run of the checkout at PARENT and of this one, every
    certificate store and app digest fingerprinted; every phase's
    certificates and app digest must be equal."""
    runs = {}
    for name, tree in (("parent", parent), ("this", HERE)):
        runs[name] = _run(tree, _FINGERPRINT_RUN.format(tree=tree))
        if runs[name]["rc"] != 0:
            raise RuntimeError(f"the default run in {tree} returned {runs[name]['rc']}")
        if runs[name]["tree"] != os.path.join(tree, "chip_smoke.py"):
            raise RuntimeError(f"the run in {tree} imported {runs[name]['tree']}")
    p, t = runs["parent"], runs["this"]
    if not (len(t["stores"]) == 8 and t["stores"] == p["stores"] and t["commits"] == p["commits"]):
        raise RuntimeError(f"certificate rows differ from the parent's: {p} != {t}")
    if t["apps"] != p["apps"]:
        raise RuntimeError(f"app digests differ from the parent's: {p} != {t}")
    return {"parent": p, "this": t}


def main(argv: list[str]) -> int:
    if argv == ["--launch-only"]:
        launch_only()
        return 0
    if len(argv) == 2 and argv[0] == "--kernels-only":
        kernels_only(argv[1])
        return 0
    modes = {"--launch-ab": (launch_ab, "launch", "launch_ab_ms"),
             "--kernels-ab": (kernels_ab, "kernels", "kernels_ab"),
             "--fingerprints": (fingerprints, "fingerprints", "fingerprints")}
    if len(argv) != 2 or argv[0] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    fn, tag, key = modes[argv[0]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    got = fn(os.path.abspath(argv[1]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"parent_ab_{tag}.json"), "w") as f:
        json.dump({"card": card, key: got}, f, indent=1)
    print(json.dumps({key: got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
