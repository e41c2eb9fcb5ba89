"""Build, load and launch the hand-written CUDA kernels.

Each library of ``LIBS`` is one source in ``csrc/`` with a C entry point,
compiled by ``nvcc`` for ``sm_90a`` with the library's own flags into
``txflow_tpu_torch/_build/`` on first use (all libraries at once, one
``nvcc`` process each, in parallel) and loaded with ctypes. ``verify.cu``
builds twice, once over each field: ``verify`` (radix 2^25.5) and
``verify13`` (radix 2^13, ``-DTXF_FE_RADIX=13``). Nothing here runs at
import: the CPU tests import every module and never reach a build.

Every launch goes through :func:`launch`, which makes the tensors'
card the current device (only when another card is current), passes
PyTorch's current stream there, raises when the C entry point reports a
CUDA error, and adds one to ``launches[kernel]`` -- the count that shows
a run went through the kernel. A failed build or launch raises; there is
no fallback. The launch path is host time on every launch (the small
kernels' whole cost): the library, the bound C function and the card
are resolved once per (kernel, card) into a cached launcher, so a launch
is a dict lookup, a current-device compare, the stream read
(``torch.cuda.current_stream(index).cuda_stream``, the public way: about
4 us of a launch's 16 on the H100's host, ``PERF.md`` section 6) and the
ctypes call. A wrapper checks its tensors in one pass (:func:`check_all`).

No kernel reads ``__constant__`` memory, so a card needs nothing copied
before a library's first launch there: every verify kernel takes the
base point's tables of its field as a device tensor of its own card
(``curve.device_base_quarters``; quarter 0 is the base table that
``txf_verify_tables`` and ``txf_dsm_encode`` read) and stages them in
shared memory per block.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# the C entry points of a verify library, built once for each field
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_VERIFY_FNS = {
    "txf_verify": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P],
    "txf_verify_tally": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _I, _P, _P, _P, _I, _I, _P],
    "txf_verify_tally64": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _L, _P, _P, _P, _P, _I, _I, _P],
    "txf_verify_tables": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "txf_dsm_encode": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
    "txf_fe_ops": [_P, _P, _P, _I, _P],
    "txf_fe_prod": [_P, _P, _P, _I, _P],
}

# library -> (source, extra nvcc flags, {C entry point: argtypes}). One
# source may build several libraries: verify.cu over each field.
LIBS = {
    "verify": ("verify.cu", [], _VERIFY_FNS),
    "verify13": ("verify.cu", ["-DTXF_FE_RADIX=13"], _VERIFY_FNS),
    "tally": (
        "tally.cu",
        [],
        {
            "txf_tally": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P],
            "txf_tally64": [_P, _P, _P, _P, _I, _P, _L, _P, _P, _P, _I, _I, _P],
            "txf_tally_partial": [_P, _P, _P, _P, _I, _P, _I, _I, _P],
            "txf_tally_partial64": [_P, _P, _P, _P, _I, _P, _I, _I, _P],
            "txf_reduce_quorum": [_P, _I, _P, _I, _P, _P, _I, _P],
            "txf_reduce_quorum64": [_P, _I, _P, _L, _P, _P, _I, _P],
            "txf_add": [_P, _P, _I, _P],
        },
    ),
}

# kernel -> library. The fused step's entries (txf_verify_tally(64)) count
# under their own names, by field, width and form: verify[13]_tally[64]
# (the quorum form, one card) and verify[13]_partial[64] (a shard's
# partial, on a mesh).
KERNELS = {"fe_ops": "verify", "fe_prod": "verify", "dsm_encode": "verify", "verify": "verify",
           "verify_tables": "verify", "verify_tally": "verify", "verify_tally64": "verify",
           "verify_partial": "verify", "verify_partial64": "verify",
           "fe13_ops": "verify13", "fe13_prod": "verify13", "dsm_encode13": "verify13",
           "verify13": "verify13", "verify_tables13": "verify13", "verify13_tally": "verify13",
           "verify13_tally64": "verify13", "verify13_partial": "verify13",
           "verify13_partial64": "verify13", "tally": "tally", "tally64": "tally",
           "tally_partial": "tally", "tally_partial64": "tally",
           "reduce_quorum": "tally", "reduce_quorum64": "tally", "ring_add": "tally"}

launches = {k: 0 for k in KERNELS}

_loaded: dict[str, ctypes.CDLL] = {}
# (kernel, C entry point, card) -> its launcher
_launchers: dict[tuple[str, str, int], object] = {}
_mtx = threading.Lock()
_count_mtx = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale(name: str) -> bool:
    so = BUILD / f"lib{name}.so"
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return so.stat().st_mtime < newest


def build_all(force: bool = False) -> dict[str, float]:
    """Compile every stale library, one nvcc per library, all started
    together. Returns seconds per library; raises on any failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, (src, flags, _fns) in LIBS.items():
        if not force and not _stale(name):
            continue
        tmp = BUILD / f"lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    seconds = {}
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD / f"lib{name}.build.txt").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, BUILD / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library, built first if its sources are newer."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _mtx:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            build_all()
        lib = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
        for fn, argtypes in LIBS[name][2].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
        return lib


def _make_launcher(kernel: str, fn: str, index: int):
    """The launcher of ``fn`` for ``kernel`` on card ``index``: the
    library loaded (built first if stale) and the C function bound once;
    each call makes the card current only when another is and passes the
    card's current stream."""
    import torch

    cfn = getattr(library(KERNELS[kernel]), fn)

    def call(args):
        cuda = torch.cuda
        if cuda.current_device() == index:
            return cfn(*args, cuda.current_stream(index).cuda_stream)
        with cuda.device(index):
            return cfn(*args, cuda.current_stream(index).cuda_stream)

    with _mtx:
        return _launchers.setdefault((kernel, fn, index), call)


def launch(kernel: str, fn: str, t, n: int, *args) -> None:
    """Call one C entry point with ``args`` and the current stream of
    ``t``'s card, that card made current; count the launch and raise on
    the CUDA error it returns. ``n`` is the size the entry point launches
    over: at 0 it would launch nothing, so it is neither called nor
    counted."""
    if n <= 0:
        return
    index = t.device.index
    call = _launchers.get((kernel, fn, index)) or _make_launcher(kernel, fn, index)
    rc = call(args)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")
    with _count_mtx:  # engines of co-located nodes launch from their own threads
        launches[kernel] += 1


def check_all(*specs) -> None:
    """Raise unless every ``(tensor, dtype, shape, name)`` of ``specs`` is
    a contiguous CUDA tensor of this dtype and shape (-1 = any size), all
    on one card (a kernel reads each pointer on the card it runs on). One
    pass over the tensors."""
    card = specs[0][0].device
    for t, dtype, shape, name in specs:
        dev = t.device
        if dev.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        got = t.shape
        if got != shape and (len(got) != len(shape)
                             or any(s != -1 and s != d for s, d in zip(shape, got))):
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(got)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if dev != card:
            cards = sorted({str(s[0].device) for s in specs})
            raise ValueError(f"kernel inputs on more than one device: {cards}")
