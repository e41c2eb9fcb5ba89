"""Build, load and launch the hand-written CUDA kernels.

Each library of ``LIBS`` is one source in ``csrc/`` with a C entry point,
compiled by ``nvcc`` for ``sm_90a`` with the library's own flags into
``txflow_tpu_torch/_build/`` on first use (all libraries at once, one
``nvcc`` process each, in parallel) and loaded with ctypes. ``verify.cu``
builds twice, once over each field: ``verify`` (radix 2^25.5) and
``verify13`` (radix 2^13, ``-DTXF_FE_RADIX=13``). Nothing here runs at
import: the CPU tests import every module and never reach a build.

Every launch goes through :func:`launch`, which makes the tensors'
card the current device, passes PyTorch's current stream there, raises
when the C entry point reports a CUDA error, and adds one to
``launches[kernel]`` -- the count that shows a run went through the
kernel. A failed build or launch raises; there is no fallback.

Each verify library keeps the base-point table of its field in
``__constant__`` memory, which each card holds separately for each
library: :func:`launch` copies it to a card before that library's first
launch there.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

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
    "txf_set_base_table": [_P],
    "txf_verify": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
    "txf_verify_tables": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
    "txf_dsm_encode": [_P, _P, _P, _P, _I, _P, _P, _I, _P],
    "txf_fe_ops": [_P, _P, _P, _I, _P],
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
            "txf_add": [_P, _P, _P, _I, _P],
        },
    ),
}

# verify library -> the field (radix) of the base table in its
# __constant__ memory
BASE_TABLE_RADIX = {"verify": 25, "verify13": 13}

# kernel -> library
KERNELS = {"fe_ops": "verify", "dsm_encode": "verify", "verify": "verify",
           "verify_tables": "verify", "fe13_ops": "verify13",
           "dsm_encode13": "verify13", "verify13": "verify13",
           "verify_tables13": "verify13", "tally": "tally", "tally64": "tally",
           "tally_partial": "tally", "tally_partial64": "tally",
           "reduce_quorum": "tally", "reduce_quorum64": "tally", "ring_add": "tally"}

launches = {k: 0 for k in KERNELS}

_loaded: dict[str, ctypes.CDLL] = {}
# (library, card) pairs whose __constant__ base table is set
_tabled: set[tuple[str, int]] = set()
_mtx = threading.Lock()


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


def _set_base_table(lib: ctypes.CDLL, name: str, index: int) -> None:
    """Copy the base-point table of library ``name``'s field into the
    current card's ``__constant__`` memory, once per (library, card)."""
    key = (name, index)
    if key in _tabled:
        return
    with _mtx:
        if key in _tabled:
            return
        from .curve import BASE_TABLES

        table = np.ascontiguousarray(BASE_TABLES[BASE_TABLE_RADIX[name]], dtype=np.int32)
        rc = lib.txf_set_base_table(table.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"txf_set_base_table failed: CUDA error {rc}")
        _tabled.add(key)


def launch(kernel: str, fn: str, t, n: int, *args) -> None:
    """Call one C entry point with ``args`` and the current stream of
    ``t``'s card, that card made current; count the launch and raise on
    the CUDA error it returns. ``n`` is the size the entry point launches
    over: at 0 it would launch nothing, so it is neither called nor
    counted."""
    import torch

    if n <= 0:
        return
    name = KERNELS[kernel]
    lib = library(name)
    index = t.device.index
    # switching cards costs host time on every launch: only when needed
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        if name in BASE_TABLE_RADIX:
            _set_base_table(lib, name, index)
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")
    launches[kernel] += 1


def same_card(*tensors) -> None:
    """Raise unless every tensor lies on one card: a kernel reads each
    pointer on the card it runs on."""
    cards = {t.device for t in tensors}
    if len(cards) != 1:
        raise ValueError(f"kernel inputs on more than one device: {sorted(map(str, cards))}")


def check(t, dtype, shape, name: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and
    shape (-1 = any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
        s != -1 and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
