"""PyTorch port, kernel launch rules (``txflow_tpu_torch/ops/_lib.py``) with
the card and the CUDA library faked: every launch runs with its tensors'
card current (switching only when another card is current) and on that
card's stream, each verify library's ``__constant__`` base table (its own
field's: ``verify`` radix 2^25.5, ``verify13`` radix 2^13) is copied to
each card before that library's first launch there (once per library and
card), an empty launch is neither made nor counted, and a CUDA error
raises without counting."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from txflow_tpu_torch.ops import _lib
from txflow_tpu_torch.ops.curve import BASE_TABLE, BASE_TABLES


class FakeLib:
    """Stands for both loaded libraries: records each C call with the card
    that was current when it was made."""

    def __init__(self):
        self.current = 0  # the current card
        self.switches = 0
        self.calls = []
        self.tables = {}
        self.rc = 0

    def txf_set_base_table(self, ptr):
        self.calls.append(("table", self.current))
        n = BASE_TABLE.size
        self.tables[self.current] = np.ctypeslib.as_array(
            (np.ctypeslib.ctypes.c_int32 * n).from_address(ptr)
        ).copy()
        return 0

    def _entry(self, name):
        def call(*args):
            self.calls.append((name, self.current, args[-1]))
            return self.rc
        return call

    def __getattr__(self, name):
        if name.startswith("txf_"):
            return self._entry(name)
        raise AttributeError(name)


class FakeLib13:
    """The verify13 library's face of the fake: the same cards, call log
    and error code; its entries are logged with a 13 suffix and its table
    (radix 2^13, [16, 4, 20]) is kept apart."""

    def __init__(self, lib):
        self.lib = lib
        self.tables = {}

    def txf_set_base_table(self, ptr):
        self.lib.calls.append(("table13", self.lib.current))
        n = BASE_TABLES[13].size
        self.tables[self.lib.current] = np.ctypeslib.as_array(
            (np.ctypeslib.ctypes.c_int32 * n).from_address(ptr)
        ).copy()
        return 0

    def __getattr__(self, name):
        if name.startswith("txf_"):
            return self.lib._entry(name + "13")
        raise AttributeError(name)


@pytest.fixture
def fake(monkeypatch):
    lib = FakeLib()

    @contextlib.contextmanager
    def device(index):
        prev, lib.current = lib.current, index
        lib.switches += 1
        try:
            yield
        finally:
            lib.current = prev

    lib.v13 = FakeLib13(lib)
    monkeypatch.setattr(_lib, "_loaded", {"verify": lib, "verify13": lib.v13, "tally": lib})
    monkeypatch.setattr(_lib, "_tabled", set())
    monkeypatch.setattr(_lib, "_launchers", {})
    monkeypatch.setattr(_lib, "launches", {k: 0 for k in _lib.KERNELS})
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: lib.current)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda dev: SimpleNamespace(cuda_stream=1000 + torch.device("cuda", dev).index),
    )
    return lib


def on(index):
    """A stand-in for a tensor on card ``index``."""
    return SimpleNamespace(device=torch.device("cuda", index))


def test_verify_sets_the_base_table_on_each_card_before_its_first_launch(fake):
    _lib.launch("verify", "txf_verify", on(1), 64, 11, 64)
    _lib.launch("verify", "txf_verify", on(0), 64, 11, 64)
    _lib.launch("dsm_encode", "txf_dsm_encode", on(1), 8, 11, 8)
    _lib.launch("verify", "txf_verify", on(0), 64, 11, 64)
    assert fake.calls == [
        ("table", 1), ("txf_verify", 1, 1001),
        ("table", 0), ("txf_verify", 0, 1000),
        ("txf_dsm_encode", 1, 1001),
        ("txf_verify", 0, 1000),
    ]
    for card in (0, 1):
        np.testing.assert_array_equal(fake.tables[card], BASE_TABLE.reshape(-1))
    assert _lib.launches["verify"] == 3 and _lib.launches["dsm_encode"] == 1
    # card 0 stays current: only the two launches on card 1 switched
    assert fake.current == 0 and fake.switches == 2


def test_tally_runs_on_its_card_and_needs_no_table(fake):
    _lib.launch("tally", "txf_tally", on(2), 4096, 7)
    _lib.launch("tally", "txf_tally", on(0), 4096, 7)
    assert fake.calls == [("txf_tally", 2, 1002), ("txf_tally", 0, 1000)]
    assert _lib.launches["tally"] == 2


@pytest.mark.parametrize("kernel,fn", [("verify", "txf_verify"), ("tally", "txf_tally")])
def test_empty_launch_is_neither_made_nor_counted(fake, kernel, fn):
    _lib.launch(kernel, fn, on(0), 0, 7)
    assert fake.calls == [] and _lib.launches[kernel] == 0


def test_cuda_error_raises_and_is_not_counted(fake):
    fake.rc = 700  # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _lib.launch("fe_ops", "txf_fe_ops", on(0), 16, 16)
    assert _lib.launches["fe_ops"] == 0


def test_each_verify_library_sets_its_own_base_table_on_each_card(fake):
    """The two verify libraries hold their own __constant__ tables: the
    first launch of each library on each card copies that library's
    field's table there, once; a launch of one library never stands in
    for the other's."""
    _lib.launch("verify", "txf_verify", on(0), 64, 11, 64)
    _lib.launch("verify13", "txf_verify", on(0), 64, 11, 64)
    _lib.launch("dsm_encode13", "txf_dsm_encode", on(1), 8, 11, 8)
    _lib.launch("verify_tables13", "txf_verify_tables", on(0), 64, 11, 64)
    _lib.launch("fe13_ops", "txf_fe_ops", on(1), 16, 16)
    _lib.launch("verify_tables", "txf_verify_tables", on(1), 64, 11, 64)
    assert fake.calls == [
        ("table", 0), ("txf_verify", 0, 1000),
        ("table13", 0), ("txf_verify13", 0, 1000),
        ("table13", 1), ("txf_dsm_encode13", 1, 1001),
        ("txf_verify_tables13", 0, 1000),
        ("txf_fe_ops13", 1, 1001),
        ("table", 1), ("txf_verify_tables", 1, 1001),
    ]
    for card in (0, 1):
        np.testing.assert_array_equal(fake.tables[card], BASE_TABLE.reshape(-1))
        np.testing.assert_array_equal(fake.v13.tables[card], BASE_TABLES[13].reshape(-1))
    assert _lib._tabled == {("verify", 0), ("verify13", 0), ("verify13", 1), ("verify", 1)}
    assert {k: _lib.launches[k] for k in ("verify", "verify13", "dsm_encode13",
                                           "verify_tables13", "fe13_ops", "verify_tables")} == {
        "verify": 1, "verify13": 1, "dsm_encode13": 1, "verify_tables13": 1, "fe13_ops": 1,
        "verify_tables": 1}


def test_libraries_are_keyed_by_library_not_source():
    """verify.cu builds twice (its own flags each, one output each); every
    kernel names a library that exists, and the radix-2^13 kernels live in
    verify13."""
    assert _lib.LIBS["verify"][0] == _lib.LIBS["verify13"][0] == "verify.cu"
    assert _lib.LIBS["verify"][1] == [] and _lib.LIBS["verify13"][1] == ["-DTXF_FE_RADIX=13"]
    assert set(_lib.KERNELS.values()) == set(_lib.LIBS)
    assert {k for k, v in _lib.KERNELS.items() if v == "verify13"} == {
        "fe13_ops", "dsm_encode13", "verify13", "verify_tables13", "verify13_tally",
        "verify13_tally64", "verify13_partial", "verify13_partial64"}
    assert {k for k, v in _lib.KERNELS.items() if k.endswith("64")} == {
        "tally64", "tally_partial64", "reduce_quorum64", "verify_tally64", "verify_partial64",
        "verify13_tally64", "verify13_partial64"}
    assert _lib.BASE_TABLE_RADIX == {"verify": 25, "verify13": 13}
