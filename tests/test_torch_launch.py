"""PyTorch port, kernel launch rules (``txflow_tpu_torch/ops/_lib.py``) with
the card and the CUDA library faked: every launch runs with its tensors'
card current (switching only when another card is current) and on that
card's stream, a card needs nothing copied before a library's first
launch there (no kernel reads ``__constant__`` memory: the K5 and K2
wrappers pass the base table of their own card and field, quarter 0 of
``curve.device_base_quarters``, and count one launch a wrapper call), an
empty launch is neither made nor counted, and a CUDA error raises without
counting."""

import contextlib
import re
from types import SimpleNamespace

import pytest
import torch

from txflow_tpu_torch.ops import _lib, curve, ed25519_batch as eb


class FakeLib:
    """Stands for both loaded libraries: records each C call with the card
    that was current when it was made."""

    def __init__(self):
        self.current = 0  # the current card
        self.switches = 0
        self.calls = []
        self.rc = 0

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
    and error code; its entries are logged with a 13 suffix."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        if name.startswith("txf_"):
            return self.lib._entry(name + "13")
        raise AttributeError(name)


class FakeTensor:
    """A stand-in for a CUDA tensor: what the wrappers read of one (card,
    dtype, shape, layout, address), and the slices and views they take of
    a scratch allocation (a slice's address moves by its offset)."""

    def __init__(self, shape, dtype, ptr, card=0, contiguous=True):
        self.device = torch.device("cuda", card)
        self.dtype, self.shape, self.ptr = dtype, torch.Size(shape), ptr
        self.contiguous = contiguous

    def is_contiguous(self):
        return self.contiguous

    def data_ptr(self):
        return self.ptr

    def __getitem__(self, sl):
        start, stop, _ = sl.indices(self.shape[0])
        item = torch.tensor([], dtype=self.dtype).element_size()
        return FakeTensor((stop - start,), self.dtype, self.ptr + item * start, self.device.index)

    def view(self, *shape):
        return FakeTensor(shape, self.dtype, self.ptr, self.device.index)

    def to(self, dtype):
        return FakeTensor(self.shape, dtype, self.ptr, self.device.index)


def fake_scratch(monkeypatch, ptr=5000):
    """Make ``torch.empty`` return a FakeTensor at ``ptr`` on the requested
    card; returns the list of (shape, dtype, device) it was asked for."""
    asked = []

    def empty(shape, dtype, device):
        asked.append((tuple(shape), dtype, torch.device(device)))
        return FakeTensor(shape, dtype, ptr, torch.device(device).index)

    monkeypatch.setattr(torch, "empty", empty)
    return asked


def fake_base_tables(monkeypatch, cards=(0, 1, 2, 3)):
    """Each (card, field)'s base quarters a FakeTensor of its own address
    (``curve.device_base_quarters``' cache): 7000 + 10 * card + field."""
    for card in cards:
        for r, nlimb in ((25, 10), (13, 20)):
            monkeypatch.setitem(curve._base_quarters, (f"cuda:{card}", r),
                                FakeTensor((4, 16, 4, nlimb), torch.int32, 7000 + 10 * card + r, card))


def k5_inputs(card, fe_radix=25, n=64):
    """verify_kernel's inputs on ``card``: addresses 101-106."""
    nlimb = 10 if fe_radix == 25 else 20
    return [FakeTensor((n, 64), torch.uint8, 101, card), FakeTensor((n, 64), torch.uint8, 102, card),
            FakeTensor((n, 16, 4, nlimb), torch.int32, 103, card),
            FakeTensor((n, 32), torch.uint8, 104, card), FakeTensor((n,), torch.uint8, 105, card),
            FakeTensor((n,), torch.bool, 106, card)]


def k2_inputs(card, fe_radix=25, n=8, v=4):
    """dsm_encode's inputs on ``card``: addresses 201-204."""
    nlimb = 10 if fe_radix == 25 else 20
    return [FakeTensor((n, 64), torch.uint8, 201, card), FakeTensor((n, 64), torch.uint8, 202, card),
            FakeTensor((n,), torch.int32, 203, card), FakeTensor((v, 16, 4, nlimb), torch.int32, 204, card)]


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


def test_verify_sets_the_base_table_on_each_card_before_its_first_launch(fake, monkeypatch):
    """Nothing is copied to a card before a library's first launch there
    (no ``__constant__`` table any more): each launch is one C call on its
    card. K2's wrapper passes its card's base table (quarter 0 of the
    card's base quarters) and one scratch: points, then y, then parity."""
    fake_base_tables(monkeypatch)
    asked = fake_scratch(monkeypatch)
    _lib.launch("verify", "txf_verify", on(1), 64, 11, 64)
    _lib.launch("verify", "txf_verify", on(0), 64, 11, 64)
    y, parity = curve.dsm_encode(*k2_inputs(1))
    _lib.launch("verify", "txf_verify", on(0), 64, 11, 64)
    assert [c[:2] for c in fake.calls] == [("txf_verify", 1), ("txf_verify", 0),
                                           ("txf_dsm_encode", 1), ("txf_verify", 0)]
    assert asked == [((8 * 41,), torch.int32, torch.device("cuda", 1))]
    assert y.data_ptr() == 5000 + 4 * 8 * 30 and parity.data_ptr() == 5000 + 4 * 8 * 40
    assert tuple(y.shape) == (8, 10) and tuple(parity.shape) == (8,)
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


def test_each_verify_library_sets_its_own_base_table_on_each_card(fake, monkeypatch):
    """K5 and K2 of either library take the base table of their own field
    on their own card (a device tensor, ``curve.device_base_quarters``),
    in the place their C signature has it, and each wrapper call counts
    one launch of its library's kernel; a launch of one library never
    stands in for the other's."""
    fake_base_tables(monkeypatch)
    got = []
    for lib, suffix in ((fake, ""), (fake.v13, "13")):
        for fn in ("txf_verify_tables", "txf_dsm_encode"):
            monkeypatch.setattr(lib, fn, lambda *a, fn=fn + suffix: got.append((fn, *a)) or 0,
                                raising=False)
    asked = fake_scratch(monkeypatch)
    eb.verify_kernel(*k5_inputs(0), fe_radix=25)
    eb.verify_kernel(*k5_inputs(0, 13), fe_radix=13)
    curve.dsm_encode(*k2_inputs(1, 13), fe_radix=13)
    eb.verify_kernel(*k5_inputs(1, 13), fe_radix=13)
    _lib.launch("fe13_ops", "txf_fe_ops", on(1), 16, 16)
    curve.dsm_encode(*k2_inputs(1), fe_radix=25)
    # K5: (s, h, a_tables, base, r_y, r_sign, pre_ok, points, out, B, stream)
    # K2: (s, h, val_idx, tables, V, base, points, y, parity, B, stream)
    assert got == [
        ("txf_verify_tables", 101, 102, 103, 7025, 104, 105, 106, 5000, 5000 + 4 * 64 * 30, 64, 1000),
        ("txf_verify_tables13", 101, 102, 103, 7013, 104, 105, 106, 5000, 5000 + 4 * 64 * 60, 64,
         1000),
        ("txf_dsm_encode13", 201, 202, 203, 204, 4, 7023, 5000, 5000 + 4 * 8 * 60,
         5000 + 4 * 8 * 80, 8, 1001),
        ("txf_verify_tables13", 101, 102, 103, 7023, 104, 105, 106, 5000, 5000 + 4 * 64 * 60, 64,
         1001),
        ("txf_dsm_encode", 201, 202, 203, 204, 4, 7035, 5000, 5000 + 4 * 8 * 30, 5000 + 4 * 8 * 40,
         8, 1001),
    ]
    assert [len(c) - 1 for c in got] == [len(_lib._VERIFY_FNS[c[0].rstrip("13")]) for c in got]
    assert [a[0] for a in asked] == [(64 * 31,), (64 * 61,), (8 * 81,), (64 * 61,), (8 * 41,)]
    assert [a[2].index for a in asked] == [0, 0, 1, 1, 1]
    assert fake.calls == [("txf_fe_ops13", 1, 1001)]
    assert {k: _lib.launches[k] for k in ("verify", "verify13", "dsm_encode13",
                                           "verify_tables13", "fe13_ops", "verify_tables",
                                           "dsm_encode")} == {
        "verify": 0, "verify13": 0, "dsm_encode13": 1, "verify_tables13": 2, "fe13_ops": 1,
        "verify_tables": 1, "dsm_encode": 1}


def test_libraries_are_keyed_by_library_not_source():
    """verify.cu builds twice (its own flags each, one output each); every
    kernel names a library that exists, and the radix-2^13 kernels live in
    verify13."""
    assert _lib.LIBS["verify"][0] == _lib.LIBS["verify13"][0] == "verify.cu"
    assert _lib.LIBS["verify"][1] == [] and _lib.LIBS["verify13"][1] == ["-DTXF_FE_RADIX=13"]
    assert set(_lib.KERNELS.values()) == set(_lib.LIBS)
    assert {k for k, v in _lib.KERNELS.items() if v == "verify13"} == {
        "fe13_ops", "fe13_prod", "dsm_encode13", "verify13", "verify_tables13", "verify13_tally",
        "verify13_tally64", "verify13_partial", "verify13_partial64"}
    assert {k for k, v in _lib.KERNELS.items() if k.endswith("64")} == {
        "tally64", "tally_partial64", "reduce_quorum64", "verify_tally64", "verify_partial64",
        "verify13_tally64", "verify13_partial64"}
    # no kernel reads __constant__ memory: no source declares any
    assert not any(re.search(r"^\s*__constant__", (_lib.CSRC / f).read_text(), re.M)
                   for f in ("verify.cu", "ge25519.cuh", "tally.cu", "fe_common.cuh"))
