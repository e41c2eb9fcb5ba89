"""PyTorch port, the cached launch path (``ops/_lib.py``) and the new
entry points' arguments, with the card and the CUDA library faked
(``tests/test_torch_launch.py``'s ``fake``): a launcher is made once per
(kernel, card) and reused; a warm launcher still makes its card current
when another card is, and only then; a launch through a warm launcher
still raises on a CUDA error and is not counted; ``verify_into`` passes
the epoch's tables, its quarter tables, the card's base quarter tables
and a points scratch to ``txf_verify`` in the order of its C signature
and checks the quarter tables' dtype, shape, card and layout like every
other input; the ring hop launches ``txf_add`` in place on the buffer it
is given; and every C entry point's parameters match the ctypes
argument types ``_lib.LIBS`` declares for it (count, and pointer, int or
64-bit int in each place), read from the sources in ``csrc/``."""

import re
from types import SimpleNamespace

import pytest
import torch

from test_torch_launch import fake, on  # noqa: F401  (fixture)
from txflow_tpu_torch.ops import _lib, curve, ed25519_batch as eb, tally


def cuda(shape, dtype, ptr, card=0, contiguous=True):
    """A stand-in for a CUDA tensor: what the wrappers read of one."""
    return SimpleNamespace(device=torch.device("cuda", card), dtype=dtype, shape=torch.Size(shape),
                           is_contiguous=lambda: contiguous, data_ptr=lambda: ptr)


def test_launcher_is_made_once_per_kernel_and_card(fake, monkeypatch):  # noqa: F811
    made = []
    make = _lib._make_launcher

    def counting(kernel, fn, index):
        made.append((kernel, index))
        return make(kernel, fn, index)

    monkeypatch.setattr(_lib, "_make_launcher", counting)
    for card in (0, 1, 0, 1, 0):
        _lib.launch("verify", "txf_verify", on(card), 64, 11, 64)
    _lib.launch("tally", "txf_tally", on(0), 4096, 7)
    _lib.launch("tally", "txf_tally", on(0), 4096, 7)
    assert made == [("verify", 0), ("verify", 1), ("tally", 0)]
    assert set(_lib._launchers) == {("verify", "txf_verify", 0), ("verify", "txf_verify", 1),
                                    ("tally", "txf_tally", 0)}
    assert _lib.launches["verify"] == 5 and _lib.launches["tally"] == 2
    # one C call a launch, on its card: nothing is copied to a card first
    assert fake.calls == [("txf_verify", card, 1000 + card) for card in (0, 1, 0, 1, 0)] + [
        ("txf_tally", 0, 1000)] * 2


def test_warm_launcher_switches_to_its_card_only_when_another_is_current(fake):  # noqa: F811
    for _ in range(3):
        _lib.launch("ring_add", "txf_add", on(2), 4096, 5, 6, 4096)
    assert fake.switches == 3 and fake.current == 0
    assert fake.calls == [("txf_add", 2, 1002)] * 3
    fake.current = 2  # the card is current already: no switch
    _lib.launch("ring_add", "txf_add", on(2), 4096, 5, 6, 4096)
    assert fake.switches == 3 and fake.calls[-1] == ("txf_add", 2, 1002)
    assert _lib.launches["ring_add"] == 4


def test_warm_launcher_raises_on_a_cuda_error_and_does_not_count(fake):  # noqa: F811
    _lib.launch("tally_partial", "txf_tally_partial", on(1), 4096, 7)
    assert ("tally_partial", "txf_tally_partial", 1) in _lib._launchers
    fake.rc = 719  # cudaErrorLaunchFailure
    with pytest.raises(RuntimeError, match="txf_tally_partial failed: CUDA error 719"):
        _lib.launch("tally_partial", "txf_tally_partial", on(1), 4096, 7)
    assert _lib.launches["tally_partial"] == 1
    fake.rc = 0
    _lib.launch("tally_partial", "txf_tally_partial", on(1), 4096, 7)
    assert _lib.launches["tally_partial"] == 2


def _verify_inputs(n=64, v=8, nlimb=10, **quarter):
    q = dict(shape=(v, 3, 16, 4, nlimb), dtype=torch.int32, ptr=105)
    q.update(quarter)
    return [cuda((n,), torch.int32, 111),  # out
            cuda((n, 64), torch.uint8, 101), cuda((n, 64), torch.uint8, 102),
            cuda((n,), torch.int32, 103), cuda((v, 16, 4, nlimb), torch.int32, 104),
            cuda(**q), cuda((n, 32), torch.uint8, 106), cuda((n,), torch.uint8, 107),
            cuda((n,), torch.bool, 108)]


@pytest.mark.parametrize("fe_radix", [25, 13])
def test_verify_into_passes_the_quarter_tables_in_c_order(fake, monkeypatch, fe_radix):  # noqa: F811
    got = []
    lib = fake if fe_radix == 25 else fake.v13
    monkeypatch.setattr(lib, "txf_verify", lambda *a: got.append(a) or 0, raising=False)
    nlimb = 10 if fe_radix == 25 else 20
    base = cuda((4, 16, 4, nlimb), torch.int32, 109)
    monkeypatch.setitem(curve._base_quarters, ("cuda:0", fe_radix), base)
    scratch = []

    def empty(shape, dtype, device):  # the points scratch, on the output's card
        scratch.append((shape, dtype, device))
        return cuda(shape, dtype, 110)

    monkeypatch.setattr(torch, "empty", empty)
    eb.verify_into(*_verify_inputs(nlimb=nlimb), fe_radix=fe_radix)
    assert scratch == [((64, 3, nlimb), torch.int32, torch.device("cuda", 0))]
    assert got == [(101, 102, 103, 104, 105, 8, 109, 106, 107, 108, 110, 111, 64, 1000)]
    assert len(_lib._VERIFY_FNS["txf_verify"]) == len(got[0])
    assert _lib.launches["verify" if fe_radix == 25 else "verify13"] == 1


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.int64), "quarter_tables: expected torch.int32"),
    (dict(shape=(8, 4, 16, 4, 10)), "quarter_tables: expected shape"),
    (dict(shape=(7, 3, 16, 4, 10)), "quarter_tables: expected shape"),
    (dict(card=1), "more than one device"),
    (dict(contiguous=False), "quarter_tables: expected a contiguous tensor"),
])
def test_verify_into_checks_the_quarter_tables(fake, bad, match):  # noqa: F811
    with pytest.raises(ValueError, match=match):
        eb.verify_into(*_verify_inputs(**bad))
    assert fake.calls == [] and _lib.launches["verify"] == 0


def test_ring_add_accumulates_in_place_on_its_buffer(fake):  # noqa: F811
    acc, b = cuda((4096,), torch.int32, 201), cuda((4096,), torch.int32, 202)
    assert tally.ring_add(acc, b) is acc
    assert fake.calls == [("txf_add", 0, 1000)] and _lib.launches["ring_add"] == 1
    assert _lib.LIBS["tally"][2]["txf_add"] == [_lib._P, _lib._P, _lib._I, _lib._P]
    with pytest.raises(ValueError, match="b: expected torch.int32"):
        tally.ring_add(acc, cuda((4096,), torch.int64, 203))


_CTYPE = {"P": _lib._P, "I": _lib._I, "L": _lib._L}


def _c_params(src: str) -> dict:
    """C entry point -> its parameters' kinds: P (pointer), I (int) or L
    (long long or int64_t), from the ``extern "C"`` block of a CUDA
    source."""
    block = src[src.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"\bint (txf_\w+)\(([^)]*)\)\s*\{", block):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append("P" if "*" in p else "L" if p.startswith(("int64_t", "long long"))
                         else "I")
        out[name] = [_CTYPE[k] for k in kinds]
    return out


@pytest.mark.parametrize("lib", sorted(_lib.LIBS))
def test_c_entry_points_match_their_ctypes_argtypes(lib):
    src, _flags, fns = _lib.LIBS[lib]
    params = _c_params((_lib.CSRC / src).read_text())
    assert set(params) == set(fns)
    for fn, argtypes in fns.items():
        assert params[fn] == argtypes, fn
