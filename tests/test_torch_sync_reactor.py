"""PyTorch port, the catch-up sync reactor (sync/reactor.py SyncReactor)
against the JAX package's over equal stores: the channel descriptor, the
STATUS advert on add_peer and on the status loop, dispatch of the three
frame tags to the manager, the raise on an empty frame or an unknown tag,
the tamper hook, and the RANGE_RESP bytes served. Tolerance 0 (bytes,
ints, messages)."""

import threading
import time

import pytest

from txflow_tpu.p2p.base import CHANNEL_SYNC as J_CHANNEL_SYNC
from txflow_tpu.sync import wire as jwire
from txflow_tpu.sync.config import SyncConfig as JSyncConfig
from txflow_tpu.sync.reactor import SyncReactor as JSyncReactor

from txflow_tpu_torch.sync import CHANNEL_SYNC, SyncConfig, SyncReactor, wire

from _torch_sync_rigs import FakePeer, FakeSwitch, History, RecordingManager, jax_set, port_set


def _pair(hist, cfg_kw=None, current=True, records=True):
    """A JAX and a port reactor over ``hist``'s equal stores, each with a
    recording manager."""
    cfg_kw = cfg_kw or {}
    jr = JSyncReactor(hist.js, hist.jss if records else None,
                      current_vals=(lambda: hist.jvals) if current else None,
                      config=JSyncConfig(**cfg_kw))
    pr = SyncReactor(hist.ps, hist.pss if records else None,
                     current_vals=(lambda: hist.pvals) if current else None,
                     config=SyncConfig(**cfg_kw))
    jr.manager, pr.manager = RecordingManager(), RecordingManager()
    return jr, pr


@pytest.mark.parametrize("max_resp_bytes", [512 * 1024, 4 * 1024 * 1024])
def test_channel_descriptor_matches_jax(max_resp_bytes):
    hist = History(n_txs=1)
    jr, pr = _pair(hist, dict(max_resp_bytes=max_resp_bytes))
    (jd,), (pd,) = jr.get_channels(), pr.get_channels()
    assert CHANNEL_SYNC == J_CHANNEL_SYNC == 0x3A
    assert (pd.id, pd.priority, pd.send_queue_capacity, pd.recv_message_capacity, pd.reliable) == (
        jd.id, jd.priority, jd.send_queue_capacity, jd.recv_message_capacity, jd.reliable)


def test_status_on_add_peer_and_peer_gone_match_jax():
    hist = History(n_txs=7)
    jr, pr = _pair(hist)
    jp, pp = FakePeer("node5"), FakePeer("node5")
    jr.add_peer(jp)
    pr.add_peer(pp)
    assert pp.sent == jp.sent == [(CHANNEL_SYNC, wire.encode_status(7, hist.ps.height()))]
    jr.remove_peer(jp, "test")
    pr.remove_peer(pp, "test")
    assert pr.manager.calls == jr.manager.calls == [("gone", "node5")]


def _frames(hist):
    entries = [(hist.hashes[0], b"cert", b"tx")]
    return {
        "status": jwire.encode_status(41, 3),
        "range_req": jwire.encode_range_req(9, 2, 5),
        "range_resp": jwire.encode_range_resp(4, 1, 30, entries, {0: hist.jvals}),
    }


@pytest.mark.parametrize("tag", ["status", "range_req", "range_resp"])
def test_receive_dispatches_like_jax(tag):
    hist = History(n_txs=9)
    jr, pr = _pair(hist)
    frame = _frames(hist)[tag]
    jp, pp = FakePeer("node1"), FakePeer("node1")
    jr.receive(CHANNEL_SYNC, jp, frame)
    pr.receive(CHANNEL_SYNC, pp, frame)
    assert pp.sent == jp.sent
    assert pr.manager.calls == jr.manager.calls
    if tag == "status":
        assert pr.manager.calls == [("status", "node1", 41, 3)] and not pp.sent
    elif tag == "range_req":
        # served on the sync channel, and counted on the manager
        assert [c for c, _ in pp.sent] == [CHANNEL_SYNC]
        assert wire.decode_range_resp(pp.sent[0][1])[:3] == (9, 2, 9)
        assert pr.manager.calls == [("served", 5)] and pr.served_ranges == 1
    else:
        assert pr.manager.calls[0][:5] == ("response", "node1", 4, 1, 30) and not pp.sent


@pytest.mark.parametrize("frame,msg", [(b"", "empty sync frame"), (b"\x07\x01", "unknown sync tag 7")])
def test_empty_frame_and_unknown_tag_raise_like_jax(frame, msg):
    hist = History(n_txs=1)
    jr, pr = _pair(hist)
    with pytest.raises(ValueError) as je:
        jr.receive(CHANNEL_SYNC, FakePeer(), frame)
    with pytest.raises(ValueError) as pe:
        pr.receive(CHANNEL_SYNC, FakePeer(), frame)
    assert str(pe.value) == str(je.value) == msg


@pytest.mark.parametrize(
    "start,count,cfg_kw,missing,records,current",
    [
        (0, 64, {}, (), True, True),  # everything, snapshots on record
        (3, 64, dict(max_range=4), (), True, True),  # max_range clamps
        (0, 64, dict(max_resp_bytes=2000), (), True, True),  # byte cap, append then check
        (2, 64, {}, (7,), True, True),  # a row it cannot serve: advert lowered
        (20, 5, {}, (), True, True),  # past the log
        (0, 64, {}, (), False, True),  # no state store: the current set
        (0, 64, {}, (), False, False),  # no snapshot source at all
    ],
)
def test_range_response_bytes_match_jax(start, count, cfg_kw, missing, records, current):
    hist = History(n_txs=12, missing=missing)
    jr, pr = _pair(hist, cfg_kw, current=current, records=records)
    want = jr._serve_range(11, start, count)
    got = pr._serve_range(11, start, count)
    assert got == want
    assert pr.manager.calls == jr.manager.calls
    _r, _s, advert, entries, snaps = wire.decode_range_resp(got)
    if missing:
        assert advert == missing[0] and len(entries) == missing[0] - start
    assert bool(snaps) == bool(entries and (records or current))


def _tampers():
    _pvs, evil = jax_set(b"evil-epoch", 1, power=99)
    pevil = port_set(evil)

    def truncate(entries, snaps):
        return entries[: max(1, len(entries) // 2)], snaps

    def forge(entries, snaps):
        out = []
        for h, cert, tx in entries:
            mid = len(cert) // 2
            out.append((h, cert[:mid] + bytes([cert[mid] ^ 0xFF]) + cert[mid + 1 :], tx))
        return out, snaps

    def swap_tx(entries, snaps):
        return [(h, c, t + b"!") for h, c, t in entries], snaps

    return {
        "truncate": (truncate, truncate),
        "forge": (forge, forge),
        "swap_tx": (swap_tx, swap_tx),
        "wrong_epoch": (lambda e, s: (e, {h: evil for h in s}), lambda e, s: (e, {h: pevil for h in s})),
        "nothing": (lambda e, s: ([], {}), lambda e, s: ([], {})),
    }


@pytest.mark.parametrize("case", sorted(_tampers()))
def test_tamper_hook_matches_jax(case):
    hist = History(n_txs=10)
    jr, pr = _pair(hist)
    jr.tamper, pr.tamper = _tampers()[case]
    jp, pp = FakePeer("node3"), FakePeer("node3")
    req = wire.encode_range_req(2, 1, 8)
    jr.receive(CHANNEL_SYNC, jp, req)
    pr.receive(CHANNEL_SYNC, pp, req)
    assert pp.sent == jp.sent and len(pp.sent) == 1
    assert pr.manager.calls == jr.manager.calls  # note_served counts what went out
    honest = SyncReactor(hist.ps, hist.pss, config=SyncConfig())._serve_range(2, 1, 8)
    assert pp.sent[0][1] != honest


def test_status_loop_adverts_to_every_peer_until_stopped():
    hist = History(n_txs=3)
    _jr, pr = _pair(hist, dict(status_interval=0.02))
    peers = [FakePeer("a"), FakePeer("b")]
    pr.set_switch(FakeSwitch(peers))
    before = set(threading.enumerate())
    pr.on_start()
    deadline = time.monotonic() + 10
    while not all(len(p.sent) >= 2 for p in peers):
        assert time.monotonic() < deadline, "no status adverts"
        time.sleep(0.01)
    pr.on_stop()
    while set(threading.enumerate()) - before:
        assert time.monotonic() < deadline, "the status thread did not exit"
        time.sleep(0.01)
    frame = wire.encode_status(3, hist.ps.height())
    assert all(m == (CHANNEL_SYNC, frame) for p in peers for m in p.sent)
    assert frame == jwire.encode_status(3, hist.js.height())
