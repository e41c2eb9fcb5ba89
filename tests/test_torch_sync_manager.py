"""PyTorch port, the catch-up client's state machine (sync/manager.py
SyncManager: window, stale-response drain, start check, truncation test,
advert shrink, resume, strikes, bans, backoff, fallback, peer choice)
against the JAX package's. Each case gives a JAX manager and a port
manager (full-set mode, ``device="cpu"``; the JAX one with no scoreboard
and no ledger) the same scripted serving peer -- the JAX reactor's
``_serve_range`` over one committed history, answered per a script --
and the same stub engine, and checks that they send the same RANGE_REQ
frames byte for byte and end with the same stats, bans, state, applies
and error. The state machine's loop runs on a clock and a stop event of
the test's own, so the backoff and cooldown sequences are compared
exactly. Tolerance 0."""

import pytest

import txflow_tpu.store as jstore
import txflow_tpu.sync.manager as jmanager
import txflow_tpu.types as jtypes
from txflow_tpu.sync import wire as jwire
from txflow_tpu.sync.config import SyncConfig as JSyncConfig
from txflow_tpu.sync.manager import SyncError as JSyncError
from txflow_tpu.sync.manager import SyncManager as JSyncManager
from txflow_tpu.sync.reactor import SyncReactor as JSyncReactor

import txflow_tpu_torch.store as pstore
import txflow_tpu_torch.sync.manager as pmanager
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.sync import SyncConfig, SyncError, SyncManager, wire

from _torch_sync_rigs import CHAIN, FakePeer, FakeSwitch, History, StubFlow


class Server:
    """A scripted serving peer over ``hist``'s JAX stores. ``script`` maps
    each request (req_id, start, count) and the honest response frame to
    the frames delivered back, in order (or holds them: ``hold`` requests
    are collected and then answered together, last first)."""

    def __init__(self, hist, cfg_kw=None, tamper=None, script=None, hold=0, silent=False):
        self.reactor = JSyncReactor(hist.js, hist.jss, current_vals=lambda: hist.jvals,
                                    config=JSyncConfig(**(cfg_kw or {})))
        self.reactor.tamper = tamper
        self.script = script
        self.hold = hold
        self.silent = silent
        self.held: list[bytes] = []

    def answer(self, req: bytes) -> list[bytes]:
        if self.silent:
            return []
        req_id, start, count = jwire.decode_range_req(req)
        frame = self.reactor._serve_range(req_id, start, count)
        frames = [frame] if self.script is None else self.script(req_id, start, count, frame)
        if self.hold:
            self.held += frames
            if len(self.held) < self.hold:
                return []
            frames, self.held = self.held[::-1], []
        return frames


def _peer(mgr, server, node_id="server", port=True):
    decode = wire.decode_range_resp if port else jwire.decode_range_resp

    def on_send(frame):
        for resp in server.answer(frame):
            sender = node_id
            if isinstance(resp, tuple):  # (sender, frame): a response from elsewhere
                sender, resp = resp
            mgr.note_response(sender, *decode(resp))

    return FakePeer(node_id, on_send=on_send)


class Pair:
    """A JAX and a port manager over empty client stores, each with its own
    scripted peers built by ``servers()`` (one Server per peer id)."""

    def __init__(self, hist, servers, cfg_kw=None, peer_ids=("server",)):
        kw = cfg_kw or {}
        self.jstore, self.pstore = jstore.TxStore(jstore.MemDB()), pstore.TxStore(pstore.MemDB())
        self.jflow = StubFlow(hist.jvals, self.jstore)
        self.pflow = StubFlow(hist.pvals, self.pstore)
        self.jm = JSyncManager(CHAIN, self.jstore, self.jflow, switch=None, state_store=None,
                               config=JSyncConfig(**kw))
        self.pm = SyncManager(CHAIN, self.pstore, self.pflow, switch=None, state_store=None,
                              config=SyncConfig(**kw), device="cpu")
        js, ps = servers(), servers()
        self.jpeers = [_peer(self.jm, js[n], n, port=False) for n in peer_ids]
        self.ppeers = [_peer(self.pm, ps[n], n, port=True) for n in peer_ids]
        self.jm.switch, self.pm.switch = FakeSwitch(self.jpeers), FakeSwitch(self.ppeers)

    def advert(self, node_id, seq, height=0):
        self.jm.note_status(node_id, seq, height)
        self.pm.note_status(node_id, seq, height)

    def both(self, fn):
        """Run ``fn(manager, peers)`` on each; return (result, error) pairs."""
        out = []
        for m, peers in ((self.jm, self.jpeers), (self.pm, self.ppeers)):
            try:
                out.append((fn(m, peers), None))
            except (JSyncError, SyncError) as e:
                out.append((None, e))
        return out

    def assert_same(self, results=None):
        if results is not None:
            (jr, je), (pr, pe) = results
            assert pr == jr
            assert (je is None) == (pe is None)
            if je is not None:
                assert str(pe) == str(je) and pe.byzantine == je.byzantine
        for jp, pp in zip(self.jpeers, self.ppeers):
            assert pp.sent == jp.sent, pp.node_id
        assert self.pm.stats == self.jm.stats
        assert self.pflow.applied == self.jflow.applied
        assert sorted(self.pm._banned) == sorted(self.jm._banned)
        assert self.pm.state == self.jm.state
        assert self.pm.last_server == self.jm.last_server
        assert self.pm.last_error == self.jm.last_error
        snap_keys = ("state", "lag", "local_seq", "best_advert", "peers_advertising",
                     "banned_peers")
        ps, js = self.pm.snapshot(), self.jm.snapshot()
        assert {k: ps[k] for k in snap_keys} == {k: js[k] for k in snap_keys}


def _fetch(cursor, target):
    return lambda m, peers: m._fetch_apply(peers[0], cursor, target)


def _round(m, _peers):
    return m._sync_round()


def test_window_fills_before_the_first_response():
    hist = History(n_txs=12)
    pair = Pair(hist, lambda: {"server": Server(hist, hold=3)}, dict(batch=2, window=3))
    res = pair.both(_fetch(0, 12))
    pair.assert_same(res)
    assert res[1] == (12, None)
    reqs = [wire.decode_range_req(f) for _c, f in pair.ppeers[0].sent]
    assert reqs[:3] == [(1, 0, 2), (2, 2, 2), (3, 4, 2)]  # three out before any answer
    assert pair.pflow.applied == hist.hashes  # applied in range order


def _dup_and_stale(req_id, start, count, frame):
    r, s, adv, entries, snaps = jwire.decode_range_resp(frame)
    stale = jwire.encode_range_resp(req_id + 100, s, adv, entries, snaps)  # an unknown req_id
    return [("other", frame), stale, frame, frame]  # another server's, then a duplicate


def test_stale_duplicate_and_foreign_responses_are_skipped():
    hist = History(n_txs=10)
    pair = Pair(hist, lambda: {"server": Server(hist, script=_dup_and_stale)},
                dict(batch=4, window=2))
    res = pair.both(_fetch(0, 10))
    pair.assert_same(res)
    assert res[1] == (10, None) and pair.pm.stats["applied"] == 10


def test_stale_responses_of_an_earlier_round_are_drained():
    hist = History(n_txs=6)
    pair = Pair(hist, lambda: {"server": Server(hist)}, dict(batch=8))
    for m, dec in ((pair.jm, jwire.decode_range_resp), (pair.pm, wire.decode_range_resp)):
        old = JSyncReactor(hist.js, hist.jss)._serve_range(1, 3, 2)  # req_id 1 again, wrong start
        m.note_response("server", *dec(old))
    res = pair.both(_fetch(0, 6))
    pair.assert_same(res)
    assert res[1] == (6, None)


def _wrong_start(req_id, start, count, frame):
    r, s, adv, entries, snaps = jwire.decode_range_resp(frame)
    return [jwire.encode_range_resp(r, s + 1, adv, entries, snaps)]


def test_wrong_start_is_a_byzantine_strike():
    hist = History(n_txs=8)
    pair = Pair(hist, lambda: {"server": Server(hist, script=_wrong_start)})
    pair.advert("server", 8)
    res = pair.both(_round)
    pair.assert_same(res)
    assert res[1] == (0, None)
    assert "answered start 1 for 0" in pair.pm.last_error
    assert pair.pm.stats["byzantine_strikes"] == 1 and "server" in pair.pm._banned
    assert pair.pm.lag() == 0  # the liar's advert is gone


@pytest.mark.parametrize(
    "case,server_kw,client_kw,tamper,want_applied,byzantine",
    [
        ("byte_capped", dict(max_resp_bytes=600), dict(max_resp_bytes=600, batch=5), None, 12, False),
        ("count_capped", dict(max_range=3), dict(max_range=3, batch=8), None, 12, False),
        ("server_count_below_client", dict(max_range=2), dict(max_range=3, batch=8), None, 0, True),
        ("provable_truncation", {}, dict(batch=8), "half", 0, True),
    ],
)
def test_truncation_against_honest_capped_resume(case, server_kw, client_kw, tamper, want_applied,
                                                 byzantine):
    hist = History(n_txs=12)

    def half(entries, snaps):
        return entries[: max(1, len(entries) // 2)], snaps

    pair = Pair(hist, lambda: {"server": Server(hist, server_kw, tamper=half if tamper else None)},
                client_kw)
    pair.advert("server", 12)
    res = pair.both(_round)
    pair.assert_same(res)
    assert pair.pm.stats["applied"] == want_applied
    assert pair.pm.stats["byzantine_strikes"] == int(byzantine)
    if byzantine:
        assert "truncated range from server" in pair.pm.last_error
    else:
        # resumed the tail of capped ranges: more requests than batches
        assert len(pair.ppeers[0].sent) > -(-12 // client_kw["batch"])


def test_a_lowered_advert_shrinks_the_walk():
    hist = History(n_txs=12, missing=(7,))  # rows 7.. cannot be served
    pair = Pair(hist, lambda: {"server": Server(hist)}, dict(batch=4, window=4))
    pair.advert("server", 12)
    res = pair.both(_round)
    pair.assert_same(res)
    assert res[1] == (7, None) and pair.pm.stats["byzantine_strikes"] == 0
    # the walk stopped at the advert: no request past row 7 was answered short
    assert pair.pstore.seq_count() == 7


def test_a_timeout_is_a_stall_strike():
    hist = History(n_txs=5)
    pair = Pair(hist, lambda: {"server": Server(hist, silent=True)},
                dict(request_timeout=0.05, window=2, batch=2))
    pair.advert("server", 5)
    res = pair.both(_round)
    pair.assert_same(res)
    assert pair.pm.stats["timeouts"] == 1 and pair.pm.stats["rotations"] == 1
    assert pair.pm.stats["byzantine_strikes"] == 0 and not pair.pm._banned
    assert "timed out" in pair.pm.last_error and len(pair.ppeers[0].sent) == 2


class FakeStop:
    """The manager's stop event, on the test's clock: ``wait(t)`` records t,
    advances the clock by it, and reports a stop after ``n`` waits."""

    def __init__(self, clock, n):
        self.clock, self.n, self.waits, self.stopped = clock, n, [], False

    def wait(self, timeout=None):
        self.waits.append(timeout)
        self.clock.t += timeout or 0.0
        if len(self.waits) >= self.n:
            self.stopped = True
        return self.stopped

    def is_set(self):
        return self.stopped

    def set(self):
        self.stopped = True

    def clear(self):
        self.stopped = False


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _run_both(pair, monkeypatch, n_waits):
    """Run each manager's loop to its n-th wait on a fresh clock; returns
    the two wait sequences and the states seen after each wait."""
    out = []
    for mod, m in ((jmanager, pair.jm), (pmanager, pair.pm)):
        clock = Clock()
        monkeypatch.setattr(mod, "monotonic", clock)
        m._stop = FakeStop(clock, n_waits)
        m._run()
        out.append(m._stop.waits)
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_sequence_from_the_seed(monkeypatch, seed):
    hist = History(n_txs=4)
    cfg = dict(seed=seed, request_timeout=0.01, max_rounds=5, poll_interval=0.05,
               backoff_base=0.25, backoff_cap=1.0, backoff_jitter=0.25)
    pair = Pair(hist, lambda: {"server": Server(hist, silent=True)}, cfg)
    pair.advert("server", 4)
    jw, pw = _run_both(pair, monkeypatch, 9)
    assert pw == jw
    # poll, then a backoff after each failed round: base 0.25 doubling to
    # the cap of 1.0, each within +/- 25% jitter
    backoffs = pw[1::2]
    assert len(backoffs) == 4
    for level, b in enumerate(backoffs):
        base = min(0.25 * 2**level, 1.0)
        assert 0.75 * base <= b <= 1.25 * base
    pair.assert_same()
    assert pair.pm.stats["timeouts"] == 4 and pair.pm.state == pmanager.STATE_SYNCING
    other = Pair(hist, lambda: {"server": Server(hist, silent=True)}, dict(cfg, seed=seed + 1))
    other.advert("server", 4)
    assert _run_both(other, monkeypatch, 9)[1] != pw


def test_max_rounds_to_fallback(monkeypatch):
    """Two peers that serve nothing: each round's server is struck
    byzantine and banned; after max_rounds consecutive failed rounds the
    client falls back and idles through its polls."""
    hist = History(n_txs=6)

    def nothing(entries, snaps):
        return [], {}

    cfg = dict(max_rounds=2, poll_interval=0.1, fallback_cooldown=1.0, backoff_base=0.05,
               backoff_cap=0.2, byzantine_ban=100.0)
    pair = Pair(hist, lambda: {n: Server(hist, tamper=nothing) for n in ("a", "b")}, cfg,
                peer_ids=("a", "b"))
    pair.advert("a", 6)
    pair.advert("b", 6)
    # poll, round on a, backoff, poll, round on b (fallback), five polls
    jw, pw = _run_both(pair, monkeypatch, 8)
    assert pw == jw
    assert pw[0] == pw[2] == 0.1 and pw[3:] == [0.1] * 5
    pair.assert_same()
    st = pair.pm.stats
    assert st["byzantine_strikes"] == 2 and st["fallbacks"] == 1 and st["rounds_failed"] == 2
    assert sorted(pair.pm._banned) == ["a", "b"]
    assert pair.pm.state == pmanager.STATE_FALLBACK
    assert "truncated range from b" in pair.pm.last_error


@pytest.mark.parametrize("n_waits,rounds", [(4, 1), (6, 2)])
def test_fallback_cooldown_then_probe_again(monkeypatch, n_waits, rounds):
    """A silent server: one failed round is max_rounds here. The polls
    inside the cooldown (0.35 s of 0.1 s polls) run no round; the first
    poll past it probes again."""
    hist = History(n_txs=3)
    cfg = dict(max_rounds=1, poll_interval=0.1, fallback_cooldown=0.35, request_timeout=0.01)
    pair = Pair(hist, lambda: {"server": Server(hist, silent=True)}, cfg)
    pair.advert("server", 3)
    jw, pw = _run_both(pair, monkeypatch, n_waits)
    assert pw == jw == [0.1] * n_waits
    pair.assert_same()
    assert pair.pm.state == pmanager.STATE_FALLBACK
    assert pair.pm.stats["fallbacks"] == pair.pm.stats["timeouts"] == rounds
    assert len(pair.ppeers[0].sent) == rounds


def test_lag_ignores_banned_adverts():
    hist = History(n_txs=1)
    pair = Pair(hist, lambda: {"server": Server(hist)})
    pair.advert("liar", 2**60)
    pair.advert("honest", 5)
    for m, err in ((pair.jm, JSyncError), (pair.pm, SyncError)):
        assert m.lag() == 2**60
        m._strike(FakePeer("liar"), err("forged", byzantine=True))
        assert m.lag() == 5
        m.note_status("liar", 2**60, 0)  # a re-advert while banned is ignored
        assert m.lag() == 5
        m.note_peer_gone("honest")
        assert m.lag() == 0
    pair.assert_same()
    assert pair.pm.snapshot()["banned_peers"] == ["liar"]


@pytest.mark.parametrize(
    "adverts,local,banned,want",
    [
        ({"a": 5, "b": 9, "c": 9}, 0, (), ("b", 9)),  # highest advert, first on a tie
        ({"a": 5, "b": 9, "c": 9}, 0, ("b",), ("c", 9)),  # a banned peer is skipped
        ({"a": 5, "b": 3}, 5, (), (None, 0)),  # nobody is ahead of us
        ({"a": 4, "zz": 50}, 2, (), ("a", 4)),  # an advert of no connected peer
        ({}, 0, (), (None, 0)),
    ],
)
def test_select_peer_choice(adverts, local, banned, want):
    hist = History(n_txs=6)
    pair = Pair(hist, lambda: {n: Server(hist) for n in ("a", "b", "c")},
                peer_ids=("a", "b", "c"))
    for n, seq in adverts.items():
        pair.advert(n, seq)
    for i in range(local):  # the client already holds ``local`` commits
        for store, src, types, vals in ((pair.jstore, hist.js, jtypes, hist.jvals),
                                        (pair.pstore, hist.ps, ptypes, hist.pvals)):
            h = hist.hashes[i]
            votes = src.load_tx_votes(h)
            vs = types.TxVoteSet(CHAIN, 0, h, votes[0].tx_key, vals)
            for v in votes:
                vs.add_verified_vote(v)
            store.save_tx(vs, votes=votes, tx=hist.txs[i])
    for m, err in ((pair.jm, JSyncError), (pair.pm, SyncError)):
        for n in banned:
            m._strike(FakePeer(n), err("x", byzantine=True))
    got = []
    for m in (pair.jm, pair.pm):
        peer, target = m._select_peer()
        got.append((peer.node_id if peer is not None else None, target))
    assert got[1] == got[0] == want


def test_sync_config_fields_and_defaults_match_jax():
    import dataclasses

    assert dataclasses.asdict(SyncConfig()) == dataclasses.asdict(JSyncConfig())
    assert [f.name for f in dataclasses.fields(SyncConfig)] == [
        f.name for f in dataclasses.fields(JSyncConfig)]
