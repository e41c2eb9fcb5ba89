"""SyncManager: the catch-up client state machine (counterpart of
``txflow_tpu/sync/manager.py``).

A node detects it is behind from its peers' STATUS adverts (commit-order
seq counts, sent by every node's SyncReactor), selects a serving peer --
the highest advert among connected peers it has not banned -- and fetches
ranges of committed txs and their certificates with a bounded in-flight
window. Every fetched certificate is re-verified before it is applied
through the engine's commit seam (``TxFlow.apply_synced_commit``): never
trusted, always re-derived. The validator set for a height is the one the
client has on record (state store, or pinned earlier); a server snapshot
that contradicts a record is byzantine. With no record for a height, the
client verifies under the server's snapshot and accepts it only when the
certificate's proven signers carry a 2/3 quorum of the nearest set it does
trust (light-client-style endorsement), then pins it.

In committee mode each certificate tallies against the committee that the
schedule derives from the full set in force at its vote height, and a
response's certificates verify as one ``BatchCertVerifier`` call (one K6
launch) per committee, on ``device``.

Failure handling, as in the JAX client:

- a per-request timeout is a stall strike, then jittered exponential
  backoff (``random.Random(config.seed)``) and peer rotation;
- at most ``window`` requests are outstanding;
- a short response is byzantine only when it is a provable lie: the
  server's own advert covers the range and it stopped with byte headroom
  below ``max_resp_bytes`` and below ``max_range``. Honest shortness (the
  byte or count cap, or an advert lowered for missing rows) resumes from
  the end of what was served;
- a byzantine server (forged certificate, wrong epoch snapshot,
  mixed-height certificate, provably truncated range, tx bytes that do not
  hash to the certified tx_hash, a wrong start) is banned locally for
  ``byzantine_ban`` seconds, its advert dropped, and rotated away from;
  nothing is applied before verification;
- after ``max_rounds`` consecutive failed rounds the client enters the
  fallback state and probes again after ``fallback_cooldown``.

Ranges are fetched in one server's seq space a round and applied in that
order; entries already committed locally are skipped before verification.
A node that lags but was not wiped tries a tail round near its own count
first and walks the whole log only when that round closes no gap.

Left out, with the layer each belongs to: the peer scoreboard (health),
the node-wide byzantine ledger, the metrics registry and the tracer's
spans. ``stats`` and ``snapshot()`` carry the counters.
"""

from __future__ import annotations

import hashlib
import queue as _queue
import random
import threading
import time

import numpy as np

from ..committee import BatchCertVerifier
from ..ops import field
from ..store.tx_store import _decode_votes
from ..types import TxVoteSet
from ..types.tx_vote import sign_bytes_many
from ..types.validator import ValidatorSet
from ..verifier import ScalarVoteVerifier, resolve_device
from . import wire
from .config import SyncConfig
from .reactor import CHANNEL_SYNC

# the clock of deadlines, bans and cooldowns (a module name, so a test can
# drive the state machine on a clock of its own)
monotonic = time.monotonic

# states
STATE_IDLE = 0
STATE_SYNCING = 1
STATE_FALLBACK = 2

_STATE_NAMES = {STATE_IDLE: "idle", STATE_SYNCING: "syncing", STATE_FALLBACK: "fallback"}


class SyncError(Exception):
    """One failed interaction with a serving peer."""

    def __init__(self, msg: str, byzantine: bool = False):
        super().__init__(msg)
        self.byzantine = byzantine


def _set_fingerprint(vs: ValidatorSet) -> tuple:
    return tuple((v.address, v.voting_power) for v in vs)


class SyncManager:
    def __init__(
        self,
        chain_id: str,
        tx_store,
        txflow,
        switch=None,
        state_store=None,
        config: SyncConfig | None = None,
        committee=None,  # committee.CommitteeSchedule | None (full-set mode)
        device=None,
        fe_radix: int | None = None,
    ):
        self.chain_id = chain_id
        self.tx_store = tx_store
        self.txflow = txflow
        self.switch = switch
        self.state_store = state_store
        self.config = config or SyncConfig()
        self.committee = committee
        # where committee-mode certificate batches verify: CUDA unless the
        # caller asks for the CPU
        self.device = resolve_device(device)
        # the field of those batches' verify kernel (ops/field.py; None
        # reads TXFLOW_FE_RADIX now)
        self.fe_radix = field.resolve(fe_radix)
        self._rng = random.Random(self.config.seed)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # adverts and bans: written by the peers' receive threads and the
        # strike path, read by the chooser
        self._mtx = threading.Lock()
        # peer node_id -> (advertised seq_count, advertised height)
        self._adverts: dict[str, tuple[int, int]] = {}
        self._banned: dict[str, float] = {}  # node_id -> ban expiry
        self._resp_q: _queue.Queue = _queue.Queue()
        self._req_id = 0
        self._verifiers: dict[tuple, ScalarVoteVerifier] = {}
        # height -> the set the client trusts there: state-store records
        # plus sets learned through endorsement (sync thread only)
        self._trusted_vals: dict[int, ValidatorSet] = {}
        self.state = STATE_IDLE
        self._consec_failed_rounds = 0
        self._backoff_level = 0
        self._cooldown_until = 0.0
        self.last_server: str | None = None
        self.last_error = ""
        self.stats = {
            "rounds_ok": 0,
            "rounds_failed": 0,
            "fetched": 0,
            "applied": 0,
            "verify_failures": 0,
            "byzantine_strikes": 0,
            "timeouts": 0,
            "rotations": 0,
            "fallbacks": 0,
            "served": 0,
        }

    # -- lifecycle --

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="sync-manager", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- reactor callbacks (the peers' receive threads) --

    def note_status(self, node_id: str, seq_count: int, height: int) -> None:
        with self._mtx:
            self._adverts[node_id] = (seq_count, height)

    def note_peer_gone(self, node_id: str) -> None:
        with self._mtx:
            self._adverts.pop(node_id, None)

    def note_response(self, node_id: str, *resp) -> None:
        self._resp_q.put((node_id, resp))

    def note_served(self, n_entries: int) -> None:
        self.stats["served"] += n_entries

    # -- introspection --

    def lag(self) -> int:
        local = self.tx_store.seq_count()
        best = self._best_advert()
        return max(0, best - local)

    def _servable_adverts(self) -> dict[str, tuple[int, int]]:
        """Adverts of the peers the client would select: a banned peer's
        inflated seq count must not keep lag() above the threshold."""
        now = monotonic()
        with self._mtx:
            return {n: a for n, a in self._adverts.items() if self._banned.get(n, 0.0) <= now}

    def _best_advert(self) -> int:
        adverts = self._servable_adverts()
        return max((seq for seq, _h in adverts.values()), default=0)

    def snapshot(self) -> dict:
        adverts = self._servable_adverts()
        with self._mtx:
            banned = [n for n, t in self._banned.items() if t > monotonic()]
        return {
            "state": _STATE_NAMES.get(self.state, str(self.state)),
            "lag": self.lag(),
            "local_seq": self.tx_store.seq_count(),
            "best_advert": max((s for s, _ in adverts.values()), default=0),
            "peers_advertising": len(adverts),
            "banned_peers": banned,
            "last_server": self.last_server,
            "last_error": self.last_error,
            **self.stats,
        }

    # -- the state machine --

    def _run(self) -> None:
        cfg = self.config
        while not self._stop.wait(cfg.poll_interval):
            self._expire_bans()
            now = monotonic()
            if self.state == STATE_FALLBACK and now < self._cooldown_until:
                continue
            if self.lag() < cfg.lag_threshold:
                self.state = STATE_IDLE
                self._consec_failed_rounds = 0
                self._backoff_level = 0
                continue
            self.state = STATE_SYNCING
            applied = self._sync_round()
            if self._stop.is_set():
                return
            if applied > 0:
                self.stats["rounds_ok"] += 1
                self._consec_failed_rounds = 0
                self._backoff_level = 0
                continue
            self._consec_failed_rounds += 1
            self.stats["rounds_failed"] += 1
            if self._consec_failed_rounds >= cfg.max_rounds:
                # no peer can serve us: fall back, probe again later
                self.state = STATE_FALLBACK
                self.stats["fallbacks"] += 1
                self._cooldown_until = monotonic() + cfg.fallback_cooldown
                self._consec_failed_rounds = 0
                self._backoff_level = 0
            else:
                self._sleep_backoff()

    def _expire_bans(self) -> None:
        now = monotonic()
        with self._mtx:
            for nid in [n for n, t in self._banned.items() if t <= now]:
                del self._banned[nid]

    def _sleep_backoff(self) -> None:
        cfg = self.config
        base = min(cfg.backoff_base * (2.0**self._backoff_level), cfg.backoff_cap)
        jitter = 1.0 + cfg.backoff_jitter * (2.0 * self._rng.random() - 1.0)
        self._backoff_level += 1
        self._stop.wait(base * jitter)

    def _select_peer(self):
        """The connected, unbanned peer with the highest advert above our
        own count (the first such peer on a tie)."""
        adverts = self._servable_adverts()
        local = self.tx_store.seq_count()
        best, best_key = None, None
        for peer in self.switch.peers():
            adv = adverts.get(peer.node_id)
            if adv is None or adv[0] <= local:
                continue
            # the JAX client's key carries the scoreboard's score second
            # (no scoreboard here: 0.0 for every peer)
            key = (adv[0], 0.0)
            if best_key is None or key > best_key:
                best, best_key = peer, key
        return best, (best_key[0] if best_key else 0)

    def _sync_round(self) -> int:
        """One fetch round against one serving peer. Returns the txs newly
        applied (0: the round failed or closed no gap)."""
        cfg = self.config
        peer, target = self._select_peer()
        if peer is None:
            self.last_error = "no servable peer"
            return 0
        self.last_server = peer.node_id
        local = self.tx_store.seq_count()
        # a tail round first, near our own count; if the orders diverged
        # so far that it closes nothing, the next round walks from 0
        start = max(0, local - cfg.batch) if self._consec_failed_rounds == 0 else 0
        try:
            return self._fetch_apply(peer, start, target)
        except SyncError as e:
            self.last_error = str(e)
            self._strike(peer, e)
            return 0

    def _strike(self, peer, err: SyncError) -> None:
        cfg = self.config
        self.stats["rotations"] += 1
        if err.byzantine:
            self.stats["byzantine_strikes"] += 1
            with self._mtx:
                self._banned[peer.node_id] = monotonic() + cfg.byzantine_ban
                # a proven liar's advert is worthless (it re-adverts on its
                # next status tick, ignored while banned)
                self._adverts.pop(peer.node_id, None)
        else:
            self.stats["timeouts"] += 1

    # -- fetch, verify, apply --

    def _next_req_id(self) -> int:
        self._req_id += 1
        return self._req_id

    def _fetch_apply(self, peer, cursor: int, target: int) -> int:
        """Windowed range fetch from ``peer`` over [cursor, target) of its
        seq space, each response verified and applied in range order.
        Raises SyncError on a stall or byzantine evidence."""
        cfg = self.config
        pending: dict[int, tuple[int, int, float]] = {}  # req_id -> (start, count, sent)
        ready: dict[int, tuple] = {}  # start -> (served, entries, snapshots)
        next_start = cursor
        applied = 0
        # drain stale responses of earlier rounds
        while not self._resp_q.empty():
            try:
                self._resp_q.get_nowait()
            except _queue.Empty:
                break
        while (cursor < target or pending) and not self._stop.is_set():
            while len(pending) < cfg.window and next_start < target:
                count = min(cfg.batch, cfg.max_range, target - next_start)
                rid = self._next_req_id()
                if not peer.try_send(CHANNEL_SYNC, wire.encode_range_req(rid, next_start, count)):
                    raise SyncError(f"send to {peer.node_id} failed")
                pending[rid] = (next_start, count, monotonic())
                next_start += count
            try:
                nid, resp = self._resp_q.get(timeout=self._wait_budget(pending))
            except _queue.Empty:
                raise SyncError(f"range request to {peer.node_id} timed out")
            if nid != peer.node_id:
                continue  # a stale response of a rotated-away server
            req_id, start, advert, entries, snapshots = resp
            meta = pending.pop(req_id, None)
            if meta is None:
                continue  # a duplicate or stale req_id
            r_start, r_count, _t_sent = meta
            if start != r_start:
                raise SyncError(
                    f"{peer.node_id} answered start {start} for {r_start}", byzantine=True
                )
            served = len(entries)
            served_bytes = sum(len(c) + len(t) for _h, c, t in entries)
            # short is a provable lie only when the server's own advert
            # covers the range and it stopped with byte headroom below a
            # byte-capped honest response (which always serves >=
            # max_resp_bytes) and below the count cap
            expected = min(r_count, max(0, advert - r_start))
            if served < expected and served_bytes < cfg.max_resp_bytes and served < cfg.max_range:
                raise SyncError(
                    f"truncated range from {peer.node_id}: "
                    f"{served} entries, expected {expected} "
                    f"with byte headroom",
                    byzantine=True,
                )
            if advert < target:
                # the server can serve less than this round planned (rows
                # lost, or it advertised more than it can prove): shrink
                # the walk instead of demanding it
                target = advert
            rem_start = r_start + served
            rem_count = min(r_count - served, target - rem_start)
            if rem_count > 0:
                # honest short response (byte or count cap): resume the
                # rest of this range -- progress, not a strike
                rid = self._next_req_id()
                if not peer.try_send(CHANNEL_SYNC, wire.encode_range_req(rid, rem_start, rem_count)):
                    raise SyncError(f"send to {peer.node_id} failed")
                pending[rid] = (rem_start, rem_count, monotonic())
            ready[r_start] = (served, entries, snapshots)
            # apply contiguously from the cursor: the commit-order log
            # extends in the server's order
            while cursor in ready:
                served, entries, snapshots = ready.pop(cursor)
                applied += self._verify_apply(peer.node_id, entries, snapshots)
                cursor += served
        return applied

    def _wait_budget(self, pending: dict) -> float:
        """Time until the oldest outstanding request times out."""
        if not pending:
            return self.config.request_timeout
        oldest = min(t for _s, _c, t in pending.values())
        return max(0.01, oldest + self.config.request_timeout - monotonic())

    def apply_range_resp(self, peer_id: str, frame: bytes) -> tuple[int, int, int]:
        """Decode one RANGE_RESP frame from ``peer_id``, verify and apply
        its certificates. Returns ``(start, entries served, applied)``;
        raises SyncError, with nothing applied, on forged content."""
        _req_id, start, _advert, entries, snapshots = wire.decode_range_resp(frame)
        return start, len(entries), self._verify_apply(peer_id, entries, snapshots)

    def _vals_for(self, height: int) -> tuple[ValidatorSet, bool]:
        """The set to verify ``height``'s votes under, and whether it is a
        record of our own (False: the engine's current set, a fallback)."""
        vals = self._trusted_vals.get(height)
        if vals is not None:
            return vals, True
        if self.state_store is not None:
            vals = self.state_store.load_validators(height)
            if vals is not None:
                self._trusted_vals[height] = vals
                return vals, True
        return self.txflow.val_set, False

    def _anchor_for(self, height: int) -> ValidatorSet:
        """The most recent set we trust at or below ``height``."""
        best_h, best = -1, None
        for h, vs in self._trusted_vals.items():
            if best_h < h <= height:
                best_h, best = h, vs
        return best if best is not None else self.txflow.val_set

    @staticmethod
    def _endorsed(votes, anchor: ValidatorSet) -> bool:
        """True when the certificate's (already verified) signers include
        members of ``anchor`` holding 2/3 of its power."""
        power, seen = 0, set()
        for v in votes:
            addr = v.validator_address
            if addr in seen:
                continue
            seen.add(addr)
            _i, val = anchor.get_by_address(addr)
            if val is not None:
                power += val.voting_power
        return power >= anchor.quorum_power()

    def _learn_vals(self, height: int, vals: ValidatorSet) -> None:
        """Pin (and persist) the set a verified certificate proved was in
        force at ``height``."""
        if height in self._trusted_vals:
            return
        self._trusted_vals[height] = vals
        if len(self._trusted_vals) > 64:
            for h in sorted(self._trusted_vals)[: len(self._trusted_vals) - 64]:
                del self._trusted_vals[h]
        if (
            self.state_store is not None
            and self.state_store.load_validators(height) is None
        ):
            try:
                self.state_store.save_validators(height, vals)
            except OSError:
                pass  # the durable pin is best-effort; the cache carries on

    def _verifier_for(self, vals: ValidatorSet) -> ScalarVoteVerifier:
        fp = _set_fingerprint(vals)
        v = self._verifiers.get(fp)
        if v is None:
            if len(self._verifiers) > 8:
                self._verifiers.clear()
            if self.committee is not None:
                # committee mode: one K6 launch per val-set group
                v = self._verifiers[fp] = BatchCertVerifier(
                    vals, device=self.device, fe_radix=self.fe_radix
                )
            else:
                v = self._verifiers[fp] = ScalarVoteVerifier(vals)
        return v

    def _verify_apply(self, peer_id: str, entries: list, snapshots: dict) -> int:
        """Verify one response's certificates (batched, grouped by the
        validator set in force at their height) and apply them in order.
        Raises SyncError(byzantine=True) on any forged content."""
        if not entries:
            return 0
        nid = peer_id
        # (tx_hash, votes, tx, tx_key, vals, height, unchained, full_vals)
        # per entry, response order; None = already committed locally
        parsed = []
        for tx_hash, cert_blob, tx in entries:
            if self.tx_store.has_tx(tx_hash):
                parsed.append(None)
                continue
            tx_key = hashlib.sha256(tx).digest()
            if tx_key.hex().upper() != tx_hash:
                raise SyncError(
                    f"{nid} served tx bytes that hash to "
                    f"{tx_key.hex().upper()[:12]}.., certified {tx_hash[:12]}..",
                    byzantine=True,
                )
            try:
                votes = _decode_votes(cert_blob)
            except Exception:
                raise SyncError(f"{nid} served an undecodable certificate", byzantine=True)
            if not votes:
                raise SyncError(f"{nid} served an empty certificate", byzantine=True)
            height = votes[0].height
            for v in votes:
                # the sign bytes zero TxKey: bind the vote's own hash/key
                # fields to the tx bytes we derived
                if v.tx_hash != tx_hash or v.tx_key != tx_key:
                    raise SyncError(
                        f"{nid} served a certificate whose votes name a "
                        "different tx",
                        byzantine=True,
                    )
                if v.height != height:
                    # other-height votes could tally under this height's
                    # stake weights and fake a quorum
                    raise SyncError(
                        f"{nid} served a certificate mixing vote heights",
                        byzantine=True,
                    )
            vals, on_record = self._vals_for(height)
            claimed = snapshots.get(height)
            unchained = False
            if claimed is not None and _set_fingerprint(claimed) != _set_fingerprint(
                vals
            ):
                if on_record:
                    raise SyncError(
                        f"{nid} claims a different validator set at height {height}",
                        byzantine=True,
                    )
                # no record of our own: verify under the claimed set, accept
                # only if endorsed (below)
                vals, unchained = claimed, True
            full_vals = vals
            if self.committee is not None:
                # the certificate was formed by the epoch's committee: tally
                # against it; full_vals is what gets pinned
                vals = self.committee.for_vote_height(height, vals)
            parsed.append(
                (tx_hash, votes, tx, tx_key, vals, height, unchained, full_vals)
            )
        # batched verify, one group per validator set (one per epoch)
        groups: dict[tuple, list[int]] = {}
        for i, p in enumerate(parsed):
            if p is None:
                continue
            groups.setdefault(_set_fingerprint(p[4]), []).append(i)
        for _fp, idxs in groups.items():
            vals = parsed[idxs[0]][4]
            verifier = self._verifier_for(vals)
            addr_to_idx = {v.address: j for j, v in enumerate(vals)}
            msgs: list[bytes] = []
            sigs: list[bytes] = []
            val_idx: list[int] = []
            tx_slot: list[int] = []
            for slot, i in enumerate(idxs):
                votes = parsed[i][1]
                vb = sign_bytes_many(votes, self.chain_id)
                for v, sb in zip(votes, vb):
                    vi = addr_to_idx.get(v.validator_address)
                    if vi is None:
                        raise SyncError(
                            f"{nid} certificate carries a vote from an "
                            "unknown validator",
                            byzantine=True,
                        )
                    msgs.append(sb)
                    sigs.append(v.signature or b"")
                    val_idx.append(vi)
                    tx_slot.append(slot)
            res = verifier.verify_and_tally(
                msgs,
                sigs,
                np.asarray(val_idx, dtype=np.int32),
                np.asarray(tx_slot, dtype=np.int32),
                n_slots=len(idxs),
                quorum=vals.quorum_power(),
            )
            if not bool(res.valid.all()):
                self.stats["verify_failures"] += 1
                raise SyncError(
                    f"{nid} served a certificate with an invalid signature",
                    byzantine=True,
                )
            if bool(res.dropped.any()):
                raise SyncError(
                    f"{nid} served a certificate with duplicate votes",
                    byzantine=True,
                )
            if not bool(res.maj23.all()):
                self.stats["verify_failures"] += 1
                raise SyncError(
                    f"{nid} served a certificate below 2/3+ stake",
                    byzantine=True,
                )
        # endorsement for sets we had no record for: the signers are now
        # proven, so require a 2/3 quorum of the nearest trusted set
        for p in parsed:
            if p is None or not p[6]:
                continue
            votes, height = p[1], p[5]
            anchor = self._anchor_for(height)
            if self.committee is not None:
                # the signers are the committee: they must carry a quorum
                # of the trusted anchor's committee
                anchor = self.committee.for_vote_height(height, anchor)
            if not self._endorsed(votes, anchor):
                # not Byzantine: our record may be too stale to chain across
                # the rotation
                raise SyncError(
                    f"{nid} claims a validator set at height {height} "
                    "that no quorum of our trusted set endorses"
                )
        for p in parsed:
            if p is not None:
                self._learn_vals(p[5], p[7])
        # verified: apply in the server's order through the commit seam
        applied = 0
        self.stats["fetched"] += sum(1 for p in parsed if p is not None)
        for p in parsed:
            if p is None:
                continue
            tx_hash, votes, tx, tx_key, vals = p[:5]
            vs = TxVoteSet(self.chain_id, votes[0].height, tx_hash, tx_key, vals)
            for v in votes:
                vs.add_verified_vote(v)
            if self.txflow.apply_synced_commit(vs, votes, tx):
                applied += 1
        self.stats["applied"] += applied
        return applied
