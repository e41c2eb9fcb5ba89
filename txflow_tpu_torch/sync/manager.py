"""SyncManager: the catch-up client's certificate re-check and apply
(counterpart of ``txflow_tpu/sync/manager.py``, trimmed to the verify and
apply path: the fetch loop, request window, timeouts, strikes, bans,
adverts and fallback state are the network layer, not ported yet).

Every fetched certificate is re-verified before it is applied through the
engine's commit seam (``TxFlow.apply_synced_commit``): never trusted,
always re-derived. The validator set for a height is the one the client
has on record (state store, or pinned earlier); a server snapshot that
contradicts a record is Byzantine. With no record for a height, the
client verifies under the server's snapshot and accepts it only when the
certificate's proven signers carry a 2/3 quorum of the nearest set it
does trust (light-client-style endorsement), then pins it.

In committee mode each certificate tallies against the committee that
the schedule derives from the full set in force at its vote height, and
a response's certificates verify as one ``BatchCertVerifier`` call (one
K6 launch) per committee.
"""

from __future__ import annotations

import hashlib

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
        state_store=None,
        config: SyncConfig | None = None,
        committee=None,  # committee.CommitteeSchedule | None (full-set mode)
        device=None,
        fe_radix: int | None = None,
    ):
        self.chain_id = chain_id
        self.tx_store = tx_store
        self.txflow = txflow
        self.state_store = state_store
        self.config = config or SyncConfig()
        self.committee = committee
        # where committee-mode certificate batches verify: CUDA unless the
        # caller asks for the CPU
        self.device = resolve_device(device)
        # the field of those batches' verify kernel (ops/field.py; None
        # reads TXFLOW_FE_RADIX now)
        self.fe_radix = field.resolve(fe_radix)
        self._verifiers: dict[tuple, ScalarVoteVerifier] = {}
        # height -> the set the client trusts there: state-store records
        # plus sets learned through endorsement
        self._trusted_vals: dict[int, ValidatorSet] = {}

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
            self.state_store.save_validators(height, vals)

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
        for p in parsed:
            if p is None:
                continue
            tx_hash, votes, tx, tx_key, vals = p[:5]
            vs = TxVoteSet(self.chain_id, votes[0].height, tx_hash, tx_key, vals)
            for v in votes:
                vs.add_verified_vote(v)
            if self.txflow.apply_synced_commit(vs, votes, tx):
                applied += 1
        return applied
