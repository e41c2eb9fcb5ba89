"""Node: the composition root of the fast path (reference node/node.go:
555-826), the counterpart of ``txflow_tpu/node/node.py``.

Assembles, in reference order: stores (TxStore, StateStore) -> ABCI proxy
connections -> event bus -> pools (mempool + commitpool + txvotepool) ->
TxExecutor + TxFlow -> the p2p switch with the mempool and txvote reactors
(every reactor registers its channel, as the JAX node fixes the
reference's wiring bug), the catch-up sync reactor and client when
``NodeConfig.sync`` (on by default, as in the JAX node) and, when the node
has a key, the PEX address book.

Committee mode (``epoch_config.committee_size > 0``): a
``CommitteeSchedule`` samples the tx-vote committee in force at each vote
height from the full set; the engine tallies against it (its quorum is the
committee's), the reactors' ``StateView`` carries it, and the sync client
verifies fetched certificates against it, one ``BatchCertVerifier`` launch
(K6) per committee group.

The engine runs on ``cuda`` unless ``NodeConfig.device`` (or the config's
engine section) says ``cpu``; without CUDA the node raises. It builds a
``DeviceVoteVerifier`` directly, or serves from the one it is given (a
``LocalNet`` shares one among its nodes); nothing falls back to the host
verifier, and ``NodeConfig`` has no switch for one. The sync client's
committee batches run on the engine's device.

The state store holds what the JAX node (``enable_consensus=False``)
holds after ``start()``: no validator record at all (its handshake finds
no block to replay, so ``StateStore.save`` never runs); the sync client
pins the sets it proves there.

Left out, each with the layer it belongs to: the block path (the
handshake replay ``txflow_tpu/node/node.py:613-640`` -- and with it the
replay of a restarted node's commit log into a fresh app --,
``BlockStore``, ``BlockExecutor``, ``EvidencePool``, ``ConsensusState``,
``EpochManager``), the health monitor and its peer scoreboard, the
byzantine ledger, admission (so no lane classifier is wired), RPC and
gRPC, the tracer, metrics, chaos and netem, and the pools' WALs.
``NodeConfig`` has no knob for them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from dataclasses import dataclass, field

from ..abci.application import Application
from ..abci.proxy import AppConns
from ..engine.execution import TxExecutor
from ..engine.txflow import TxFlow
from ..p2p import Switch
from ..pool.mempool import Mempool
from ..pool.txvotepool import TxVotePool
from ..reactors import MempoolReactor, StateView, TxVoteReactor
from ..state import StateStore
from ..store.db import MemDB
from ..store.tx_store import TxStore
from ..types.validator import ValidatorSet
from ..utils.config import Config
from ..utils.events import EventBus


# entries per gossip frame, both reactors (the JAX NodeConfig's default)
GOSSIP_BATCH = 4096


@dataclass
class NodeConfig:
    """Assembly knobs beyond the Config sections."""

    config: Config = field(default_factory=Config)
    # where the engine's verifier runs ("cuda" or "cpu"); None = the
    # config's engine section (itself "cuda" by default)
    device: str | None = None
    # the mempool reactor's broadcast (None = follow config.mempool.broadcast)
    mempool_broadcast: bool | None = None
    # False disables the signTxRoutine (pregenerated-vote replay) without
    # removing the node's validator identity
    sign_votes: bool = True
    # ed25519 node key seed: authenticated secret connections on TCP links,
    # and the PEX reactor with an in-memory address book when config.p2p.pex
    node_key_seed: bytes | None = None
    # epoch.EpochConfig: committee mode when committee_size > 0 (length 0
    # is a static committee); None = every validator signs
    epoch_config: object = None
    # catch-up sync: the server half (range serving and STATUS adverts) and
    # the client (lag detection, fetch, verify, apply) on the sync channel.
    # False = neither
    sync: bool = True
    # sync.SyncConfig override (None = defaults)
    sync_config: object = None


class Node:
    def __init__(
        self,
        node_id: str,
        chain_id: str,
        val_set: ValidatorSet,
        app: Application,
        priv_val=None,
        node_config: NodeConfig | None = None,
        tx_store_db=None,
        verifier=None,
        state_db=None,
    ):
        nc = node_config or NodeConfig()
        self.node_id = node_id
        self.chain_id = chain_id
        self.config = nc.config
        self.priv_val = priv_val
        self._state_mtx = threading.Lock()
        self._last_block_height = 0
        self._val_set = val_set
        # per-height validator records (empty until the sync client pins
        # the sets it proves)
        self.state_store = StateStore(state_db if state_db is not None else MemDB())

        # -- committee sampling (committee/): the tx-vote committee of each
        # vote height, derived from (chain_id, epoch) on every node; full-set
        # mode leaves all of this None --
        self.committee_schedule = None
        self._committee = None
        if nc.epoch_config is not None and getattr(nc.epoch_config, "committee_size", 0) > 0:
            from ..committee import CommitteeSchedule

            self.committee_schedule = CommitteeSchedule(chain_id, nc.epoch_config)
            self._committee = self.committee_schedule.for_vote_height(
                self._last_block_height, self._val_set
            )

        self.app = app
        self.proxy_app = AppConns(app)
        self.event_bus = EventBus()

        # -- pools (node/node.go:627-633) --
        self.mempool = Mempool(self.config.mempool, proxy_app_conn=self.proxy_app.mempool)
        self.commitpool = Mempool(self.config.mempool)  # fast-committed txs for blocks
        self.tx_vote_pool = TxVotePool(self.config.mempool)

        # -- store + executor + engine (node/node.go:645-668) --
        self.tx_store = TxStore(tx_store_db if tx_store_db is not None else MemDB())
        self.tx_executor = TxExecutor(self.proxy_app.consensus, self.mempool, self.event_bus)
        engine_cfg = dataclasses.replace(
            self.config.engine, use_device=True,
            device=self.config.engine.device if nc.device is None else nc.device)
        # committee mode: the engine's tally set is the committee
        engine_vals = self._committee if self._committee is not None else self._val_set
        self.txflow = TxFlow(
            chain_id,
            self._last_block_height,
            engine_vals,
            self.tx_vote_pool,
            self.mempool,
            self.commitpool,
            self.tx_executor,
            self.tx_store,
            config=engine_cfg,
            verifier=verifier,
        )

        # -- switch + reactors (node/node.go:688-722) --
        self.switch = Switch(node_id, node_seed=nc.node_key_seed)
        broadcast = self.config.mempool.broadcast
        self.mempool_reactor = MempoolReactor(
            self.mempool,
            broadcast=broadcast if nc.mempool_broadcast is None else nc.mempool_broadcast,
            batch_size=GOSSIP_BATCH,
        )
        self.txvote_reactor = TxVoteReactor(
            self.state_view,
            self.mempool,
            self.tx_vote_pool,
            priv_val=priv_val if nc.sign_votes else None,
            broadcast=broadcast,
            batch_size=GOSSIP_BATCH,
        )
        self.switch.add_reactor("mempool", self.mempool_reactor)
        self.switch.add_reactor("txvote", self.txvote_reactor)

        # -- PEX (p2p/pex.py, channel 0x00): on for keyed TCP assemblies;
        # in-memory pipes have no dialable address --
        self.address_book = None
        self.pex = None
        if self.config.p2p.pex and nc.node_key_seed is not None:
            from ..p2p.pex import AddressBook, PEXReactor

            self.address_book = AddressBook()
            self.pex = PEXReactor(self.address_book)
            self.switch.add_reactor("pex", self.pex)

        # -- catch-up sync (sync/): the server half serves committed ranges
        # read-only; the client runs on its own thread --
        self.sync_reactor = None
        self.sync_manager = None
        if nc.sync:
            from ..sync import SyncManager, SyncReactor

            self.sync_reactor = SyncReactor(
                self.tx_store,
                state_store=self.state_store,
                current_vals=lambda: self.state_view().validators,
                config=nc.sync_config,
            )
            self.sync_manager = SyncManager(
                chain_id,
                self.tx_store,
                self.txflow,
                self.switch,
                state_store=self.state_store,
                config=nc.sync_config,
                committee=self.committee_schedule,
                device=engine_cfg.device,
                fe_radix=engine_cfg.fe_radix,
            )
            self.sync_reactor.manager = self.sync_manager
            self.switch.add_reactor("sync", self.sync_reactor)
        self._started = False

    # -- state view read by the reactors (reference reads state.State) --

    def state_view(self) -> StateView:
        with self._state_mtx:
            return StateView(self.chain_id, self._last_block_height, self._val_set,
                             committee=self._committee)

    def _engine_val_set(self, height: int, full: ValidatorSet) -> ValidatorSet:
        """The set the engine tallies against at ``height``: the epoch's
        committee in committee mode (kept as the reactors' view too), the
        full set otherwise."""
        if self.committee_schedule is None:
            return full
        committee = self.committee_schedule.for_vote_height(height, full)
        with self._state_mtx:
            self._committee = committee
        return committee

    def update_state(self, height: int, val_set: ValidatorSet | None = None) -> None:
        """Block boundary: advance the height, maybe rotate the set."""
        with self._state_mtx:
            self._last_block_height = height
            if val_set is not None:
                self._val_set = val_set
            full = self._val_set
        self.txflow.update_state(height, self._engine_val_set(height, full))
        self.txvote_reactor.broadcast_height(height)
        self.mempool_reactor.broadcast_height(height)

    # -- lifecycle (reference OnStart :768-826 / OnStop :829-874) --

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.switch.start()
        self.txflow.start()
        if self.sync_manager is not None:
            self.sync_manager.start()

    def stop(self) -> None:
        """Stop the sync client, the engine, then the switch (peers,
        reactors, their threads); raises the engine's first error, after
        the switch is down."""
        if not self._started:
            return
        self._started = False
        if self.sync_manager is not None:
            self.sync_manager.stop()
        try:
            self.txflow.stop()
        finally:
            self.switch.stop()

    # -- client surface --

    def broadcast_tx(self, tx: bytes) -> None:
        """Client tx ingress: local CheckTx; gossip and votes follow."""
        self.mempool.check_tx(tx)

    def is_committed(self, tx: bytes) -> bool:
        return self.txflow.is_tx_committed(hashlib.sha256(tx).hexdigest().upper())
