"""Node: the composition root of the fast path (reference node/node.go:
555-826), the counterpart of ``txflow_tpu/node/node.py``.

Assembles, in reference order: ABCI proxy connections -> event bus ->
pools (mempool + commitpool + txvotepool) -> TxExecutor + TxFlow -> the
p2p switch with the mempool and txvote reactors (every reactor registers
its channel, as the JAX node fixes the reference's wiring bug) and, when
the node has a key, the PEX address book.

The engine runs on ``cuda`` unless ``NodeConfig.device`` (or the config's
engine section) says ``cpu``; without CUDA the node raises. It builds a
``DeviceVoteVerifier`` directly, or serves from the one it is given (a
``LocalNet`` shares one among its nodes); nothing falls back to the host
verifier, and ``NodeConfig`` has no switch for one.

Left out, each with the layer it belongs to: the block path (the
handshake replay ``txflow_tpu/node/node.py:613-640``, ``BlockStore``,
``BlockExecutor``, ``EvidencePool``, ``ConsensusState``), the health
monitor, the byzantine ledger, catch-up sync, epochs and committees,
admission (so no lane classifier is wired), RPC and gRPC, the tracer,
chaos and netem, and the pools' WALs. ``NodeConfig`` has no knob for
them.
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
    ):
        nc = node_config or NodeConfig()
        self.node_id = node_id
        self.chain_id = chain_id
        self.config = nc.config
        self.priv_val = priv_val
        self._state_mtx = threading.Lock()
        self._last_block_height = 0
        self._val_set = val_set

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
        self.txflow = TxFlow(
            chain_id,
            self._last_block_height,
            val_set,
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
        self._started = False

    # -- state view read by the reactors (reference reads state.State) --

    def state_view(self) -> StateView:
        with self._state_mtx:
            return StateView(self.chain_id, self._last_block_height, self._val_set)

    def update_state(self, height: int, val_set: ValidatorSet | None = None) -> None:
        """Block boundary: advance the height, maybe rotate the set."""
        with self._state_mtx:
            self._last_block_height = height
            if val_set is not None:
                self._val_set = val_set
            full = self._val_set
        self.txflow.update_state(height, full)
        self.txvote_reactor.broadcast_height(height)
        self.mempool_reactor.broadcast_height(height)

    # -- lifecycle (reference OnStart :768-826 / OnStop :829-874) --

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.switch.start()
        self.txflow.start()

    def stop(self) -> None:
        """Stop the engine, then the switch (peers, reactors, their
        threads); raises the engine's first error, after the switch is
        down."""
        if not self._started:
            return
        self._started = False
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
