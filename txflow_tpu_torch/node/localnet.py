"""LocalNet: an N-validator in-process network over in-memory pipes (the
counterpart of ``txflow_tpu/node/localnet.py``, fast path only).

The reference's in-process testnets (p2p.MakeConnectedSwitches + real
reactors, txvotepool/reactor_test.go:47-66) and the rig of BASELINE
configs 1-2 ("4-validator in-proc net, kvstore app, pregenerated TxVotes
replayed through txvotepool"). Every node runs the fast path: mempool
gossip -> signTxRoutine -> vote gossip -> batched verify + tally ->
per-tx commit against its own app instance, and catch-up sync (on unless
``sync=False``). A shared ``verifier`` (one ``DeviceVoteVerifier``, with
``shared_cache`` one verify per distinct vote) serves every engine on one
card; without one each node builds its own on ``device`` ("cuda" unless
the caller says "cpu"; without CUDA it raises). ``epoch_config`` with a
``committee_size`` runs every node in committee mode.

Durable members (``make_durable``) keep their tx and state stores in
``FileDB`` files under a root of their own, so they can be crashed,
wiped and revived: a revived node rebuilds over its stores and rejoins the
full mesh over fresh pipes, and catch-up sync brings back what it lacks.
Only a wiped node can be revived: a node revived over its old stores
would need the JAX package's handshake replay of the commit log into its
fresh app (``txflow_tpu/consensus/replay.py:185-212``), which belongs to
the block path the port does not carry yet, so ``revive_node`` raises for
it rather than let the app diverge from the store.

Left out: consensus (``enable_consensus``), the block store, WAL
directories, RPC, chaos, netem, health and the byzantine ledger -- the
layers the port lacks. No parameter stands for them.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time

from ..abci.kvstore import KVStoreApplication
from ..p2p import connect_switches
from ..store.db import FileDB
from ..types.priv_validator import MockPV
from ..types.validator import Validator, ValidatorSet
from ..utils.config import Config, test_config
from .node import Node, NodeConfig


class LocalNet:
    def __init__(
        self,
        n_validators: int = 4,
        chain_id: str = "txflow-localnet",
        config: Config | None = None,
        priv_vals: list | None = None,
        sign: bool = True,
        mempool_broadcast: bool | None = None,
        verifier=None,
        n_nodes: int | None = None,
        voting_powers: list[int] | None = None,
        device: str | None = None,
        epoch_config=None,  # epoch.EpochConfig: committee mode (committee_size > 0)
        sync: bool = True,  # catch-up sync channel + client
        sync_config=None,  # sync.SyncConfig override
    ):
        """n_nodes: host only the first n_nodes validators as nodes (the
        rest's votes arrive pregenerated, like votes from remote peers);
        quorum still needs 2/3 of the whole set's stake. Every validator
        has power 10 unless voting_powers says otherwise; every node runs a
        kvstore app."""
        self.chain_id = chain_id
        if priv_vals is None:
            priv_vals = [
                MockPV(hashlib.sha256(b"localnet-val%d" % i).digest())
                for i in range(n_validators)
            ]
        self.priv_vals = priv_vals
        if voting_powers is not None and len(voting_powers) != len(priv_vals):
            raise ValueError(
                f"voting_powers must have {len(priv_vals)} entries, "
                f"got {len(voting_powers)}"
            )
        powers = voting_powers or [10] * len(priv_vals)
        self.val_set = ValidatorSet(
            [Validator.from_pub_key(pv.get_pub_key(), p) for pv, p in zip(priv_vals, powers)]
        )
        if n_nodes is not None and not 1 <= n_nodes <= len(priv_vals):
            raise ValueError(f"n_nodes must be in [1, {len(priv_vals)}], got {n_nodes}")
        cfg = config or test_config()
        self.verifier = verifier
        # rebuild inputs, kept so durable members can be crashed and
        # revived over their stores
        self._cfg = cfg
        self._device = device
        self._mempool_broadcast = mempool_broadcast
        self._sign = sign
        self._epoch_config = epoch_config
        self._sync = sync
        self._sync_config = sync_config
        self._durable_roots: dict[int, str] = {}
        self._down: set[int] = set()
        self._wiped: set[int] = set()
        hosted = priv_vals if n_nodes is None else priv_vals[:n_nodes]
        self.nodes: list[Node] = [self._build_node(i) for i in range(len(hosted))]

    def _build_node(self, i: int) -> Node:
        root = self._durable_roots.get(i)
        dbs = {}
        if root is not None:
            dbs = {
                "tx_store_db": FileDB(f"{root}/txstore.db"),
                "state_db": FileDB(f"{root}/state.db"),
            }
        return Node(
            node_id=f"node{i}",
            chain_id=self.chain_id,
            val_set=self.val_set,
            app=KVStoreApplication(),
            priv_val=self.priv_vals[i],
            # one shared verifier: one set of device tables for all
            verifier=self.verifier,
            node_config=NodeConfig(
                config=self._cfg,
                device=self._device,
                mempool_broadcast=self._mempool_broadcast,
                # sign=False: votes are injected from outside (the
                # pregenerated-vote replay of BASELINE configs 1-2)
                sign_votes=self._sign,
                epoch_config=self._epoch_config,
                sync=self._sync,
                sync_config=self._sync_config,
            ),
            **dbs,
        )

    def start(self) -> None:
        """Start every node, then wire the full mesh (reference
        MakeConnectedSwitches connects all pairs)."""
        for node in self.nodes:
            node.start()
        for i in range(len(self.nodes)):
            for j in range(i + 1, len(self.nodes)):
                connect_switches(self.nodes[i].switch, self.nodes[j].switch)

    def stop(self) -> None:
        """Stop every node (the last engine to stop closes a shared
        verifier) and close the durable members' stores; raises the first
        engine error after all are down."""
        first = None
        for i, node in enumerate(self.nodes):
            try:
                node.stop()
            except BaseException as exc:  # stop the rest, then raise
                if first is None:
                    first = exc
            if i in self._durable_roots:
                _close_stores(node)
        if first is not None:
            raise first

    # -- durable members: crash, wipe and revive drills --

    def make_durable(self, i: int, root: str) -> None:
        """Rebuild node i (before start) over FileDB tx and state stores
        under ``root``, so it can be crashed, wiped and revived."""
        if self.nodes[i]._started:
            raise RuntimeError("make_durable must run before start()")
        self._durable_roots[i] = root
        self._unbind(self.nodes[i])
        self.nodes[i] = self._build_node(i)

    def crash_node(self, i: int) -> Node:
        """Stop node i in place (its peers see the links die); it keeps
        only what its stores persisted. Returns the stopped node."""
        node = self.nodes[i]
        self._down.add(i)
        try:
            node.stop()
        finally:
            if i in self._durable_roots:
                _close_stores(node)
        return node

    def wipe_node(self, i: int) -> None:
        """Delete node i's durable stores while it is down: revive_node then
        rebuilds it over empty stores, a freshly joined node that must
        recover the committed set from its peers by catch-up sync."""
        if i not in self._down:
            raise RuntimeError(f"node {i} must be crashed before wiping")
        root = self._durable_roots.get(i)
        if root is None:
            raise RuntimeError(f"node {i} has no durable root to wipe")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root, exist_ok=True)
        self._wiped.add(i)

    def revive_node(self, i: int) -> Node:
        """Rebuild a crashed and wiped node i over its (empty) stores, start
        it, and connect it to every live node over fresh pipes, in index
        order. A node that was not wiped raises: its fresh app would need
        the block path's replay of the stored commit log."""
        if i not in self._down:
            raise RuntimeError(f"node {i} is not down")
        if i not in self._wiped:
            raise RuntimeError(
                f"node {i} was not wiped: reviving it over its stores needs the "
                "commit-log replay into a fresh app, which the port does not carry"
            )
        self._unbind(self.nodes[i])
        node = self._build_node(i)
        self.nodes[i] = node
        node.start()
        for j, other in enumerate(self.nodes):
            if j != i and j not in self._down:
                connect_switches(node.switch, other.switch)
        self._down.discard(i)
        self._wiped.discard(i)
        return node

    def _unbind(self, node: Node) -> None:
        """A replaced node's engine no longer counts among the shared
        verifier's engines (``DeviceVoteVerifier.bind``)."""
        if self.verifier is not None and node.txflow.verifier is self.verifier:
            self.verifier.bind(-1)

    # -- client helpers --

    def broadcast_tx(self, tx: bytes, node_index: int = 0) -> None:
        self.nodes[node_index].broadcast_tx(tx)

    def live_nodes(self) -> list[Node]:
        """The nodes that are not crashed."""
        return [n for i, n in enumerate(self.nodes) if i not in self._down]

    def wait_all_committed(self, txs: list[bytes], timeout: float = 30.0,
                           poll: float = 0.01) -> bool:
        """Block until every live node has committed every tx and applied
        it (its committer drained), or the timeout passes."""
        hashes = [hashlib.sha256(tx).hexdigest().upper() for tx in txs]
        deadline = time.monotonic() + timeout
        for node in self.live_nodes():
            for h in hashes:
                while not node.tx_store.has_tx(h):
                    if node.txflow.error is not None:
                        raise node.txflow.error
                    if time.monotonic() > deadline:
                        return False
                    time.sleep(poll)
        for node in self.live_nodes():
            while not node.txflow.commits_drained():
                if time.monotonic() > deadline:
                    return False
                time.sleep(poll)
        return True

    def committed_votes_total(self) -> int:
        """Sum over nodes of the votes in committed certificates."""
        return sum(n.txflow.committed_votes for n in self.nodes)


def _close_stores(node: Node) -> None:
    """Close a stopped node's store files (a revive reopens them)."""
    node.tx_store.db.close()
    node.state_store.db.close()
