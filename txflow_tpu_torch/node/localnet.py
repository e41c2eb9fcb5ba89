"""LocalNet: an N-validator in-process network over in-memory pipes (the
counterpart of ``txflow_tpu/node/localnet.py``, fast path only).

The reference's in-process testnets (p2p.MakeConnectedSwitches + real
reactors, txvotepool/reactor_test.go:47-66) and the rig of BASELINE
configs 1-2 ("4-validator in-proc net, kvstore app, pregenerated TxVotes
replayed through txvotepool"). Every node runs the fast path: mempool
gossip -> signTxRoutine -> vote gossip -> batched verify + tally ->
per-tx commit against its own app instance. A shared ``verifier`` (one
``DeviceVoteVerifier``, with ``shared_cache`` one verify per distinct vote)
serves every engine on one card; without one each node builds its own on
``device`` ("cuda" unless the caller says "cpu"; without CUDA it raises).

Left out: consensus (``enable_consensus``), WAL directories, RPC,
durable members and their crash drills, chaos, netem, health, the
byzantine ledger, epochs and sync -- the layers the port lacks. No
parameter stands for them.
"""

from __future__ import annotations

import hashlib
import time

from ..abci.kvstore import KVStoreApplication
from ..p2p import connect_switches
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
        hosted = priv_vals if n_nodes is None else priv_vals[:n_nodes]
        self.nodes: list[Node] = [
            Node(
                node_id=f"node{i}",
                chain_id=chain_id,
                val_set=self.val_set,
                app=KVStoreApplication(),
                priv_val=pv,
                # one shared verifier: one set of device tables for all
                verifier=verifier,
                node_config=NodeConfig(
                    config=cfg,
                    device=device,
                    mempool_broadcast=mempool_broadcast,
                    # sign=False: votes are injected from outside (the
                    # pregenerated-vote replay of BASELINE configs 1-2)
                    sign_votes=sign,
                ),
            )
            for i, pv in enumerate(hosted)
        ]

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
        verifier); raises the first engine error after all are down."""
        first = None
        for node in self.nodes:
            try:
                node.stop()
            except BaseException as exc:  # stop the rest, then raise
                if first is None:
                    first = exc
        if first is not None:
            raise first

    # -- client helpers --

    def broadcast_tx(self, tx: bytes, node_index: int = 0) -> None:
        self.nodes[node_index].broadcast_tx(tx)

    def wait_all_committed(self, txs: list[bytes], timeout: float = 30.0,
                           poll: float = 0.01) -> bool:
        """Block until every node has committed every tx and applied it
        (its committer drained), or the timeout passes."""
        hashes = [hashlib.sha256(tx).hexdigest().upper() for tx in txs]
        deadline = time.monotonic() + timeout
        for node in self.nodes:
            for h in hashes:
                while not node.tx_store.has_tx(h):
                    if node.txflow.error is not None:
                        raise node.txflow.error
                    if time.monotonic() > deadline:
                        return False
                    time.sleep(poll)
        for node in self.nodes:
            while not node.txflow.commits_drained():
                if time.monotonic() > deadline:
                    return False
                time.sleep(poll)
        return True

    def committed_votes_total(self) -> int:
        """Sum over nodes of the votes in committed certificates."""
        return sum(n.txflow.committed_votes for n in self.nodes)
