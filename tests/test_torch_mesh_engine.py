"""PyTorch port, the mesh-sharded serving path end to end: the port's
``TxFlow.step()`` with ``EngineConfig(mesh_devices=4, device="cpu")``
(a 4-entry CPU mesh: the sharded step's plain versions) against the JAX
package's engine with ``mesh_devices=4`` over its 8-device CPU mesh, and
against the port's one-device engine, on the shuffled adversarial stream
of tests/test_torch_engine.py (the pattern of
tests/test_mesh_engine.py:115). The port's mesh engine drains 28 votes a
step (max_batch 30 rounded down to a shard multiple) where the JAX engine
drains 30: certificate bytes, app digest (commit order), app state,
commit-order log and uncommitted stake must all be identical anyway."""

import hashlib

from test_torch_engine import JAX_PKG, PORT_PKG, _port_vote, _stream, make_engine
from txflow_tpu_torch.ops import _lib

MAX_BATCH = 30


def _fill(flow_mem_pool, txs, stream, conv):
    _flow, mem, pool = flow_mem_pool
    for tx in txs:
        mem.check_tx(tx)
    for v in stream:
        try:
            pool.check_tx(conv(v))
        except Exception:
            pass


def test_port_mesh_engine_matches_jax_mesh_engine_and_one_device():
    txs, stream, vals_j, vals_p = _stream()
    flow_j, mem_j, pool_j, store_j, app_j = make_engine(
        JAX_PKG, vals_j, max_batch=MAX_BATCH, mesh_devices=4
    )
    flow_m, mem_m, pool_m, store_m, app_m = make_engine(
        PORT_PKG, vals_p, max_batch=MAX_BATCH, mesh_devices=4, device="cpu"
    )
    flow_1, mem_1, pool_1, store_1, app_1 = make_engine(
        PORT_PKG, vals_p, max_batch=MAX_BATCH, device="cpu"
    )
    assert flow_j._verifier_shards() == 4  # the JAX engine did build its mesh
    assert flow_m._verifier_shards() == 4 and flow_m._drain_cap == 28
    assert flow_1._verifier_shards() == 1
    _fill((flow_j, mem_j, pool_j), txs, stream, lambda v: v.copy())
    _fill((flow_m, mem_m, pool_m), txs, stream, _port_vote)
    _fill((flow_1, mem_1, pool_1), txs, stream, _port_vote)
    done = {}  # votes each step processed
    for name, flow in (("jax", flow_j), ("mesh", flow_m), ("one", flow_1)):
        _lib.reset_launches()
        done[name] = []
        while n := flow.step():
            done[name].append(n)
        if name != "jax":
            assert sum(_lib.launches.values()) == 0  # CPU tensors: plain versions
    assert done["jax"][0] == done["one"][0] == MAX_BATCH and done["mesh"][0] == 28

    assert app_m.tx_count == app_1.tx_count == app_j.tx_count > 0
    assert app_m.state == app_1.state == app_j.state
    assert app_m.digest == app_1.digest == app_j.digest  # commit order
    order = store_j.committed_hashes_in_order()
    assert store_m.committed_hashes_in_order() == store_1.committed_hashes_in_order() == order
    for tx in txs:
        key = b"H:" + hashlib.sha256(tx).hexdigest().upper().encode()
        assert store_m.db.get(key) == store_1.db.get(key) == store_j.db.get(key)  # certificate bytes
    assert set(flow_m.vote_sets) == set(flow_1.vote_sets) == set(flow_j.vote_sets)
    for h, vs in flow_j.vote_sets.items():
        assert flow_m.vote_sets[h].stake() == flow_1.vote_sets[h].stake() == vs.stake()
    assert len(flow_j.vote_sets) > 0  # some stake stays uncommitted
    assert pool_m.size() == pool_1.size() == pool_j.size()
