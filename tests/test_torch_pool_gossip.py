"""PyTorch port, what gossip reads of the pools, against the JAX package on
the same seeded ingests (tolerance 0): the vote pool's 4-tuple walks
(wire segments included), sender sets, ``add_sender`` codes, origins and
``in_cache``; the mempool's 5-tuple walks, its priority lane's own log,
``has_sender`` and ``fast_path_of``; the reactors' ``LRUMap``; and the
config sections a node reads."""

import dataclasses
import hashlib

import numpy as np

import txflow_tpu.abci as jabci
import txflow_tpu.pool as jpool
import txflow_tpu.types as jtypes
import txflow_tpu.utils.cache as jcache
import txflow_tpu.utils.config as jconfig

import txflow_tpu_torch.abci as pabci
import txflow_tpu_torch.pool as ppool
import txflow_tpu_torch.types as ptypes
import txflow_tpu_torch.utils.cache as pcache
import txflow_tpu_torch.utils.config as pconfig
from txflow_tpu_torch.utils.events import EventBus

PKGS = {"jax": (jtypes, jpool, jabci, jconfig), "port": (ptypes, ppool, pabci, pconfig)}
CURSORS = (0, 1, 4, 9, 17, 10**9)


def wire_votes(n_txs=6, n_vals=3, seed=6):
    rng = np.random.default_rng(seed)
    pvs = [jtypes.MockPV(rng.bytes(32)) for _ in range(n_vals)]
    out = []
    for t in range(n_txs):
        key = hashlib.sha256(b"g%d" % t).digest()
        for pv in pvs:
            v = jtypes.TxVote(1 + t % 2, key.hex().upper(), key, 1_700_000_000 + t,
                              pv.get_address())
            pv.sign_tx_vote("gossip", v)
            out.append(jtypes.encode_tx_vote(v))
    return out


def _vote_pool_script(pkg, wires):
    types, pool, _, config = PKGS[pkg]
    vp = pool.TxVotePool(config.MempoolConfig(size=14, cache_size=100))
    info = pool.TxInfo
    out = []
    dec = lambda ws: [types.decode_tx_vote(w) for w in ws]  # noqa: E731
    vp.check_tx(dec(wires[:1])[0])  # local ingest: origin 0
    errs = vp.check_tx_many(dec(wires[1:8]), info(sender_id=3))
    out.append([type(e).__name__ if e else None for e in errs])
    errs = vp.check_tx_many(dec(wires[4:12]), info(sender_id=5))  # some duplicates
    out.append([type(e).__name__ if e else None for e in errs])
    errs = vp.check_tx_many(dec(wires[12:]), info(sender_id=7))  # fills: size 14
    out.append([type(e).__name__ if e else None for e in errs])
    vp.update(2, dec(wires[2:4]))  # two commit
    vp.remove([types.decode_tx_vote(wires[5]).vote_key()])
    for c in CURSORS:
        for limit in (1, 3, 100):
            items, pos = vp.entries_from(c, limit)
            out.append(([(k, types.encode_tx_vote(v), h, seg) for k, v, h, seg in items], pos))
    keys = [k for k, *_ in vp.entries_from(0, 100)[0]]
    gone = [types.decode_tx_vote(w).vote_key() for w in wires[2:4]]
    out.append([vp.has_sender_many(keys + gone, sid) for sid in (0, 3, 5, 7, 9)])
    out.append(vp.origins_of(keys + gone))
    out.append([vp.in_cache(k) for k in keys + gone + [b"\x01" * 32]])
    out.append([vp.add_sender(k, sid) for k in keys[:4] + gone for sid in (3, 9)])
    out.append([vp.has_sender(k, 9) for k in keys])
    return out


def test_vote_pool_gossip_view_matches_jax():
    wires = wire_votes()
    got = {pkg: _vote_pool_script(pkg, wires) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"][2].count("ErrMempoolIsFull") > 0 and got["port"][1].count("ErrTxInCache")


def _mempool_script(pkg):
    _, pool, abci, config = PKGS[pkg]
    conns = abci.AppConns(abci.KVStoreApplication())
    mp = pool.Mempool(config.MempoolConfig(size=30, cache_size=100), proxy_app_conn=conns.mempool)
    mp.lane_of = lambda tx: 0 if tx.startswith(b"fee") else 1
    rng = np.random.default_rng(12)
    txs = []
    for i in range(24):
        kind = int(rng.integers(4))
        txs.append(b"fee=%d;k%d=v" % (i, i) if kind == 0 else
                   b"val:" + b"ab" * 32 + b"!%d" % i if kind == 1 else b"k%d=v" % i)
    out = []
    info = pool.TxInfo
    for i, tx in enumerate(txs[:12]):
        mp.check_tx(tx, info(sender_id=i % 3))
    errs = mp.check_tx_many(txs[8:] + [b"val:zz!1"], info(sender_id=4))
    out.append([type(e).__name__ if e else None for e in errs])
    mp.lock()
    try:
        mp.update(1, txs[3:6])
    finally:
        mp.unlock()
    for c in CURSORS:
        for limit in (1, 4, 100):
            out.append(mp.entries_from(c, limit))
            out.append(mp.priority_entries_from(c, limit))
    keys = [hashlib.sha256(tx).digest() for tx in txs] + [b"\x02" * 32]
    out.append([[mp.has_sender(k, s) for k in keys] for s in (0, 1, 2, 4, 9)])
    out.append([mp.fast_path_of(k) for k in keys])
    out.append((mp.size(), mp.lane_size(0), mp.lane_size(1), mp.seq()))
    return out


def test_mempool_gossip_view_matches_jax():
    got = {pkg: _mempool_script(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert False in got["port"][-2]  # a block-only tx was pooled


def test_lru_map_matches_jax():
    rng = np.random.default_rng(1)
    maps = {"jax": jcache.LRUMap(5), "port": pcache.LRUMap(5)}
    ops = [(int(rng.integers(3)), bytes([int(rng.integers(9))])) for _ in range(200)]
    trace = {k: [] for k in maps}
    for name, m in maps.items():
        for op, key in ops:
            if op == 0:
                m.put(key, key * 2)
            elif op == 1:
                trace[name].append(m.get(key))
            else:
                trace[name].append(m.peek(key))
        trace[name].append(list(m._map.items()))
    assert trace["port"] == trace["jax"]


def test_node_config_sections_and_event_callbacks():
    for cls in ("P2PConfig",):
        assert dataclasses.asdict(getattr(pconfig, cls)()) == dataclasses.asdict(getattr(jconfig, cls)())
    pm, jm = pconfig.MempoolConfig(), jconfig.MempoolConfig()
    for f in ("size", "max_txs_bytes", "cache_size", "max_msg_bytes", "broadcast"):
        assert getattr(pm, f) == getattr(jm, f)
    assert pconfig.test_config().mempool.cache_size == jconfig.test_config().mempool.cache_size
    bus, seen = EventBus(), []
    sub = bus.subscribe("Tx")
    bus.subscribe_callback("Tx", lambda ev: seen.append(ev.data))
    bus.publish("Tx", 1)
    bus.publish("Other", 2)
    assert seen == [1] and sub.get(timeout=1.0).data == 1
