"""PyTorch port, the JAX engine's default served path: lane-split drains,
shape-stable coalescing, speculative commit and adaptive depth in
txflow_tpu_torch/engine/txflow.py, against the JAX package's engine
(txflow_tpu/engine/txflow.py) on the same seeded votes, pools and lane
hook (tolerance 0: keys, certificate bytes, app state, stakes):

- serial ``step(limit, lane)`` over "prio", "bulk" and the merged drain,
  against the JAX engine stepping the same sequence
  (tests/test_latency_lanes.py:406): the keys each step drains, its
  counts, certificates, commit order, app state and residual stake;
- the threaded lane-split, speculative, coalescing engine with a
  mid-stream restage against the JAX scalar golden path
  (tests/test_latency_lanes.py:92, seeds 7 and 31): certificates,
  committed set, app state and residual stake (priority txs jump the
  queue, so the commit order is not compared);
- a CPU mesh of 4 whose coalescer targets are shard multiples;
- the depth controller's wiring (tests/test_coalesce.py:141), the JAX
  default configuration through ``start()``, and a lane failure raising
  through ``stop()``."""

import hashlib
import time

import pytest

import txflow_tpu.abci as jabci
import txflow_tpu.engine as jengine
import txflow_tpu.pool as jpool
import txflow_tpu.store as jstore
from txflow_tpu.engine.txflow import _BatchCoalescer as JCoalescer
from txflow_tpu.types import Validator as JValidator
from txflow_tpu.types import ValidatorSet as JValidatorSet
from txflow_tpu.utils.config import EngineConfig as JEngineConfig
from txflow_tpu.utils.config import MempoolConfig as JMempoolConfig
from txflow_tpu.verifier import ScalarVoteVerifier as JScalarVoteVerifier

from test_torch_pipeline import (  # noqa: F401  (one_torch_thread: autouse fixture)
    CHAIN_ID, HEIGHT, jax_golden, make_port_engine, make_pvs, mixed_stream, one_torch_thread,
    port_vote, sign_vote,
)
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.engine.txflow import _BatchCoalescer
from txflow_tpu_torch.pool import LANE_BULK, LANE_PRIORITY
from txflow_tpu_torch.utils.config import EngineConfig
from txflow_tpu_torch.verifier import DEFAULT_BUCKETS, DeviceVoteVerifier, ScalarVoteVerifier


def _key(tx: bytes) -> bytes:
    return hashlib.sha256(tx).digest()


def _hash(tx: bytes) -> str:
    return hashlib.sha256(tx).hexdigest().upper()


def _hook(prio_keys):
    return lambda v: LANE_PRIORITY if v.tx_key in prio_keys else LANE_BULK


def jax_engine(vals_j, verifier=None, **cfg):
    conns = jabci.AppConns(jabci.KVStoreApplication())
    mempool = jpool.Mempool(JMempoolConfig(cache_size=4000), conns.mempool)
    votepool = jpool.TxVotePool(JMempoolConfig(cache_size=20000))
    store = jstore.TxStore(jstore.MemDB())
    flow = jengine.TxFlow(
        CHAIN_ID, HEIGHT, vals_j, votepool, mempool,
        jpool.Mempool(JMempoolConfig(cache_size=4000)),
        jengine.TxExecutor(conns.consensus, mempool), store,
        config=JEngineConfig(use_device=False, **cfg), verifier=verifier,
    )
    return flow, mempool, votepool, store, conns.app


def _record_drains(flow):
    """Wrap the engine's submit to record each dispatched batch's lane and
    pool keys."""
    seen = []
    submit = flow._submit_prep

    def wrapped(prep):
        seen.append((prep.lane, list(prep.keys)))
        return submit(prep)

    flow._submit_prep = wrapped
    return seen


def _cert(store, tx):
    return store.db.get(b"H:" + _hash(tx).encode())


def wait_quiescent_lanes(flow, votepool, timeout=60.0):
    """Lane-aware quiescence (tests/test_latency_lanes.py:68): both drain
    cursors caught up, both retry lists empty, no batch drained and not
    routed, every decided commit applied; three polls in a row."""
    deadline = time.monotonic() + timeout
    stable = 0
    while time.monotonic() < deadline:
        assert flow.error is None, flow.error
        idle = (flow._drain_cursor >= votepool.seq()
                and flow._prio_drain_cursor >= votepool.prio_seq()
                and not flow._retry and not flow._retry_prio
                and flow.pipeline_stats()["in_flight"] == 0 and flow.commits_drained())
        stable = stable + 1 if idle else 0
        if stable >= 3:
            return True
        time.sleep(0.02)
    return False


# ---- serial lane steps against the JAX engine ----

PLAN = [("prio", 5), ("bulk", 8), (None, 6), ("prio", None), ("bulk", 3), (None, None),
        ("bulk", None), ("prio", 2)]


@pytest.mark.parametrize("speculative", [False, True])
@pytest.mark.parametrize("seed", [3, 19])
def test_serial_lane_steps_match_jax(seed, speculative):
    pvs, vals_j, vals_p = make_pvs(7, seed)  # total 70, quorum 47: 5 votes
    txs = [b"sl%d-%d=%d" % (seed, i, i) for i in range(12)]
    prio_keys = {_key(tx) for tx in txs[::3]}
    stream = mixed_stream(pvs, txs, seed)
    # right behind a validator's vote on some txs of both lanes, its
    # re-signed twin: an in-batch repeat that requeues into its lane's
    # retry list
    for tx in txs[::3] + txs[1::5]:
        i = next(i for i, v in enumerate(stream) if v.tx_key == _key(tx)
                 and any(pv.get_address() == v.validator_address for pv in pvs))
        pv = next(pv for pv in pvs if pv.get_address() == stream[i].validator_address)
        stream.insert(i + 1, sign_vote(pv, tx, ts=1700000001_000000000))
    jver = JScalarVoteVerifier(vals_j)
    jver.buckets = (8, 32)  # attached, as tests/test_latency_lanes.py:123 does
    cfg = dict(max_batch=32, max_slots=3, speculative_commit=speculative)
    jflow, jmem, jpool_, jstore_, japp = jax_engine(vals_j, jver, **cfg)
    pflow, pmem, ppool_, pstore_, papp = make_port_engine(
        vals_p, DeviceVoteVerifier(vals_p, device="cpu", buckets=(8, 32)), **cfg)
    jpool_.lane_of_vote = ppool_.lane_of_vote = _hook(prio_keys)
    for tx in txs:
        jmem.check_tx(tx)
        pmem.check_tx(tx)
    for v in stream:
        for pool, vote in ((jpool_, v.copy()), (ppool_, port_vote(v))):
            try:
                pool.check_tx(vote)
            except Exception:
                pass  # a cache dup (zeroed signatures share a vote key)
    assert ppool_.prio_seq() == jpool_.prio_seq() > 0
    # a priority lane, as start() would build it: the bulk estimate then
    # leaves the priority backlog out (tests/test_latency_lanes.py:406)
    jflow._prio_lane = JCoalescer((8,), cap=8, min_batch=1, linger=0.001)
    pflow._prio_lane = _BatchCoalescer((8,), cap=8, min_batch=1, linger=0.001)
    jseen, pseen = _record_drains(jflow), _record_drains(pflow)
    idle = 0
    n_steps = 0
    requeued = {"prio": 0, "bulk": 0}
    while idle < len(PLAN):
        lane, limit = PLAN[n_steps % len(PLAN)]
        n_steps += 1
        got = pflow.step(limit, lane)
        assert got == jflow.step(limit=limit, lane=lane), (n_steps, lane, limit)
        assert pflow.last_step_stats == jflow.last_step_stats
        assert pseen == jseen
        assert (pflow._drain_cursor, pflow._prio_drain_cursor) == (
            jflow._drain_cursor, jflow._prio_drain_cursor)
        assert [k for k, _ in pflow._retry_prio] == [k for k, _ in jflow._retry_prio]
        assert [k for k, _ in pflow._retry] == [k for k, _ in jflow._retry]
        assert (pflow._prio_pending(), pflow._bulk_pending(), pflow._bulk_quantum()) == (
            jflow._prio_pending(), jflow._bulk_pending(), jflow._bulk_quantum())
        requeued["prio"] += bool(pflow._retry_prio)
        requeued["bulk"] += bool(pflow._retry)
        idle = idle + 1 if got == 0 else 0
    assert any(lane == "prio" for lane, _ in pseen) and any(lane == "bulk" for lane, _ in pseen)
    assert requeued["prio"] > 0 and requeued["bulk"] > 0  # both retry lists were used
    assert ppool_.size() == jpool_.size()
    assert papp.tx_count == japp.tx_count > 0
    assert papp.digest == japp.digest and papp.state == japp.state
    for tx in txs:
        assert _cert(pstore_, tx) == _cert(jstore_, tx)
    assert {h: vs.stake() for h, vs in pflow.vote_sets.items()} == {
        h: vs.stake() for h, vs in jflow.vote_sets.items()}
    ps, js = pflow.pipeline_stats(), jflow.pipeline_stats()
    assert ps["lanes"]["prio_batches"] == js["lanes"]["prio_batches"] > 0
    assert ps["lanes"]["prio_votes"] == js["lanes"]["prio_votes"]
    assert ps["spec"]["commits"] == js["spec"]["commits"]
    assert (ps["spec"]["commits"] > 0) == speculative


def test_speculative_reorder_matches_jax():
    """One quorate and one sub-quorum tx interleaved in one batch: the
    quorate tx commits in the speculative first pass on both engines
    (tests/test_latency_lanes.py:190), with the golden certificate."""
    pvs, vals_j, vals_p = make_pvs(4, 2)  # total 40, quorum 27: 3 votes
    tx_a, tx_b = b"spec-a=1", b"spec-b=1"
    votes = [sign_vote(pvs[0], tx_a), sign_vote(pvs[1], tx_b), sign_vote(pvs[1], tx_a),
             sign_vote(pvs[2], tx_a)]
    golden = jax_golden(vals_j, [tx_a, tx_b], votes)
    cfg = dict(min_batch=1, max_batch=8, coalesce=False, speculative_commit=True)
    jflow, jmem, jpool_, jstore_, japp = jax_engine(vals_j, **cfg)
    pflow, pmem, ppool_, pstore_, papp = make_port_engine(
        vals_p, DeviceVoteVerifier(vals_p, device="cpu", buckets=(8,)), **cfg)
    for tx in (tx_a, tx_b):
        jmem.check_tx(tx)
        pmem.check_tx(tx)
    for v in votes:
        jpool_.check_tx(v.copy())
        ppool_.check_tx(port_vote(v))
    jflow.step()
    pflow.step()
    assert papp.tx_count == japp.tx_count == 1
    assert pflow._spec_commits == jflow._spec_commits == 1
    stats = pflow.pipeline_stats()["spec"]
    assert stats["enabled"] and stats["commits"] == 1 and stats["saved_s"] >= 0.0
    assert _cert(pstore_, tx_a) == _cert(jstore_, tx_a) == _cert(golden[1], tx_a)


# ---- the threaded lane-split engine against the JAX golden path ----


def _restaged(pvs):
    """The same membership, powers re-weighted: an in-place restage."""
    powers = [10 + (i % 3) for i in range(len(pvs))]
    vj = JValidatorSet([JValidator.from_pub_key(pv.get_pub_key(), p) for pv, p in zip(pvs, powers)])
    vp = ptypes.ValidatorSet(
        [ptypes.Validator.from_pub_key(pv.get_pub_key(), p) for pv, p in zip(pvs, powers)])
    return vj, vp


def _feed(pool, votes):
    for v in votes:
        try:
            pool.check_tx(port_vote(v))
        except Exception:
            pass  # a cache dup: the golden path saw the vote anyway


def _assert_same_certs_state_stakes(txs, flow_s, store_s, app_s, flow_p, store_p, app_p):
    assert app_p.tx_count == app_s.tx_count > 0
    assert app_p.state == app_s.state
    for tx in txs:
        assert _cert(store_p, tx) == _cert(store_s, tx)
    # the scalar path makes a vote set for a vote that then fails verify
    # (stake 0), the batched path only for verified votes: golden is a
    # superset, and every set holding stake agrees
    assert set(flow_p.vote_sets) <= set(flow_s.vote_sets)
    for h, vs in flow_s.vote_sets.items():
        if vs.stake() > 0:
            assert flow_p.vote_sets[h].stake() == vs.stake()
    for h, vs in flow_p.vote_sets.items():
        assert vs.stake() == flow_s.vote_sets[h].stake()


@pytest.mark.parametrize("seed", [7, 31])
def test_threaded_lane_split_speculative_matches_golden(seed):
    pvs, vals_j, vals_p = make_pvs(7, seed)
    txs = [b"lane%d-%d=%d" % (seed, i, i) for i in range(16)]
    prio_keys = {_key(tx) for tx in txs[::3]}
    stream = mixed_stream(pvs, txs, seed)
    half = len(stream) // 2
    vals2_j, vals2_p = _restaged(pvs)
    # the JAX scalar golden path, one vote at a time, restaged at the half
    flow_s, store_s, app_s = jax_golden(vals_j, txs, stream[:half])
    flow_s.update_state(flow_s.height, vals2_j)
    for v in stream[half:]:
        flow_s.try_add_vote(v.copy())

    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, DeviceVoteVerifier(vals_p, device="cpu", buckets=(8, 32)), max_batch=32,
        min_batch=1, pipeline_depth=3, coalesce=True, coalesce_linger=0.02, lane_split=True,
        priority_linger=0.002, priority_bucket_cap=8, speculative_commit=True)
    votepool.lane_of_vote = _hook(prio_keys)
    seen = _record_drains(flow)
    for tx in txs:
        mempool.check_tx(tx)
    flow.start()
    try:
        _feed(votepool, stream[:half])
        assert wait_quiescent_lanes(flow, votepool), "the first half never drained"
        flow.update_state(flow.height, vals2_p)
        assert flow.last_rotation["restaged"]
        _feed(votepool, stream[half:])
        assert wait_quiescent_lanes(flow, votepool), "the second half never drained"
        stats = flow.pipeline_stats()
    finally:
        flow.stop()
    _assert_same_certs_state_stakes(txs, flow_s, store_s, app_s, flow, store, app)
    assert stats["lanes"]["enabled"] and stats["coalesce"]["enabled"]
    assert stats["lanes"]["prio_batches"] > 0 and stats["lanes"]["prio_votes"] > 0
    assert stats["coalesce"]["targets"] == [8, 32] and stats["lanes"]["prio_targets"] == [8]
    assert stats["spec"]["enabled"] and stats["spec"]["saved_s"] >= 0.0
    # each lane drained only its own votes
    tx_key_of: dict = {}
    for v in stream:  # the pool keeps the first vote of a key (zeroed signatures share one)
        tx_key_of.setdefault(port_vote(v).vote_key(), v.tx_key)
    for lane, keys in seen:
        assert all(lane == ("prio" if tx_key_of[k] in prio_keys else "bulk") for k in keys)


# ---- what start() builds, against the JAX engine's start() ----


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(max_batch=8, wide_buckets=True),
    dict(max_batch=8, min_batch=1, priority_bucket_cap=20, coalesce_linger=0.01),
    dict(coalesce=False, priority_linger=0.003),
    dict(lane_split=False, min_batch=16, max_batch=32),
    dict(coalesce=False, lane_split=False, adaptive_depth=True, pipeline_depth_max=5),
], ids=["defaults", "wide", "small-cap", "no-coalesce", "no-lanes", "neither"])
def test_start_builds_the_jax_lanes(cfg):
    """The drain caps, the bulk coalescer (targets, wide gate, linger) and
    the priority lane that start() builds from the same config and ladder
    (a scalar verifier with (8, 32, 128) attached), and the depth
    controller, in both engines."""
    pvs, vals_j, vals_p = make_pvs(4, 59)
    jver, pver = JScalarVoteVerifier(vals_j), ScalarVoteVerifier(vals_p)
    jver.buckets = pver.buckets = (8, 32, 128)
    cfg = dict(cfg, pipeline_commits=False)
    jflow = jax_engine(vals_j, jver, **cfg)[0]
    pflow = make_port_engine(vals_p, pver, **cfg)[0]
    for flow in (jflow, pflow):
        flow.start()
        flow.stop()
    assert (pflow._drain_cap, pflow._classic_drain_cap) == (jflow._drain_cap,
                                                            jflow._classic_drain_cap)
    for name in ("_coalescer", "_prio_lane"):
        jc, pc = getattr(jflow, name), getattr(pflow, name)
        assert (jc is None) == (pc is None), name
        if pc is not None:
            assert (pc.targets, pc.linger, pc.wide_from) == (jc.targets, jc.linger, jc.wide_from)
    assert (pflow._depth_ctrl is None) == (jflow._depth_ctrl is None)
    if pflow._depth_ctrl is not None:
        assert pflow._depth_ctrl.stats() == jflow._depth_ctrl.stats()
    ps, js = pflow.pipeline_stats(), jflow.pipeline_stats()
    for key in ("enabled", "full_batches", "linger_flushes", "wide_from", "wide_ok"):
        assert ps["coalesce"][key] == js["coalesce"][key], key
    for key in ("enabled", "prio_linger_ms", "bulk_linger_ms"):
        assert ps["lanes"][key] == js["lanes"][key], key
    assert ps["spec"] == js["spec"] and ps["depth"] == js["depth"]


# ---- a CPU mesh: shard-multiple targets ----


def test_mesh_coalescer_targets_are_shard_multiples():
    pvs, vals_j, vals_p = make_pvs(4, 41)
    txs = [b"mesh%d=%d" % (i, i) for i in range(8)]
    prio_keys = {_key(txs[0]), _key(txs[5])}
    stream = mixed_stream(pvs, txs, 41)
    flow_s, store_s, app_s = jax_golden(vals_j, txs, stream)
    cfg = dict(mesh_devices=4, max_batch=256, min_batch=64, coalesce_linger=0.004,
               priority_bucket_cap=6, pipeline_depth=2)
    flow, mempool, votepool, store, app = make_port_engine(vals_p, **cfg)
    assert flow._verifier_shards() == 4
    votepool.lane_of_vote = _hook(prio_keys)
    padded = []
    dispatch = flow.verifier._dispatch

    def recording(batch, slot, *a):
        padded.append(slot.shape[0])
        return dispatch(batch, slot, *a)

    flow.verifier._dispatch = recording
    for tx in txs:
        mempool.check_tx(tx)
    flow.start()
    try:
        _feed(votepool, stream)
        assert wait_quiescent_lanes(flow, votepool)
        stats = flow.pipeline_stats()
    finally:
        flow.stop()
    want_bulk = JCoalescer(DEFAULT_BUCKETS, cap=256, min_batch=64, linger=0.004, multiple=4)
    want_prio = JCoalescer(DEFAULT_BUCKETS, cap=6, min_batch=1, linger=0.001, multiple=4)
    assert stats["coalesce"]["targets"] == want_bulk.targets == [64, 256]
    assert stats["lanes"]["prio_targets"] == want_prio.targets == [8]
    assert padded and all(b % 4 == 0 for b in padded)  # the warm step's included
    assert stats["lanes"]["prio_batches"] > 0
    _assert_same_certs_state_stakes(txs, flow_s, store_s, app_s, flow, store, app)


# ---- the depth controller, the JAX defaults, and no fallback ----


def test_adaptive_depth_engine_wiring():
    """tests/test_coalesce.py:141 on the port: the controller is built by
    start(), reported by pipeline_stats() and read by the fill stage."""
    pvs, _, vals_p = make_pvs(4, 43)
    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, ScalarVoteVerifier(vals_p), coalesce=False, adaptive_depth=True,
        pipeline_depth=2, pipeline_depth_max=6, min_batch=1, max_batch=8)
    txs = [b"ad%d=v" % i for i in range(12)]
    for tx in txs:
        mempool.check_tx(tx)
    flow.start()
    try:
        _feed(votepool, [sign_vote(pv, tx) for tx in txs for pv in pvs[:3]])
        assert wait_quiescent_lanes(flow, votepool)
    finally:
        flow.stop()
    assert app.tx_count == len(txs)
    ctrl = flow._depth_ctrl
    assert ctrl is not None
    assert flow.pipeline_stats()["adaptive_depth"]["depth"] == ctrl.depth == flow._target_depth()
    d0 = ctrl.depth
    grown = ctrl.observe(ctrl._last_busy + 0.1, ctrl._last_active + 1.0,
                         ctrl._last_steps + ctrl.window)
    assert grown == min(d0 + 1, ctrl.max_depth) == flow._target_depth()
    assert flow.pipeline_stats()["depth"] == grown
    for _ in range(20):
        ctrl.observe(ctrl._last_busy + 1.0, ctrl._last_active + 1.0,
                     ctrl._last_steps + ctrl.window)
    assert ctrl.depth == ctrl.min_depth == flow._target_depth()


def test_default_config_serves_the_lane_split_path():
    """The JAX EngineConfig defaults of the new fields, and a threaded run
    on them (a DeviceVoteVerifier with the default ladder): both
    coalescers built, commit order and certificates of the golden path."""
    jcfg, pcfg = JEngineConfig(), EngineConfig()
    for name in ("coalesce", "coalesce_linger", "adaptive_depth", "pipeline_depth_min",
                 "pipeline_depth_max", "wide_buckets", "lane_split", "priority_linger",
                 "priority_bucket_cap", "speculative_commit", "min_batch", "max_batch",
                 "pipeline_depth"):
        assert getattr(pcfg, name) == getattr(jcfg, name), name
    pvs, vals_j, vals_p = make_pvs(5, 47)
    txs = [b"dflt%d=%d" % (i, i) for i in range(10)]
    stream = mixed_stream(pvs, txs, 47)
    golden = jax_golden(vals_j, txs, stream)
    flow, mempool, votepool, store, app = make_port_engine(vals_p)
    assert isinstance(flow.verifier, DeviceVoteVerifier)
    assert flow.verifier.buckets == tuple(DEFAULT_BUCKETS)
    for tx in txs:
        mempool.check_tx(tx)
    flow.start()
    try:
        _feed(votepool, stream)
        assert wait_quiescent_lanes(flow, votepool)
        stats = flow.pipeline_stats()
    finally:
        flow.stop()
    assert stats["lanes"]["enabled"] and stats["coalesce"]["enabled"]
    assert stats["coalesce"]["targets"] == [256, 1024, 4096, 16384]
    assert stats["lanes"]["prio_targets"] == [64, 256]
    assert stats["coalesce"]["linger_flushes"] > 0  # a light load: every batch a flush
    flow_s, store_s, app_s = golden
    assert app.digest == app_s.digest  # no priority traffic: the golden order
    _assert_same_certs_state_stakes(txs, flow_s, store_s, app_s, flow, store, app)


class _BrokenLane(_BatchCoalescer):
    def decide(self, pending):
        raise RuntimeError("lane failed")


@pytest.mark.parametrize("depth", [1, 2])
def test_lane_failure_raises_at_stop(depth):
    """A failure in the priority lane ends the loop and raises at stop();
    nothing carries on another way."""
    pvs, _, vals_p = make_pvs(4, 53)
    flow, mempool, votepool, store, app = make_port_engine(
        vals_p, ScalarVoteVerifier(vals_p), min_batch=1, pipeline_depth=depth)
    flow._prio_lane = _BrokenLane((), cap=8, min_batch=1, linger=0.001)
    mempool.check_tx(b"lf=1")
    flow.start()
    _feed(votepool, [sign_vote(pv, b"lf=1") for pv in pvs])
    deadline = time.monotonic() + 10
    while flow.error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="lane failed"):
        flow.stop()
    assert flow._thread is None and flow._committer is None
    assert app.tx_count == 0
