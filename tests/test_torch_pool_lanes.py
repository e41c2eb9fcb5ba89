"""PyTorch port, pool lanes: the same ingest sequences and lane hooks go to
the JAX package's pools (txflow_tpu/pool/mempool.py, txvotepool.py) and the
port's, and the lane bookkeeping must agree exactly (tolerance 0: keys,
counts, cursors):

- the mempool's lane counts, ``lane_of_key`` and reap order (priority
  first), after commits (tests/test_overload.py:44);
- the vote pool's ``prio_seq``, ``priority_entries_from`` and
  ``bulk_entries_from`` at several cursors, the lane frozen at ingest,
  bulk eviction for a priority vote on a full pool and a faulting hook
  demoting to bulk (tests/test_overload.py:189), both ingest paths;
- the logs' compaction after ``remove`` and ``update``."""

import hashlib

import numpy as np
import pytest

import txflow_tpu.pool as jpool
import txflow_tpu.types as jtypes
from txflow_tpu.admission.classifier import FeeLaneClassifier as JFeeLaneClassifier
from txflow_tpu.utils.config import MempoolConfig as JMempoolConfig

import txflow_tpu_torch.pool as ppool
import txflow_tpu_torch.types as ptypes
from txflow_tpu_torch.admission import FeeLaneClassifier
from txflow_tpu_torch.pool import LANE_BULK, LANE_PRIORITY
from txflow_tpu_torch.pool.base import COMPACT_THRESHOLD
from txflow_tpu_torch.utils.config import MempoolConfig


def _txs(rng, n):
    """n distinct txs, about a third with a fee prefix (some below the
    threshold, some malformed)."""
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.2:
            out.append(b"fee=%d;p%d=v" % (int(rng.integers(1, 9)), i))
        elif r < 0.3:
            out.append(b"fee=0;z%d=v" % i)
        elif r < 0.35:
            out.append(b"fee=x;m%d=v" % i)
        else:
            out.append(b"b%d=v" % i)
    return out


class _Flaky:
    """A classifier that raises on every tx holding ``boom``."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, tx):
        if b"boom" in tx:
            raise RuntimeError("hostile tx")
        return self.inner(tx)


def _mempools(hook_j, hook_p, size=10000):
    mj = jpool.Mempool(JMempoolConfig(size=size, cache_size=4 * size))
    mp = ppool.Mempool(MempoolConfig(size=size, cache_size=4 * size))
    mj.lane_of, mp.lane_of = hook_j, hook_p
    return mj, mp


def _same_mempool(mj, mp, txs):
    for lane in (LANE_PRIORITY, LANE_BULK):
        assert mp.lane_size(lane) == mj.lane_size(lane)
    for tx in txs:
        key = hashlib.sha256(tx).digest()
        assert mp.lane_of_key(key) == mj.lane_of_key(key)
    for n in (-1, 0, 1, 5, 17, len(txs)):
        assert mp.reap_max_txs(n) == mj.reap_max_txs(n)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mempool_lanes_match_jax(seed):
    rng = np.random.default_rng(seed)
    txs = _txs(rng, 60) + [b"fee=4;boom%d=v" % seed, b"boom=%d" % seed]
    mj, mp = _mempools(_Flaky(JFeeLaneClassifier(2)), _Flaky(FeeLaneClassifier(2)))
    for tx in txs:
        mj.check_tx(tx)
        mp.check_tx(tx)
    # a faulting hook demotes to bulk
    assert mp.lane_of_key(hashlib.sha256(b"fee=4;boom%d=v" % seed).digest()) == LANE_BULK
    _same_mempool(mj, mp, txs)
    # commits update the lane accounting; the batched ingest takes the rest
    done = [txs[i] for i in rng.choice(len(txs), 20, replace=False)]
    for m in (mj, mp):
        m.lock()
        try:
            m.update(1, done)
        finally:
            m.unlock()
    more = _txs(np.random.default_rng(seed + 100), 30)
    more = [b"x" + tx for tx in more]
    assert [e is None for e in mp.check_tx_many(more)] == [e is None for e in mj.check_tx_many(more)]
    _same_mempool(mj, mp, txs + more)


def test_mempool_overload_case():
    """tests/test_overload.py:44 on both pools."""
    bulk = [b"b%d=v" % i for i in range(4)]
    prio = [b"fee=2;p%d=v" % i for i in range(3)]
    mj, mp = _mempools(JFeeLaneClassifier(1), FeeLaneClassifier(1), size=100)
    for tx in (bulk[0], prio[0], bulk[1], prio[1], bulk[2], prio[2], bulk[3]):
        mj.check_tx(tx)
        mp.check_tx(tx)
    assert mp.lane_size(LANE_PRIORITY) == 3 and mp.lane_size(LANE_BULK) == 4
    assert mp.reap_max_txs(5) == prio + bulk[:2] == mj.reap_max_txs(5)
    mp.lock()
    try:
        mp.update(1, [prio[0]])
    finally:
        mp.unlock()
    assert mp.lane_size(LANE_PRIORITY) == 2 and mp.size() == 6
    # the commitpool's staged txs are bulk
    mp.push_committed_many([b"c=1"], [hashlib.sha256(b"c=1").digest()])
    assert mp.lane_size(LANE_BULK) == 5


# ---- the vote pool ----


def _vote_pair(i, tx_key, height=1):
    """A vote in both packages (distinct signature bytes: distinct keys)."""
    args = (height, tx_key.hex().upper(), tx_key, 1_700_000_000_000_000_000 + i,
            hashlib.sha256(b"val%d" % (i % 7)).digest()[:20],
            hashlib.sha256(b"sig%d" % i).digest() * 2)
    return jtypes.TxVote(*args), ptypes.TxVote(*args)


def _votepools(size, hook_j, hook_p):
    pj = jpool.TxVotePool(JMempoolConfig(size=size, cache_size=8 * size))
    pp = ppool.TxVotePool(MempoolConfig(size=size, cache_size=8 * size))
    pj.lane_of_vote, pp.lane_of_vote = hook_j, hook_p
    return pj, pp


def _walk(fn, cursor, limit):
    items, pos = fn(cursor, limit=limit)
    return [(t[0], t[2]) for t in items], pos


def _same_votepool(pj, pp, cursors=(0, 1, 5, 37, 200, 10**9)):
    assert pp.size() == pj.size() and pp.seq() == pj.seq()
    assert pp.prio_seq() == pj.prio_seq()
    for c in cursors:
        for limit in (1, 7, 10**6):
            assert _walk(pp.priority_entries_from, c, limit) == _walk(pj.priority_entries_from, c, limit)
            assert _walk(pp.bulk_entries_from, c, limit) == _walk(pj.bulk_entries_from, c, limit)
            assert _walk(pp.entries_from, c, limit) == _walk(pj.entries_from, c, limit)
    # the two lane walks partition the pool exactly
    prio = {k for k, _ in _walk(pp.priority_entries_from, 0, 10**9)[0]}
    bulk = {k for k, _ in _walk(pp.bulk_entries_from, 0, 10**9)[0]}
    assert not prio & bulk
    assert prio | bulk == {k for k, _ in _walk(pp.entries_from, 0, 10**9)[0]}


def _tx_keys(rng, n):
    keys = [hashlib.sha256(b"tx%d" % i).digest() for i in range(n)]
    prio = {k for k in keys if rng.random() < 0.3}
    return keys, prio


@pytest.mark.parametrize("seed", [4, 9])
@pytest.mark.parametrize("batched", [False, True])
def test_votepool_lane_walks_match_jax(seed, batched):
    rng = np.random.default_rng(seed)
    keys, prio = _tx_keys(rng, 24)
    live = set(prio)  # the hook's answer drifts: keys leave it mid-stream

    def hook(v):
        if v.tx_key == keys[0]:
            raise RuntimeError("hook fault")  # demoted to bulk
        return LANE_PRIORITY if v.tx_key in live else LANE_BULK

    pj, pp = _votepools(10000, hook, hook)
    pairs = [_vote_pair(i, keys[int(rng.integers(len(keys)))]) for i in range(300)]
    for n, chunk in enumerate(range(0, len(pairs), 50)):
        part = pairs[chunk:chunk + 50]
        if batched:
            assert [e is None for e in pp.check_tx_many([p for _, p in part])] == [
                e is None for e in pj.check_tx_many([j for j, _ in part])]
        else:
            for j, p in part:
                pj.check_tx(j)
                pp.check_tx(p)
        if n == 2:
            # the lane stays as ingested: a drifting hook moves no vote
            live.difference_update(list(live)[: len(live) // 2])
    _same_votepool(pj, pp)
    # removals and commits keep both walks equal
    gone = [pairs[i][0].vote_key() for i in rng.choice(len(pairs), 60, replace=False)]
    pj.remove(gone)
    pp.remove(gone)
    committed = [pairs[i] for i in rng.choice(len(pairs), 40, replace=False)]
    pj.update(2, [j for j, _ in committed])
    pp.update(2, [p for _, p in committed])
    _same_votepool(pj, pp)


@pytest.mark.parametrize("batched", [False, True])
def test_votepool_priority_evicts_oldest_bulk(batched):
    """tests/test_overload.py:189 on both pools: a full pool bounces bulk
    and evicts its oldest bulk vote for a priority one, which leaves the
    dedup cache too; the JAX pool asks the hook again at eviction."""
    prio_keys = {hashlib.sha256(b"fee=2;p=v").digest()}

    def hook(v):
        return LANE_PRIORITY if v.tx_key in prio_keys else LANE_BULK

    pj, pp = _votepools(3, hook, hook)
    bulk = [_vote_pair(i, hashlib.sha256(b"b%d=v" % i).digest()) for i in range(3)]
    pv = _vote_pair(10, next(iter(prio_keys)))
    b4 = _vote_pair(11, hashlib.sha256(b"b4=v").digest())
    p2k = hashlib.sha256(b"fee=2;p2=v").digest()
    p2 = _vote_pair(12, p2k)
    for j, p in bulk:
        pj.check_tx(j)
        pp.check_tx(p)
    if batched:
        ej = pj.check_tx_many([pv[0], b4[0]])
        ep = pp.check_tx_many([pv[1], b4[1]])
        assert [type(e) .__name__ for e in ep] == [type(e).__name__ for e in ej] == [
            "NoneType", "ErrMempoolIsFull"]
    else:
        pj.check_tx(pv[0])
        pp.check_tx(pv[1])
        with pytest.raises(ppool.ErrMempoolIsFull):
            pp.check_tx(b4[1])
        with pytest.raises(jpool.ErrMempoolIsFull):
            pj.check_tx(b4[0])
    k0 = bulk[0][0].vote_key()
    assert not pp.has(k0) and k0 not in pp.cache and pp.has(pv[0].vote_key())
    assert pj.has(k0) == pp.has(k0)
    prio_keys.add(p2k)
    pj.check_tx_many([p2[0]])
    pp.check_tx_many([p2[1]])
    _same_votepool(pj, pp)
    assert pp.size() == 3 and pp.prio_seq() == 2


def test_votepool_logs_compact_after_remove_and_update():
    """More than COMPACT_THRESHOLD dead entries at the head of both logs:
    both drop their dead prefix, in both packages, and the cursors keep
    their meaning."""
    n = COMPACT_THRESHOLD + 600
    prio_keys = [hashlib.sha256(b"ptx%d" % i).digest() for i in range(n // 8)]
    bulk_keys = [hashlib.sha256(b"btx%d" % i).digest() for i in range(64)]
    prio = set(prio_keys)

    def hook(v):
        return LANE_PRIORITY if v.tx_key in prio else LANE_BULK

    pj, pp = _votepools(4 * n, hook, hook)
    # a priority head, then a mixed tail
    pairs = [_vote_pair(i, prio_keys[i % len(prio_keys)]) for i in range(n + 100)]
    pairs += [_vote_pair(n + 100 + i, (prio_keys + bulk_keys)[i % (len(prio_keys) + 64)])
              for i in range(800)]
    pj.check_tx_many([j for j, _ in pairs])
    pp.check_tx_many([p for _, p in pairs])
    head = pairs[: n + 100]
    # remove the first part of the head, commit the rest of it
    cut = len(head) // 2
    pj.remove([j.vote_key() for j, _ in head[:cut]])
    pp.remove([p.vote_key() for _, p in head[:cut]])
    pj.update(2, [j for j, _ in head[cut:]])
    pp.update(2, [p for _, p in head[cut:]])
    assert pp._log_base == pj._log_base > 0
    assert pp._prio_log_base == pj._prio_log_base > 0
    _same_votepool(pj, pp, cursors=(0, 17, n, n + 100, n + 500))
