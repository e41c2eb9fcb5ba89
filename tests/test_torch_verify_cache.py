"""PyTorch port, the shared verdict cache on the CPU (``VerifyCache`` and
the verifier's cache path), against the JAX package (tolerance 0: key
bytes, verdicts, stake, masks, counters):

- ``VerifyCache.key`` bytes;
- a scripted sequence of ``lookup_or_claim_many``, ``store_many``,
  ``release_many``, ``heartbeat_many`` and claim expiry on a fake clock,
  with capacity eviction;
- two CPU verifiers sharing one cache decide a batch as the fused path
  does and as the JAX ``DeviceVoteVerifier(shared_cache=True)`` does, and
  a vote another verifier has in flight comes back dropped;
- a failed dispatch, and a failed readback, release their claims.
Four engines' threads on one verifier: ``test_torch_shared_verifier.py``.
"""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

import txflow_tpu.types as jtypes
import txflow_tpu.verifier as jver

import txflow_tpu_torch.types as ptypes
import txflow_tpu_torch.verifier as pver
from txflow_tpu_torch.crypto import ed25519
from txflow_tpu_torch.parallel.staging import StagingRing


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Batch:
    """Seeded votes over ``n_vals`` validators (power 10 * (1 + i % 3)):
    about 1/5 of them invalid (a flipped byte, a foreign key), plus an
    unknown validator index and an in-batch (slot, validator) repeat."""

    def __init__(self, seed, n=40, n_vals=4, n_slots=10):
        rng = np.random.default_rng(seed)
        self.seeds = [np.random.default_rng(1000 + i).bytes(32) for i in range(n_vals)]
        pubs = [ed25519.public_key_from_seed(s) for s in self.seeds]
        self.vals = {m: t.ValidatorSet([t.Validator.from_pub_key(p, 10 * (1 + i % 3))
                                        for i, p in enumerate(pubs)])
                     for m, t in (("jax", jtypes), ("port", ptypes))}
        order = [v.pub_key for v in self.vals["port"]]
        seed_of = dict(zip(pubs, self.seeds))
        self.msgs, self.sigs, vidx, slots = [], [], [], []
        for i in range(n):
            vi = int(rng.integers(n_vals))
            msg = rng.bytes(int(rng.integers(40, 120)))
            sig = ed25519.sign(seed_of[order[vi]], msg)
            r = rng.random()
            if r < 0.1:
                sig = sig[:3] + bytes([sig[3] ^ 4]) + sig[4:]
            elif r < 0.2:
                sig = ed25519.sign(rng.bytes(32), msg)
            self.msgs.append(msg)
            self.sigs.append(sig)
            vidx.append(vi)
            slots.append(int(rng.integers(n_slots)))
        vidx[5] = n_vals + 2  # unknown validator
        vidx[7], slots[7] = vidx[6], slots[6]  # in-batch repeat
        self.val_idx = np.array(vidx, np.int64)
        self.slots = np.array(slots, np.int32)
        self.n_slots = n_slots
        self.prior = rng.integers(0, 20, n_slots).astype(np.int64)

    def args(self, lo=0, hi=None):
        hi = len(self.msgs) if hi is None else hi
        return (self.msgs[lo:hi], self.sigs[lo:hi], self.val_idx[lo:hi], self.slots[lo:hi],
                self.n_slots)


def as_tuple(res):
    return (res.valid.astype(bool).tolist(), np.asarray(res.stake, np.int64).tolist(),
            res.maj23.astype(bool).tolist(), res.dropped.astype(bool).tolist())


def test_cache_key_bytes_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        m, s, p = (rng.bytes(int(rng.integers(0, 200))) for _ in range(3))
        assert pver.VerifyCache.key(m, s, p) == jver.VerifyCache.key(m, s, p)
    # the lengths bind the split: no (msg, sig) ambiguity
    assert pver.VerifyCache.key(b"ab", b"c", b"k") != pver.VerifyCache.key(b"a", b"bc", b"k")


def _cache_script(cls, clock):
    c = cls(capacity=4, claim_ttl=3.0)
    k = [hashlib.sha256(b"%d" % i).digest() for i in range(8)]
    out = []

    def look(keys):
        vals, pend = c.lookup_or_claim_many(keys)
        out.append((vals, pend.tolist(), c.hits, c.misses, c.deferrals))

    look([k[0], k[1], None, k[2]])  # three claims
    look([k[0], k[3]])  # k0 in flight elsewhere: pending; k3 claimed
    clock[0] += 2.0
    c.heartbeat_many([k[0], k[7]])  # k0 re-stamped; k7 was never claimed
    clock[0] += 2.0  # k1, k2, k3 stale now; k0 not
    look([k[0], k[1], k[3]])
    c.store_many([(k[0], True), (k[1], False)])
    c.release_many([k[3], k[5]])
    look([k[0], k[1], k[3]])  # hits, and k3 claimed again
    c.store_many([(k[i], bool(i % 2)) for i in range(2, 7)])  # capacity 4: k0..k2 out
    look([k[i] for i in range(7)])
    out.append(sorted(c._inflight))
    return out


def test_cache_scripted_claims_match_jax(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    got_p = _cache_script(pver.VerifyCache, clock)
    clock[0] = 1000.0
    got_j = _cache_script(jver.VerifyCache, clock)
    assert got_p == got_j
    assert got_p[1][1] == [True, False] and got_p[2][1] == [True, False, False]


def cpu_verifier(vals, cache=None, **kw):
    return pver.DeviceVoteVerifier(vals, device="cpu", buckets=(64,), shared_cache=cache, **kw)


def test_two_verifiers_sharing_a_cache_decide_like_the_fused_path_and_jax():
    b = Batch(11)
    fused = cpu_verifier(b.vals["port"]).verify_and_tally(*b.args(), prior_stake=b.prior)
    cache = pver.VerifyCache()
    v1, v2 = cpu_verifier(b.vals["port"], cache), cpu_verifier(b.vals["port"], cache)
    first = v1.verify_and_tally(*b.args(), prior_stake=b.prior)
    second = v2.verify_and_tally(*b.args(), prior_stake=b.prior)  # all hits
    assert as_tuple(first) == as_tuple(second) == as_tuple(fused)
    assert v1.cache_verify_calls == 1 and v2.cache_verify_calls == 0
    assert v1.cache_verify_rows == cache.misses == int((~fused.dropped).sum()) - 1  # unknown
    jv = jver.DeviceVoteVerifier(b.vals["jax"], buckets=(64,), shared_cache=True)
    jres = jv.verify_and_tally(*b.args(), prior_stake=b.prior)
    assert as_tuple(first) == as_tuple(jres)
    assert (cache.hits, cache.misses, cache.deferrals) == (
        jv.cache.hits + v1.cache_verify_rows, jv.cache.misses, jv.cache.deferrals)
    # a vote another verifier has in flight comes back dropped (re-offer)
    b2 = Batch(12)
    cache2 = pver.VerifyCache()
    w1, w2 = cpu_verifier(b2.vals["port"], cache2), cpu_verifier(b2.vals["port"], cache2)
    t1 = w1.submit(*b2.args(0, 20))
    r2 = w2.submit(*b2.args(10, 30)).result()
    # w1 claimed the first occurrences of its batch with a known signer
    k1 = pver.first_occurrence_mask(b2.slots[:20], b2.val_idx[:20]) & (b2.val_idx[:20] < 4)
    k2 = pver.first_occurrence_mask(b2.slots[10:30], b2.val_idx[10:30])
    pending = k2[:10] & k1[10:]
    assert pending.sum() >= 5 and not r2.valid[:10][pending].any()
    assert r2.dropped[:10].tolist() == (~k2[:10] | pending).tolist()
    r1 = t1.result()
    again = w2.submit(*b2.args(10, 30)).result()  # now hits for the overlap
    ref = cpu_verifier(b2.vals["port"]).verify_and_tally(*b2.args(10, 30))
    assert as_tuple(again) == as_tuple(ref)
    assert r1.valid.tolist() == cpu_verifier(b2.vals["port"]).verify_and_tally(
        *b2.args(0, 20)).valid.tolist()
    assert not cache2._inflight


def test_failed_dispatch_and_readback_release_claims(monkeypatch):
    b = Batch(13)
    cache = pver.VerifyCache()
    v = cpu_verifier(b.vals["port"], cache)

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(v, "_dispatch_verify_only", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        v.submit(*b.args())
    assert not cache._inflight
    monkeypatch.undo()
    # a failed readback on the ring: the ticket raises and lets go too
    v2 = cpu_verifier(b.vals["port"], cache, staging_ring=2)

    def bad_result(self, slot):
        raise RuntimeError("readback failed")

    monkeypatch.setattr(StagingRing, "result", bad_result)
    ticket = v2.submit(*b.args())
    assert cache._inflight
    with pytest.raises(RuntimeError, match="readback failed"):
        ticket.result()
    assert not cache._inflight
    monkeypatch.undo()
    # the next asker claims the votes: nothing is pending
    res = cpu_verifier(b.vals["port"], cache).submit(*b.args()).result()
    keep = pver.first_occurrence_mask(b.slots, b.val_idx)
    assert res.dropped.tolist() == (~keep).tolist()  # only in-batch repeats
