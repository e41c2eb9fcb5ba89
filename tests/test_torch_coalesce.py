"""PyTorch port, shape-stable coalescing and the adaptive controllers: the
port's ``_BatchCoalescer`` (txflow_tpu_torch/engine/txflow.py) and
``AdaptiveDepthController``/``AdaptiveLingerController``
(engine/adaptive.py) against the JAX package's, under a fake clock, on the
same seeded sequences of pending counts, clock steps, idle notes and wide
gates (tests/test_coalesce.py:52-107, tests/test_latency_lanes.py:253-342).
Every output is an int, a bool or a float computed by the same operations
in the same order: equality, tolerance 0."""

import numpy as np
import pytest

from txflow_tpu.engine.adaptive import AdaptiveDepthController as JDepth
from txflow_tpu.engine.adaptive import AdaptiveLingerController as JLinger
from txflow_tpu.engine.txflow import _BatchCoalescer as JCoalescer
from txflow_tpu.verifier import DEFAULT_BUCKETS as J_BUCKETS

from txflow_tpu_torch.engine.adaptive import AdaptiveDepthController, AdaptiveLingerController
from txflow_tpu_torch.engine.txflow import _BatchCoalescer
from txflow_tpu_torch.verifier import DEFAULT_BUCKETS


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _pair(buckets, **kw):
    cj, cp = FakeClock(), FakeClock()
    return JCoalescer(buckets, clock=cj, **kw), _BatchCoalescer(buckets, clock=cp, **kw), cj, cp


def _state(co):
    return (list(co.targets), co.full_batches, co.linger_flushes, co.wide_full_batches,
            co.wide_ok, co.wide_from)


CONFIGS = [
    dict(buckets=(8, 32, 128), cap=64, min_batch=4, linger=0.01),
    dict(buckets=(8,), cap=64, min_batch=1, linger=0.5),
    dict(buckets=(256, 1024), cap=64, min_batch=1, linger=0.01),
    dict(buckets=DEFAULT_BUCKETS, cap=16384, min_batch=256, linger=0.004),
    dict(buckets=DEFAULT_BUCKETS, cap=16384, min_batch=256, linger=0.004, multiple=3),
    dict(buckets=DEFAULT_BUCKETS, cap=65536, min_batch=256, linger=0.004, multiple=4,
         wide_from=16384),
    dict(buckets=DEFAULT_BUCKETS, cap=512, min_batch=1, linger=0.001, multiple=4),
    dict(buckets=(), cap=16, min_batch=1, linger=0.003),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=range(len(CONFIGS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_coalescer_sequences_match_jax(cfg, seed):
    cfg = dict(cfg)
    buckets = cfg.pop("buckets")
    jco, pco, cj, cp = _pair(buckets, **cfg)
    assert _state(pco) == _state(jco)
    rng = np.random.default_rng(seed)
    top = 2 * max(pco.targets)
    for _ in range(400):
        op = rng.integers(6)
        if op <= 1:
            pending = int(rng.choice([0, 1, 3, int(rng.integers(0, top + 1))]))
            assert pco.decide(pending) == jco.decide(pending)
        elif op == 2:
            dt = float(rng.choice([0.0, 0.0002, 0.001, 0.003, 0.6]))
            cj.t += dt
            cp.t += dt
        elif op == 3:
            jco.note_idle()
            pco.note_idle()
        elif op == 4:
            poll, idle = float(rng.choice([0.002, 0.25])), float(rng.choice([0.0, 0.002, 0.05]))
            assert pco.wait_budget(poll, idle) == jco.wait_budget(poll, idle)
        else:
            ok = bool(rng.integers(2))
            jco.set_wide(ok)
            pco.set_wide(ok)
        assert _state(pco) == _state(jco)


def test_coalescer_fixed_cases():
    """tests/test_coalesce.py:52-98 and tests/test_latency_lanes.py:253 on
    the port."""
    clk = FakeClock()
    co = _BatchCoalescer((8, 32, 128), cap=64, min_batch=4, linger=0.01, clock=clk)
    assert co.targets == [8, 32]
    assert co.decide(5) == 0
    assert (co.decide(9), co.decide(32), co.decide(70)) == (8, 32, 32)
    assert (co.full_batches, co.linger_flushes) == (3, 0)
    co = _BatchCoalescer((8,), cap=64, min_batch=1, linger=0.5, clock=clk)
    assert co.decide(3) == 0
    clk.t += 0.3
    assert co.decide(3) == 0
    clk.t += 0.3
    assert co.decide(3) == 3 and co.linger_flushes == 1
    co = _BatchCoalescer((8,), cap=64, min_batch=1, linger=10.0, clock=clk)
    co.note_idle()  # nothing pending: no-op
    assert co.wait_budget(0.25, 0.05) == 0.25
    assert co.decide(3) == 0
    assert co.wait_budget(0.25, 0.05) == 0.05
    co.note_idle()
    assert co.decide(3) == 3
    assert _BatchCoalescer((256, 1024), cap=64, min_batch=1, linger=0.01).targets == [64]
    # an expired deadline: the flush is due now
    co = _BatchCoalescer((8,), cap=64, min_batch=1, linger=0.5, clock=clk)
    assert co.decide(3) == 0
    assert 0.0 < co.wait_budget(0.2, 0.0) <= 0.2
    clk.t += 0.6
    assert co.wait_budget(0.2, 0.0) == 0.0 == co.wait_budget(0.2, 0.05)


@pytest.mark.parametrize("multiple", [1, 3, 4])
@pytest.mark.parametrize("cap", [1, 16, 100, 512, 4096])
def test_priority_lane_targets_capped_and_shard_divisible(multiple, cap):
    """The priority lane as start() builds it (min_batch 1, the cap, the
    mesh's multiple) over the default ladder: the JAX targets, each a
    shard multiple and within the cap rounded up to one."""
    assert tuple(DEFAULT_BUCKETS) == tuple(J_BUCKETS)
    kw = dict(cap=cap, min_batch=1, linger=0.001, multiple=multiple)
    jco, pco = JCoalescer(DEFAULT_BUCKETS, **kw), _BatchCoalescer(DEFAULT_BUCKETS, **kw)
    assert pco.targets == jco.targets
    assert all(t % multiple == 0 and t <= -(-cap // multiple) * multiple for t in pco.targets)


def test_depth_controller_matches_jax():
    rng = np.random.default_rng(3)
    for kw in (dict(), dict(depth=2, min_depth=2, max_depth=4, window=8, cooldown=1),
               dict(depth=5, min_depth=1, max_depth=3, window=1, cooldown=0)):
        j, p = JDepth(**kw), AdaptiveDepthController(**kw)
        busy = active = 0.0
        steps = 0
        for _ in range(300):
            steps += int(rng.integers(0, 12))
            active += float(rng.choice([0.0, 0.5, 1.0]))
            busy += float(rng.random()) * 1.1
            assert p.observe(busy, active, steps) == j.observe(busy, active, steps)
            assert p.stats() == j.stats()
            assert (p.depth, p.changes, p._cool) == (j.depth, j.changes, j._cool)


def test_depth_controller_fixed_case():
    """tests/test_coalesce.py:107 on the port."""
    ctrl = AdaptiveDepthController(depth=2, min_depth=2, max_depth=4, window=8, cooldown=1)

    def window_obs(ratio):
        return ctrl.observe(ctrl._last_busy + ratio, ctrl._last_active + 1.0,
                            ctrl._last_steps + ctrl.window)

    assert ctrl.observe(0.1, 1.0, ctrl.window - 1) == 2
    assert window_obs(0.5) == 3 and ctrl.changes == 1
    assert window_obs(0.5) == 3  # cooldown
    assert window_obs(0.5) == 4
    assert window_obs(0.5) == 4
    assert window_obs(0.5) == 4  # max
    for _ in range(10):
        window_obs(1.0)
    assert ctrl.depth == ctrl.min_depth == 2
    assert window_obs(0.9) == 2


def test_linger_controller_matches_jax():
    rng = np.random.default_rng(8)
    for kw in (dict(), dict(slo_budget_ms=50.0, prio_linger=0.002, bulk_linger=0.008,
                            min_linger=0.0005), dict(slo_budget_ms=10.0, interval=0.0)):
        j, p = JLinger(**kw), AdaptiveLingerController(**kw)
        now = 100.0
        for _ in range(200):
            r = rng.integers(4)
            if r == 0:
                p50 = float(rng.choice([1.0, 5.0, 12.0, 30.0, 49.0, 80.0, 500.0]))
                assert p.observe(p50) == j.observe(p50)
            else:
                now += float(rng.choice([0.0, 0.1, 0.3]))
                fam = {"e2e": {"p50": float(rng.uniform(0, 120))}} if r == 1 else {}

                def dig(fam=fam):
                    return {"latency_ms": fam}

                def boom():
                    raise RuntimeError("digest fault")

                fn = boom if r == 3 else dig
                assert p.maybe_observe(fn, now) == j.maybe_observe(fn, now)
            assert p.stats() == j.stats()
            assert (p.prio_linger, p.bulk_linger, p.wide_ok) == (j.prio_linger, j.bulk_linger,
                                                                 j.wide_ok)


def test_linger_controller_fixed_case():
    """tests/test_latency_lanes.py:316 on the port."""
    c = AdaptiveLingerController(slo_budget_ms=50.0, prio_linger=0.002, bulk_linger=0.008,
                                 min_linger=0.0005)
    assert c.observe(80.0) is True
    assert c.prio_linger == pytest.approx(0.001) and c.bulk_linger == pytest.approx(0.006)
    for _ in range(12):
        c.observe(80.0)
    assert c.prio_linger == pytest.approx(0.0005)
    assert c.observe(80.0) is False
    for _ in range(50):
        c.observe(10.0)
    assert c.prio_linger == pytest.approx(0.002) and c.bulk_linger == pytest.approx(0.008)
    assert c.observe(30.0) is False
