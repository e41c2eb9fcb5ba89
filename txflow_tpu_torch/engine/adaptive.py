"""Adaptive controllers of the engine (``txflow_tpu/engine/adaptive.py``).

``AdaptiveDepthController`` steers how many verify tickets the pipelined
loop keeps in flight. The engine calls ``observe()`` once per routed ticket
with its cumulative busy and active seconds (``TxFlow._pipe_busy_s``, the
union of [submit, collect] windows, and ``_pipe_active_s``, the loop's
prep, wait and route seconds); the controller windows them into deltas of
``window`` steps and steers:

- window overlap below ``grow_below``: the device sat idle while the loop
  worked -- one more ticket in flight can cover the gap, grow;
- above ``shrink_above`` with depth above the floor: the device is
  saturated, a shallower pipeline commits earlier -- probe down;
- ``cooldown`` windows of hold after every change damp oscillation.

``AdaptiveLingerController`` steers the two lanes' lingers from a commit
latency digest against an SLO budget. The port's engine does not wire it:
the JAX engine feeds it from its tracer (``_steer_lingers``), and the port
has no tracer yet.

Both are synchronous and owned by the engine thread: no thread, no lock;
tests drive them with synthetic sequences.
"""

from __future__ import annotations


class AdaptiveDepthController:
    def __init__(
        self,
        depth: int = 2,
        min_depth: int = 2,
        max_depth: int = 8,
        grow_below: float = 0.85,
        shrink_above: float = 0.97,
        window: int = 32,
        cooldown: int = 2,
    ):
        self.min_depth = max(2, int(min_depth))  # < 2 would leave the pipelined loop
        self.max_depth = max(self.min_depth, int(max_depth))
        self.depth = min(max(int(depth), self.min_depth), self.max_depth)
        self.grow_below = grow_below
        self.shrink_above = shrink_above
        self.window = max(1, int(window))
        self.cooldown = max(0, int(cooldown))
        self.last_ratio: float | None = None
        self.changes = 0
        self._last_busy = 0.0
        self._last_active = 0.0
        self._last_steps = 0
        self._cool = 0

    def observe(self, busy_s: float, active_s: float, steps: int) -> int:
        """Feed the engine's cumulative counters; returns the depth the
        fill stage should honor from now on (== self.depth)."""
        if steps - self._last_steps < self.window:
            return self.depth
        d_busy = busy_s - self._last_busy
        d_active = active_s - self._last_active
        self._last_busy = busy_s
        self._last_active = active_s
        self._last_steps = steps
        if d_active <= 0:
            return self.depth
        ratio = min(d_busy / d_active, 1.0)
        self.last_ratio = ratio
        if self._cool > 0:
            self._cool -= 1
            return self.depth
        old = self.depth
        if ratio < self.grow_below and self.depth < self.max_depth:
            self.depth += 1
        elif ratio > self.shrink_above and self.depth > self.min_depth:
            self.depth -= 1
        if self.depth != old:
            self.changes += 1
            self._cool = self.cooldown
        return self.depth

    def stats(self) -> dict:
        return {
            "depth": self.depth,
            "min": self.min_depth,
            "max": self.max_depth,
            "changes": self.changes,
            "last_window_ratio": (
                round(self.last_ratio, 4) if self.last_ratio is not None else None
            ),
        }


class AdaptiveLingerController:
    """Per-lane linger steering against an SLO budget.

    The lane lingers trade latency for batch occupancy: a longer hold
    coalesces more votes a dispatch at the cost of every held vote's commit
    latency. ``maybe_observe`` pulls a digest (``digest_fn()["latency_ms"]``)
    at most once per ``interval`` seconds and steers both lingers
    multiplicatively:

    - p50 over ``slo_budget_ms``: shrink both toward ``min_linger``, the
      priority lane faster than bulk;
    - p50 under half the budget: relax each back toward its configured
      target, never past it;
    - in between, or no data yet: hold.

    ``wide_ok`` is the verdict on the bulk coalescer's wide rungs, with
    hysteresis: a breach revokes them, p50 under a quarter of the budget
    restores them. Clock values come from the caller."""

    def __init__(
        self,
        slo_budget_ms: float = 50.0,
        prio_linger: float = 0.001,
        bulk_linger: float = 0.004,
        min_linger: float = 0.0002,
        interval: float = 0.25,
        shrink: float = 0.5,
        relax: float = 1.25,
        family: str = "e2e",
    ):
        self.slo_budget_ms = float(slo_budget_ms)
        self.prio_target = float(prio_linger)
        self.bulk_target = float(bulk_linger)
        self.prio_linger = float(prio_linger)
        self.bulk_linger = float(bulk_linger)
        self.min_linger = float(min_linger)
        self.interval = float(interval)
        self.shrink = float(shrink)
        self.relax = float(relax)
        self.family = family
        self.adjustments = 0
        self.observations = 0
        self.last_p50_ms: float | None = None
        self._next_due: float | None = None
        # may the bulk coalescer dispatch rungs above the classic drain
        # cap (EngineConfig.wide_buckets)? The band between the two
        # thresholds holds the last verdict, so the gate does not flap
        self.wide_ok = True

    def maybe_observe(self, digest_fn, now: float) -> bool:
        """Cadence gate + digest pull; returns True when the lingers
        changed (the engine then pushes them into its lane coalescers)."""
        if self._next_due is not None and now < self._next_due:
            return False
        self._next_due = now + self.interval
        try:
            lat = digest_fn().get("latency_ms") or {}
        except Exception:
            return False  # tracer without metrics / digest fault: hold
        p50 = (lat.get(self.family) or {}).get("p50")
        if p50 is None:
            return False  # no sampled commits yet: nothing to steer by
        return self.observe(p50)

    def observe(self, p50_ms: float) -> bool:
        self.observations += 1
        self.last_p50_ms = float(p50_ms)
        old = (self.prio_linger, self.bulk_linger, self.wide_ok)
        if p50_ms > self.slo_budget_ms:
            self.wide_ok = False
        elif p50_ms < 0.25 * self.slo_budget_ms:
            self.wide_ok = True
        if p50_ms > self.slo_budget_ms:
            # priority shrinks harder: it carries the SLO; bulk keeps
            # more of its coalescing so throughput degrades gracefully
            self.prio_linger = max(
                self.min_linger, self.prio_linger * self.shrink
            )
            self.bulk_linger = max(
                self.min_linger, self.bulk_linger * (self.shrink + 1.0) / 2.0
            )
        elif p50_ms < 0.5 * self.slo_budget_ms:
            self.prio_linger = min(
                self.prio_target, self.prio_linger * self.relax
            )
            self.bulk_linger = min(
                self.bulk_target, self.bulk_linger * self.relax
            )
        changed = (self.prio_linger, self.bulk_linger, self.wide_ok) != old
        if changed:
            self.adjustments += 1
        return changed

    def stats(self) -> dict:
        return {
            "slo_budget_ms": self.slo_budget_ms,
            "prio_linger_ms": round(self.prio_linger * 1e3, 4),
            "bulk_linger_ms": round(self.bulk_linger * 1e3, 4),
            "adjustments": self.adjustments,
            "observations": self.observations,
            "wide_ok": self.wide_ok,
            "last_p50_ms": (
                round(self.last_p50_ms, 3)
                if self.last_p50_ms is not None else None
            ),
        }
