"""ServingAutoScaler: the SLO-driven serving scale loop.

Port of ``dlrover_tpu/master/serving_autoscaler.py``. The serving-side
sibling of :class:`~dlrover_tpu_torch.master.auto_scaler.JobAutoScaler`:
where the trainer loop consumes the resource optimizer's throughput
plans, this loop consumes the serving tier's own telemetry and turns a
watchdog gate into a scale decision:

- **Signals** — merged fleet latency histograms
  (``ReplicaRouter.fleet_histograms``), per-role TTFT/TPOT windows,
  scheduler queue depth + drop counters, and PageAllocator occupancy
  (the same axes ``engine.observability_snapshot()`` freezes into a
  capture artifact). Histograms are LIFETIME counters, so every
  evaluation judges the delta window since the previous one
  (:func:`~dlrover_tpu_torch.observability.histogram.histogram_delta`) —
  minutes of healthy history must not mask a fresh breach, nor a
  fresh recovery.
- **Attribution** — a breach names a ROLE before it names a size: a
  TTFT breach points at the prefill pool, an e2e/TPOT breach at the
  decode pool, out-of-pages at the most-occupied pool (reusing
  ``healthcheck._slow_role``, the replay-side version of the same
  judgement). Prefill and decode therefore scale independently,
  which is the whole reason serving nodes register role-tagged.
- **Decisions** — edge-triggered with hysteresis (a breach latches
  until the window drops below ``clear_frac`` × target), per-role
  cooldown, and min/max bounds, like the trainer loop. Scale-out
  attaches a warm replica to the live router
  (``ReplicaRouter.add_replica``); scale-in drains the least-loaded
  victim over the live-migration wire (``remove_replica`` — zero
  lost, zero re-prefilled) after ``shrink_after_clear`` consecutive
  clear windows.
- **Versioning** — every decision flows through
  ``JobManager.plan_serving_scale`` (in-process master) or
  ``MasterClient.report_serving_scale`` (remote), falling back to a
  local counter, and is published as a
  :class:`~dlrover_tpu_torch.observability.telemetry.ScaleDecisionRecord`
  so the healthcheck can replay WHY the fleet is its current size.

``evaluate(signals=...)`` is a pure decision function (tests drive it
with synthetic signal dicts and a fake clock); only ``collect()`` and
``apply()`` touch live replicas. ``step()`` runs one tick for a caller
that drives the loop; the JAX background thread (``start``/``stop``)
is not ported: the caller picks the period.
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.observability.healthcheck import _slow_role
from dlrover_tpu_torch.observability.histogram import (
    histogram_delta,
    merge_histograms,
)
from dlrover_tpu_torch.observability.telemetry import ScaleDecisionRecord

logger = get_logger(__name__)

# breach signals in detection priority order: page exhaustion starves
# everything downstream of it, so it outranks the latency symptoms it
# causes; queue depth is the earliest (cheapest) overload indicator but
# the least specific, so it ranks last
SCALE_SIGNALS = (
    "out_of_pages",
    "ttft_regression",
    "slo_breach",
    "tpot_breach",
    "queue_depth",
)


@dataclass
class ServingScalerConfig:
    """Targets + control knobs for one serving fleet's scale loop.

    A target of 0 disables that signal, mirroring
    ``ServingWatchdogConfig``. ``role_min``/``role_max`` override the
    scalar bounds per role so a disaggregated fleet can pin, say, the
    decode pool while the prefill pool breathes."""

    p99_target_ms: float = 0.0
    ttft_target_ms: float = 0.0
    tpot_target_ms: float = 0.0
    # queue depth (per role, summed over the pool) above this is an
    # overload signal even before latency percentiles move
    queue_depth_high: int = 0
    # fraction of KV pages in use (worst replica of the pool)
    occupancy_high: float = 0.92
    # hysteresis: a latched breach clears only when the window value
    # drops below clear_frac × target — never at target itself, or an
    # oscillating trace flaps the gate every evaluation
    clear_frac: float = 0.8
    # at most one actionable decision per role per cooldown window
    cooldown_s: float = 10.0
    min_replicas: int = 1
    max_replicas: int = 2
    role_min: Dict[str, int] = field(default_factory=dict)
    role_max: Dict[str, int] = field(default_factory=dict)
    # judging percentiles on a handful of window samples is noise
    min_window_n: int = 8
    # consecutive clear evaluations before a scale-in is considered
    shrink_after_clear: int = 3
    # the JAX loop's period; the port's caller drives ``step()`` itself
    interval_s: float = 0.25


class ServingAutoScaler:
    """Close the telemetry → ScalePlan loop for one serving fleet.

    ``provision_fn(role) -> ServingReplica`` supplies a warm (started)
    replica on scale-out — in production a launcher that boots a host
    and waits for its ``refresh_discovery`` registration, in drills a
    factory over pre-warmed spares. Without one, scale-out decisions
    are recorded but not applied (signal-only mode)."""

    def __init__(
        self,
        router,
        config: Optional[ServingScalerConfig] = None,
        *,
        provision_fn: Optional[Callable] = None,
        decommission_fn: Optional[Callable] = None,
        job_manager=None,
        master_client=None,
        watchdog=None,
        hub=None,
        node_id: int = 0,
        clock=time.monotonic,
    ):
        self.router = router
        self.cfg = config or ServingScalerConfig()
        self.provision_fn = provision_fn
        self.decommission_fn = decommission_fn
        self.job_manager = job_manager
        self.master_client = master_client
        self.hub = hub
        self.node_id = node_id
        self._clock = clock
        self._lock = threading.Lock()
        # lifetime-histogram snapshots per role, for delta windows
        self._prev_hists: Dict[str, Dict] = {}
        self._prev_drops: Dict[str, int] = {}
        # gate edges pushed by the watchdog subscription; drained into
        # the next evaluation so a breach the watchdog saw first still
        # starts the reaction clock at ITS edge, not our next tick
        self._gate_state: Dict[str, bool] = {}
        # first-seen time of each active breach signal (reaction clock)
        self._breach_t: Dict[str, float] = {}
        # per-role latched breach signal (hysteresis) + bookkeeping
        self._latched: Dict[str, str] = {}
        self._clear_streak: Dict[str, int] = {}
        self._last_decision_t: Dict[str, float] = {}
        self._local_version = 0
        self.decisions: List[ScaleDecisionRecord] = []
        self.last_reaction_s = 0.0   # breach edge → decision applied
        self.last_restore_s = 0.0    # breach edge → window back in SLO
        if watchdog is not None:
            watchdog.subscribe(self._on_gate)

    # ---- watchdog subscription -------------------------------------------

    def _on_gate(self, kind: str, breaching: bool, rec) -> None:
        """Gate-edge hook (``ServingWatchdog.subscribe``): latch the
        edge and stamp the breach start so reaction time is measured
        from the moment the SLO broke, not the next evaluation tick."""
        with self._lock:
            self._gate_state[kind] = breaching
            if breaching:
                self._breach_t.setdefault(kind, self._clock())

    # ---- signal collection -----------------------------------------------

    def _pools(self) -> Dict[str, List]:
        if self.router.disaggregated:
            return {
                "prefill": self.router.live_replicas("prefill"),
                "decode": self.router.live_replicas("decode"),
            }
        return {"unified": self.router.live_replicas()}

    def collect(self) -> Dict:
        """One evaluation's signal snapshot: per-role WINDOW latency
        percentiles (delta since the previous collect — membership
        changes between snapshots clamp at zero, never go negative),
        pool queue depth, new drops, and worst-replica page occupancy."""
        roles: Dict[str, Dict] = {}
        for role, reps in self._pools().items():
            if not reps:
                continue
            per = [r.server.scheduler.histograms() for r in reps]
            cur = {}
            for k in per[0]:
                merged = merge_histograms(p[k] for p in per)
                if merged is not None:
                    cur[k] = merged
            prev = self._prev_hists.get(role, {})
            win = {
                k: histogram_delta(h, prev.get(k)) for k, h in cur.items()
            }
            self._prev_hists[role] = cur
            occ = 0.0
            for r in reps:
                eng = r.server.engine
                n_pages = max(1, eng.geom.n_pages)
                occ = max(occ, 1.0 - eng.alloc.free_pages / n_pages)
            drops = sum(
                r.server.scheduler.shed
                + r.server.scheduler.rejected
                + r.server.scheduler.timed_out
                + r.server.scheduler.poisoned
                for r in reps
            )
            new_drops = drops - self._prev_drops.get(role, drops)
            self._prev_drops[role] = drops
            e2e = win.get("e2e")
            roles[role] = {
                "n": e2e.n if e2e is not None else 0,
                "p99_ms": e2e.percentile(99.0) if e2e is not None else 0.0,
                "ttft_p99_ms": (
                    win["ttft"].percentile(99.0) if "ttft" in win else 0.0
                ),
                "tpot_p99_ms": (
                    win["tpot"].percentile(99.0) if "tpot" in win else 0.0
                ),
                "queue_depth": sum(
                    r.server.scheduler.queue_depth() for r in reps
                ),
                "new_drops": new_drops,
                "occupancy": occ,
                "n_replicas": len(reps),
            }
        return {"roles": roles}

    # ---- pure decision logic ---------------------------------------------

    def _bounds(self, role: str):
        lo = self.cfg.role_min.get(role, self.cfg.min_replicas)
        hi = self.cfg.role_max.get(role, self.cfg.max_replicas)
        return lo, hi

    def _signal_reading(self, info: Dict, signal: str):
        """(value, target) of ``signal`` in one role's window, or None
        when the signal is disabled or the window is too thin to judge
        latency percentiles (depth/occupancy need no sample floor)."""
        cfg = self.cfg
        enough = info.get("n", 0) >= cfg.min_window_n
        if signal == "out_of_pages":
            return (info.get("occupancy", 0.0), cfg.occupancy_high)
        if signal == "queue_depth" and cfg.queue_depth_high > 0:
            return (
                float(info.get("queue_depth", 0)),
                float(cfg.queue_depth_high),
            )
        if signal == "ttft_regression" and cfg.ttft_target_ms > 0 and enough:
            return (info.get("ttft_p99_ms", 0.0), cfg.ttft_target_ms)
        if signal == "slo_breach" and cfg.p99_target_ms > 0 and enough:
            return (info.get("p99_ms", 0.0), cfg.p99_target_ms)
        if signal == "tpot_breach" and cfg.tpot_target_ms > 0 and enough:
            return (info.get("tpot_p99_ms", 0.0), cfg.tpot_target_ms)
        return None

    def _attribute(self, roles: Dict, signal: str) -> str:
        """Which pool a breach names. Resource/backlog signals point at
        the pressured pool directly; latency signals reuse the
        healthcheck's role attribution (TTFT → worst-TTFT role, pace →
        worst-pace role). Single-pool fleets have nothing to choose."""
        if len(roles) < 2:
            return next(iter(roles), "unified")
        if signal == "out_of_pages":
            return max(roles, key=lambda r: roles[r].get("occupancy", 0.0))
        if signal == "queue_depth":
            return max(roles, key=lambda r: roles[r].get("queue_depth", 0))
        kind = (
            "ttft_regression" if signal == "ttft_regression" else "slo"
        )
        return _slow_role({"roles": roles}, kind) or "unified"

    def evaluate(
        self, signals: Optional[Dict] = None, now: Optional[float] = None
    ) -> Optional[Dict]:
        """One control-loop tick, pure given ``signals``: detect a
        breach (or a hysteresis-clear), attribute it to a role, and
        return the decision dict — or None when nothing to do. Tests
        drive this with synthetic signal dicts and a fake clock;
        ``step()`` feeds it live ``collect()`` output and applies the
        result."""
        now = self._clock() if now is None else now
        if signals is None:
            signals = self.collect()
        roles = signals.get("roles") or {}
        with self._lock:
            gate_breach = [k for k, v in self._gate_state.items() if v]
        # -- detect: first breaching signal in priority order
        for signal in SCALE_SIGNALS:
            worst = None
            for role, info in roles.items():
                reading = self._signal_reading(info, signal)
                if reading is None:
                    continue
                value, target = reading
                if value > target and (
                    worst is None or value / target > worst[0] / worst[1]
                ):
                    worst = (value, target)
            if worst is None:
                continue
            value, target = worst
            role = self._attribute(roles, signal)
            with self._lock:
                self._breach_t.setdefault(signal, now)
                breach_start = self._breach_t[signal]
            self._latched[role] = signal
            self._clear_streak[role] = 0
            n_live = roles.get(role, {}).get("n_replicas", 0)
            lo, hi = self._bounds(role)
            last = self._last_decision_t.get(role)
            if n_live >= hi:
                return None  # already at the ceiling: breach stays latched
            if last is not None and now - last < self.cfg.cooldown_s:
                return None  # in cooldown: at most one decision per window
            return {
                "direction": "out",
                "role": role,
                "signal": signal,
                "value": value,
                "target": target,
                "n_before": n_live,
                "n_after": n_live + 1,
                "reaction_s": max(0.0, now - breach_start),
                "reason": f"{signal} {value:g}>{target:g}",
            }
        # -- no breach: run the clear / shrink ladder per latched role
        for role, signal in list(self._latched.items()):
            info = roles.get(role)
            if info is None:
                continue
            reading = self._signal_reading(info, signal)
            if reading is not None:
                value, target = reading
                if value > target * self.cfg.clear_frac:
                    continue  # inside the hysteresis band: stay latched
            else:
                value, target = 0.0, 0.0
            del self._latched[role]
            with self._lock:
                breach_start = self._breach_t.pop(signal, now)
                self._gate_state.pop(signal, None)
            self.last_restore_s = max(0.0, now - breach_start)
            return {
                "direction": "",
                "role": role,
                "signal": "clear",
                "value": value,
                "target": target,
                "n_before": info.get("n_replicas", 0),
                "n_after": info.get("n_replicas", 0),
                "reaction_s": self.last_restore_s,
                "reason": f"{signal} cleared",
            }
        if gate_breach:
            return None  # watchdog still holds a gate open: never shrink
        for role, info in roles.items():
            if role in self._latched:
                continue
            self._clear_streak[role] = self._clear_streak.get(role, 0) + 1
            lo, hi = self._bounds(role)
            n_live = info.get("n_replicas", 0)
            if (
                self._clear_streak[role] < self.cfg.shrink_after_clear
                or n_live <= lo
            ):
                continue
            last = self._last_decision_t.get(role)
            if last is not None and now - last < self.cfg.cooldown_s:
                continue
            self._clear_streak[role] = 0
            return {
                "direction": "in",
                "role": role,
                "signal": "planned",
                "value": 0.0,
                "target": 0.0,
                "n_before": n_live,
                "n_after": n_live - 1,
                "reaction_s": 0.0,
                "reason": (
                    f"{self.cfg.shrink_after_clear} clear windows, "
                    f"pool>{lo}"
                ),
            }
        return None

    # ---- apply ------------------------------------------------------------

    def _version(self, d: Dict) -> int:
        """Version the decision through whichever master plane is
        bound; a standalone fleet versions locally (version stays 0 in
        the record, matching the reshard directive convention)."""
        if self.job_manager is not None:
            return self.job_manager.plan_serving_scale(
                d["role"], d["n_after"], reason=d["reason"]
            )
        if self.master_client is not None:
            self.master_client.report_serving_scale(
                d["role"], d["direction"], d["n_before"], d["n_after"],
                signal=d["signal"], reason=d["reason"],
            )
            return self.master_client.get_serving_scale(
                d["role"]
            ).version
        self._local_version += 1
        return 0

    def _pick_victim(self, role: str):
        """Least-loaded live member of the pool: fewest occupied slots,
        queue depth as tiebreak — evacuating it moves the fewest pages."""
        pool = self.router.live_replicas(
            None if role == "unified" else role
        )
        if len(pool) < 2:
            return None
        return min(
            pool,
            key=lambda r: (
                sum(s is not None for s in r.server.engine.slots),
                r.server.scheduler.queue_depth(),
            ),
        )

    def apply(self, decision: Dict) -> Optional[ScaleDecisionRecord]:
        """Execute one ``evaluate()`` decision against the live fleet
        and publish its ScaleDecisionRecord. Clear decisions are
        telemetry-only; out/in mutate the router."""
        role = decision["role"]
        replica_name = ""
        now = self._clock()
        if decision["direction"] == "out":
            if self.provision_fn is None:
                logger.warning(
                    "scale-out wanted for %s pool but no provision_fn "
                    "bound — decision recorded, fleet unchanged", role,
                )
            else:
                rep = self.provision_fn(role)
                self.router.add_replica(rep)
                replica_name = rep.name
            self._last_decision_t[role] = now
            self.last_reaction_s = decision["reaction_s"]
        elif decision["direction"] == "in":
            victim = self._pick_victim(role)
            if victim is None:
                return None  # pool shrank under us: nothing to drain
            self.router.remove_replica(victim, reason="autoscale")
            if self.decommission_fn is not None:
                self.decommission_fn(victim)
            replica_name = victim.name
            self._last_decision_t[role] = now
        version = (
            self._version(decision) if decision["direction"] else 0
        )
        rec = ScaleDecisionRecord(
            role=role,
            direction=decision["direction"],
            signal=decision["signal"],
            value=float(decision["value"]),
            target=float(decision["target"]),
            n_before=int(decision["n_before"]),
            n_after=int(decision["n_after"]),
            version=version,
            reaction_s=float(decision["reaction_s"]),
            replica=replica_name,
            reason=decision["reason"],
            ts=time.time(),
        )
        self.decisions.append(rec)
        if self.hub is not None and getattr(self.hub, "enabled", True):
            self.hub.publish(rec)
        logger.info(
            "serving autoscale v%d: %s %s pool %d→%d (%s)",
            version, decision["direction"] or "clear", role,
            decision["n_before"], decision["n_after"], decision["reason"],
        )
        return rec

    def step(self) -> Optional[ScaleDecisionRecord]:
        decision = self.evaluate()
        if decision is None:
            return None
        return self.apply(decision)
