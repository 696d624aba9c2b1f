"""Offline health diagnosis: replay a flight-recorder file into a report.

Port of ``dlrover_tpu/observability/healthcheck.py``. Usage::

    python -m dlrover_tpu_torch.observability.healthcheck <telemetry.jsonl>

The input is any ``JsonlSink`` output (a worker's telemetry file, or the
master's): one ``to_json`` envelope per line. The replay tolerates torn
tails and foreign lines — a run that died mid-write still diagnoses.
AnomalyRecords are re-correlated through the ``HealthAggregator`` the
live master runs (recorded HealthSummary lines take precedence), so the
verdict offline is the verdict the master reached online.

The port replays the record types it has: the steps, the training and
serving anomalies, the numeric and elastic events, the summaries, the
serving replicas' ``ServingRecord`` windows (per replica, per role,
and the fleet's percentiles merged from their histograms), the serving
autoscaler's ``ScaleDecisionRecord`` trail and the Brain's tuning
decisions (``TuningPlan`` lines: the cold-start plan, then each
versioned revision with its signal and knob; ``cluster/brain.py`` is
imported so its records replay). The JAX report's sparse-serving
section waits for the sparse tier's workers (ROADMAP A18).
"""

import argparse
import json
import sys
from collections import Counter
from typing import Dict, List, Optional

import dlrover_tpu_torch.cluster.brain  # noqa: F401 — registers TuningPlan/JobMetrics for replay
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.histogram import (
    LatencyHistogram,
    merge_histograms,
)
from dlrover_tpu_torch.observability.watchdog import HealthAggregator


def load_records(path: str) -> List:
    """Rehydrate every parseable record; skip torn/foreign lines."""
    out: List = []
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(telemetry.from_json(line))
            except (json.JSONDecodeError, KeyError, TypeError):
                continue  # torn tail / unknown type / foreign line
    return out


def diagnose(records: List, world: int = 0) -> Dict:
    """Correlate a record stream into a diagnosis dict.

    Keys: ``world``, ``steps`` (count / last step / last loss),
    ``anomalies`` (per kind: first bad step, failing ranks, verdict,
    captures), ``numeric_events``, ``elastic_events``, ``summaries``
    (recorded HealthSummary lines), ``serving``, ``scale_decisions``,
    ``tuning``, ``healthy``.
    """
    by_type: Dict[str, List] = {}
    for rec in records:
        by_type.setdefault(type(rec).__name__, []).append(rec)

    # infer the world size when not given: distinct ranks seen anywhere
    ranks_seen = {
        r.node_id
        for r in by_type.get("AnomalyRecord", [])
        + by_type.get("ResourceRecord", [])
        if getattr(r, "node_id", -1) >= 0
    }
    world = world or len(ranks_seen)

    # replay the live master's correlation over the anomaly stream
    agg = HealthAggregator(world=world)
    for rec in sorted(by_type.get("AnomalyRecord", []),
                      key=lambda r: r.step):
        agg._on_record(rec)
    replayed = dict(agg.summaries)
    # recorded summaries (the master's own verdicts) take precedence
    for s in by_type.get("HealthSummary", []):
        replayed[s.kind] = s

    anomalies: Dict[str, Dict] = {}
    for kind in sorted({r.kind for r in by_type.get("AnomalyRecord", [])}):
        recs = [r for r in by_type["AnomalyRecord"] if r.kind == kind]
        first = min(recs, key=lambda r: r.step)
        summary = replayed.get(kind)
        anomalies[kind] = {
            "count": len(recs),
            "first_step": first.step,
            "failing_ranks": sorted({r.node_id for r in recs}),
            "verdict": summary.verdict if summary else "",
            "captures": sorted({r.capture for r in recs if r.capture}),
            "detail": first.detail,
            "replicas": sorted({r.replica for r in recs if r.replica}),
        }

    serving = _serving_section(by_type)
    scale_decisions = _scale_section(by_type)
    tuning = _tuning_section(by_type)

    steps = by_type.get("StepRecord", [])
    step_info = {}
    if steps:
        last = max(steps, key=lambda r: r.step)
        step_info = {"count": len(steps), "last_step": last.step,
                     "last_loss": last.loss}

    return {
        "world": world,
        "steps": step_info,
        "anomalies": anomalies,
        "numeric_events": [
            {"kind": e.kind, "step": e.step, "value": e.value,
             "detail": e.detail}
            for e in by_type.get("NumericEvent", [])
        ],
        "elastic_events": Counter(
            e.kind for e in by_type.get("ElasticEvent", [])),
        "summaries": [
            {"kind": s.kind, "first_step": s.first_step, "ranks": s.ranks,
             "verdict": s.verdict}
            for s in by_type.get("HealthSummary", [])
        ],
        "serving": serving,
        "scale_decisions": scale_decisions,
        "tuning": tuning,
        "healthy": not anomalies,
    }


def _tuning_section(by_type: Dict[str, List]) -> Dict:
    """Replay ``TuningPlan`` lines into why the job runs at its current
    knobs: the cold-start plan, then every versioned revision with the
    signal that triggered it and the knob it moved. A recording with no
    such lines replays as ``{}``: no tuning decisions, not an error."""
    recs = by_type.get("TuningPlan", [])
    if not recs:
        return {}
    trail = []
    knobs_moved: Counter = Counter()
    for r in recs:  # file order == write order
        trail.append({
            "version": r.version,
            "origin": r.origin,
            "signal": r.signal,
            "knob": r.knob,
            "reason": r.reason,
        })
        if r.knob:
            knobs_moved[r.knob] += 1
    return {
        "decisions": trail,
        "n_revisions": sum(1 for d in trail if d["origin"] == "revision"),
        "knobs_moved": dict(knobs_moved),
    }


def _scale_section(by_type: Dict[str, List]) -> Dict:
    """Replay ``ScaleDecisionRecord`` lines into WHY the fleet is its
    current size: the full decision trail in write order, per-role
    final pool sizes, and the worst observed reaction time. Recordings
    that predate autoscaling contain no such lines and replay as
    ``{}`` — absence means "no decisions", not an error."""
    recs = by_type.get("ScaleDecisionRecord", [])
    if not recs:
        return {}
    trail = []
    final_size: Dict[str, int] = {}
    worst_reaction = 0.0
    for r in recs:  # file order == write order
        trail.append({
            "role": r.role,
            "direction": r.direction,
            "signal": r.signal,
            "value": r.value,
            "target": r.target,
            "n_before": r.n_before,
            "n_after": r.n_after,
            "version": r.version,
            "reaction_s": r.reaction_s,
            "replica": r.replica,
            "reason": r.reason,
        })
        if r.direction:  # clear records don't resize the pool
            final_size[r.role] = r.n_after
        worst_reaction = max(worst_reaction, r.reaction_s)
    return {
        "decisions": trail,
        "n_scaled": sum(1 for d in trail if d["direction"]),
        "final_size": final_size,
        "worst_reaction_s": worst_reaction,
    }


def _serving_section(by_type: Dict[str, List]) -> Dict:
    """Roll ServingRecord lines into per-replica windows + fleet
    percentiles.

    The LAST record per replica wins (counters are lifetime, the
    percentiles describe the latest window). Fleet percentiles are
    merged from each replica's recorded ``hists`` envelope — exact
    bucket-count addition, never averaging of per-replica percentiles.
    """
    recs = by_type.get("ServingRecord", [])
    if not recs:
        return {}
    latest: Dict[str, object] = {}
    for rec in recs:  # file order == write order; last one wins
        latest[rec.replica] = rec
    replicas = {}
    for name in sorted(latest):
        r = latest[name]
        dropped = r.shed + r.rejected + r.timed_out + r.poisoned
        replicas[name] = {
            "completed": r.completed,
            "admitted": r.admitted,
            "dropped": dropped,
            "p99_ms": r.p99_ms,
            "ttft_p99_ms": r.ttft_p99_ms,
            "tpot_p99_ms": r.tpot_p99_ms,
            "queue_wait_p99_ms": r.queue_wait_p99_ms,
            "tokens_per_s": r.tokens_per_s,
            # pre-disaggregation recordings replay via the dataclass
            # defaults: role "unified", zero handoffs
            "role": getattr(r, "role", "unified") or "unified",
            "handoffs_in": getattr(r, "handoffs_in", 0),
            "handoffs_out": getattr(r, "handoffs_out", 0),
            "handoff_ms_p99": getattr(r, "handoff_ms_p99", 0.0),
        }
    roles: Dict[str, Dict] = {}
    for info in replicas.values():
        agg = roles.setdefault(info["role"], {
            "replicas": 0,
            "ttft_p99_ms": 0.0,
            "tpot_p99_ms": 0.0,
            "p99_ms": 0.0,
            "handoff_ms_p99": 0.0,
        })
        agg["replicas"] += 1
        for k in ("ttft_p99_ms", "tpot_p99_ms", "p99_ms", "handoff_ms_p99"):
            agg[k] = max(agg[k], info[k])
    fleet = {}
    try:
        per_phase: Dict[str, List] = {}
        for r in latest.values():
            if not r.hists:
                continue
            for phase, env in json.loads(r.hists).items():
                per_phase.setdefault(phase, []).append(
                    LatencyHistogram.from_dict(env)
                )
        for phase, hists in sorted(per_phase.items()):
            merged = merge_histograms(hists)
            if merged is not None and merged.n:
                fleet[phase] = merged.summary()
    except (json.JSONDecodeError, KeyError, TypeError, ValueError):
        pass  # torn/foreign envelope: per-replica view still stands
    return {"replicas": replicas, "fleet": fleet, "roles": roles}


def _slow_role(serving: Dict, kind: str) -> str:
    """On a latency breach in a DISAGGREGATED fleet, name the pool to
    look at: the split decouples the axes, so a TTFT breach points at
    the worst-TTFT role (prefill pool undersized / handoff stalled)
    and an e2e/TPOT breach at the worst-pace role. Empty when the
    fleet has fewer than two roles — there is nothing to choose."""
    roles = serving.get("roles") or {}
    if len(roles) < 2:
        return ""
    metric = "ttft_p99_ms" if kind == "ttft_regression" else "tpot_p99_ms"
    if all(info[metric] <= 0.0 for info in roles.values()):
        metric = "p99_ms"
    return max(roles, key=lambda role: roles[role][metric])


def format_report(diag: Dict) -> str:
    """Human-readable diagnosis (the CLI's stdout)."""
    lines = ["== dlrover-tpu healthcheck =="]
    if diag["steps"]:
        lines.append(
            "run: {count} steps recorded, last step {last_step} "
            "(loss {last_loss:.4f})".format(**diag["steps"]))
    lines.append(f"world: {diag['world'] or 'unknown'} rank(s)")
    serving = diag.get("serving") or {}
    if serving:
        lines.append("")
        lines.append("serving replicas:")
        for name, info in serving["replicas"].items():
            role = info.get("role", "unified")
            role_tag = f" [{role}]" if role != "unified" else ""
            handoff = ""
            if info.get("handoffs_in") or info.get("handoffs_out"):
                handoff = (f"; handoffs in/out {info['handoffs_in']}/"
                           f"{info['handoffs_out']} "
                           f"(p99 {info['handoff_ms_p99']:.1f}ms)")
            lines.append(
                f"  {name}{role_tag}: completed {info['completed']}/"
                f"{info['admitted']} admitted, dropped {info['dropped']}; "
                f"p99 {info['p99_ms']:.1f}ms "
                f"ttft_p99 {info['ttft_p99_ms']:.1f}ms{handoff}")
        roles = serving.get("roles") or {}
        if len(roles) > 1:
            lines.append("  roles: " + ", ".join(
                f"{role}×{info['replicas']} "
                f"(ttft_p99 {info['ttft_p99_ms']:.1f}ms "
                f"tpot_p99 {info['tpot_p99_ms']:.1f}ms)"
                for role, info in sorted(roles.items())))
        for phase, sm in serving.get("fleet", {}).items():
            lines.append(f"  fleet {phase}: p50 {sm['p50']:.1f}ms "
                         f"p99 {sm['p99']:.1f}ms (n={sm['n']})")
    scale = diag.get("scale_decisions") or {}
    if scale:
        lines.append("")
        lines.append(
            f"autoscale: {scale['n_scaled']} scale decision(s), "
            f"worst reaction {scale['worst_reaction_s']:.2f}s")
        for role, n in sorted(scale["final_size"].items()):
            lines.append(f"  {role} pool: {n} replica(s) final")
        for d in scale["decisions"][:20]:
            arrow = d["direction"] or "clear"
            who = f" [{d['replica']}]" if d["replica"] else ""
            lines.append(
                f"  v{d['version']} {arrow} {d['role']} "
                f"{d['n_before']}→{d['n_after']}: {d['signal']} "
                f"({d['reason']}){who}")
    tuning = diag.get("tuning") or {}
    if tuning:
        lines.append("")
        lines.append(
            f"brain tuning: {tuning['n_revisions']} revision(s) after "
            "cold start")
        if tuning["knobs_moved"]:
            lines.append("  knobs moved: " + ", ".join(
                f"{k}×{n}" for k, n in sorted(tuning["knobs_moved"].items())))
        for d in tuning["decisions"][:20]:
            what = d["knob"] or d["origin"]
            why = d["signal"] or d["reason"] or d["origin"]
            lines.append(f"  v{d['version']} {what}: {why}")
    if diag["healthy"]:
        lines.append("no anomalies recorded — run looks healthy")
        return "\n".join(lines)
    lines.append("")
    for kind, info in diag["anomalies"].items():
        ranks = ",".join(str(r) for r in info["failing_ranks"])
        lines.append(
            f"[{kind}] {info['count']} record(s); "
            f"first bad step {info['first_step']}; "
            f"failing rank(s) {ranks}")
        if info.get("replicas"):
            lines.append("  breaching replica(s): "
                         + ",".join(info["replicas"]))
        if kind in ("ttft_regression", "slo_breach"):
            slow = _slow_role(serving, kind)
            if slow:
                lines.append(f"  slow role: {slow}")
        if info["verdict"]:
            lines.append(f"  verdict: {info['verdict']}")
        if info["detail"]:
            lines.append(f"  detail: {info['detail']}")
        for cap in info["captures"]:
            lines.append(f"  capture: {cap}")
    if diag["numeric_events"]:
        lines.append("")
        lines.append("numeric events:")
        for e in diag["numeric_events"][:20]:
            tail = f" [{e['detail']}]" if e["detail"] else ""
            lines.append(f"  step {e['step']}: {e['kind']} "
                         f"value={e['value']:.4f}{tail}")
    if diag["elastic_events"]:
        lines.append("")
        lines.append("elastic events: " + ", ".join(
            f"{k}×{n}" for k, n in sorted(diag["elastic_events"].items())))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dlrover_tpu_torch.observability.healthcheck",
        description="Replay a flight-recorder jsonl into a health "
        "diagnosis")
    parser.add_argument("path", help="flight-recorder .jsonl file")
    parser.add_argument(
        "--world", type=int, default=0,
        help="world size (ranks); inferred from the records when 0")
    parser.add_argument(
        "--json", action="store_true",
        help="emit the raw diagnosis dict as JSON instead of text")
    ns = parser.parse_args(argv)
    diag = diagnose(load_records(ns.path), world=ns.world)
    if ns.json:
        diag = dict(diag, elastic_events=dict(diag["elastic_events"]))
        print(json.dumps(diag, indent=2))
    else:
        print(format_report(diag))
    return 0 if diag["healthy"] else 1


if __name__ == "__main__":
    sys.exit(main())
