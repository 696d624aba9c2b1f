"""Offline health diagnosis: replay a flight-recorder file into a report.

Port of ``dlrover_tpu/observability/healthcheck.py``. Usage::

    python -m dlrover_tpu_torch.observability.healthcheck <telemetry.jsonl>

The input is any ``JsonlSink`` output (a worker's telemetry file, or the
master's): one ``to_json`` envelope per line. The replay tolerates torn
tails and foreign lines — a run that died mid-write still diagnoses.
AnomalyRecords are re-correlated through the ``HealthAggregator`` the
live master runs (recorded HealthSummary lines take precedence), so the
verdict offline is the verdict the master reached online.

The port replays the record types it has: the steps, the training
anomalies, the numeric and elastic events, the summaries and the Brain's
tuning decisions (``TuningPlan`` lines: the cold-start plan, then each
versioned revision with its signal and knob; ``cluster/brain.py`` is
imported so its records replay). The JAX report's serving and scale
sections wait for the rest of the serving tier (ROADMAP A15), its
sparse-serving section for the sparse tier's workers (A18).
"""

import argparse
import json
import sys
from collections import Counter
from typing import Dict, List, Optional

import dlrover_tpu_torch.cluster.brain  # noqa: F401 — registers TuningPlan/JobMetrics for replay
from dlrover_tpu_torch.observability import telemetry
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
    (recorded HealthSummary lines), ``healthy``.
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


def format_report(diag: Dict) -> str:
    """Human-readable diagnosis (the CLI's stdout)."""
    lines = ["== dlrover-tpu healthcheck =="]
    if diag["steps"]:
        lines.append(
            "run: {count} steps recorded, last step {last_step} "
            "(loss {last_loss:.4f})".format(**diag["steps"]))
    lines.append(f"world: {diag['world'] or 'unknown'} rank(s)")
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
