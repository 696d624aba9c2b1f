"""Live resharding of ZeRO state across a dp-size change.

Port of ``dlrover_tpu/elastic/resharding.py`` (reference: ElaWave-style
elastic-native failover, arxiv 2510.00606): on a membership change,
re-plan the dp group and migrate sharded state between the ranks
instead of restarting from a checkpoint. The wire format is the
``PackPlan`` flat bucket layout (``parallel/sharding.py``): optimizer
state lives on flat leaves of global shape ``(n_buckets, bucket_elems)``
of which rank ``r`` holds columns ``[r*S, (r+1)*S)`` of every bucket,
``S = bucket_elems / dp``. Bucket geometry *changes* with dp
(``bucket_elems`` is aligned to ``dp * BLOCK``), so resharding
translates through canonical flat-stream coordinates: canonical coord
``c < total`` lives at bucket ``c // E``, column ``c % E``; everything
at and beyond ``total`` is tail padding.

Padding correctness: AdamW on a zero-padded region stays identically zero
(grad 0 → mu = nu = 0 → update 0; param 0 → weight-decay term 0), so
migrating only the canonical ``[0, total)`` stream and zero-filling the
new plan's padding is bitwise-exact.

``shard_intervals``, ``donation_plan`` and ``reshard_flat`` are the JAX
module's numpy functions. ``migrate_flat`` runs over
``torch.distributed``: the JAX function moves a global array's columns
in one process, here each rank holds only its own columns, so every
``(src, dst)`` donation of the plan is a point-to-point message from
the old dp rank's process to the new one's (a local copy when they are
one process); the departing ranks donate and receive nothing. The
parameters are whole on every rank and need no move.

The :class:`LiveResharder` runs the failover phases
(detect / replan / migrate / rebuild / first_step) under per-phase
deadline budgets with retry/backoff on retryable faults, emitting one
``failover.reshard_<phase>`` trace span + ``ElasticEvent`` per phase and a
final ``reshard_recovery`` event, and degrades to a caller-supplied
fallback (the checkpoint tier ladder) instead of hanging.
"""

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.elastic.faults import (
    FaultInjector,
    InjectedKill,
    TornDonation,
)
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.parallel.collectives import _host, _staged
from dlrover_tpu_torch.parallel.sharding import PackPlan

logger = get_logger(__name__)

Interval = Tuple[int, int]


class MigrationError(RuntimeError):
    """Live migration cannot complete (e.g. a dead donor held the only
    copy of a shard); not retryable — fall back to the checkpoint tiers."""


class PhaseDeadlineExceeded(RuntimeError):
    def __init__(self, phase: str, budget_s: float, elapsed_s: float):
        super().__init__(
            f"failover phase {phase!r} exceeded its {budget_s:.1f}s budget "
            f"(took {elapsed_s:.1f}s)"
        )
        self.phase = phase
        self.budget_s = budget_s
        self.elapsed_s = elapsed_s


# ---------------------------------------------------------------- intervals


def shard_intervals(plan: PackPlan, rank: int) -> List[Interval]:
    """Canonical-coordinate intervals held by ``rank`` under ``plan``.

    One interval per bucket, clipped to ``plan.total`` (tail padding is
    not part of the canonical stream); empty intervals dropped.
    """
    if not 0 <= rank < plan.dp:
        raise ValueError(f"rank {rank} out of range for dp={plan.dp}")
    E = plan.bucket_elems
    S = E // plan.dp
    out: List[Interval] = []
    for i in range(plan.n_buckets):
        a = i * E + rank * S
        b = min(a + S, plan.total)
        if a < b:
            out.append((a, b))
    return out


def donation_plan(
    old_plan: PackPlan, new_plan: PackPlan
) -> Dict[Tuple[int, int], List[Interval]]:
    """Pairwise ``(src_rank, dst_rank) -> canonical intervals`` to move.

    Each interval is the intersection of one old-rank slice with one
    new-rank slice, so it lies within a single bucket of *both* plans.
    """
    if old_plan.total != new_plan.total:
        raise ValueError(
            "plans describe different parameter streams: "
            f"{old_plan.total} vs {new_plan.total} canonical elements"
        )
    new_iv = [shard_intervals(new_plan, d) for d in range(new_plan.dp)]
    out: Dict[Tuple[int, int], List[Interval]] = {}
    for src in range(old_plan.dp):
        for a, b in shard_intervals(old_plan, src):
            for dst in range(new_plan.dp):
                for c, d in new_iv[dst]:
                    lo, hi = max(a, c), min(b, d)
                    if lo < hi:
                        out.setdefault((src, dst), []).append((lo, hi))
    for ivs in out.values():
        ivs.sort()
    return out


# ---------------------------------------------------------------- migration


def reshard_flat(flat, old_plan: PackPlan, new_plan: PackPlan):
    """Reference path: repack a whole flat ``(nb, E)`` leaf (a numpy
    array or a tensor; the same kind back) straight through the canonical
    stream (no per-rank donation machinery)."""
    shape = tuple(flat.shape)
    if shape != (old_plan.n_buckets, old_plan.bucket_elems):
        raise ValueError(
            f"flat leaf shape {shape} does not match old plan "
            f"({old_plan.n_buckets}, {old_plan.bucket_elems})"
        )
    if isinstance(flat, torch.Tensor):
        out = torch.zeros(new_plan.padded, dtype=flat.dtype,
                          device=flat.device)
    else:
        flat = np.asarray(flat)
        out = np.zeros(new_plan.padded, dtype=flat.dtype)
    out[: new_plan.total] = flat.reshape(-1)[: old_plan.total]
    return out.reshape(new_plan.n_buckets, new_plan.bucket_elems)


def _check_plans(old_plan: PackPlan, new_plan: PackPlan) -> None:
    """Plans spanning a hybrid mesh (``mesh_axes`` beyond ``("dp",)``)
    are REFUSED: the donation plan maps flat intervals between dp shards
    only, so a stream whose offsets mean something else would migrate
    silently wrong. :class:`MigrationError` sends :class:`LiveResharder`
    down the checkpoint-tier fallback."""
    for which, plan in (("old", old_plan), ("new", new_plan)):
        axes = getattr(plan, "mesh_axes", ("dp",))
        if tuple(axes) != ("dp",):
            raise MigrationError(
                f"live donation refused: {which} PackPlan spans mesh axes "
                f"{tuple(axes)}; in-HBM donation is only defined over a "
                f"pure-dp mesh — fall back to the checkpoint ladder"
            )


def migrate_flat(
    leaves: Dict[str, torch.Tensor],
    old_plan: PackPlan,
    new_plan: PackPlan,
    old_ranks: Sequence[int],
    new_ranks: Sequence[int],
    faults: Optional[FaultInjector] = None,
    dead_ranks: Sequence[int] = (),
) -> Optional[Dict[str, torch.Tensor]]:
    """Donation path over ``torch.distributed``: move this rank's columns
    of each flat leaf (``{name: [old nb, old S]}``) from the old to the
    new layout. ``old_ranks[i]`` / ``new_ranks[j]`` are the global ranks
    of old dp rank i and new dp rank j; every rank of ``old_ranks`` calls
    this together. Returns this rank's new columns (``{name: [new nb,
    new S]}``), or None on a departing rank (it only donates).

    ``dead_ranks`` are old dp ranks whose device memory is gone (hard
    kill): any donation sourced from one raises :class:`MigrationError`
    on every caller, before any message moves — the shard is
    unrecoverable live and the caller must fall back to the checkpoint
    tiers. Every caller visits the ``"donation"`` injection point of
    every pair of the plan in the same order, so an injected
    :class:`TornDonation` (retryable) fires on all ranks alike.
    """
    plan = sorted(donation_plan(old_plan, new_plan).items())
    dead = frozenset(dead_ranks)
    for (src, _), intervals in plan:
        if src in dead:
            raise MigrationError(
                f"donor dp rank {src} is dead; canonical intervals "
                f"{intervals} are unrecoverable from survivors' HBM"
            )
    if faults is not None:
        for (src, _), _ in plan:
            faults.at("donation", rank=src)
    me = dist.get_rank()
    names = sorted(leaves)
    E_old, E_new = old_plan.bucket_elems, new_plan.bucket_elems
    S_old = E_old // old_plan.dp
    S_new = E_new // new_plan.dp
    for name in names:
        if tuple(leaves[name].shape) != (old_plan.n_buckets, S_old):
            raise ValueError(
                f"{name}: shard shape {tuple(leaves[name].shape)} does not "
                f"match old plan ({old_plan.n_buckets}, {S_old})")
    mine = me in new_ranks
    out = {n: torch.zeros((new_plan.n_buckets, S_new),
                          dtype=leaves[n].dtype, device=leaves[n].device)
           for n in names} if mine else None

    def pieces(intervals, src, dst):
        for a, b in intervals:
            i_old, col_src = divmod(a, E_old)
            i_new, col_dst = divmod(a, E_new)
            yield (i_old, col_src - src * S_old, i_new, col_dst - dst * S_new,
                   b - a)

    def gather(name, intervals, src, dst):
        return torch.cat([leaves[name][i, c: c + n]
                          for i, c, _, _, n in pieces(intervals, src, dst)])

    def scatter(name, buf, intervals, src, dst):
        at = 0
        for _, _, i, c, n in pieces(intervals, src, dst):
            out[name][i, c: c + n] = buf[at: at + n]
            at += n

    ops, landing = [], []
    for (src, dst), intervals in plan:
        s_rank, d_rank = old_ranks[src], new_ranks[dst]
        for tag, name in enumerate(names):
            if s_rank == me and d_rank == me:
                scatter(name, gather(name, intervals, src, dst), intervals,
                        src, dst)
            elif s_rank == me:
                buf = gather(name, intervals, src, dst)
                if _staged(None, buf):
                    buf = _host(buf)
                ops.append(dist.P2POp(dist.isend, buf, d_rank, tag=tag))
            elif d_rank == me:
                t = leaves[name]
                n = sum(b - a for a, b in intervals)
                staged = _staged(None, t)
                buf = torch.empty(n, dtype=t.dtype,
                                  device="cpu" if staged else t.device,
                                  pin_memory=staged)
                ops.append(dist.P2POp(dist.irecv, buf, s_rank, tag=tag))
                landing.append((name, buf, intervals, src, dst))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for name, buf, intervals, src, dst in landing:
        scatter(name, buf.to(out[name].device), intervals, src, dst)
    return out


def reshard_train_state(
    state: Dict,
    old_plan: PackPlan,
    new_plan: PackPlan,
    old_ranks: Sequence[int],
    new_ranks: Sequence[int],
    faults: Optional[FaultInjector] = None,
    dead_ranks: Sequence[int] = (),
) -> Optional[Dict]:
    """Move an update-sharded train state onto the new plan: the flat
    moments (``opt_state["m"]["flat"]``, ``opt_state["v"]["flat"]``)
    migrate through :func:`migrate_flat`; the parameters (whole on every
    rank), the counts and the step stay. Returns the survivor's new state
    (the same parameters), None on a departing rank. Plans spanning a
    hybrid mesh are refused with :class:`MigrationError`."""
    _check_plans(old_plan, new_plan)
    opt = state["opt_state"]
    moved = migrate_flat({"m": opt["m"]["flat"], "v": opt["v"]["flat"]},
                         old_plan, new_plan, old_ranks, new_ranks,
                         faults=faults, dead_ranks=dead_ranks)
    if moved is None:
        return None
    new_opt = dict(opt, m={"flat": moved["m"]}, v={"flat": moved["v"]})
    return dict(state, opt_state=new_opt)


# ------------------------------------------------------------ phase machine


@dataclass
class PhaseBudgets:
    """Per-phase deadline budgets (seconds) for the failover state machine:
    the training ladder's detect/replan/migrate/rebuild/first_step, the
    serving page migrator's detect/plan/reserve/transfer/resume
    (``serving/migration.py``), and the fallback. Unknown phase names
    get 60 s."""

    detect_s: float = 15.0
    replan_s: float = 15.0
    migrate_s: float = 60.0
    rebuild_s: float = 120.0
    first_step_s: float = 120.0
    fallback_s: float = 300.0
    # serving-migration phases
    plan_s: float = 15.0
    reserve_s: float = 20.0
    transfer_s: float = 60.0
    resume_s: float = 60.0

    def for_phase(self, name: str) -> float:
        return float(getattr(self, f"{name}_s", 60.0))


@dataclass
class ReshardOutcome:
    ok: bool
    path: str  # "live" | "fallback"
    phase_seconds: Dict[str, float]
    recovery_s: float
    result: Any = None
    failed_phase: str = ""
    reason: str = ""


class LiveResharder:
    """Runs failover phases under budgets; degrades to a fallback.

    ``execute`` threads each phase's return value into the next phase's
    callable. Retryable faults (:class:`TornDonation` by default) are
    retried with jittered exponential backoff inside the phase budget;
    anything else — including :class:`MigrationError` and a blown
    deadline — aborts the live path and runs ``fallback(exc)`` (the
    checkpoint tier ladder) instead of hanging.
    """

    def __init__(
        self,
        budgets: Optional[PhaseBudgets] = None,
        faults: Optional[FaultInjector] = None,
        retries: int = 2,
        backoff_base_s: float = 0.2,
        backoff_cap_s: float = 5.0,
        retryable: Tuple[type, ...] = (TornDonation,),
    ):
        self.budgets = budgets or PhaseBudgets()
        self.faults = faults
        self.retries = retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.retryable = retryable

    def _run_phase(
        self, name: str, fn: Callable[[Any], Any], prev: Any
    ) -> Tuple[Any, float]:
        budget = self.budgets.for_phase(name)
        span = get_tracer().span(f"failover.reshard_{name}", budget_s=budget)
        t0 = time.monotonic()
        ok = False
        attempt = 0
        err = ""
        try:
            while True:
                try:
                    out = fn(prev)
                    break
                except self.retryable as e:
                    attempt += 1
                    elapsed = time.monotonic() - t0
                    if attempt > self.retries or elapsed >= budget:
                        raise
                    delay = min(
                        self.backoff_cap_s,
                        self.backoff_base_s * 2 ** (attempt - 1),
                    ) * random.uniform(0.5, 1.0)
                    delay = min(delay, max(0.0, budget - elapsed))
                    logger.warning(
                        "phase %s attempt %d failed (%s); retrying in %.2fs",
                        name,
                        attempt,
                        e,
                        delay,
                    )
                    time.sleep(delay)
            elapsed = time.monotonic() - t0
            if elapsed > budget:
                raise PhaseDeadlineExceeded(name, budget, elapsed)
            ok = True
            return out, elapsed
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            span.end(ok=ok, retries=attempt)
            # clock the event off the monotonic phase window, not the
            # span (the tracer may be disabled and its NullSpan reports 0)
            secs = time.monotonic() - t0
            hub = telemetry.get_hub()
            if hub.enabled:
                hub.publish(
                    telemetry.ElasticEvent(
                        kind=f"reshard_{name}",
                        seconds=secs,
                        detail=f"ok={ok} retries={attempt}"
                        + (f" err={err}" if err else ""),
                    )
                )

    def execute(
        self,
        phases: Sequence[Tuple[str, Callable[[Any], Any]]],
        fallback: Optional[Callable[[BaseException], Any]] = None,
    ) -> ReshardOutcome:
        phase_seconds: Dict[str, float] = {}
        t0 = time.monotonic()
        prev: Any = None
        outcome: Optional[ReshardOutcome] = None
        current = ""
        try:
            for name, fn in phases:
                current = name
                prev, secs = self._run_phase(name, fn, prev)
                phase_seconds[name] = secs
            outcome = ReshardOutcome(
                ok=True,
                path="live",
                phase_seconds=phase_seconds,
                recovery_s=time.monotonic() - t0,
                result=prev,
            )
        except InjectedKill:
            raise  # process death: nothing to degrade to in this process
        except Exception as e:
            reason = f"{type(e).__name__}: {e}"
            failed = getattr(e, "phase", "") or current
            logger.error(
                "live reshard failed (%s); degrading to fallback tier", reason
            )
            if fallback is None:
                raise
            prev, secs = self._run_phase("fallback", lambda _: fallback(e), None)
            phase_seconds["fallback"] = secs
            outcome = ReshardOutcome(
                ok=True,
                path="fallback",
                phase_seconds=phase_seconds,
                recovery_s=time.monotonic() - t0,
                result=prev,
                failed_phase=failed,
                reason=reason,
            )
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(
                telemetry.ElasticEvent(
                    kind="reshard_recovery",
                    seconds=outcome.recovery_s,
                    detail=f"path={outcome.path}"
                    + (f" reason={outcome.reason}" if outcome.reason else ""),
                )
            )
        return outcome
