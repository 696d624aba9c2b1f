"""Elastic serving replicas: master registration + failover routing.

Port of ``dlrover_tpu/serving/replica.py``. A ``ServingReplica`` wraps one ``GenerationServer`` and, when given a
master address, registers with the job master EXACTLY like a trainer
node (``NodeType.SERVING``): same heartbeat/failure machinery, same KV
store for discovery (address published under
``serving_replica_addr_<name>``, as the JAX package does). The master's node manager lists them
via ``serving_nodes()`` without treating them as part of the train
rendezvous.

``ReplicaRouter`` is the client-side elastic story: round-robin
dispatch over live replicas, and on replica death (``poll``) every
in-flight request of the dead replica moves to a survivor — exactly
once, no lost and no duplicated requests. With a ``ServingMigrator`` attached the move is a LIVE KV-page
migration (serving/migration.py): the survivor adopts the victim's
pages and resumes mid-decode with zero re-prefilled prompt tokens and
the never-migrated stream. Without one — or when the migrator itself
degrades — requests are re-admitted under their original ticket and
re-prefill from the prompt.

Disaggregated fleets (serving/disagg.py): when the replica set carries
both ``prefill``- and ``decode``-role engines the router grows a
dispatch layer — new requests go to the least-loaded live prefill
replica and stream to the decode pool through a
:class:`~dlrover_tpu_torch.serving.disagg.HandoffCoordinator`; a request
whose prompt hits a prefix already RESIDENT on a decode replica's trie
skips the prefill fleet entirely (only the divergent suffix prefills
on the decode replica — the cross-replica placement residual of
the JAX package's design). Failover is role-aware: a dead prefill replica's
requests re-dispatch on the prefill pool (committed handoffs just
repoint), a dead decode replica's slots live-migrate to decode
survivors via the migration ladder, and when either pool empties the
fleet collapses to ``unified`` — a one-replica "fleet" therefore
silently runs today's engine. A decode-role replica is never handed a
raw un-prefilled request on re-admission (it would chunk-prefill it
and recreate the interference the split removed).
"""

import concurrent.futures
import json
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.comm import _backoff_delay
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.observability.histogram import merge_histograms
from dlrover_tpu_torch.serving import prefix as prefix_mod
from dlrover_tpu_torch.serving.disagg import HandoffCoordinator
from dlrover_tpu_torch.serving.scheduler import LATENCY_PHASES, Request
from dlrover_tpu_torch.serving.server import GenerationServer

logger = get_logger(__name__)

ADDR_KV_PREFIX = "serving_replica_addr_"


class ServingReplica:
    """One serving host: a GenerationServer plus master-plane plumbing.

    ``model`` is the ``models.decoder.Decoder`` the server runs: several
    replicas in one process may share one (read-only) model, each with
    its own pools. ``server_cls`` swaps the front end and keeps the
    registration path; ``server_kw`` passes through to it."""

    def __init__(
        self,
        name: str,
        model,
        cfg,
        *,
        master_addr: Optional[str] = None,
        node_id: int = 0,
        hub=None,
        server_cls: type = GenerationServer,
        **server_kw,
    ):
        self.name = name
        self.node_id = node_id
        self.master_addr = master_addr
        self.server = server_cls(
            model, cfg, hub=hub, replica=name, **server_kw
        )
        self._client = None

    @property
    def alive(self) -> bool:
        return self.server.alive

    @property
    def role(self) -> str:
        return self.server.role

    def start(self) -> "ServingReplica":
        self.server.start()
        if self.master_addr:
            self._client = MasterClient(
                self.master_addr, node_id=self.node_id
            )
            # role-tagged registration: the master's node manager keeps
            # the prefill and decode pools distinguishable so
            # plan_serving_reshard can scale them independently
            self._client.register_node(
                node_type=NodeType.SERVING, role=self.role
            )
            self._client.kv_store_set(
                ADDR_KV_PREFIX + self.name,
                json.dumps({
                    "name": self.name,
                    "node_id": self.node_id,
                    "role": self.role,
                }),
            )
        return self

    def stop(self) -> None:
        self.server.stop()
        if self._client is not None:
            self._client.report_node_status("exited", retries=1)
            self._client.close()
            self._client = None

    def kill(self) -> None:
        """Simulated host eviction: the serve loop halts, in-flight
        futures stay unresolved, and (unlike ``stop``) the master is
        NOT told about a clean exit — failure detection or the router's
        liveness poll must notice."""
        self.server.kill()
        if self._client is not None:
            self._client.close()
            self._client = None

    # convenience passthroughs
    def submit(self, *a, **kw) -> Request:
        return self.server.submit(*a, **kw)

    def generate(self, *a, **kw):
        return self.server.generate(*a, **kw)


def discover_replicas(client, names) -> Optional[Dict[str, dict]]:
    """Resolve replica names → registration payloads via the master KV
    store; None when any member hasn't registered yet (never adopt a
    partial set)."""
    out: Dict[str, dict] = {}
    for name in names:
        raw = client.kv_store_get(ADDR_KV_PREFIX + name)
        if not raw:
            logger.warning(
                "serving replica %s has no registration yet; deferring",
                name,
            )
            return None
        out[name] = json.loads(raw)
    return out


def refresh_discovery(client, names, known=None) -> Dict[str, dict]:
    """Incremental discovery for a LIVE fleet: resolve whichever of
    ``names`` have registered since ``known`` was built and return only
    the new entries (name → registration payload).

    ``discover_replicas`` enforces the all-or-nothing startup rule — a
    router must never adopt a partial initial set. Scale-out breaks
    that premise on purpose: the autoscaler launches replicas one at a
    time, and each becomes routable the moment its
    ``serving_replica_addr_<name>`` key lands, while the rest of the
    candidate roster stays pending without deferring anybody. Callers
    fold the result into their ``known`` map and call again on the
    next refresh tick."""
    known = known or {}
    out: Dict[str, dict] = {}
    for name in names:
        if name in known:
            continue
        raw = client.kv_store_get(ADDR_KV_PREFIX + name)
        if raw:
            out[name] = json.loads(raw)
    return out


class _Entry:
    """Router-side view of one request: which replica holds it and
    whether its result already landed."""

    __slots__ = ("req", "replica", "done")

    def __init__(self, req: Request, replica: ServingReplica):
        self.req = req
        self.replica = replica
        self.done = False


class ReplicaRouter:
    """Request router with exactly-once failover and, on a role-typed
    fleet, the prefill/decode dispatch layer.

    Requests fan out over live replicas (round-robin when unified;
    least-loaded-prefill or prefix-affinity-decode when disaggregated).
    ``poll`` detects dead replicas and moves their incomplete requests
    to survivors under the ORIGINAL admission ticket (the ``Request``
    object travels — its future resolves wherever the survivor finishes
    it). Completed entries are never resubmitted; ``Scheduler.complete``
    resolves each future at most once even if a race double-delivers.
    """

    def __init__(
        self,
        replicas: List[ServingReplica],
        migrator=None,
        watchdog=None,
        faults=None,
        streaming: bool = True,
    ):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self.migrator = migrator  # ServingMigrator or None (re-admit path)
        # optional ServingWatchdog: fed every MigrationReport so a run
        # of fallback outcomes classifies as ``migration_fallback``
        self.watchdog = watchdog
        self._entries: List[_Entry] = []
        self._by_rid: Dict[str, _Entry] = {}
        self._rr = 0
        # reentrant: the migrator's role-aware re_admit override runs
        # while poll already holds the lock, and must also work when a
        # drill drives the migrator directly with no lock held
        self._lock = threading.RLock()
        self.reports: List = []   # MigrationReports, drill introspection

        self.prefill_pool = [r for r in self.replicas if r.role == "prefill"]
        self.decode_pool = [r for r in self.replicas if r.role == "decode"]
        self.disaggregated = bool(self.prefill_pool) and bool(
            self.decode_pool
        )
        self.coordinator = None
        self._dead_seen: set = set()
        # replicas removed ON PURPOSE (scale-in): drained, detached from
        # every pool, and invisible to the failover sweep — a detached
        # replica's stopped loop must never read as a death and trigger
        # a spurious migration or a collapse-to-unified
        self._detached: set = set()
        if self.disaggregated:
            self.coordinator = HandoffCoordinator(
                self.prefill_pool,
                self.decode_pool,
                router=self,
                faults=faults,
                streaming=streaming,
            ).start()
            if self.migrator is not None:
                # the migrator's fallback must never hand a decode-only
                # survivor a raw un-prefilled request
                self.migrator.re_admit = self._role_aware_re_admit
        else:
            # one-sided or one-replica "fleet": silently run unified —
            # a lone prefill replica would park every prompt forever,
            # a lone decode replica would bounce every cold prompt
            for r in self.replicas:
                if r.role != "unified":
                    logger.warning(
                        "replica %s has role=%s but the fleet has no "
                        "%s counterpart — running unified",
                        r.name, r.role,
                        "decode" if r.role == "prefill" else "prefill",
                    )
                    r.server.engine.role = "unified"
            self.prefill_pool = []
            self.decode_pool = []

    # ---- fleet latency rollup -------------------------------------------

    def fleet_histograms(self) -> Dict:
        """Merge every replica's per-phase latency histograms
        bucket by bucket (observability/histogram.py) — dead replicas
        included, their schedulers outlive the serve loop. Because the
        bucket boundaries are fixed by geometry, the merged counts are
        IDENTICAL to histogramming the concatenated raw samples: fleet
        percentiles come from counts, never from averaging per-replica
        percentiles."""
        per = [r.server.scheduler.histograms() for r in self.replicas]
        out = {}
        for k in LATENCY_PHASES:
            merged = merge_histograms(p[k] for p in per)
            if merged is not None:
                out[k] = merged
        return out

    def fleet_latency_ms(self) -> dict:
        """Fleet end-to-end percentiles in the scheduler's
        ``{p50, p99, n}`` shape, from the merged histogram."""
        hists = self.fleet_histograms()
        if "e2e" not in hists:
            return {"p50": 0.0, "p99": 0.0, "n": 0}
        return hists["e2e"].summary()

    def _mark_done(self, entry: _Entry):
        def _cb(_future):
            entry.done = True

        return _cb

    def _live(self) -> List[ServingReplica]:
        return [
            r for r in self.replicas
            if r.alive and id(r) not in self._detached
        ]

    def live_replicas(self, role: Optional[str] = None) -> List[
        "ServingReplica"
    ]:
        """Routable replicas (live and not detached), optionally
        filtered to one role pool — the autoscaler's fleet view."""
        with self._lock:
            live = self._live()
        if role is None:
            return live
        return [r for r in live if r.role == role]

    def is_detached(self, replica: "ServingReplica") -> bool:
        with self._lock:
            return id(replica) in self._detached

    def submit(
        self, prompt, max_new_tokens: int, eos_id=None, priority: int = 0,
        sampling=None, deadline_s=None,
    ) -> Request:
        with self._lock:
            live = self._live()
            if not live:
                raise RuntimeError("no live serving replicas")
            if self.disaggregated:
                replica = self._dispatch_target(prompt)
            else:
                replica = live[self._rr % len(live)]
                self._rr += 1
            req = replica.submit(
                prompt, max_new_tokens, eos_id=eos_id, priority=priority,
                sampling=sampling, deadline_s=deadline_s,
            )
            entry = _Entry(req, replica)
            req.future.add_done_callback(self._mark_done(entry))
            self._entries.append(entry)
            self._by_rid[req.rid] = entry
        return req

    # ---- disaggregated dispatch ------------------------------------------

    def _dispatch_target(self, prompt) -> ServingReplica:
        """Where a new request starts. Prefix affinity first: if a
        decode replica's radix index holds a resident prefix covering
        all but an ``affinity_suffix_max`` suffix of the prompt, the
        request skips the prefill fleet — shared pages map in place and
        only the divergent suffix prefills there. Otherwise the
        least-loaded live prefill replica takes it (the engine
        re-checks the plan at admission and bounces if the donor pages
        churned out meanwhile). Caller holds the lock."""
        tokens = [int(t) for t in prompt]
        best, best_resume = None, 0
        for r in self.decode_pool:
            if not r.alive:
                continue
            eng = r.server.engine
            if eng.trie is None:
                continue
            match = eng.trie.lookup(tokens)
            if not match.pages and not match.tail_tokens:
                continue
            plan = prefix_mod.plan_admission(
                match, len(tokens), eng.geom.page_size, eng.prefill_chunk
            )
            if (
                prefix_mod.affinity_ok(
                    plan, len(tokens), eng.affinity_suffix_max
                )
                and plan.resume > best_resume
            ):
                best, best_resume = r, plan.resume
        if best is not None:
            logger.info(
                "prefix-affinity dispatch to %s (%d resident tokens)",
                best.name, best_resume,
            )
            return best
        live_prefill = [r for r in self.prefill_pool if r.alive]
        if not live_prefill:
            self._collapse_locked()
            live = self._live()
            if not live:
                raise RuntimeError("no live serving replicas")
            r = live[self._rr % len(live)]
            self._rr += 1
            return r
        return min(
            live_prefill,
            key=lambda r: r.server.scheduler.queue_depth()
            + sum(s is not None for s in r.server.engine.slots),
        )

    def _repoint(self, rid: str, replica: ServingReplica) -> None:
        """A committed handoff moved ``rid``'s ownership; track it so
        failover sweeps watch the right replica."""
        with self._lock:
            entry = self._by_rid.get(rid)
            if entry is not None:
                entry.replica = replica

    def redispatch(self, req: Request) -> str:
        """Degraded-handoff / affinity-bounce intake: requeue ``req``
        under its original ticket on a replica that can PREFILL it,
        and repoint its entry. Returns the receiving replica's name."""
        with self._lock:
            tgt = self._re_admit_target()
            tgt.server.re_admit(req)
            entry = self._by_rid.get(req.rid)
            if entry is not None:
                entry.replica = tgt
            return tgt.name

    def _re_admit_target(self) -> ServingReplica:
        """A live replica that accepts raw (un-prefilled) requests —
        never a decode-role one. When only decode replicas survive,
        collapse the fleet so they can. Caller holds the lock."""
        cand = [r for r in self._live() if r.role != "decode"]
        if not cand:
            self._collapse_locked()
            cand = self._live()
        if not cand:
            raise RuntimeError("no live serving replicas")
        r = cand[self._rr % len(cand)]
        self._rr += 1
        return r

    def _role_aware_re_admit(self, req: Request, survivor) -> str:
        """Installed as the migrator's ``re_admit`` override on a
        disaggregated fleet: the fallback ladder's raw
        re-admissions route through the prefill pool instead of the
        decode survivor the migrator happened to pick."""
        if survivor.role != "decode":
            survivor.server.re_admit(req)
            with self._lock:
                entry = self._by_rid.get(req.rid)
                if entry is not None:
                    entry.replica = survivor
            return survivor.name
        return self.redispatch(req)

    def _drain_bounced(self) -> int:
        """Decode-role engines bounce admissions whose affinity plan
        degraded between dispatch and admission (lock-free deque — the
        engine loop must never wait on the router). Re-dispatch them
        through the prefill pool. Caller holds the lock."""
        n = 0
        for r in self.decode_pool:
            bounced = r.server.engine.bounced
            while bounced:
                try:
                    req = bounced.popleft()
                except IndexError:
                    break
                tgt = self._re_admit_target()
                tgt.server.re_admit(req)
                entry = self._by_rid.get(req.rid)
                if entry is not None:
                    entry.replica = tgt
                logger.info(
                    "affinity bounce: %s re-dispatched from %s to %s",
                    req.rid, r.name, tgt.name,
                )
                n += 1
        return n

    def _collapse_locked(self) -> None:
        """Runtime degradation: one pool has no live member, so the
        split cannot function — fold every surviving engine back to
        ``unified`` and re-dispatch the requests the collapse orphaned
        (prefill-role slots hold prompt-only footprints and cannot
        decode in place). Caller holds the lock."""
        if not self.disaggregated:
            return
        logger.warning(
            "collapsing disaggregated fleet to unified "
            "(prefill live=%d decode live=%d)",
            sum(r.alive for r in self.prefill_pool),
            sum(r.alive for r in self.decode_pool),
        )
        self.disaggregated = False
        coord, self.coordinator = self.coordinator, None
        if self.migrator is not None:
            self.migrator.re_admit = None
        orphans = coord.collapse() if coord is not None else []
        self.prefill_pool = []
        self.decode_pool = []
        live = self._live()
        for req in orphans:
            if not live:
                raise RuntimeError(
                    "all serving replicas died with requests in flight"
                )
            tgt = live[self._rr % len(live)]
            self._rr += 1
            tgt.server.re_admit(req)
            entry = self._by_rid.get(req.rid)
            if entry is not None:
                entry.replica = tgt

    # ---- elastic fleet membership (serving autoscaler) -------------------

    def add_replica(self, replica: ServingReplica) -> None:
        """Attach a warm (already-started) replica to the live fleet —
        the autoscaler's scale-out path. On a disaggregated fleet the
        replica joins its role pool and the handoff coordinator starts
        targeting/sourcing it immediately; a role-typed replica joining
        a UNIFIED fleet folds to unified, mirroring ``__init__``'s
        one-sided-fleet rule. Idempotent for an already-member replica."""
        if not replica.alive:
            raise ValueError(
                f"cannot attach replica {replica.name}: not alive"
            )
        with self._lock:
            if replica in self.replicas and not self.is_detached(replica):
                return
            # a re-attached replica sheds its detached/dead history:
            # the failover sweep should watch it again
            self._detached.discard(id(replica))
            self._dead_seen.discard(id(replica))
            if replica not in self.replicas:
                self.replicas.append(replica)
            if self.disaggregated:
                if replica.role == "prefill":
                    if replica not in self.prefill_pool:
                        self.prefill_pool.append(replica)
                    if self.coordinator is not None:
                        self.coordinator.attach_prefill(replica)
                elif replica.role == "decode":
                    if replica not in self.decode_pool:
                        self.decode_pool.append(replica)
                    if self.coordinator is not None:
                        self.coordinator.attach_decode(replica)
                # a unified joiner on a split fleet serves only failover
                # re-admissions (it is in no dispatch pool) — harmless
            elif replica.role != "unified":
                logger.warning(
                    "replica %s joins a unified fleet with role=%s — "
                    "running unified", replica.name, replica.role,
                )
                replica.server.engine.role = "unified"
            # work stealing: queued-but-unadmitted requests rebalance
            # onto the joiner, so a scale-out relieves the very backlog
            # that triggered it instead of only absorbing FUTURE
            # arrivals. Decode-role joiners steal nothing — a raw
            # un-prefilled request must never land on one.
            stolen = 0
            if replica.role != "decode":
                donors = [
                    r for r in self._live()
                    if r is not replica
                    and (
                        not self.disaggregated or r.role == replica.role
                    )
                ]
                while donors:
                    src = max(
                        donors,
                        key=lambda r: r.server.scheduler.queue_depth(),
                    )
                    if (
                        src.server.scheduler.queue_depth()
                        <= replica.server.scheduler.queue_depth() + 1
                    ):
                        break
                    q = src.server.scheduler.pop_next()
                    if q is None:
                        break
                    replica.server.re_admit(q)
                    entry = self._by_rid.get(q.rid)
                    if entry is not None:
                        entry.replica = replica
                    stolen += 1
            logger.info(
                "scale-out: attached replica %s (role=%s), fleet=%d "
                "live, %d queued request(s) rebalanced",
                replica.name, replica.role, len(self._live()), stolen,
            )

    def remove_replica(
        self,
        replica: ServingReplica,
        *,
        reason: str = "scale_in",
        drain_timeout_s: float = 30.0,
    ):
        """Planned scale-in: drain ``replica`` and detach it from the
        fleet with zero lost or duplicated requests. Decode/unified
        victims evacuate over the live-migration wire (the migrator's
        detect phase sees the victim ALIVE → ``begin_drain`` + stop at
        a step boundary → pages move to pool peers, zero re-prefilled
        prompt tokens). Prefill victims drain cooperatively: queued
        prompts re-dispatch on the pool, in-flight handoffs finish
        streaming, then the loop stops. Either way the replica ends
        ``detached`` — never counted dead, never migrated again, never
        collapsing the fleet. Returns the MigrationReport when the
        live path ran, else None. Raises ValueError when the victim is
        the last live member of its pool."""
        with self._lock:
            if id(replica) in self._detached or replica not in self.replicas:
                return None
            in_prefill = (
                self.disaggregated and replica in self.prefill_pool
            )
            if in_prefill:
                peers = [
                    r for r in self.prefill_pool
                    if r.alive and r is not replica
                ]
            elif self.disaggregated and replica in self.decode_pool:
                peers = [
                    r for r in self.decode_pool
                    if r.alive and r is not replica
                ]
            else:
                peers = [r for r in self._live() if r is not replica]
            if not peers:
                raise ValueError(
                    f"cannot scale in {replica.name}: last live member "
                    "of its pool"
                )
            # detach FIRST: no new dispatch lands on the victim, and the
            # failover sweep must never read the drained loop as a death
            self._detached.add(id(replica))
            self._dead_seen.add(id(replica))
            if replica in self.prefill_pool:
                self.prefill_pool.remove(replica)
            if replica in self.decode_pool:
                self.decode_pool.remove(replica)
            if self.coordinator is not None:
                self.coordinator.detach(replica)
            if not in_prefill and self.migrator is not None:
                self._migrate_victim(replica, peers)
                logger.info(
                    "scale-in: detached replica %s via live migration "
                    "(reason=%s)", replica.name, reason,
                )
                return self.reports[-1]
            # cooperative drain (prefill victim, or no migrator): stop
            # admitting, re-route the queue under original tickets
            replica.server.begin_drain()
            while True:
                q = replica.server.scheduler.pop_next()
                if q is None:
                    break
                tgt = self._re_admit_target()
                tgt.server.re_admit(q)
                entry = self._by_rid.get(q.rid)
                if entry is not None:
                    entry.replica = tgt
        # wait OUTSIDE the lock for in-flight slots to finish (prefill
        # slots hand off and repoint via the coordinator's commit path)
        deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < deadline:
            eng = replica.server.engine
            if not any(
                s is not None and not s.req.future.done()
                for s in eng.slots
            ):
                break
            time.sleep(0.005)
        replica.server.stop()
        with self._lock:
            # anything still parked on the victim (drain deadline hit)
            # re-admits from the prompt — degraded but never lost
            for entry in self._entries:
                if entry.done or entry.replica is not replica:
                    continue
                tgt = self._re_admit_target()
                tgt.server.re_admit(entry.req)
                entry.replica = tgt
        logger.info(
            "scale-in: detached replica %s via cooperative drain "
            "(reason=%s)", replica.name, reason,
        )
        return None

    def close(self) -> None:
        """Stop the handoff coordinator's worker thread (no-op on a
        unified fleet)."""
        with self._lock:
            coord, self.coordinator = self.coordinator, None
        if coord is not None:
            coord.stop()

    # ---- failover --------------------------------------------------------

    def poll(self) -> int:
        """Failover sweep: move every incomplete request whose replica
        died onto a survivor — live page migration when a migrator is
        attached, re-admission otherwise. On a disaggregated fleet the
        sweep is role-aware: dead-prefill requests re-dispatch on the
        prefill pool (committed handoffs just repoint to their decode
        owner), dead-decode slots migrate to decode survivors, and an
        emptied pool collapses the fleet to unified. Returns how many
        requests moved."""
        with self._lock:
            moved = 0
            if self.disaggregated:
                moved += self._drain_bounced()
                if self.coordinator is not None:
                    for r in self.decode_pool:
                        if not r.alive and id(r) not in self._dead_seen:
                            self._dead_seen.add(id(r))
                            n = self.coordinator.on_replica_dead(r)
                            if n:
                                logger.info(
                                    "dead decode replica %s: %d in-flight "
                                    "handoffs restarting elsewhere",
                                    r.name, n,
                                )
                if not any(r.alive for r in self.decode_pool) or not any(
                    r.alive for r in self.prefill_pool
                ):
                    self._collapse_locked()
            live = self._live()
            migrated_victims = set()
            for entry in self._entries:
                if entry.done or entry.replica.alive:
                    continue
                if not live:
                    raise RuntimeError(
                        "all serving replicas died with requests in flight"
                    )
                victim = entry.replica
                if self.disaggregated and victim in self.prefill_pool:
                    owner = self.coordinator.resolve_dead_donor(
                        entry.req.rid
                    )
                    if owner is not None and owner.alive:
                        # the handoff committed before the donor died —
                        # the decode replica owns the stream; re-admitting
                        # would duplicate it
                        entry.replica = owner
                        moved += 1
                        continue
                    survivor = self._re_admit_target()
                    logger.info(
                        "re-dispatching %s from dead prefill replica %s "
                        "onto %s", entry.req.rid, victim.name, survivor.name,
                    )
                    survivor.server.re_admit(entry.req)
                    entry.replica = survivor
                    moved += 1
                    continue
                if (
                    self.migrator is not None
                    and id(victim) not in migrated_victims
                    # a detached victim was already evacuated by
                    # remove_replica; a straggler entry here just
                    # re-admits below instead of re-running a migration
                    # against the drained engine
                    and id(victim) not in self._detached
                ):
                    migrated_victims.add(id(victim))
                    survivors = (
                        [r for r in self.decode_pool if r.alive]
                        if self.disaggregated and victim in self.decode_pool
                        else live
                    )
                    if survivors:
                        moved += self._migrate_victim(victim, survivors)
                if not entry.replica.alive:
                    # no migrator, or this request slipped past one
                    # (e.g. completed-but-unresolved slot): re-admit on a
                    # replica that can prefill it
                    survivor = self._re_admit_target()
                    logger.info(
                        "re-admitting %s from dead replica %s onto %s",
                        entry.req.rid, victim.name, survivor.name,
                    )
                    survivor.server.re_admit(entry.req)
                    entry.replica = survivor
                    moved += 1
            return moved

    def _migrate_victim(self, victim, live) -> int:
        """Drive one dead/drained replica through the migrator and
        repoint every entry it placed. Caller holds ``_lock``."""
        report = self.migrator.migrate(victim, live)
        self.reports.append(report)
        if self.watchdog is not None:
            self.watchdog.observe_migration(report, replica=victim.name)
        by_name = {r.name: r for r in live}
        placed = {}
        placed.update(report.placements)
        placed.update(report.re_prefilled)
        placed.update(report.re_routed)
        moved = 0
        for entry in self._entries:
            if entry.done or entry.replica is not victim:
                continue
            survivor_name = placed.get(entry.req.rid)
            if survivor_name in by_name:
                entry.replica = by_name[survivor_name]
                moved += 1
        logger.info(
            "migrated replica %s: path=%s live=%d re_prefilled=%d",
            victim.name, report.path, len(report.placements),
            len(report.re_prefilled),
        )
        return moved

    def wait_all(self, timeout: float = 120.0) -> List:
        """Poll for failovers while gathering every outstanding result
        (submission order). Raises on per-request failure or timeout.

        Waits in jittered-backoff slices (``comm._backoff_delay``, capped
        at attempt 3 ≈ 4 s so a mid-wait replica death is still noticed
        promptly) instead of a fixed 50 ms spin — one slow straggler no
        longer costs a poll storm. Deadlines are per-request: a request
        carrying ``deadline_s`` must finish within that budget of its
        OWN submit time; the ``timeout`` argument bounds the rest
        relative to this call."""
        t_start = time.monotonic()
        with self._lock:
            entries = list(self._entries)
        results = []
        for entry in entries:
            req = entry.req
            if req.deadline_s is not None:
                deadline = req.submit_t + req.deadline_s
            else:
                deadline = t_start + timeout
            attempt = 0
            while True:
                self.poll()
                remaining = deadline - time.monotonic()
                if remaining <= 0 and not req.future.done():
                    entry.replica.server.scheduler.count_timed_out()
                    raise concurrent.futures.TimeoutError(
                        f"request {req.rid} missed its deadline"
                    )
                wait = min(_backoff_delay(min(attempt, 3)), max(remaining, 0.0))
                try:
                    results.append(req.future.result(timeout=wait))
                    break
                except concurrent.futures.TimeoutError:
                    attempt += 1
        return results
