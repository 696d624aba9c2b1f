"""Live KV-page migration between serving replicas.

Port of ``dlrover_tpu/serving/migration.py``. On a planned drain or a
detected eviction, each victim request's held KV pages — int8 payloads
and per-block f32 scales, or compute-dtype rows, exactly as the pools
store them — plus block-table order, position and sampling state move to
a survivor that has RESERVED the same page footprint, and the survivor
resumes mid-decode at the original position. A sampled draw is keyed on
the request's seed and the absolute position of the token
(``models/generate.py``), so the migrated continuation is the
never-evicted stream and nothing re-prefills.

Phases, run by :class:`~dlrover_tpu_torch.elastic.resharding.
LiveResharder` under per-phase :class:`PhaseBudgets`:

1. **detect**: halt the victim (a planned drain stops its loop; a kill
   already did), inventory its in-flight slots and queued requests.
2. **plan**: a versioned serving-reshard directive (the master's
   ``ServingEvictionNotice`` → ``ServingReshardDirective`` when a client
   is attached, a local counter otherwise); each victim request goes to
   the survivor with the most free pages.
3. **reserve**: hold each request's full footprint on its survivor
   (``PageAllocator.reserve_for_migration`` under ``server.paused()``).
   Short of pages, shed the survivor's lowest-priority queued NEW
   admissions, back off with jitter and retry inside the budget.
4. **transfer**: snapshot each slot read-only on the donor, encode the
   checksummed wire blob, decode it on the survivor's side. A truncated
   or corrupt blob raises :class:`TornPageTransfer` (a ``TornDonation``:
   the resharder retries it before falling back).
5. **resume**: commit the reservation into a free survivor slot and
   rebuild the lane where the donor stopped (``ServingEngine.
   import_slot``), then release the donor slot.

A torn or over-deadline migration degrades to re-prefill (abort the
reservations, ``re_admit`` every request not resumed under its original
ticket), never to a lost request.

The wire (``DTKV1``): magic, a u32 header length, a JSON header (the
metadata, each array's dtype name and shape, the payload length and its
CRC-32) and the raw page bytes, byte for byte the JAX package's, so
each package decodes the other's blobs. Pages are torch tensors on the
host; a ``bfloat16`` page ships as its raw 16-bit words under the dtype
name ``"bfloat16"`` (read back through a torch ``view``), which the JAX
decoder maps to its own bfloat16.

Fault points: ``serving.detect`` / ``serving.plan`` /
``serving.reserve`` / ``serving.transfer`` / ``serving.resume`` with
``rank`` = the acting replica's node_id. The victim and the survivors
are duck-typed (``.name``, ``.node_id``, ``.server``), so the router can
hold a migrator without an import cycle.
"""

import itertools
import json
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common.comm import _backoff_delay
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.elastic.faults import (
    FaultInjector,
    TornDonation,
    get_injector,
)
from dlrover_tpu_torch.elastic.resharding import (
    LiveResharder,
    MigrationError,
    PhaseBudgets,
    ReshardOutcome,
)
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.serving.scheduler import AdmissionError, Request

logger = get_logger(__name__)

_MAGIC = b"DTKV1\n"
_local_directive = itertools.count(1)

#: the dtype names of the wire, as numpy (and ml_dtypes) spell them
_DTYPES = {
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class TornPageTransfer(TornDonation):
    """A page blob arrived truncated or corrupt (checksum or shape
    mismatch). Retryable: the donor snapshot is read-only, so the
    resharder re-runs the transfer phase before degrading."""


@dataclass
class RequestSnapshot:
    """Everything a survivor needs to resume one request mid-decode.

    ``pages`` maps pool key → host tensor ``[L, n_held, page_size, ...]``
    in LOGICAL page order, exactly as stored. The geometry fingerprint
    fields let the survivor refuse an incompatible donor (another page
    size, mode or shape) and fall back to re-prefill rather than import
    garbage. The ``Request`` object travels in-process beside the
    snapshot (its future must resolve for the original caller)."""

    rid: str
    prompt: List[int]
    generated: List[int]
    n_prefilled: int
    phase: str                   # "prefill" | "decode"
    max_new_tokens: int
    seed: int
    # geometry fingerprint
    mode: str
    page_size: int
    n_layers: int
    kv_heads: int
    head_dim: int
    kv_block: int
    # logical index of the first page in ``pages``: a whole-slot
    # migration ships 0, a streaming-handoff fragment the offset its
    # chunk committed at (serving/disagg.py)
    page_start: int = 0
    pages: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def n_pages(self) -> int:
        if not self.pages:
            return 0
        return next(iter(self.pages.values())).shape[1]

    @property
    def tokens_resident(self) -> int:
        """Tokens of compute a re-prefill would redo (the savings)."""
        return self.n_prefilled + len(self.generated)


def geometry_fingerprint(geom) -> Dict[str, Any]:
    return {
        "mode": geom.mode,
        "page_size": geom.page_size,
        "n_layers": geom.n_layers,
        "kv_heads": geom.kv_heads,
        "head_dim": geom.head_dim,
        "kv_block": geom.kv_block,
    }


def snapshot_slot(engine, i: int) -> RequestSnapshot:
    """Read-only donor-side snapshot of slot ``i`` (engine halted or
    paused). Safe to repeat: a torn transfer re-snapshots."""
    s = engine.slots[i]
    if s is None:
        raise ValueError(f"slot {i} is empty")
    return RequestSnapshot(
        rid=s.req.rid,
        prompt=[int(t) for t in s.prompt],
        generated=list(s.generated),
        n_prefilled=int(s.n_prefilled),
        phase=s.phase,
        max_new_tokens=int(s.req.max_new_tokens),
        seed=int(s.req.sampling.seed),
        pages=engine.export_pages(i),
        **geometry_fingerprint(engine.geom),
    )


# ------------------------------------------------------------------ wire


def _host(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().contiguous()


def _byte_view(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes in memory order, without a copy (a bfloat16
    tensor's raw 16-bit words): numpy has no bfloat16, a byte view needs
    none."""
    if t.numel() == 0:
        return np.empty(0, np.uint8)
    return t.reshape(-1).view(torch.uint8).numpy()


def _from_bytes(payload, pos: int, name: str, shape) -> torch.Tensor:
    """The array at byte ``pos`` of ``payload``: one copy out of the
    blob, viewed as its dtype."""
    if name not in _DTYPES:
        raise TornPageTransfer(f"unknown page dtype {name!r}")
    dt = _DTYPES[name]
    n = dt.itemsize * int(np.prod(shape))
    if pos + n > len(payload):
        raise TornPageTransfer("array manifest exceeds payload")
    if n == 0:
        return torch.empty(shape, dtype=dt)
    flat = np.frombuffer(payload, np.uint8, count=n, offset=pos).copy()
    return torch.from_numpy(flat).view(dt).reshape(shape)


def encode_snapshot(snap: RequestSnapshot) -> bytes:
    """Serialize to the migration wire blob: JSON header (metadata, each
    array's dtype and shape, payload CRC) followed by the raw page
    bytes, key by key in sorted order. The pages are copied once, into
    the blob."""
    keys = sorted(snap.pages)
    pages = {k: _host(snap.pages[k]) for k in keys}
    chunks = [_byte_view(pages[k]) for k in keys]
    crc, payload_len = 0, 0
    for c in chunks:
        crc = zlib.crc32(c, crc)
        payload_len += c.nbytes
    header = json.dumps({
        "meta": {
            "rid": snap.rid,
            "prompt": snap.prompt,
            "generated": snap.generated,
            "n_prefilled": snap.n_prefilled,
            "phase": snap.phase,
            "max_new_tokens": snap.max_new_tokens,
            "seed": snap.seed,
            "page_start": snap.page_start,
            "mode": snap.mode,
            "page_size": snap.page_size,
            "n_layers": snap.n_layers,
            "kv_heads": snap.kv_heads,
            "head_dim": snap.head_dim,
            "kv_block": snap.kv_block,
        },
        "arrays": [
            {
                "key": k,
                "dtype": _NAMES[pages[k].dtype],
                "shape": list(pages[k].shape),
            }
            for k in keys
        ],
        "payload_len": payload_len,
        "crc": crc,
    }).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(header)), header,
                     *chunks])


def decode_snapshot(data: bytes) -> RequestSnapshot:
    """Parse and VERIFY a wire blob. Any truncation, bad magic, length
    or CRC mismatch raises :class:`TornPageTransfer`, the retryable
    torn-transfer signal, never a silent partial import."""
    try:
        view = memoryview(data)  # slices of it copy nothing
        if bytes(view[: len(_MAGIC)]) != _MAGIC:
            raise TornPageTransfer("bad magic — not a migration blob")
        off = len(_MAGIC)
        (hlen,) = struct.unpack("<I", view[off:off + 4])
        off += 4
        raw = bytes(view[off:off + hlen])
        if len(raw) != hlen:
            raise TornPageTransfer("truncated header")
        header = json.loads(raw)
        off += hlen
        payload = view[off:]
        if len(payload) != header["payload_len"]:
            raise TornPageTransfer(
                f"truncated payload: {len(payload)} of "
                f"{header['payload_len']} bytes"
            )
        if zlib.crc32(payload) != header["crc"]:
            raise TornPageTransfer("payload checksum mismatch")
        pages: Dict[str, torch.Tensor] = {}
        pos = 0
        for spec in header["arrays"]:
            shape = tuple(spec["shape"])
            t = _from_bytes(payload, pos, spec["dtype"], shape)
            pages[spec["key"]] = t
            pos += t.numel() * t.element_size()
        return RequestSnapshot(pages=pages, **header["meta"])
    except TornPageTransfer:
        raise
    except Exception as e:  # struct/json/shape errors are torn too
        raise TornPageTransfer(f"undecodable migration blob: {e}") from e


# ------------------------------------------------------------ phase machine


@dataclass
class MigrationReport:
    """What one :meth:`ServingMigrator.migrate` call did."""

    outcome: ReshardOutcome
    placements: Dict[str, str]        # rid → survivor name (live-migrated)
    re_prefilled: Dict[str, str]      # rid → survivor name (fallback tier)
    re_routed: Dict[str, str]         # queued-only rids → survivor name
    directive_version: int = 0
    bytes_moved: int = 0
    tokens_saved: int = 0             # prefill+decode compute not redone

    @property
    def path(self) -> str:
        return self.outcome.path


class _Assignment:
    """One victim request's migration state across phases."""

    __slots__ = ("slot", "req", "survivor", "snap", "reserved", "resumed")

    def __init__(self, slot: int, req: Request, survivor):
        self.slot = slot
        self.req = req
        self.survivor = survivor
        self.snap: Optional[RequestSnapshot] = None
        self.reserved = False
        self.resumed = False


class ServingMigrator:
    """Drives one victim's drain or eviction through the migration
    ladder.

    ``master_client`` (optional, any object with
    ``report_serving_eviction``/``get_serving_reshard``) threads the
    directive through the master; without one the migrator versions
    directives locally. ``re_admit(req, survivor) -> name`` overrides the
    fallback's raw re-admission: a disaggregated router installs a
    role-aware one, since a decode-only survivor must never be handed an
    un-prefilled request."""

    def __init__(
        self,
        budgets: Optional[PhaseBudgets] = None,
        faults: Optional[FaultInjector] = None,
        master_client=None,
        retries: int = 2,
        shed_per_attempt: int = 2,
        reserve_attempts: int = 6,
        re_admit=None,
    ):
        self.budgets = budgets or PhaseBudgets()
        self.faults = faults if faults is not None else get_injector()
        self.master_client = master_client
        self.retries = retries
        self.shed_per_attempt = shed_per_attempt
        self.reserve_attempts = reserve_attempts
        self.re_admit = re_admit

    def _re_admit(self, req: Request, survivor) -> str:
        if self.re_admit is not None:
            return self.re_admit(req, survivor)
        survivor.server.re_admit(req)
        return survivor.name

    # ---- phases (each closes over one migration's context) ---------------

    def migrate(self, victim, survivors: Sequence) -> MigrationReport:
        """Move every in-flight request off ``victim`` onto
        ``survivors``; queued, never-admitted requests are re-routed
        (nothing to migrate). Never raises for torn or over-deadline
        transfers, which degrade to re-prefill; an ``InjectedKill``
        propagates."""
        survivors = [s for s in survivors if s.server.alive or s is victim]
        if not survivors or all(s is victim for s in survivors):
            raise ValueError("migration needs at least one live survivor")
        survivors = [s for s in survivors if s is not victim]

        ctx: Dict[str, Any] = {
            "assignments": [],      # List[_Assignment]
            "queued": [],           # List[Request]
            "version": 0,
            "bytes": 0,
            "placements": {},
            "re_prefilled": {},
            "re_routed": {},
            "tokens_saved": 0,
        }
        rr = itertools.count()

        def detect(_prev):
            self.faults.at("serving.detect", rank=victim.node_id)
            srv = victim.server
            ctx["reason"] = "drain" if srv.alive else "evict"
            if srv.alive:
                # planned drain: stop admitting, then halt the loop at a
                # step boundary; the pools on the card survive the stop
                srv.begin_drain()
                srv.stop()
            eng = srv.engine
            in_flight = [
                (i, s.req)
                for i, s in enumerate(eng.slots)
                if s is not None and not s.req.future.done()
            ]
            while True:
                q = srv.scheduler.pop_next()
                if q is None:
                    break
                ctx["queued"].append(q)
            if not in_flight and not ctx["queued"]:
                return ctx
            return {"in_flight": in_flight}

        def plan(detected):
            self.faults.at("serving.plan", rank=victim.node_id)
            in_flight = (detected or {}).get("in_flight", [])
            if self.master_client is not None:
                self.master_client.report_serving_eviction(
                    victim.name,
                    in_flight=len(in_flight),
                    deadline_s=self.budgets.transfer_s,
                    reason=ctx.get("reason", "evict"),
                )
                directive = self.master_client.get_serving_reshard()
                ctx["version"] = int(directive.version)
            else:
                ctx["version"] = next(_local_directive)
            # most-free-pages-first placement, debited as we assign
            headroom = {
                id(s): s.server.engine.alloc.free_pages for s in survivors
            }
            for slot, req in in_flight:
                tgt = max(survivors, key=lambda s: headroom[id(s)])
                headroom[id(tgt)] -= tgt.server.engine.alloc.pages_needed(
                    req.total_tokens
                )
                ctx["assignments"].append(_Assignment(slot, req, tgt))
            return ctx["assignments"]

        def reserve(assignments):
            t0 = time.monotonic()
            budget = self.budgets.for_phase("reserve")
            for a in assignments:
                self.faults.at("serving.reserve", rank=a.survivor.node_id)
                sched = a.survivor.server.scheduler
                for attempt in range(self.reserve_attempts):
                    with a.survivor.server.paused() as eng:
                        a.reserved = eng.alloc.reserve_for_migration(
                            a.req.rid, a.req.total_tokens
                        )
                    if a.reserved:
                        break
                    # shed the survivor's lowest-priority queued NEW
                    # admissions (never re-admits), then back off while
                    # running slots retire
                    shed = sched.shed_lowest(
                        count=self.shed_per_attempt,
                        below_priority=a.req.priority,
                    )
                    remaining = budget - (time.monotonic() - t0)
                    if remaining <= 0:
                        break
                    time.sleep(min(_backoff_delay(attempt), remaining))
                    logger.info(
                        "reserve retry %d for %s on %s (shed %d)",
                        attempt + 1, a.req.rid, a.survivor.name, len(shed),
                    )
                if not a.reserved:
                    raise MigrationError(
                        f"survivor {a.survivor.name} cannot reserve "
                        f"{a.req.total_tokens} tokens for {a.req.rid} "
                        f"within the {budget:.1f}s reserve budget"
                    )
            return assignments

        def transfer(assignments):
            eng = victim.server.engine
            tr = get_tracer()
            ctx["bytes"] = 0
            for a in assignments:
                sp = None
                if tr.enabled:
                    sp = tr.begin(
                        "serving.migrate_transfer", rid=a.req.rid,
                        victim=victim.name, survivor=a.survivor.name,
                    )
                snap = snapshot_slot(eng, a.slot)
                blob = encode_snapshot(snap)
                self.faults.at("serving.transfer", rank=victim.node_id)
                a.snap = decode_snapshot(blob)
                ctx["bytes"] += len(blob)
                if sp is not None:
                    sp.end(bytes=len(blob))
            return assignments

        def resume(assignments):
            tr = get_tracer()
            for a in assignments:
                sp = None
                if tr.enabled:
                    sp = tr.begin(
                        "serving.migrate_resume", rid=a.req.rid,
                        victim=victim.name, survivor=a.survivor.name,
                    )
                self.faults.at("serving.resume", rank=a.survivor.node_id)
                snap = a.snap
                try:
                    self._check_geometry(snap, a.survivor.server.engine)
                    with a.survivor.server.paused() as eng:
                        eng.import_slot(
                            a.req,
                            snap.pages,
                            phase=snap.phase,
                            n_prefilled=snap.n_prefilled,
                            generated=snap.generated,
                            reserved_tag=a.req.rid,
                        )
                except (AdmissionError, ValueError, KeyError) as e:
                    # per-request ladder: this one re-prefills, the rest
                    # of the batch still migrates live
                    logger.warning(
                        "resume of %s on %s degraded to re-prefill: %s",
                        a.req.rid, a.survivor.name, e,
                    )
                    with a.survivor.server.paused() as eng:
                        eng.alloc.abort_migration(a.req.rid)
                    ctx["re_prefilled"][a.req.rid] = self._re_admit(
                        a.req, a.survivor
                    )
                    if sp is not None:
                        sp.end(path="re_prefill")
                else:
                    a.resumed = True
                    ctx["placements"][a.req.rid] = a.survivor.name
                    ctx["tokens_saved"] += snap.tokens_resident
                    if sp is not None:
                        sp.end(path="live")
                victim.server.engine.release_slot(a.slot)
            self._route_queued(ctx, survivors, rr)
            return assignments

        def fallback(exc):
            """The re-prefill tier: abort every reservation, re-admit
            every in-flight request not resumed under its original
            ticket. None is lost; none is duplicated (resumed ones keep
            their survivor slot)."""
            for a in ctx["assignments"]:
                if a.resumed:
                    continue
                with a.survivor.server.paused() as eng:
                    eng.alloc.abort_migration(a.req.rid)
                ctx["re_prefilled"][a.req.rid] = self._re_admit(
                    a.req, a.survivor
                )
            self._route_queued(ctx, survivors, rr)
            return ctx["assignments"]

        resharder = LiveResharder(
            budgets=self.budgets,
            faults=self.faults,
            retries=self.retries,
        )
        outcome = resharder.execute(
            [
                ("detect", detect),
                ("plan", plan),
                ("reserve", reserve),
                ("transfer", transfer),
                ("resume", resume),
            ],
            fallback=fallback,
        )
        report = MigrationReport(
            outcome=outcome,
            placements=dict(ctx["placements"]),
            re_prefilled=dict(ctx["re_prefilled"]),
            re_routed=dict(ctx["re_routed"]),
            directive_version=ctx["version"],
            bytes_moved=ctx["bytes"],
            tokens_saved=ctx["tokens_saved"],
        )
        logger.info(
            "migration of %s: path=%s live=%d fallback=%d re_routed=%d "
            "v%d %.0f bytes, %d tokens saved, %.3fs",
            victim.name, report.path, len(report.placements),
            len(report.re_prefilled), len(report.re_routed),
            report.directive_version, report.bytes_moved,
            report.tokens_saved, outcome.recovery_s,
        )
        return report

    # ---- helpers ---------------------------------------------------------

    @staticmethod
    def _check_geometry(snap: RequestSnapshot, engine) -> None:
        want = geometry_fingerprint(engine.geom)
        got = {k: getattr(snap, k) for k in want}
        if got != want:
            raise ValueError(
                f"donor geometry {got} incompatible with survivor {want}"
            )

    def _route_queued(self, ctx, survivors, rr) -> None:
        """Queued, never-admitted victim requests re-route round-robin
        (original tickets; nothing resident to migrate). Idempotent, so
        resume and fallback can both call it."""
        while ctx["queued"]:
            req = ctx["queued"].pop(0)
            tgt = survivors[next(rr) % len(survivors)]
            ctx["re_routed"][req.rid] = self._re_admit(req, tgt)
