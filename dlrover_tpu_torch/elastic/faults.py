"""Fault injection for elastic failover paths.

A copy of ``dlrover_tpu/elastic/faults.py`` (the same kinds, grammar
and ``DLROVER_TPU_FAULTS`` seeding).

Reference shape: chaos harnesses in elastic trainers (dlrover's
node-failure drills) expose *named injection points* inside the recovery
path; tests install a :class:`FaultSpec` and the production code calls
``injector.at("donation", rank=src)`` at each edge. The happy path pays
one dict lookup; the drill and unit tests get deterministic kill /
evict / slow-peer / torn-donation behaviour without monkeypatching.

Kinds:

- ``kill``             raise :class:`InjectedKill` at the point (hard stop)
- ``evict``            mark a rank as evicted; ``evicted_ranks()`` feeds the
                       reshard plan — no exception raised
- ``slow_peer``        sleep ``delay_s`` at the point (deadline-budget tests)
- ``torn_donation``    raise :class:`TornDonation` (partial shard transfer)
- ``drop_page``        raise :class:`DroppedPage` (a KV page frame lost
                       mid-migration; TornDonation subclass, so the
                       serving migrator's retry/fallback ladder covers it)
- ``stall_migration``  sleep ``delay_s`` inside a serving-migration phase
                       (drives the phase machine over its budget)

Serving injection points are namespaced ``serving.<phase>`` (detect /
plan / reserve / transfer / resume) with ``rank`` = replica index, so
``kill`` composes at replica scope too. ``times`` bounds how often a
spec fires (-1 = unlimited), so a transient fault (fires once, then the
retry succeeds) is ``times=1``. The full ``DLROVER_TPU_FAULTS`` grammar
is documented in docs/fault_drills.md.
"""

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

KINDS = (
    "kill",
    "evict",
    "slow_peer",
    "torn_donation",
    "drop_page",
    "stall_migration",
)


class TornDonation(RuntimeError):
    """A shard donation was interrupted mid-transfer."""


class DroppedPage(TornDonation):
    """A KV page frame was lost during a serving migration transfer."""


class InjectedKill(RuntimeError):
    """A hard kill fired at an injection point."""


@dataclass
class FaultSpec:
    """One fault: fire ``kind`` at injection point ``point`` (all points
    when empty) for rank ``rank`` (all ranks when -1), at most ``times``
    times (-1 = unlimited)."""

    kind: str
    rank: int = -1
    point: str = ""
    delay_s: float = 0.0
    times: int = -1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")

    def matches(self, point: str, rank: int) -> bool:
        if self.point and self.point != point:
            return False
        if self.rank >= 0 and rank >= 0 and self.rank != rank:
            return False
        return True


class FaultInjector:
    """Holds installed specs; production code calls :meth:`at`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: List[FaultSpec] = []

    def install(self, spec: FaultSpec) -> FaultSpec:
        with self._lock:
            self._specs.append(spec)
        return spec

    def clear(self):
        with self._lock:
            self._specs = []

    def specs(self) -> Tuple[FaultSpec, ...]:
        with self._lock:
            return tuple(self._specs)

    def evicted_ranks(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(
                sorted({s.rank for s in self._specs if s.kind == "evict" and s.rank >= 0})
            )

    def at(self, point: str, rank: int = -1):
        """Fire any matching faults at a named injection point."""
        fired: List[FaultSpec] = []
        with self._lock:
            if not self._specs:
                return
            for s in self._specs:
                if s.kind == "evict" or not s.matches(point, rank):
                    continue
                if s.times == 0:
                    continue
                if s.times > 0:
                    s.times -= 1
                fired.append(s)
        for s in fired:
            logger.warning(
                "fault injected: %s at %s (rank=%d)", s.kind, point, rank
            )
            if s.kind in ("slow_peer", "stall_migration"):
                time.sleep(s.delay_s)
            elif s.kind == "drop_page":
                raise DroppedPage(f"page dropped at {point} (rank={rank})")
            elif s.kind == "torn_donation":
                raise TornDonation(f"torn donation at {point} (rank={rank})")
            elif s.kind == "kill":
                raise InjectedKill(f"injected kill at {point} (rank={rank})")


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse ``"kind:key=val:key=val;kind2:..."`` into specs.

    Example: ``"torn_donation:point=donation:times=1;slow_peer:delay_s=2"``.

    Strict: any malformed clause — unknown kind, a ``key=value`` pair
    with no ``=``, an unknown key, or an unparseable value — raises
    ``ValueError`` naming the clause. A fault drill with a typo'd spec
    must fail loudly at startup, not silently run without the fault.
    """
    specs: List[FaultSpec] = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        if parts[0] not in KINDS:
            raise ValueError(
                f"malformed fault clause {chunk!r}: unknown kind "
                f"{parts[0]!r}; one of {KINDS}"
            )
        kw: Dict[str, object] = {}
        for part in parts[1:]:
            k, sep, v = part.partition("=")
            if not sep or not k:
                raise ValueError(
                    f"malformed fault clause {chunk!r}: expected key=value, "
                    f"got {part!r}"
                )
            if k in ("rank", "times"):
                try:
                    kw[k] = int(v)
                except ValueError:
                    raise ValueError(
                        f"malformed fault clause {chunk!r}: {k} must be an "
                        f"integer, got {v!r}"
                    ) from None
            elif k == "delay_s":
                try:
                    kw[k] = float(v)
                except ValueError:
                    raise ValueError(
                        f"malformed fault clause {chunk!r}: delay_s must be "
                        f"a float, got {v!r}"
                    ) from None
            elif k == "point":
                kw[k] = v
            else:
                raise ValueError(
                    f"malformed fault clause {chunk!r}: unknown key {k!r}; "
                    f"one of ('point', 'rank', 'delay_s', 'times')"
                )
        specs.append(FaultSpec(parts[0], **kw))
    return specs


_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def get_injector() -> FaultInjector:
    """Process-wide injector; seeds from ``DLROVER_TPU_FAULTS`` once."""
    global _injector
    with _injector_lock:
        if _injector is None:
            import os

            _injector = FaultInjector()
            text = os.environ.get("DLROVER_TPU_FAULTS", "")
            for spec in parse_faults(text):
                _injector.install(spec)
        return _injector


def reset_injector():
    global _injector
    with _injector_lock:
        _injector = None
