"""Brain-style resource optimization service and the auto-tuner.

Port of ``dlrover_tpu/cluster/brain.py`` (reference: dlrover/go/brain —
a cluster-level gRPC service with three RPCs, persist_metrics / optimize
/ get_job_metrics (proto/brain.proto:196-199), a MySQL datastore and
pluggable optimize algorithms, e.g. optimize_job_worker_resource.go;
consumed by the master when ``optimize_mode=cluster``,
resource/brain_optimizer.py).

The resource half: an in-process (or jsonl-persisted) metrics store and
the registry of optimize algorithms (first allocation from same-kind
history, its OOM memory hint, the running-job adjustment from observed
throughput, the sparse tier's memory and hot-shard hints), behind the
``ResourceOptimizer`` interface the master's auto-scaler consumes, so
``LocalHeuristicOptimizer``, an in-process ``BrainService`` and a
``BrainClient`` to ``python -m dlrover_tpu_torch.cluster.brain`` are
drop-in alternatives.

The auto-tuner half closes the telemetry → config loop over performance
knobs: :class:`ColdStartPlanner` derives a versioned :class:`TuningPlan`
(remat policy, batch size, comm buckets, wire dtypes, update sharding,
block_k) from the model shape and the mesh alone, and
:class:`BrainTuner` refines it from telemetry records (overlap drift →
re-bucket, fp8 amax saturation → a wider wire, OOM → the remat and
batch ladder, the serving curves → spec_k, prefill chunk, page
bucketing, slot count). Revisions are versioned by the master
(``JobManager.plan_tuning``) and reach trainers through the agent's
``ParalConfigTuner`` document; a worker folds one into its step-building
arguments with :func:`apply_revision` and rebuilds its step at a step
boundary (``ElasticTrainer.apply_tuning``).

The device tables are keyed by CUDA device name. The remat ladder is
the JAX package's, so plans stay equal; the port runs only ``"none"`` and
``"full"`` (ROADMAP A21), and :func:`apply_revision` refuses a revision
naming another policy with A21's error rather than map it.
"""

import json
import os
import threading
import time
from dataclasses import asdict, dataclass, replace
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.resource_optimizer import (
    ResourceOptimizer,
    ResourcePlan,
)
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.telemetry import telemetry_record

logger = get_logger(__name__)


@telemetry_record
class JobMetrics:
    """One observation of a running job (reference: brain.proto
    JobMetrics). A registered telemetry record (scalar fields only) so
    healthcheck can replay the Brain's inputs next to its tuning
    decisions. ``timestamp`` is stamped by :meth:`MetricsStore.append`
    when left 0; ``ts`` is the hub's publish stamp."""

    job_name: str = ""
    job_kind: str = ""            # user-declared workload family
    timestamp: float = 0.0
    worker_num: int = 0
    steps_per_sec: float = 0.0
    samples_per_sec: float = 0.0
    hbm_used_bytes: int = 0
    host_mem_used_bytes: int = 0
    finished: bool = False
    oom: bool = False
    ts: float = 0.0


@telemetry_record
class TuningPlan:
    """One versioned tuning directive: the cold-start plan or a live
    revision of one knob.

    Sentinels: ``""`` (strings), ``0`` (counts and sizes) and ``-1``
    (``spec_k``, ``page_bucketing``, where 0 is meaningful) mean "leave
    that knob alone", so a revision carries exactly the knob it changed.
    ``origin`` is ``cold_start`` (a full plan) or ``revision``; a
    revision also names the ``knob`` it moved and the telemetry
    ``signal`` behind it. Versions are minted by the master
    (``JobManager.plan_tuning``) when wired, else by the tuner."""

    version: int = 0
    origin: str = "cold_start"     # cold_start | revision
    signal: str = ""               # telemetry signal behind a revision
    knob: str = ""                 # the knob a revision changed
    reason: str = ""
    # train knobs
    block_k: int = 1               # fused train steps per dispatch
    remat: str = ""                # rematerialisation policy; "" = leave
    batch_size: int = 0            # per-device micro batch; 0 = leave
    grad_accum_steps: int = 0      # 0 = leave
    comm_bucket_mb: float = 0.0    # ZeRO exchange bucket; 0 = leave
    comm_wire_dtype: str = ""      # dp exchange wire dtype; "" = leave
    comm_wire_dtype_dcn: str = ""  # cross-slice override; "" = none
    update_sharding: str = ""      # "" leave | off | zero1 | zero2
    # serving knobs
    spec_k: int = -1               # speculative draft length; -1 = leave
    prefill_chunk: int = 0         # 0 = leave
    page_bucketing: int = -1       # -1 leave | 0 off | 1 on
    n_slots: int = 0               # engine batch slots; 0 = leave
    ts: float = 0.0


class BaseMetricsStore:
    """Datastore contract the Brain runs over (reference: the Go
    brain's pluggable datastore, go/brain/pkg/datastore)."""

    def append(self, m: JobMetrics) -> None:
        raise NotImplementedError

    def job_rows(self, job_name: str) -> List[JobMetrics]:
        raise NotImplementedError

    def kind_rows(self, job_kind: str) -> List[JobMetrics]:
        raise NotImplementedError


class MetricsStore(BaseMetricsStore):
    """Append-only metrics log, optionally persisted as jsonl."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._lock = threading.Lock()
        self._rows: List[JobMetrics] = []
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        self._rows.append(JobMetrics(**json.loads(line)))
                    except (TypeError, json.JSONDecodeError):
                        continue

    def append(self, m: JobMetrics):
        if not m.timestamp:
            m.timestamp = time.time()
        with self._lock:
            self._rows.append(m)
            if self._path:
                with open(self._path, "a") as f:
                    f.write(json.dumps(asdict(m)) + "\n")

    def job_rows(self, job_name: str) -> List[JobMetrics]:
        with self._lock:
            return [r for r in self._rows if r.job_name == job_name]

    def kind_rows(self, job_kind: str) -> List[JobMetrics]:
        with self._lock:
            return [r for r in self._rows if r.job_kind == job_kind]


# ---- pluggable optimize algorithms ----------------------------------------
#
# Reference: go/brain/pkg/optimizer/implementation/optalgorithm/
# optimize_algorithm.go — a name → algorithm registry; a stage runs a
# chain of algorithms, later ones only fill fields the earlier ones left
# unset (worker_num) or merge resource hints.

OptimizeAlgorithm = Callable[["BrainService", Dict], ResourcePlan]
_ALGORITHMS: Dict[str, OptimizeAlgorithm] = {}


def register_algorithm(name: str):
    def deco(fn):
        _ALGORITHMS[name] = fn
        return fn

    return deco


def get_algorithm(name: str) -> "OptimizeAlgorithm":
    try:
        return _ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown brain algorithm {name!r}; registered: "
            f"{sorted(_ALGORITHMS)}"
        ) from None


def _merge_plans(base: ResourcePlan, extra: ResourcePlan) -> ResourcePlan:
    if base.worker_num is None:
        base.worker_num = extra.worker_num
    for role, res in extra.node_resources.items():
        base.node_resources.setdefault(role, {}).update(res)
    return base


DEFAULT_STAGE_CHAINS = {
    "create": [
        "job_worker_create_resource",
        "job_worker_create_oom_resource",
    ],
    "running": [
        "job_worker_resource",
        "job_ps_oom_resource",
        "job_hot_ps_resource",
    ],
}


class BrainService(ResourceOptimizer):
    """persist_metrics / optimize, cluster-memory backed."""

    def __init__(
        self,
        store: Optional[BaseMetricsStore] = None,
        min_workers: int = 1,
        max_workers: int = 64,
        node_unit: int = 1,
        efficiency_floor: float = 0.7,
        stage_chains: Optional[Dict[str, List[str]]] = None,
    ):
        self.store = store or MetricsStore()
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.node_unit = max(1, node_unit)
        self.efficiency_floor = efficiency_floor
        self.stage_chains = stage_chains or DEFAULT_STAGE_CHAINS
        self._job_name = ""
        self._job_kind = ""

    def bind_job(self, job_name: str, job_kind: str = ""):
        self._job_name = job_name
        self._job_kind = job_kind

    # ---- brain.proto persist_metrics --------------------------------------

    def persist_metrics(self, m: JobMetrics):
        self.store.append(m)

    def get_job_metrics(self, job_name: str) -> List[JobMetrics]:
        return self.store.job_rows(job_name)

    # ---- brain.proto optimize (ResourceOptimizer interface) ---------------

    def generate_plan(self, stage: str, stats: Dict) -> ResourcePlan:
        plan = ResourcePlan()
        for name in self.stage_chains.get(stage, []):
            plan = _merge_plans(plan, get_algorithm(name)(self, stats))
        return plan

    def _first_allocation(self) -> ResourcePlan:
        """Cold-start worker count from completed jobs of the same kind
        (reference: optimize_job_worker_create_resource.go)."""
        plan = ResourcePlan()
        history = [
            r
            for r in self.store.kind_rows(self._job_kind)
            if r.finished and r.worker_num > 0 and not r.oom
        ]
        if not history:
            return plan
        # the worker count with the best observed samples/sec/worker
        by_n: Dict[int, List[float]] = {}
        for r in history:
            if r.samples_per_sec > 0:
                by_n.setdefault(r.worker_num, []).append(
                    r.samples_per_sec / r.worker_num
                )
        if not by_n:
            return plan
        best = max(by_n, key=lambda n: sum(by_n[n]) / len(by_n[n]))
        plan.worker_num = self._clamp(best)
        logger.info(
            "brain first-allocation for kind %r: %d workers "
            "(from %d history rows)",
            self._job_kind,
            plan.worker_num,
            len(history),
        )
        return plan

    def _adjust_running(self, stats: Dict) -> ResourcePlan:
        """Running-job adjustment (reference:
        optimize_job_worker_resource.go): grow while marginal throughput
        holds; on OOM raise per-host memory hints instead of count."""
        plan = ResourcePlan()
        rows = self.store.job_rows(self._job_name)
        if stats.get("oom") or any(r.oom for r in rows[-3:]):
            plan.node_resources["worker"] = {"memory_scale": 1.5}
            return plan
        speeds: Dict[int, float] = {}
        for r in rows:
            if r.worker_num > 0 and r.steps_per_sec > 0:
                speeds[r.worker_num] = max(
                    speeds.get(r.worker_num, 0.0), r.steps_per_sec
                )
        cur_n = int(stats.get("worker_num", 0))
        cur_speed = float(stats.get("steps_per_sec", 0.0))
        if cur_n <= 0 or cur_speed <= 0.0:
            return plan
        speeds[cur_n] = max(speeds.get(cur_n, 0.0), cur_speed)
        smaller = [n for n in speeds if n < cur_n]
        if smaller:
            base = max(smaller)
            # scaling efficiency against the smaller observed size
            eff = (speeds[cur_n] / speeds[base]) * (base / cur_n)
            if eff < self.efficiency_floor:
                plan.worker_num = self._clamp(cur_n - self.node_unit)
                return plan
        if cur_n < self.max_workers:
            cand = self._clamp(cur_n + self.node_unit)
            # don't grow back into a size already observed to scale
            # poorly against the current one: that would thrash nodes
            # between grow and shrink forever
            for n2, s2 in speeds.items():
                if cur_n < n2 <= cand:
                    eff2 = (s2 / speeds[cur_n]) * (cur_n / n2)
                    if eff2 < self.efficiency_floor:
                        return plan
            if cand > cur_n:
                plan.worker_num = cand
        return plan

    def _clamp(self, n: int) -> int:
        n = max(self.min_workers, min(self.max_workers, n))
        n = (n // self.node_unit) * self.node_unit or self.node_unit
        # the unit floor may have dropped below min_workers: restore it
        while n < self.min_workers:
            n += self.node_unit
        return min(n, max(self.max_workers, self.min_workers))


# ---- stock algorithms ------------------------------------------------------


@register_algorithm("job_worker_create_resource")
def _algo_worker_create(svc: BrainService, stats: Dict) -> ResourcePlan:
    """First allocation from same-kind history
    (optimize_job_worker_create_resource.go analog)."""
    return svc._first_allocation()


@register_algorithm("job_worker_create_oom_resource")
def _algo_worker_create_oom(svc: BrainService, stats: Dict) -> ResourcePlan:
    """Cold-start memory hint when this kind's history shows OOMs
    (optimize_job_worker_create_oom_resource.go analog)."""
    plan = ResourcePlan()
    rows = svc.store.kind_rows(svc._job_kind)
    ooms = sum(1 for r in rows if r.oom)
    if rows and ooms and ooms >= max(1, len(rows) // 4):
        plan.node_resources["worker"] = {"memory_scale": 1.5}
        logger.info(
            "brain create-oom hint for kind %r: %d/%d history rows OOMed",
            svc._job_kind,
            ooms,
            len(rows),
        )
    return plan


@register_algorithm("job_worker_resource")
def _algo_worker_resource(svc: BrainService, stats: Dict) -> ResourcePlan:
    """Running-job worker adjustment
    (optimize_job_worker_resource.go analog)."""
    return svc._adjust_running(stats)


@register_algorithm("job_ps_oom_resource")
def _algo_ps_oom(svc: BrainService, stats: Dict) -> ResourcePlan:
    """Sparse-tier memory pressure (optimize_job_ps_oom_resource.go
    analog): a shard host near its memory cap gets one more PS node."""
    plan = ResourcePlan()
    used = stats.get("ps_mem_used_bytes")
    cap = stats.get("ps_mem_cap_bytes")
    ps_num = int(stats.get("ps_num", 0))
    if used and cap and ps_num and used / cap > 0.85:
        plan.node_resources["ps"] = {"num": ps_num + 1}
        logger.info(
            "brain ps-oom: %.0f%% of sparse-tier memory used → %d ps",
            100 * used / cap,
            ps_num + 1,
        )
    return plan


@register_algorithm("job_hot_ps_resource")
def _algo_hot_ps(svc: BrainService, stats: Dict) -> ResourcePlan:
    """Hot-shard rebalance (optimize_job_hot_ps_resource.go analog):
    when one sparse shard takes a disproportionate share of lookups,
    emit per-shard HRW weights that shift keys off it."""
    plan = ResourcePlan()
    qps: Dict[str, float] = stats.get("ps_shard_qps") or {}
    if len(qps) < 2:
        return plan
    total = sum(qps.values())
    if total <= 0:
        return plan
    mean = total / len(qps)
    hot = {s: q for s, q in qps.items() if q > 2.0 * mean}
    if not hot:
        return plan
    # weight inversely to load, normalized to mean 1.0
    weights = {s: mean / max(q, 1e-9) for s, q in qps.items()}
    norm = sum(weights.values()) / len(weights)
    plan.node_resources["ps"] = {
        "weights": {s: w / norm for s, w in weights.items()}
    }
    logger.info(
        "brain hot-ps: shards %s over 2x mean qps → rebalance weights",
        sorted(hot),
    )
    return plan


# ---------------------------------------------------------------------------
# Auto-tuner: cold-start planning + live refinement
# ---------------------------------------------------------------------------

# cheapest-first remat ladder, the JAX package's: each step trades more
# recompute for a smaller residual set; BrainTuner's OOM ladder descends
# it left → right. The port runs "none" and "full" (PORTED_REMAT).
REMAT_LADDER = (
    "none",
    "save_dots",
    "save_qkv_gate",
    "save_qkv",
    "save_attn",
    "full",
)
PORTED_REMAT = ("none", "full")
# activation bytes ≈ tokens × d_model × 2 (bf16) × n_layer × scale: the
# per-layer residual multiple each policy keeps live ("none" keeps the
# full ×12 working set, "full" one boundary tensor per layer)
_ACT_SCALE = {
    "none": 12.0,
    "save_dots": 8.0,
    "save_qkv_gate": 5.0,
    "save_qkv": 3.0,
    "save_attn": 2.0,
    "full": 1.0,
}
_OPT_SLOTS = {"adamw": 2, "adam": 2, "agd": 3, "sgd": 1, "lion": 1}
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}
# the link a dp exchange crosses, GB/s per direction, by CUDA device
# name (lower case, matched as a substring). The H100 SXM's NVLink 4
# (18 links × 25 GB/s a direction) is the datasheet value, not
# measured: one card cannot measure its NVLink. "cpu" is the JAX
# package's loopback figure, so a plan on the CPU is the JAX one.
_LINK_GBPS = {
    "h100": 450.0,
    "cpu": 10.0,
}
# device memory by CUDA device name, for a kind no card here can be
# asked about (the datasheet's 80 GB for the H100 80GB parts)
_DEVICE_HBM_GB = {"h100": 80.0}
# the card this port targets: a kind neither table knows plans as one
_DEFAULT_KIND = "h100"


def _link_gbps(device_kind: str = "") -> float:
    kind = (device_kind or "").lower()
    for key, val in _LINK_GBPS.items():
        if key in kind:
            return val
    return _LINK_GBPS[_DEFAULT_KIND]


def _device_hbm_bytes(device_kind: str = "") -> float:
    """Device memory of ``device_kind``: a local CUDA device of that name
    (any local one when no kind is given) answers through
    ``torch.cuda.get_device_properties``; else the table."""
    import torch

    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            if not device_kind or torch.cuda.get_device_name(i) == device_kind:
                return float(torch.cuda.get_device_properties(i).total_memory)
    kind = (device_kind or "").lower()
    for key, gb in _DEVICE_HBM_GB.items():
        if key in kind:
            return gb * 1e9
    return _DEVICE_HBM_GB[_DEFAULT_KIND] * 1e9


def _suggest_bucket_mb(total_grad_bytes, device_kind="", launch_us=5.0,
                       grad_accum=1, update_mode=""):
    """The JAX bench's bucket rule: the smallest bucket whose wire time
    dominates launch latency, but ≥ 4 buckets in flight, clamped to
    [1, 64] MB."""
    gbps = _link_gbps(device_kind)
    passes = grad_accum if (update_mode == "zero2" and grad_accum > 1) else 1
    min_bytes = 4.0 * launch_us * passes * gbps * 1e3
    mb = max(1.0, min_bytes / 2**20)
    mb = min(mb, max(1.0, total_grad_bytes / 4 / 2**20))
    return round(min(mb, 64.0), 2)


def estimate_hbm_bytes(
    cfg,
    batch_per_chip: int,
    seq: int,
    remat: str,
    param_shards: int = 1,
    optimizer: str = "adamw",
    state_dtype: str = "bfloat16",
) -> float:
    """Peak device-memory estimate for one device running ``cfg`` at
    this shape (the JAX package's model).

    Model states = params f32 + optimizer slots at ``state_dtype``;
    gradients are transient (no persistent term). The logits term
    honors fused CE: with ``cfg.fused_ce`` only one ``ce_block_v``-wide
    f32 chunk is ever live. ×1.05 slack for fragmentation/workspace.
    """
    n = float(cfg.num_params())
    slots = _OPT_SLOTS.get(optimizer, 2)
    state_b = _DTYPE_BYTES.get(state_dtype or "float32", 4)
    model_states = (n * 4.0 + n * slots * state_b) / max(1, param_shards)
    tokens = float(batch_per_chip) * float(seq)
    act = tokens * cfg.d_model * 2.0 * cfg.n_layer * _ACT_SCALE.get(
        remat, 12.0
    )
    if getattr(cfg, "fused_ce", False):
        logits = tokens * cfg.ce_block_v * 4.0
    else:
        logits = tokens * cfg.vocab_size * 4.0
    return (model_states + act + logits) * 1.05


class ColdStartPlanner:
    """Zero-config plan from only the model shape + mesh.

    Picks the largest per-device batch whose cheapest-fitting remat
    policy stays under the memory budget, then derives the comm knobs:
    the bucket size from ``_suggest_bucket_mb``, an f32 wire inside a
    slice with an int8 override across slices, the ZeRO mode from the
    mesh (zero2 when the exchange amortizes over grad accumulation)."""

    def __init__(
        self,
        hbm_fraction: float = 0.92,
        target_tokens_per_chip: int = 8192,
    ):
        self.hbm_fraction = hbm_fraction
        self.target_tokens_per_chip = target_tokens_per_chip

    def plan(
        self,
        cfg,
        mesh=None,
        n_devices: int = 1,
        seq: int = 0,
        device_kind: str = "",
        hbm_bytes: float = 0.0,
        grad_accum: int = 1,
        optimizer: str = "adamw",
        state_dtype: str = "bfloat16",
    ) -> "TuningPlan":
        seq = int(seq or getattr(cfg, "max_seq", 1024))
        hbm = float(hbm_bytes or _device_hbm_bytes(device_kind))
        budget = hbm * self.hbm_fraction
        if mesh is None:
            sizes = {"dp": max(1, n_devices), "pp": 1, "ep": 1, "fsdp": 1,
                     "sp": 1, "tp": 1}
            num_slices = 1
        elif isinstance(mesh, dict):
            sizes = {k: int(mesh.get(k, 1)) for k in
                     ("dp", "pp", "ep", "fsdp", "sp", "tp")}
            num_slices = int(mesh.get("num_slices", 1))
        else:
            sizes = mesh.resolved_sizes(n_devices)
            num_slices = getattr(mesh, "num_slices", 1)
        param_shards = sizes["fsdp"] * sizes["tp"] * sizes["pp"]

        batch, remat, fits = 1, "full", False
        start = max(1, self.target_tokens_per_chip // seq)
        for b in range(start, 0, -1):
            for r in REMAT_LADDER:
                if estimate_hbm_bytes(
                    cfg, b, seq, r,
                    param_shards=param_shards,
                    optimizer=optimizer,
                    state_dtype=state_dtype,
                ) <= budget:
                    batch, remat, fits = b, r, True
                    break
            if fits:
                break

        n = float(cfg.num_params())
        update_sharding = ""
        if sizes["dp"] > 1 and sizes["pp"] == 1:
            # zero1 shards the update; zero2's per-microbatch
            # reduce-scatter only pays off when accumulation amortizes it
            update_sharding = "zero2" if grad_accum > 1 else "zero1"
        bucket = _suggest_bucket_mb(
            n * 4.0 / max(1, param_shards),
            device_kind,
            grad_accum=grad_accum,
            update_mode=update_sharding,
        )
        # small models at short sequence amortize dispatch overhead by
        # fusing K train steps into one call
        block_k = 8 if (n < 2e8 and seq <= 1024) else 1
        reason = (
            f"model={getattr(cfg, 'name', '?')} seq={seq} "
            f"hbm_gb={hbm / 1e9:.1f} shards={param_shards}"
        )
        if not fits:
            reason += " (no shape fits; emitting minimum)"
            logger.warning(
                "cold-start planner: no (batch, remat) fits %s under "
                "%.1f GB; emitting batch=1 remat=full anyway",
                getattr(cfg, "name", "?"), budget / 1e9,
            )
        return TuningPlan(
            version=1,
            origin="cold_start",
            signal="model_shape",
            reason=reason,
            block_k=block_k,
            remat=remat,
            batch_size=batch,
            grad_accum_steps=max(1, grad_accum),
            comm_bucket_mb=bucket,
            comm_wire_dtype="float32",
            comm_wire_dtype_dcn="int8" if num_slices > 1 else "",
            update_sharding=update_sharding,
        )


@dataclass(frozen=True)
class StepArgs:
    """The step-building arguments a :class:`TuningPlan` moves: the
    model config's ``remat``, the ``CommConfig`` fields (the bucket, the
    wire dtypes, the update sharding) and ``TrainStepBuilder``'s
    ``grad_accum``, under the JAX ``AccelerationPlan``'s field names."""

    remat: str = "none"
    comm_bucket_mb: float = 4.0
    comm_wire_dtype: str = "float32"
    comm_wire_dtype_dcn: Optional[str] = None
    update_sharding: object = False   # False | True | "zero1" | "zero2"
    grad_accum: int = 1

    def comm_config(self):
        """The ``parallel.sharding.CommConfig`` of these arguments."""
        from dlrover_tpu_torch.parallel.sharding import CommConfig

        return CommConfig(update_sharding=self.update_sharding,
                          bucket_mb=self.comm_bucket_mb,
                          wire_dtype=self.comm_wire_dtype,
                          wire_dtype_dcn=self.comm_wire_dtype_dcn)


def check_remat(remat: str) -> None:
    """Refuse a remat policy the port cannot run (ROADMAP A21's error);
    "" (leave the knob alone) passes."""
    if remat and remat not in PORTED_REMAT:
        from dlrover_tpu_torch.models.decoder import _REMAT_NAMED

        raise NotImplementedError(
            f"tuning revision remat={remat!r}: {_REMAT_NAMED}")


def apply_revision(args: StepArgs, tp: "TuningPlan") -> StepArgs:
    """Fold a :class:`TuningPlan` into ``args``: the JAX package's field
    mapping onto its ``AccelerationPlan``, honoring the leave-alone
    sentinels, so the trainer can rebuild its step from the revised
    arguments at a step boundary without a restart. A remat policy the
    port cannot run raises (:func:`check_remat`): it is never mapped to
    another policy."""
    check_remat(tp.remat)
    kw = {}
    if tp.remat:
        kw["remat"] = tp.remat
    if tp.comm_bucket_mb:
        kw["comm_bucket_mb"] = float(tp.comm_bucket_mb)
    if tp.comm_wire_dtype:
        kw["comm_wire_dtype"] = tp.comm_wire_dtype
    if tp.comm_wire_dtype_dcn:
        kw["comm_wire_dtype_dcn"] = tp.comm_wire_dtype_dcn
    if tp.update_sharding:
        kw["update_sharding"] = (
            False if tp.update_sharding == "off" else tp.update_sharding
        )
    if tp.grad_accum_steps:
        kw["grad_accum"] = int(tp.grad_accum_steps)
    return replace(args, **kw) if kw else args


class BrainTuner:
    """Live refinement: subscribe to the telemetry hub, turn sustained
    signals into one-knob :class:`TuningPlan` revisions.

    Ladders (the JAX package's):

    * overlap drift (``OverlapDriftRecord.drift_frac`` over threshold
      for ``drift_patience`` consecutive samples) → double
      ``comm_bucket_mb``, clamped to [1, 64];
    * fp8 amax saturation (``AnomalyRecord(kind="fp8_saturation")``) →
      ascend the wire-dtype ladder int8 → bfloat16 → float32 (the
      cross-slice override first when one is set);
    * OOM (:meth:`on_failure` or an ``AnomalyRecord(kind="oom")``) →
      descend :data:`REMAT_LADDER`; past ``full``, halve the batch;
    * serving (``ServingRecord``): accept-rate EWMA high/low →
      ``spec_k`` ±1; TTFT p99 over target → halve ``prefill_chunk``;
      full slots with queued work → grow ``n_slots`` (idle → shrink);
      a rising ``table_ships`` rate (:meth:`observe_serving_stats`) →
      enable page bucketing.

    Each revision is versioned through ``report`` (the master's
    ``plan_tuning``) when wired, else a local counter; applied to the
    held plan; and published on the hub so the flight recorder and
    healthcheck can replay the decision trail. A per-knob cooldown
    keeps the loop from thrashing.
    """

    WIRE_LADDER = ("int8", "bfloat16", "float32")

    def __init__(
        self,
        plan: "TuningPlan",
        report: Optional[Callable[["TuningPlan"], int]] = None,
        cooldown_s: float = 30.0,
        drift_frac_threshold: float = 0.25,
        drift_patience: int = 3,
        accept_high: float = 0.8,
        accept_low: float = 0.4,
        spec_k_max: int = 8,
        ttft_target_ms: float = 0.0,
        prefill_chunk_min: int = 16,
        occupancy_patience: int = 3,
        table_ship_budget: int = 4,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.plan = plan
        self.revisions: List[TuningPlan] = []
        self._report = report
        self._version = int(plan.version)
        self._cooldown_s = cooldown_s
        self._drift_threshold = drift_frac_threshold
        self._drift_patience = drift_patience
        self._accept_high = accept_high
        self._accept_low = accept_low
        self._spec_k_max = spec_k_max
        self._ttft_target_ms = ttft_target_ms
        self._prefill_chunk_min = prefill_chunk_min
        self._occupancy_patience = occupancy_patience
        self._table_ship_budget = table_ship_budget
        self._clock = clock
        self._lock = threading.Lock()
        self._last_rev_t: Dict[str, float] = {}
        self._drift_streak = 0
        self._accept_ewma: Optional[float] = None
        self._occupancy_streak = 0
        self._idle_streak = 0
        self._last_table_ships: Optional[int] = None
        self._sink = None

    # ---- hub wiring -------------------------------------------------------

    def attach(self, hub):
        """Subscribe to the signals this tuner consumes; returns the
        sink (pass to ``hub.remove_sink`` to detach)."""
        self._sink = hub.subscribe(
            self.on_record,
            types=("OverlapDriftRecord", "AnomalyRecord", "ServingRecord"),
        )
        return self._sink

    def on_record(self, record) -> None:
        name = type(record).__name__
        if name == "OverlapDriftRecord":
            self._on_drift(record)
        elif name == "AnomalyRecord":
            self._on_anomaly(record)
        elif name == "ServingRecord":
            self._on_serving(record)

    # ---- train ladders ----------------------------------------------------

    def _on_drift(self, r) -> None:
        if r.drift_frac <= self._drift_threshold:
            self._drift_streak = 0
            return
        self._drift_streak += 1
        if self._drift_streak < self._drift_patience:
            return
        cur = self.plan.comm_bucket_mb or 4.0
        new = round(min(64.0, cur * 2.0), 2)
        if new == cur:
            return
        if self._revise(
            "comm_bucket_mb",
            signal="overlap_drift",
            reason=(
                f"drift_frac={r.drift_frac:.2f} over "
                f"{self._drift_streak} samples; bucket {cur}→{new} MB"
            ),
            comm_bucket_mb=new,
        ):
            self._drift_streak = 0

    def _on_anomaly(self, r) -> None:
        if r.kind == "fp8_saturation":
            self._widen_wire(r.detail)
        elif r.kind == "oom":
            self.on_failure("oom", r.detail)

    def _widen_wire(self, detail: str = "") -> None:
        # the narrow wire is wherever the plan put it: the cross-slice
        # override when one is set, else the dp wire
        if self.plan.comm_wire_dtype_dcn:
            knob, cur = "comm_wire_dtype_dcn", self.plan.comm_wire_dtype_dcn
        else:
            knob, cur = "comm_wire_dtype", self.plan.comm_wire_dtype
        cur = cur or "float32"
        try:
            idx = self.WIRE_LADDER.index(cur)
        except ValueError:
            return
        if idx >= len(self.WIRE_LADDER) - 1:
            return  # already float32: nothing wider
        wider = self.WIRE_LADDER[idx + 1]
        self._revise(
            knob,
            signal="fp8_saturation",
            reason=f"amax saturation; {knob} {cur}→{wider} {detail}".strip(),
            **{knob: wider},
        )

    def on_failure(self, kind: str, detail: str = "") -> Optional["TuningPlan"]:
        """Feed a failure classifier's verdict (oom | compile_error |
        timeout | error); OOM descends the remat ladder, then the
        batch."""
        if kind != "oom":
            return None
        cur = self.plan.remat or "none"
        try:
            idx = REMAT_LADDER.index(cur)
        except ValueError:
            idx = 0
        if idx < len(REMAT_LADDER) - 1:
            nxt = REMAT_LADDER[idx + 1]
            return self._revise(
                "remat",
                signal="oom",
                reason=f"oom; remat {cur}→{nxt} {detail}".strip(),
                remat=nxt,
            )
        batch = self.plan.batch_size
        if batch > 1:
            return self._revise(
                "batch_size",
                signal="oom",
                reason=f"oom at remat=full; batch {batch}→{batch // 2}",
                batch_size=batch // 2,
            )
        logger.warning("oom with remat=full batch=1: ladder exhausted")
        return None

    # ---- serving ladders --------------------------------------------------

    def _on_serving(self, r) -> None:
        if r.draft_tokens > 0 and self.plan.spec_k >= 0:
            rate = r.spec_accept_rate
            self._accept_ewma = (
                rate
                if self._accept_ewma is None
                else 0.7 * self._accept_ewma + 0.3 * rate
            )
            k = self.plan.spec_k
            if self._accept_ewma > self._accept_high and k < self._spec_k_max:
                self._revise(
                    "spec_k",
                    signal="spec_accept_rate",
                    reason=f"accept ewma {self._accept_ewma:.2f} high; "
                           f"spec_k {k}→{k + 1}",
                    spec_k=k + 1,
                )
            elif self._accept_ewma < self._accept_low and k > 0:
                self._revise(
                    "spec_k",
                    signal="spec_accept_rate",
                    reason=f"accept ewma {self._accept_ewma:.2f} low; "
                           f"spec_k {k}→{k - 1}",
                    spec_k=k - 1,
                )
        if (
            self._ttft_target_ms
            and r.ttft_p99_ms > self._ttft_target_ms
            and self.plan.prefill_chunk > self._prefill_chunk_min
        ):
            cur = self.plan.prefill_chunk
            new = max(self._prefill_chunk_min, cur // 2)
            self._revise(
                "prefill_chunk",
                signal="ttft_p99",
                reason=f"ttft_p99 {r.ttft_p99_ms:.0f}ms over "
                       f"{self._ttft_target_ms:.0f}ms; chunk {cur}→{new}",
                prefill_chunk=new,
            )
        if self.plan.n_slots > 0:
            n = self.plan.n_slots
            if r.active_slots >= n and r.queue_depth > 0:
                self._occupancy_streak += 1
                self._idle_streak = 0
            elif r.queue_depth == 0 and r.active_slots * 2 <= n:
                self._idle_streak += 1
                self._occupancy_streak = 0
            else:
                self._occupancy_streak = self._idle_streak = 0
            grow = max(1, n // 4)
            if self._occupancy_streak >= self._occupancy_patience:
                if self._revise(
                    "n_slots",
                    signal="occupancy",
                    reason=f"slots full with queue {r.queue_depth}; "
                           f"n_slots {n}→{n + grow}",
                    n_slots=n + grow,
                ):
                    self._occupancy_streak = 0
            elif self._idle_streak >= self._occupancy_patience and n > 1:
                new = max(1, n - grow)
                if new != n and self._revise(
                    "n_slots",
                    signal="occupancy",
                    reason=f"≤half slots busy, empty queue; "
                           f"n_slots {n}→{new}",
                    n_slots=new,
                ):
                    self._idle_streak = 0

    def observe_serving_stats(self, stats: Dict) -> None:
        """Consume an engine ``stats()`` snapshot for the signals not on
        ``ServingRecord``: the block-table ship rate."""
        ships = int(stats.get("table_ships", 0))
        if (
            self._last_table_ships is not None
            and ships - self._last_table_ships > self._table_ship_budget
            and self.plan.page_bucketing != 1
        ):
            self._revise(
                "page_bucketing",
                signal="table_ships",
                reason=f"{ships - self._last_table_ships} table ships "
                       f"since last snapshot; enabling page bucketing",
                page_bucketing=1,
            )
        self._last_table_ships = ships

    # ---- revision machinery -----------------------------------------------

    def _revise(
        self, knob: str, signal: str, reason: str, **fields
    ) -> Optional["TuningPlan"]:
        with self._lock:
            now = self._clock()
            last = self._last_rev_t.get(knob)
            if last is not None and now - last < self._cooldown_s:
                return None
            rev = TuningPlan(
                origin="revision",
                signal=signal,
                knob=knob,
                reason=reason,
                **fields,
            )
            version = 0
            if self._report is not None:
                try:
                    version = int(self._report(rev) or 0)
                except Exception:  # noqa: BLE001 — master unreachable
                    logger.warning(
                        "tuning revision report failed; versioning "
                        "locally",
                        exc_info=True,
                    )
            if not version:
                version = self._version + 1
            self._version = max(self._version, version)
            rev.version = version
            self.plan = replace(self.plan, version=version, **fields)
            self.revisions.append(rev)
            self._last_rev_t[knob] = now
        logger.info(
            "tuning revision v%d: %s (%s) — %s",
            rev.version, knob, signal, reason,
        )
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(rev)
        return rev


def master_report(client) -> Callable[["TuningPlan"], int]:
    """A :class:`BrainTuner` ``report`` over a ``MasterClient``: the
    revision goes to the master as a ``TuningPlanNotice`` (its asdict
    JSON) and the version is the one the master minted for it."""

    def report(rev: "TuningPlan") -> int:
        if not client.report_tuning_plan(json.dumps(asdict(rev)),
                                         signal=rev.signal,
                                         reason=rev.reason):
            return 0
        return client.get_tuning().version

    return report


# ---------------------------------------------------------------------------
# Wire service (reference: the Go brain is a standalone cluster-level
# service shared across jobs, proto/brain.proto:196-199; masters reach it
# through BrainResoureOptimizer, resource/brain_optimizer.py). The same
# split over the port's two-RPC transport (common/comm.py).
# ---------------------------------------------------------------------------


class _BrainServicer:
    """Transport servicer over one shared BrainService."""

    def __init__(self, service: BrainService):
        self._svc = service
        # bind_job mutates per-job state on the shared service; requests
        # from many masters interleave, so bind + optimize is one atom
        self._lock = threading.Lock()

    @staticmethod
    def unported(type_name: str) -> Optional[str]:
        return None

    def report(self, msg) -> bool:
        from dlrover_tpu_torch.common import messages as msgs

        if isinstance(msg, msgs.BrainPersistMetricsRequest):
            try:
                self._svc.persist_metrics(
                    JobMetrics(**json.loads(msg.metrics_json))
                )
                return True
            except (TypeError, json.JSONDecodeError):
                logger.exception("bad persist_metrics payload")
                return False
        return False

    def get(self, msg):
        from dlrover_tpu_torch.common import messages as msgs

        if isinstance(msg, msgs.BrainOptimizeRequest):
            try:
                with self._lock:
                    self._svc.bind_job(msg.job_name, msg.job_kind)
                    plan = self._svc.generate_plan(
                        msg.stage, json.loads(msg.stats_json)
                    )
                return msgs.BrainOptimizeResponse(
                    plan_json=json.dumps(asdict(plan))
                )
            except Exception as e:  # noqa: BLE001
                logger.exception("brain optimize failed")
                return msgs.BrainOptimizeResponse(error=str(e))
        if isinstance(msg, msgs.BrainJobMetricsRequest):
            rows = self._svc.get_job_metrics(msg.job_name)
            return msgs.BrainJobMetricsResponse(
                rows_json=json.dumps([asdict(r) for r in rows])
            )
        return None


class BrainWireServer:
    """Hosts one BrainService for the whole cluster."""

    def __init__(self, service: Optional[BrainService] = None, port: int = 0):
        from dlrover_tpu_torch.common.comm import MasterTransportServer

        self.service = service or BrainService()
        self._server = MasterTransportServer(
            _BrainServicer(self.service), port=port
        )
        self._server.start()
        self.port = self._server.port

    def stop(self):
        self._server.stop()


class BrainClient(ResourceOptimizer):
    """Master-side optimizer backed by a remote Brain
    (``optimize_mode=cluster``): drop-in where LocalHeuristicOptimizer
    or an in-process BrainService goes (bind_job + generate_plan), plus
    the persist and get metrics calls."""

    def __init__(self, addr: str, timeout_s: float = 30.0):
        from dlrover_tpu_torch.common.comm import MasterTransportClient

        self._t = MasterTransportClient(addr, timeout_s=timeout_s)
        self._job_name = ""
        self._job_kind = ""

    def bind_job(self, job_name: str, job_kind: str = ""):
        self._job_name = job_name
        self._job_kind = job_kind

    def persist_metrics(self, m: JobMetrics) -> bool:
        from dlrover_tpu_torch.common import messages as msgs

        return self._t.report(
            msgs.BrainPersistMetricsRequest(metrics_json=json.dumps(asdict(m)))
        )

    def get_job_metrics(self, job_name: str) -> List[JobMetrics]:
        from dlrover_tpu_torch.common import messages as msgs

        resp = self._t.get(msgs.BrainJobMetricsRequest(job_name=job_name))
        if resp is None or resp.error:
            raise RuntimeError(
                f"brain get_job_metrics failed: "
                f"{'unreachable' if resp is None else resp.error}"
            )
        return [JobMetrics(**d) for d in json.loads(resp.rows_json)]

    def generate_plan(self, stage: str, stats: Dict) -> ResourcePlan:
        from dlrover_tpu_torch.common import messages as msgs

        try:
            resp = self._t.get(
                msgs.BrainOptimizeRequest(
                    job_name=self._job_name,
                    job_kind=self._job_kind,
                    stage=stage,
                    stats_json=json.dumps(stats),
                )
            )
        except Exception as e:  # noqa: BLE001 — transport failure
            logger.warning(
                "brain optimize unreachable (%s); returning empty plan", e
            )
            return ResourcePlan()
        if resp is None or resp.error:
            # an unreachable or failing Brain must not stall the job: an
            # empty plan means "no change"
            logger.warning(
                "brain optimize unavailable (%s); returning empty plan",
                "unreachable" if resp is None else resp.error,
            )
            return ResourcePlan()
        return ResourcePlan(**json.loads(resp.plan_json))

    def close(self):
        self._t.close()


def main(argv: Optional[List[str]] = None) -> int:
    """Run the cluster Brain as its own process (reference: go/brain's
    standalone deployment): ``python -m dlrover_tpu_torch.cluster.brain
    --port 8600``. It prints ``DLROVER_TPU_BRAIN_ADDR=localhost:<port>``
    once it serves."""
    import argparse

    p = argparse.ArgumentParser(prog="dlrover-tpu-torch-brain")
    p.add_argument("--port", type=int, default=8600)
    p.add_argument(
        "--store-path",
        default="",
        help="jsonl metrics store path (empty = in-memory)",
    )
    p.add_argument("--min-workers", type=int, default=1)
    p.add_argument("--max-workers", type=int, default=64)
    p.add_argument("--node-unit", type=int, default=1)
    args = p.parse_args(argv)
    store = MetricsStore(args.store_path or None)
    server = BrainWireServer(
        BrainService(
            store=store,
            min_workers=args.min_workers,
            max_workers=args.max_workers,
            node_unit=args.node_unit,
        ),
        port=args.port,
    )
    logger.info("dlrover-tpu-torch-brain serving on port %d", server.port)
    print(f"DLROVER_TPU_BRAIN_ADDR=localhost:{server.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
