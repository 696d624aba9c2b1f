"""Typed control-plane messages.

Port of ``dlrover_tpu/common/messages.py``: one dataclass per message
type, encoded as the JSON envelope ``{"t": <type-name>, "d": {fields}}``
with a strict registry, so only registered message classes can ever be
instantiated. The encoding is byte for byte the JAX package's for the
messages both packages send; the port registers the messages its
control plane sends (node lifecycle, rendezvous, the KV store and sync
barriers, the global step, checkpoint steps, model info, the data-shard
service, the live-reshard directive, the network check's results and
status, the agent monitor's resource stats, the telemetry records a
worker forwards, the serving tier's reshard and scale directives, the parallel-config and tuning directives, the sparse
tier's versions and the Brain service's three calls).

One field is the port's own: ``JoinRendezvousRequest.coordinator_port``
(the port of the torch.distributed store the joining agent picked). A
field marked ``_EXT`` is left out of the encoding at its default, so a
join that picks no port encodes as the JAX package's join.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_REGISTRY: Dict[str, type] = {}
_EXT = {"ext": True}


def message(cls):
    """Register a dataclass as a wire message type."""
    cls = dataclass(cls)
    _REGISTRY[cls.__name__] = cls
    return cls


def registered(name: str) -> bool:
    return name in _REGISTRY


def _omitted(f: dataclasses.Field, value) -> bool:
    return f.metadata.get("ext", False) and value == f.default


def _to_jsonable(value):
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            "__msg__": type(value).__name__,
            **{
                f.name: _to_jsonable(getattr(value, f.name))
                for f in dataclasses.fields(value)
                if not _omitted(f, getattr(value, f.name))
            },
        }
    if isinstance(value, dict):
        return {str(k): _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    return value


def _from_jsonable(value):
    if isinstance(value, dict):
        if "__msg__" in value:
            cls = _REGISTRY[value["__msg__"]]
            kwargs = {
                k: _from_jsonable(v) for k, v in value.items() if k != "__msg__"
            }
            return cls(**kwargs)
        return {k: _from_jsonable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_from_jsonable(v) for v in value]
    return value


def serialize(msg) -> bytes:
    if not dataclasses.is_dataclass(msg):
        raise TypeError(f"not a message dataclass: {type(msg)}")
    name = type(msg).__name__
    if name not in _REGISTRY:
        raise TypeError(f"unregistered message type: {name}")
    payload = _to_jsonable(msg)
    payload.pop("__msg__", None)
    return json.dumps({"t": name, "d": payload}).encode("utf-8")


def type_name(data: bytes) -> str:
    """The envelope's type name, without decoding the fields."""
    return json.loads(data.decode("utf-8"))["t"]


def deserialize(data: bytes):
    if not data:
        return None
    obj = json.loads(data.decode("utf-8"))
    name = obj["t"]
    if name not in _REGISTRY:
        raise TypeError(f"unregistered message type: {name}")
    return _from_jsonable({"__msg__": name, **obj["d"]})


# ---------------------------------------------------------------------------
# Generic responses
# ---------------------------------------------------------------------------


@message
class Response:
    success: bool = True
    reason: str = ""


@message
class Empty:
    pass


# ---------------------------------------------------------------------------
# Node lifecycle
# ---------------------------------------------------------------------------


@message
class NodeMeta:
    node_type: str = "worker"
    node_id: int = 0
    node_rank: int = -1
    host_name: str = ""
    host_addr: str = ""
    local_chips: int = 0        # the node's local GPUs
    tpu_type: str = ""          # the JAX field's name: the device kind
    slice_id: str = ""
    slice_index: int = 0
    role: str = ""


@message
class NodeRegisterRequest:
    meta: Optional[NodeMeta] = None
    restart_count: int = 0


@message
class NodeRegisterResponse:
    success: bool = True
    node_rank: int = -1
    node_num: int = 0


@message
class HeartbeatReport:
    node_id: int = 0
    node_type: str = "worker"
    timestamp: float = 0.0


@message
class HeartbeatResponse:
    # actions for the agent to execute (e.g. "restart_worker")
    actions: List[str] = field(default_factory=list)


@message
class NodeStatusReport:
    node_id: int = 0
    node_type: str = "worker"
    status: str = ""
    exit_reason: str = ""


@message
class WorkerRestartReport:
    """Agent notice that it killed and is respawning its workers on
    purpose (membership change, restart prescription)."""

    node_id: int = 0
    reason: str = ""


@message
class NodeFailureReport:
    node_id: int = 0
    node_rank: int = -1
    error_data: str = ""
    level: str = "process_error"
    restart_count: int = 0


@message
class ResourceStats:
    """A node's resource use (``hbm_*``: the JAX field names; on the
    card, its memory)."""

    node_id: int = 0
    cpu_percent: float = 0.0
    used_memory_mb: float = 0.0
    tpu_duty_cycle: float = 0.0
    hbm_used_mb: float = 0.0
    hbm_peak_mb: float = 0.0


@message
class TelemetryEventReport:
    """One telemetry record forwarded to the master's hub. ``payload`` is
    the record's own ``to_json`` line (``observability/telemetry.py``),
    so the wire layer stays agnostic of record schemas."""

    node_id: int = -1
    payload: str = ""


@message
class ModelInfoReport:
    """Model/job statistics (reference: grpc.ModelInfo)."""

    node_id: int = 0
    model_name: str = ""
    num_params: int = 0
    flops_per_token: float = 0.0
    global_batch_size: int = 0
    seq_len: int = 0
    strategy_json: str = ""


@message
class RunningNodesRequest:
    node_id: int = 0


@message
class NodeInfo:
    id: int = 0
    type: str = "worker"
    name: str = ""
    status: str = ""
    host_addr: str = ""
    rank_index: int = 0


@message
class RunningNodesResponse:
    nodes: List[NodeInfo] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Rendezvous
# ---------------------------------------------------------------------------


@message
class JoinRendezvousRequest:
    node_id: int = 0
    node_rank: int = -1
    local_world_size: int = 1
    rdzv_name: str = "elastic-training"
    node_unit: int = 1
    # the port's own: the store port this node's agent picked (0 = none)
    coordinator_port: int = field(default=0, metadata=_EXT)


@message
class JoinRendezvousResponse:
    round: int = 0


@message
class CommWorldRequest:
    node_id: int = 0
    rdzv_name: str = "elastic-training"


@message
class CommWorldResponse:
    rdzv_round: int = 0
    group: int = 0
    # node_rank -> local world size (GPUs) for every node in the world;
    # empty until the rendezvous completes.
    world: Dict[str, int] = field(default_factory=dict)
    # host:port of the worker group's store, filled once the world is
    # sealed.
    coordinator: str = ""


@message
class NumNodesWaitingRequest:
    rdzv_name: str = "elastic-training"


@message
class NumNodesWaitingResponse:
    waiting_num: int = 0


@message
class NetworkCheckResult:
    node_id: int = 0
    elapsed_time: float = 0.0
    succeeded: bool = True


@message
class NetworkCheckStatusRequest:
    node_id: int = 0


@message
class NetworkCheckStatusResponse:
    normal: bool = True
    # nodes the master decided are faulty / straggling
    fault_nodes: List[int] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Training telemetry
# ---------------------------------------------------------------------------


@message
class GlobalStepRecord:
    global_step: int = 0
    timestamp: float = 0.0
    worker_num: int = 0
    node_id: int = -1


# ---------------------------------------------------------------------------
# KV store + sync service
# ---------------------------------------------------------------------------


@message
class KeyValuePair:
    key: str = ""
    value: str = ""


@message
class KeyRequest:
    key: str = ""


@message
class SyncJoin:
    sync_name: str = ""
    node_id: int = 0
    node_rank: int = -1


@message
class SyncRequest:
    sync_name: str = ""


@message
class SyncResponse:
    success: bool = False


# ---------------------------------------------------------------------------
# Checkpoint coordination
# ---------------------------------------------------------------------------


@message
class CheckpointStepSync:
    node_rank: int = -1
    step: int = 0


@message
class CheckpointStepRequest:
    pass


@message
class CheckpointStepResponse:
    step: int = 0


# ---------------------------------------------------------------------------
# Live reshard (a graceful eviction and the master's directive)
# ---------------------------------------------------------------------------


@message
class EvictionNotice:
    """A node (or the scheduler, relayed by a worker) announces dp ranks
    leaving the job — graceful eviction with a donation grace window."""

    node_id: int = 0
    node_rank: int = -1
    lost_dp_ranks: List[int] = field(default_factory=list)
    dp_size: int = 0             # dp size the notice is relative to
    deadline_s: float = 30.0     # donation grace window
    reason: str = ""


@message
class ReshardPlanRequest:
    node_id: int = 0
    node_rank: int = -1
    rdzv_name: str = "elastic-training"


@message
class ReshardPlanResponse:
    """The master's live-reshard directive. ``version`` increments per
    directive; 0 means no reshard is pending."""

    version: int = 0
    rdzv_round: int = -1
    dp_old: int = 0
    dp_new: int = 0
    lost_ranks: List[int] = field(default_factory=list)
    deadline_s: float = 30.0
    reason: str = ""


@message
class ServingEvictionNotice:
    """Serving variant of :class:`EvictionNotice`: a replica (or the
    router observing its death) announces a serving replica leaving,
    planned drain or detected eviction, with its in-flight request
    count, so the master can issue a page-migration directive."""

    node_id: int = 0
    replica: str = ""
    in_flight: int = 0
    deadline_s: float = 10.0     # page-transfer grace window
    reason: str = ""


@message
class ServingReshardRequest:
    node_id: int = 0


@message
class ServingReshardDirective:
    """The master's serving-reshard directive (versioned; 0 = none
    pending): migrate the victim's held KV pages onto ``survivors``
    within ``deadline_s``, degrading to re-prefill past the deadline."""

    version: int = 0
    victim: str = ""
    survivors: List[str] = field(default_factory=list)
    deadline_s: float = 10.0
    reason: str = ""


@message
class ServingScaleNotice:
    """The serving autoscaler announces one scale decision so the
    master can version it and track the fleet's target sizes."""

    node_id: int = 0
    role: str = "unified"        # prefill | decode | unified
    direction: str = ""          # out | in
    n_before: int = 0
    n_after: int = 0
    signal: str = ""             # breach signal that drove the decision
    reason: str = ""


@message
class ServingScaleRequest:
    node_id: int = 0
    role: str = ""               # "" = any role's latest directive


@message
class ServingScaleDirective:
    """The master's serving-scale directive (versioned; 0 = none
    pending): bring the ``role`` pool to ``target`` live replicas."""

    version: int = 0
    role: str = "unified"
    target: int = 0
    reason: str = ""


# ---------------------------------------------------------------------------
# Dynamic data sharding
# ---------------------------------------------------------------------------


@message
class DatasetShardParams:
    dataset_name: str = ""
    dataset_size: int = 0
    shard_size: int = 0          # samples per shard (= batches × batch size)
    batch_size: int = 0
    num_epochs: int = 1
    shuffle: bool = False
    storage_type: str = "table"  # table | text | stream
    task_type: str = "training"


@message
class TaskRequest:
    dataset_name: str = ""
    worker_id: int = 0


@message
class Task:
    task_id: int = -1
    task_type: str = "none"
    dataset_name: str = ""
    shard_start: int = 0
    shard_end: int = 0
    epoch: int = 0
    # record indices inside the shard when shuffling
    record_indices: List[int] = field(default_factory=list)


@message
class TaskResult:
    dataset_name: str = ""
    task_id: int = -1
    worker_id: int = 0
    success: bool = True
    elapsed_time: float = 0.0


@message
class ShardCheckpointRequest:
    dataset_name: str = ""


@message
class ShardCheckpoint:
    dataset_name: str = ""
    content: str = ""  # JSON payload of the dataset manager's checkpoint


@message
class DatasetEpochRequest:
    dataset_name: str = ""


@message
class DatasetEpochResponse:
    epoch: int = 0


# ---------------------------------------------------------------------------
# Runtime re-config (reference: paral_config_tuner.py) and Brain tuning
# ---------------------------------------------------------------------------


@message
class ParallelConfig:
    # dataloader
    batch_size: int = 0
    num_workers: int = 0
    # grad accumulation (elastic trainer keeps global batch fixed)
    grad_accum_steps: int = 1
    version: int = 0
    # the Brain tuning directive riding the same poll
    # (cluster/brain.py): the latest TuningPlan as its asdict JSON, with
    # its own version so a dataloader re-config and a tuning revision
    # don't mask each other ("" / 0 = no tuning directive pending)
    tuning_json: str = ""
    tuning_version: int = 0


@message
class ParallelConfigRequest:
    node_id: int = 0


@message
class TuningPlanNotice:
    """A Brain tuner announces one cold-start plan or revision so the
    master can version it."""

    node_id: int = 0
    plan_json: str = ""          # TuningPlan asdict JSON
    signal: str = ""             # telemetry signal that drove it
    reason: str = ""


@message
class TuningPlanRequest:
    node_id: int = 0


@message
class TuningPlanDirective:
    """The master's tuning directive (0 = none pending)."""

    version: int = 0
    plan_json: str = ""
    reason: str = ""


# ---------------------------------------------------------------------------
# Sparse-tier (PS) cluster versioning (reference: elastic_ps.py)
# ---------------------------------------------------------------------------


@message
class PsVersionReport:
    """Bump (global) or set (node) a sparse cluster version."""

    node_id: int = 0
    version_type: str = "global"   # global | node
    version: int = 0               # node type: the version to record


@message
class PsVersionRequest:
    node_id: int = 0
    version_type: str = "global"


@message
class PsVersionResponse:
    version: int = 0
    servers: List[str] = field(default_factory=list)
    # Brain hot-shard rebalance weights (ElasticPsService.set_weights)
    weights: Dict[str, float] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Brain service (reference: dlrover/proto/brain.proto:196-199 —
# persist_metrics / optimize / get_job_metrics as a standalone
# cluster-level service shared across jobs)
# ---------------------------------------------------------------------------


@message
class BrainPersistMetricsRequest:
    """One JobMetrics observation, as its asdict JSON."""

    metrics_json: str = ""


@message
class BrainOptimizeRequest:
    """Ask the Brain for a ResourcePlan for one job's stage."""

    job_name: str = ""
    job_kind: str = ""
    stage: str = "running"        # create | running
    stats_json: str = "{}"


@message
class BrainOptimizeResponse:
    plan_json: str = ""           # ResourcePlan asdict JSON
    error: str = ""


@message
class BrainJobMetricsRequest:
    job_name: str = ""


@message
class BrainJobMetricsResponse:
    rows_json: str = "[]"         # list of JobMetrics asdict JSON
    error: str = ""
