"""Framework-wide constants.

Port of ``dlrover_tpu/common/constants.py``: the node types and
statuses, the rendezvous names, the default tunables and the
environment variable names the master, the agent and the worker share.
The names and values are the JAX package's, so one environment drives
both packages. A node is a host with its local GPUs; the agent spawns
one worker process a GPU.
"""


class NodeType:
    """Roles a node can play in a job."""

    MASTER = "master"
    WORKER = "worker"          # a host driving its local GPUs
    CHIEF = "chief"            # rank-0 coordination anchor
    EVALUATOR = "evaluator"    # side-car eval host, outside the train mesh
    PS = "ps"                  # sparse-tier server host (elastic_ps.py)
    SERVING = "serving"        # generation-serving replica (serving/replica.py)


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    CHECK_FAILED = "check_failed"

    ALL = (INITIAL, PENDING, RUNNING, SUCCEEDED, FAILED, DELETED, CHECK_FAILED)
    TERMINAL = (SUCCEEDED, FAILED, DELETED)


class NodeEventType:
    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"
    HEARTBEAT_TIMEOUT = "heartbeat_timeout"


class NodeExitReason:
    SUCCEEDED = "succeeded"
    KILLED = "killed"            # preemption / eviction
    OOM = "oom"
    FATAL_ERROR = "fatal_error"  # un-relaunchable user error
    HARDWARE_ERROR = "hardware_error"
    UNKNOWN = "unknown"

    # Exit reasons that should NOT consume a relaunch budget: the node was
    # taken from us, it did not fail on its own.
    NO_BUDGET = (KILLED,)
    # Exit reasons that should never be relaunched.
    NEVER_RELAUNCH = (FATAL_ERROR, SUCCEEDED)


class JobExitReason:
    SUCCEEDED = "succeeded"
    NODE_CHECK_FAILED = "node_check_failed"
    PENDING_TIMEOUT = "pending_timeout"
    RELAUNCH_BUDGET_EXHAUSTED = "relaunch_budget_exhausted"
    HANG = "hang"
    UNKNOWN = "unknown"


class RendezvousName:
    TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"
    SERVING = "serving"


class TrainingExceptionLevel:
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    RDZV_ERROR = "rdzv_error"
    WARNING = "warning"
    INFO = "info"


class DefaultValues:
    """Default tunables (reference: constants.py DefaultValues)."""

    SERVICE_PORT = 0                 # 0 → pick a free port
    RPC_TIMEOUT_S = 30.0
    RPC_RETRY = 10
    HEARTBEAT_INTERVAL_S = 15.0
    HEARTBEAT_TIMEOUT_S = 300.0
    SUPERVISE_INTERVAL_S = 5.0
    RDZV_TIMEOUT_S = 600.0
    RDZV_WAIT_EXTRA_NODES_S = 30.0   # grace period past min_nodes
    RELAUNCH_BUDGET = 3
    PENDING_TIMEOUT_S = 900.0
    SPEED_MONITOR_WINDOW = 30
    STRAGGLER_RATIO = 1.6            # step-time ratio over median → straggler
    # the coordinator port the master hands out when the first node's
    # agent does not send one (the JAX rdzv_manager's fixed port)
    COORDINATOR_PORT = 7010
    SHARD_TIMEOUT_S = 1800.0         # re-queue a dispatched shard after this
    HANG_KICK_COOLDOWN_S = 600.0     # min gap between job-wide hang kicks
    AUTOSCALE_INTERVAL_S = 60.0      # the auto-scaler's period
    SECONDS_TO_WAIT_PENDING_POD = 900


class TaskType:
    """Data-shard task flavours (reference: proto elastic_training TaskType)."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"
    NONE = "none"


class GraftEnv:
    """Environment variable names used across master/agent/worker."""

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    # the port of the worker group's torch.distributed store: a number,
    # or 0 for a free port picked by the agent at each rendezvous; unset,
    # the master hands out DefaultValues.COORDINATOR_PORT
    COORDINATOR_PORT = "DLROVER_TPU_COORDINATOR_PORT"
    LOCAL_CHIPS = "DLROVER_TPU_LOCAL_CHIPS"
    # the parallel-config file the elastic dataloader reloads
    PARAL_CONFIG_PATH = "DLROVER_TPU_PARAL_CONFIG"
    RUN_ID = "DLROVER_TPU_RUN_ID"
    RDZV_ROUND = "DLROVER_TPU_RDZV_ROUND"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    # flight recorder: per-process Chrome-trace JSONL spans / telemetry
    # record streams land under these dirs when set (see
    # observability/tracing.py and observability/telemetry.py)
    TRACE_DIR = "DLROVER_TPU_TRACE_DIR"
    TRACE_ROLE = "DLROVER_TPU_TRACE_ROLE"
    TELEMETRY_DIR = "DLROVER_TPU_TELEMETRY_DIR"
