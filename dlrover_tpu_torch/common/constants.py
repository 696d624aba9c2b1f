"""Environment variable names the port reads.

The subset of ``dlrover_tpu/common/constants.py::GraftEnv`` that the
tracer needs. The names are the same, so one environment drives both
packages.
"""


class GraftEnv:
    """Environment variable names used across master/agent/worker."""

    NODE_ID = "DLROVER_TPU_NODE_ID"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    RUN_ID = "DLROVER_TPU_RUN_ID"
    RDZV_ROUND = "DLROVER_TPU_RDZV_ROUND"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    # flight recorder: per-process Chrome-trace JSONL spans land under
    # this dir when set (see observability/tracing.py)
    TRACE_DIR = "DLROVER_TPU_TRACE_DIR"
    TRACE_ROLE = "DLROVER_TPU_TRACE_ROLE"
