"""Pluggable node-event callbacks for the master.

Port of ``dlrover_tpu/master/event_callback.py`` (reference: dlrover's
master/node/event_callback.py:42): ``NodeEventCallback`` observers
(``on_node_started``/``succeeded``/``failed``/``deleted``) registered
with the job manager, whose dispatch (``JobManager._fire``) keeps an
observer's exception from breaking node bookkeeping, and the callbacks
the master wires by default: a dead node's dataset shards re-queued,
the node dropped from every rendezvous world, the job failed when its
chief cannot be relaunched, the job completed when every worker
succeeded and every evaluator exited.
"""

import abc
from typing import List

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import Node

logger = get_logger(__name__)


class ClusterContext:
    """What callbacks may touch: the managers, never raw node dicts."""

    def __init__(self, job_manager, task_manager=None, rdzv_managers=None,
                 speed_monitor=None):
        self.job_manager = job_manager
        self.task_manager = task_manager
        self.rdzv_managers = rdzv_managers or {}
        self.speed_monitor = speed_monitor


class NodeEventCallback(abc.ABC):
    """Override any subset of the hooks."""

    def on_node_started(self, node: Node, ctx: ClusterContext):
        pass

    def on_node_succeeded(self, node: Node, ctx: ClusterContext):
        pass

    def on_node_failed(self, node: Node, ctx: ClusterContext):
        pass

    def on_node_deleted(self, node: Node, ctx: ClusterContext):
        pass


class TaskRescheduleCallback(NodeEventCallback):
    """Re-queue a dead node's in-flight dataset shards (reference:
    TaskRescheduleCallback, event_callback.py:111)."""

    def __init__(self, task_manager):
        self._tasks = task_manager

    def on_node_failed(self, node, ctx):
        self._tasks.recover_worker_tasks(node.id)

    def on_node_deleted(self, node, ctx):
        self._tasks.recover_worker_tasks(node.id)


class RendezvousPruneCallback(NodeEventCallback):
    """Drop a dead node from every rendezvous world so the next seal does
    not wait on it."""

    def __init__(self, rdzv_managers):
        self._managers = rdzv_managers

    def on_node_failed(self, node, ctx):
        for mgr in self._managers.values():
            mgr.remove_alive_node(node.rank_index)

    on_node_deleted = on_node_failed


class ChiefFailureCallback(NodeEventCallback):
    """A chief that dies past its relaunch budget fails the job: workers
    can be relaunched, the coordination anchor cannot."""

    def __init__(self, on_job_failed):
        self._on_job_failed = on_job_failed

    def on_node_failed(self, node, ctx):
        from dlrover_tpu_torch.common.constants import NodeType

        if (node.type == NodeType.CHIEF and not node.is_released
                and not node.should_relaunch()):
            logger.error("chief exhausted its budget: failing the job")
            self._on_job_failed(f"chief {node.name}: {node.exit_reason}")

    on_node_deleted = on_node_failed


class JobCompletionCallback(NodeEventCallback):
    """The job is done when every worker succeeded and every evaluator
    exited."""

    def __init__(self, on_job_completed):
        self._on_job_completed = on_job_completed

    def on_node_succeeded(self, node, ctx):
        jm = ctx.job_manager
        if jm.all_workers_succeeded() and jm.all_evaluators_exited():
            self._on_job_completed()


def default_callbacks(task_manager=None, rdzv_managers=None,
                      on_job_failed=None, on_job_completed=None
                      ) -> List[NodeEventCallback]:
    out: List[NodeEventCallback] = []
    if task_manager is not None:
        out.append(TaskRescheduleCallback(task_manager))
    if rdzv_managers:
        out.append(RendezvousPruneCallback(rdzv_managers))
    if on_job_failed is not None:
        out.append(ChiefFailureCallback(on_job_failed))
    if on_job_completed is not None:
        out.append(JobCompletionCallback(on_job_completed))
    return out
