"""Typed master client: the ONLY channel from agents/workers to the master.

Port of ``dlrover_tpu/agent/master_client.py`` (``MasterClient``,
``build_master_client``) for the calls the elastic path makes: node
registration, heartbeats (and the actions they bring back), status,
restart and failure reports, resource stats, the rendezvous, the KV
store and sync barriers, the global step, checkpoint steps, model info,
the data-shard service, the live-reshard
directive (an eviction notice, the plan), the Brain's tuning directives
(``report_tuning_plan``, ``get_tuning``), the parallel config the
agent's ``ParalConfigTuner`` polls (``get_parallel_config``) and the
sparse tier's versions (``bump_ps_version``, ``report_ps_node_version``,
``get_ps_version``) and the network check
(``report_network_check_result``, ``get_network_check_status``) and the
serving tier's directives (``report_serving_eviction``,
``get_serving_reshard``, ``report_serving_scale``,
``get_serving_scale``; a serving replica registers with
``register_node(node_type="serving", role=...)``).
"""

import os
import socket
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import messages as msgs
from dlrover_tpu_torch.common.comm import MasterTransportClient
from dlrover_tpu_torch.common.constants import GraftEnv, RendezvousName
from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

_singleton: Optional["MasterClient"] = None


class MasterClient:
    def __init__(self, master_addr: str, node_id: int = 0, node_rank: int = -1):
        ctx = get_context()
        self._t = MasterTransportClient(
            master_addr, timeout_s=ctx.rpc_timeout_s, retries=ctx.rpc_retry
        )
        self.node_id = node_id
        self.node_rank = node_rank

    @property
    def addr(self) -> str:
        return self._t.addr

    # ---- node lifecycle --------------------------------------------------

    def register_node(
        self,
        node_type: str = "worker",
        local_chips: int = 0,
        tpu_type: str = "",
        slice_id: str = "",
        slice_index: int = 0,
        restart_count: int = 0,
        role: str = "",
    ) -> msgs.NodeRegisterResponse:
        """``local_chips`` is the node's GPU count and ``tpu_type`` (the
        wire field's name) its device kind."""
        meta = msgs.NodeMeta(
            node_type=node_type,
            node_id=self.node_id,
            node_rank=self.node_rank,
            host_name=socket.gethostname(),
            host_addr=os.environ.get(
                "DLROVER_TPU_HOST_ADDR", socket.gethostname()
            ),
            local_chips=local_chips,
            tpu_type=tpu_type,
            slice_id=slice_id,
            slice_index=slice_index,
            role=role,
        )
        resp = self._t.get(
            msgs.NodeRegisterRequest(meta=meta, restart_count=restart_count)
        )
        if resp and resp.node_rank >= 0:
            self.node_rank = resp.node_rank
        return resp

    def report_heartbeat(self) -> bool:
        return self._t.report(
            msgs.HeartbeatReport(
                node_id=self.node_id, timestamp=time.time()
            )
        )

    def heartbeat_with_actions(self) -> List[str]:
        """Heartbeat that returns queued actions for this node."""
        resp = self._t.get(
            msgs.HeartbeatReport(node_id=self.node_id, timestamp=time.time())
        )
        return list(resp.actions) if resp else []

    def report_node_status(
        self,
        status: str,
        exit_reason: str = "",
        retries: Optional[int] = None,
    ) -> bool:
        return self._t.report(
            msgs.NodeStatusReport(
                node_id=self.node_id, status=status, exit_reason=exit_reason
            ),
            retries=retries,
        )

    def report_worker_restart(
        self, reason: str = "", retries: Optional[int] = None
    ) -> bool:
        """Planned worker kill+respawn (membership change, restart
        prescription)."""
        return self._t.report(
            msgs.WorkerRestartReport(node_id=self.node_id, reason=reason),
            retries=retries,
        )

    def report_failure(
        self,
        error_data: str,
        level: str = "process_error",
        restart_count=0,
        retries: Optional[int] = None,
    ) -> bool:
        return self._t.report(
            msgs.NodeFailureReport(
                node_id=self.node_id,
                node_rank=self.node_rank,
                error_data=error_data,
                level=level,
                restart_count=restart_count,
            ),
            retries=retries,
        )

    def report_resource_stats(self, cpu_percent: float,
                              used_memory_mb: float, **kw) -> bool:
        """The node's resource use (``hbm_used_mb``, ``hbm_peak_mb``: the
        card's memory under the JAX field names)."""
        return self._t.report(msgs.ResourceStats(
            node_id=self.node_id, cpu_percent=cpu_percent,
            used_memory_mb=used_memory_mb, **kw))

    def report_telemetry(self, payload: str) -> bool:
        """Forward one serialized telemetry record (``record.to_json()``)
        onto the master's hub (``observability/telemetry.py``
        ``MasterSink``)."""
        return self._t.report(
            msgs.TelemetryEventReport(node_id=self.node_id, payload=payload))

    # ---- rendezvous ------------------------------------------------------

    def join_rendezvous(
        self,
        local_world_size: int,
        rdzv_name: str = RendezvousName.TRAINING,
        coordinator_port: int = 0,
    ) -> int:
        """Join the next round; ``coordinator_port`` is the store port
        this node offers should it be the first of the world (0: the
        master's default)."""
        resp = self._t.get(
            msgs.JoinRendezvousRequest(
                node_id=self.node_id,
                node_rank=self.node_rank,
                local_world_size=local_world_size,
                rdzv_name=rdzv_name,
                coordinator_port=coordinator_port,
            )
        )
        return resp.round if resp else -1

    def get_comm_world(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> Tuple[int, int, Dict[int, int], str]:
        resp = self._t.get(
            msgs.CommWorldRequest(node_id=self.node_id, rdzv_name=rdzv_name)
        )
        if resp is None:
            return -1, 0, {}, ""
        return (
            resp.rdzv_round,
            resp.group,
            {int(k): v for k, v in resp.world.items()},
            resp.coordinator,
        )

    def num_nodes_waiting(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> int:
        resp = self._t.get(msgs.NumNodesWaitingRequest(rdzv_name=rdzv_name))
        return resp.waiting_num if resp else 0

    def report_eviction(
        self,
        lost_dp_ranks,
        dp_size: int,
        deadline_s: float = 30.0,
        reason: str = "",
    ) -> bool:
        """Announce departing dp ranks; the master answers future
        ``get_reshard_plan`` polls with a live-reshard directive."""
        return self._t.report(
            msgs.EvictionNotice(
                node_id=self.node_id,
                node_rank=self.node_rank,
                lost_dp_ranks=[int(r) for r in lost_dp_ranks],
                dp_size=int(dp_size),
                deadline_s=deadline_s,
                reason=reason,
            )
        )

    def get_reshard_plan(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> msgs.ReshardPlanResponse:
        resp = self._t.get(
            msgs.ReshardPlanRequest(
                node_id=self.node_id,
                node_rank=self.node_rank,
                rdzv_name=rdzv_name,
            )
        )
        return resp if resp else msgs.ReshardPlanResponse()

    def report_serving_eviction(
        self,
        replica: str,
        in_flight: int = 0,
        deadline_s: float = 10.0,
        reason: str = "",
    ) -> bool:
        """Announce a departing serving replica; the master answers
        later ``get_serving_reshard`` polls with a page-migration
        directive."""
        return self._t.report(
            msgs.ServingEvictionNotice(
                node_id=self.node_id,
                replica=replica,
                in_flight=int(in_flight),
                deadline_s=deadline_s,
                reason=reason,
            )
        )

    def get_serving_reshard(self) -> msgs.ServingReshardDirective:
        resp = self._t.get(msgs.ServingReshardRequest(node_id=self.node_id))
        return resp if resp else msgs.ServingReshardDirective()

    def report_serving_scale(
        self,
        role: str,
        direction: str,
        n_before: int,
        n_after: int,
        signal: str = "",
        reason: str = "",
    ) -> bool:
        """Announce one autoscaler scale decision; the master versions
        it as a serving-scale directive (``get_serving_scale``)."""
        return self._t.report(
            msgs.ServingScaleNotice(
                node_id=self.node_id,
                role=role,
                direction=direction,
                n_before=int(n_before),
                n_after=int(n_after),
                signal=signal,
                reason=reason,
            )
        )

    def get_serving_scale(self, role: str = "") -> msgs.ServingScaleDirective:
        resp = self._t.get(
            msgs.ServingScaleRequest(node_id=self.node_id, role=role)
        )
        return resp if resp else msgs.ServingScaleDirective()

    # ---- data sharding ---------------------------------------------------

    def report_dataset_shard_params(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "table",
        task_type: str = "training",
    ) -> bool:
        return self._t.report(
            msgs.DatasetShardParams(
                dataset_name=dataset_name,
                dataset_size=dataset_size,
                shard_size=shard_size,
                num_epochs=num_epochs,
                shuffle=shuffle,
                storage_type=storage_type,
                task_type=task_type,
            )
        )

    def get_task(self, dataset_name: str) -> msgs.Task:
        resp = self._t.get(
            msgs.TaskRequest(dataset_name=dataset_name, worker_id=self.node_id)
        )
        return resp or msgs.Task()

    def report_task_result(
        self, dataset_name: str, task_id: int, success: bool = True
    ) -> bool:
        return self._t.report(
            msgs.TaskResult(
                dataset_name=dataset_name,
                task_id=task_id,
                worker_id=self.node_id,
                success=success,
            )
        )

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        resp = self._t.get(
            msgs.ShardCheckpointRequest(dataset_name=dataset_name)
        )
        return resp.content if resp else ""

    def report_shard_checkpoint(self, dataset_name: str, content: str) -> bool:
        return self._t.report(
            msgs.ShardCheckpoint(dataset_name=dataset_name, content=content)
        )

    def get_dataset_epoch(self, dataset_name: str) -> int:
        resp = self._t.get(msgs.DatasetEpochRequest(dataset_name=dataset_name))
        return resp.epoch if resp else 0

    # ---- telemetry -------------------------------------------------------

    def report_global_step(self, step: int, worker_num: int = 0) -> bool:
        return self._t.report(
            msgs.GlobalStepRecord(
                global_step=step,
                timestamp=time.time(),
                worker_num=worker_num,
                node_id=self.node_id,
            )
        )

    def report_model_info(
        self,
        model_name: str = "",
        num_params: int = 0,
        flops_per_token: float = 0.0,
        global_batch_size: int = 0,
        seq_len: int = 0,
        strategy_json: str = "",
    ) -> bool:
        """Model/job statistics (reference: master_client.py:217)."""
        return self._t.report(
            msgs.ModelInfoReport(
                node_id=self.node_id,
                model_name=model_name,
                num_params=num_params,
                flops_per_token=flops_per_token,
                global_batch_size=global_batch_size,
                seq_len=seq_len,
                strategy_json=strategy_json,
            )
        )

    def get_running_nodes(self) -> list:
        resp = self._t.get(msgs.RunningNodesRequest(node_id=self.node_id))
        return list(resp.nodes) if resp else []

    # ---- kv / sync -------------------------------------------------------

    def kv_store_set(self, key: str, value: str) -> bool:
        return self._t.report(msgs.KeyValuePair(key=key, value=value))

    def kv_store_get(self, key: str) -> str:
        resp = self._t.get(msgs.KeyRequest(key=key))
        return resp.value if resp else ""

    def join_sync(self, sync_name: str) -> bool:
        return self._t.report(
            msgs.SyncJoin(
                sync_name=sync_name,
                node_id=self.node_id,
                node_rank=self.node_rank,
            )
        )

    def sync_finished(self, sync_name: str) -> bool:
        resp = self._t.get(msgs.SyncRequest(sync_name=sync_name))
        return bool(resp and resp.success)

    # ---- checkpoint sync -------------------------------------------------

    def report_ckpt_step(self, step: int, rank: Optional[int] = None) -> bool:
        """The step this rank staged; ``rank`` (a worker's global rank)
        keys it instead of the node rank, as several workers of a node
        stage each their own."""
        return self._t.report(
            msgs.CheckpointStepSync(
                node_rank=self.node_rank if rank is None else rank, step=step)
        )

    def get_min_ckpt_step(self) -> int:
        resp = self._t.get(msgs.CheckpointStepRequest())
        return resp.step if resp else 0

    # ---- Brain tuning and runtime config ----------------------------------

    def report_tuning_plan(
        self, plan_json: str, signal: str = "", reason: str = ""
    ) -> bool:
        """Announce one Brain tuning plan or revision; the master
        versions it as a tuning directive (``get_tuning`` and the
        ``ParallelConfig`` poll both serve it)."""
        return self._t.report(
            msgs.TuningPlanNotice(
                node_id=self.node_id,
                plan_json=plan_json,
                signal=signal,
                reason=reason,
            )
        )

    def get_tuning(self) -> msgs.TuningPlanDirective:
        resp = self._t.get(msgs.TuningPlanRequest(node_id=self.node_id))
        return resp if resp else msgs.TuningPlanDirective()

    def report_network_check_result(
        self, elapsed_time: float, succeeded: bool
    ) -> bool:
        return self._t.report(
            msgs.NetworkCheckResult(
                node_id=self.node_id,
                elapsed_time=elapsed_time,
                succeeded=succeeded,
            )
        )

    def get_network_check_status(self) -> msgs.NetworkCheckStatusResponse:
        return self._t.get(
            msgs.NetworkCheckStatusRequest(node_id=self.node_id)
        )

    def get_parallel_config(self) -> msgs.ParallelConfig:
        resp = self._t.get(msgs.ParallelConfigRequest(node_id=self.node_id))
        return resp or msgs.ParallelConfig()

    def bump_ps_version(self) -> bool:
        """Announce a sparse-tier membership change (reference:
        elastic_ps.py update cluster version)."""
        return self._t.report(
            msgs.PsVersionReport(node_id=self.node_id, version_type="global")
        )

    def report_ps_node_version(self, version: int) -> bool:
        return self._t.report(
            msgs.PsVersionReport(
                node_id=self.node_id,
                version_type="node",
                version=version,
            )
        )

    def get_ps_version(
        self, version_type: str = "global"
    ) -> msgs.PsVersionResponse:
        resp = self._t.get(
            msgs.PsVersionRequest(
                node_id=self.node_id, version_type=version_type
            )
        )
        return resp or msgs.PsVersionResponse()

    def close(self):
        self._t.close()


def build_master_client(
    master_addr: Optional[str] = None, node_id: Optional[int] = None
) -> MasterClient:
    """Singleton accessor, env-driven (reference: master_client.py:420)."""
    global _singleton
    if _singleton is None:
        addr = master_addr or os.environ.get(GraftEnv.MASTER_ADDR, "")
        if not addr:
            raise RuntimeError(
                f"{GraftEnv.MASTER_ADDR} not set and no master_addr given"
            )
        nid = node_id
        if nid is None:
            nid = int(os.environ.get(GraftEnv.NODE_ID, "0"))
        _singleton = MasterClient(addr, node_id=nid)
        rank = os.environ.get(GraftEnv.NODE_RANK)
        if rank is not None:
            _singleton.node_rank = int(rank)
    return _singleton
