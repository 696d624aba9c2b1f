"""MasterServicer: demux the two-RPC surface onto the managers.

Port of ``dlrover_tpu/master/servicer.py`` for the handlers the elastic
path reaches: heartbeats (their responses carry the diagnosis manager's
queued actions), node status, worker restarts, failures (classified by
the diagnosis manager; an abort fans out to every running node; a
collector's ``level="diagnosis"`` report is evidence only), resource
stats (onto the master's telemetry hub, or to the diagnosis manager
without one), the records a worker's ``MasterSink`` sends
(``TelemetryEventReport``: decoded onto the hub), registration, the
rendezvous (join, comm world, nodes waiting), the KV store, sync
barriers, the global step, checkpoint steps, model info (the job meta of
the metric collector), the running-node listing, the data-shard service
(datasets, tasks and their results, the dataset checkpoint, the epoch;
a restarted or failed node's in-flight shards re-queued) and the
live-reshard directive (an eviction notice in, the plan out, an
``eviction_notice`` event on the hub), the network check (a node's
result to the network-check rendezvous, its status out: faulty nodes
and stragglers), the Brain's tuning directives (a
``TuningPlanNotice`` versioned by the node manager's ``plan_tuning``, a
``tuning_plan_notice`` event on the hub; served by ``TuningPlanRequest``
and folded into each node's ``ParallelConfig``), the sparse tier's
versions (``ElasticPsService``) and the serving tier's directives (a
``ServingEvictionNotice`` versioned by ``plan_serving_reshard``, a
``ServingScaleNotice`` by ``plan_serving_scale``, each an event on the
hub; served by ``ServingReshardRequest`` and ``ServingScaleRequest``). The goodput tracker is marked as
the JAX handlers mark it: stalled at a worker restart and at a failure
report (from the step training had reached), productive at a step
report that advances past the stall, completed at a SUCCEEDED status.
Exceptions never cross the RPC edge.

The Brain's own messages (``BrainOptimizeRequest`` and the others)
reach the master as they reach the JAX one: no handler, so a report is
answered unsuccessful and a get with nothing (the Brain process serves
them, ``cluster/brain.py``). Every other message type of the JAX
servicer is answered with an error naming the ROADMAP item that ports it
(``UNPORTED``); the transport sends it back and the client raises
``NotImplementedError`` with it.
"""

import time
from typing import Dict, Optional

from dlrover_tpu_torch.common import messages as msgs
from dlrover_tpu_torch.common.constants import NodeStatus, RendezvousName
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.tracing import get_tracer

logger = get_logger(__name__)

_ITEMS = {
    "A20 (the strategy engine)": (
        "NetworkReadyRequest", "StrategySearchRequest"),
}
UNPORTED: Dict[str, str] = {
    name: f"{name}: its master handler is not ported yet (ROADMAP {item})"
    for item, names in _ITEMS.items() for name in names
}


class MasterServicer:
    def __init__(
        self,
        job_manager=None,
        rdzv_managers=None,
        kv_store=None,
        sync_service=None,
        speed_monitor=None,
        task_manager=None,
        diagnosis_manager=None,
        goodput_tracker=None,
        metric_collector=None,
        telemetry_hub=None,
        ps_service=None,
    ):
        self.job_manager = job_manager
        self.ps_service = ps_service
        self.diagnosis_manager = diagnosis_manager
        self.goodput_tracker = goodput_tracker
        self.metric_collector = metric_collector
        self.telemetry_hub = telemetry_hub
        self.task_manager = task_manager
        self.rdzv_managers = rdzv_managers or {}
        self.kv_store = kv_store
        self.sync_service = sync_service
        self.speed_monitor = speed_monitor
        self._ckpt_steps = {}  # node_rank -> step (flash-ckpt rank sync)

    @staticmethod
    def unported(type_name: str) -> Optional[str]:
        return UNPORTED.get(type_name)

    # ---- report: fire-and-forget ----------------------------------------

    def report(self, msg) -> bool:
        handler = self._REPORT_HANDLERS.get(type(msg).__name__)
        if handler is None:
            logger.warning("no report handler for %s", type(msg).__name__)
            return False
        return bool(handler(self, msg))

    def _report_heartbeat(self, m: msgs.HeartbeatReport) -> bool:
        if self.job_manager:
            self.job_manager.handle_heartbeat(m.node_id)
        return True

    def _get_heartbeat(self, m: msgs.HeartbeatReport):
        """Heartbeat via get: the response carries the node's queued
        diagnosis actions."""
        if self.job_manager:
            self.job_manager.handle_heartbeat(m.node_id)
        actions = (self.diagnosis_manager.take_actions(m.node_id)
                   if self.diagnosis_manager else [])
        return msgs.HeartbeatResponse(actions=actions)

    def _report_node_status(self, m: msgs.NodeStatusReport) -> bool:
        if self.job_manager:
            self.job_manager.handle_status_report(
                m.node_id, m.status, m.exit_reason
            )
        if m.status == NodeStatus.SUCCEEDED and self.goodput_tracker:
            # a worker ran to its final step: training is over, so the
            # lost-time accounting stops (a peer's death detected after
            # this could never be closed by a step report)
            self.goodput_tracker.mark_completed()
        return True

    def _mark_stalled(self) -> None:
        """Open a goodput stall from the step training had reached: a
        later step report closes it only once training advances past
        it."""
        if self.goodput_tracker:
            self.goodput_tracker.mark_stalled(
                at_step=self.speed_monitor.global_step
                if self.speed_monitor else None)

    def _report_worker_restart(self, m: msgs.WorkerRestartReport) -> bool:
        """Voluntary worker kill+respawn: re-queue the node's in-flight
        shards (a leaked lease can never complete and deadlocks the
        dataset's tail)."""
        logger.info(
            "node %d restarting its worker (%s)", m.node_id, m.reason
        )
        if self.task_manager:
            self.task_manager.recover_worker_tasks(m.node_id)
        # training is stopped until the restarted world's first step
        self._mark_stalled()
        return True

    def _report_node_failure(self, m: msgs.NodeFailureReport) -> bool:
        if m.level == "diagnosis":
            # a collector's payload (log tail, proc state, stack) is
            # evidence, not a failure: no re-queue, no classification, so a
            # healthy worker whose log holds an old error string triggers
            # nothing
            if self.diagnosis_manager:
                self.diagnosis_manager.collect_diagnosis_data(
                    m.node_id, m.error_data)
            logger.info("diagnosis data from node %d: %s", m.node_id,
                        m.error_data[:200])
            return True
        # a worker crash stalls the job until a step report after the
        # restart advances past here
        self._mark_stalled()
        if self.diagnosis_manager:
            rec = self.diagnosis_manager.collect_failure(m)
            get_tracer().instant("failover.diagnosed", node=m.node_id,
                                 classification=rec.classification,
                                 action=rec.action)
            # an abort is a job-level verdict: every node must stop, not
            # just the reporter (the others would re-rendezvous forever)
            if rec.action == "abort_job":
                ids = {m.node_id}
                if self.job_manager:
                    ids.update(n.id for n in self.job_manager.running_nodes())
                self.diagnosis_manager.queue_action_for(ids, rec.action)
        # the restarting worker lost its in-flight shards — re-queue them
        # (at-least-once delivery; reference: task_manager re-queue on death)
        if self.task_manager:
            self.task_manager.recover_worker_tasks(m.node_id)
        logger.warning(
            "node %d failure (level=%s restart=%d): %s",
            m.node_id,
            m.level,
            m.restart_count,
            m.error_data[:500],
        )
        return True

    def _report_resource(self, m: msgs.ResourceStats) -> bool:
        """Wire → record on the master's hub (the diagnosis manager
        subscribes); without a hub, straight to the manager."""
        if self.telemetry_hub is not None and self.telemetry_hub.enabled:
            self.telemetry_hub.publish(telemetry.ResourceRecord(
                node_id=m.node_id, cpu_percent=m.cpu_percent,
                mem_mb=m.used_memory_mb, hbm_mb=m.hbm_used_mb,
                hbm_peak_mb=m.hbm_peak_mb))
        elif self.diagnosis_manager:
            self.diagnosis_manager.collect_resource(m)
        return True

    def _report_telemetry(self, m: msgs.TelemetryEventReport) -> bool:
        """A worker's record (its ``to_json`` line) onto the master's
        hub."""
        if self.telemetry_hub is None or not self.telemetry_hub.enabled:
            return True  # accepted, nobody listening
        try:
            record = telemetry.from_json(m.payload)
        except (KeyError, ValueError) as e:
            logger.warning(
                "undecodable telemetry record from node %d: %s", m.node_id, e
            )
            return False
        self.telemetry_hub.publish(record)
        return True

    def _report_global_step(self, m: msgs.GlobalStepRecord) -> bool:
        if self.speed_monitor:
            self.speed_monitor.collect_global_step(
                m.global_step, m.timestamp or time.time(), node_id=m.node_id
            )
        if self.goodput_tracker:
            # forward progress closes a stall, but only for a step TAKEN
            # after it opened and ADVANCING past its step (a surviving
            # rank's in-flight report must not hide the recovery)
            self.goodput_tracker.mark_productive(
                step=m.global_step, report_ts=m.timestamp or None)
        return True

    def _report_kv(self, m: msgs.KeyValuePair) -> bool:
        if self.kv_store:
            self.kv_store.set(m.key, m.value)
        return True

    def _report_sync_join(self, m: msgs.SyncJoin) -> bool:
        if self.sync_service:
            return self.sync_service.join_sync(m.sync_name, m.node_rank)
        return False

    def _report_ckpt_step(self, m: msgs.CheckpointStepSync) -> bool:
        self._ckpt_steps[m.node_rank] = m.step
        return True

    def _report_task_result(self, m: msgs.TaskResult) -> bool:
        if self.task_manager:
            self.task_manager.report_task_status(
                m.dataset_name, m.task_id, m.success, m.worker_id
            )
        return True

    def _report_dataset(self, m: msgs.DatasetShardParams) -> bool:
        if self.task_manager:
            self.task_manager.new_dataset(
                m.dataset_name,
                m.dataset_size,
                m.shard_size,
                num_epochs=m.num_epochs,
                shuffle=m.shuffle,
                storage_type=m.storage_type,
                task_type=m.task_type,
            )
        return True

    def _report_shard_ckpt(self, m: msgs.ShardCheckpoint) -> bool:
        if self.task_manager:
            self.task_manager.restore_checkpoint(m.dataset_name, m.content)
        return True

    def _report_network_check(self, m: msgs.NetworkCheckResult) -> bool:
        mgr = self.rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if mgr:
            mgr.report_network_check_result(
                m.node_id, m.succeeded, m.elapsed_time
            )
        return True

    def _report_eviction(self, m: msgs.EvictionNotice) -> bool:
        """A worker announced departing dp ranks: issue the live-reshard
        directive so survivors migrate their in-device state instead of
        restarting from a checkpoint."""
        mgr = self.rdzv_managers.get(RendezvousName.TRAINING)
        if mgr is None:
            return False
        try:
            version = mgr.plan_reshard(
                m.lost_dp_ranks,
                m.dp_size,
                deadline_s=m.deadline_s,
                reason=m.reason,
            )
        except ValueError as e:
            logger.warning(
                "rejecting eviction notice from node %d: %s", m.node_id, e
            )
            return False
        if self.telemetry_hub is not None and self.telemetry_hub.enabled:
            self.telemetry_hub.publish(telemetry.ElasticEvent(
                kind="eviction_notice", node_id=m.node_id,
                detail=(f"v{version} lost={m.lost_dp_ranks} "
                        f"dp={m.dp_size} {m.reason}").strip()))
        return True

    def _report_serving_eviction(self, m: msgs.ServingEvictionNotice) -> bool:
        """A serving replica is leaving (planned drain or detected
        eviction): issue the page-migration directive, so survivors
        adopt its in-flight requests' KV pages instead of re-prefilling."""
        if self.job_manager is None:
            return False
        version = self.job_manager.plan_serving_reshard(
            m.replica, deadline_s=m.deadline_s, reason=m.reason)
        if self.telemetry_hub is not None and self.telemetry_hub.enabled:
            self.telemetry_hub.publish(telemetry.ElasticEvent(
                kind="serving_eviction_notice", node_id=m.node_id,
                detail=(f"v{version} victim={m.replica} "
                        f"in_flight={m.in_flight} {m.reason}").strip()))
        return True

    def _report_serving_scale(self, m: msgs.ServingScaleNotice) -> bool:
        """The serving autoscaler reports one scale decision: version it
        as a serving-scale directive and put it on the event stream."""
        if self.job_manager is None:
            return False
        version = self.job_manager.plan_serving_scale(
            m.role, m.n_after, reason=m.reason or m.signal)
        if self.telemetry_hub is not None and self.telemetry_hub.enabled:
            self.telemetry_hub.publish(telemetry.ElasticEvent(
                kind="serving_scale_notice", node_id=m.node_id,
                detail=(f"v{version} role={m.role} {m.direction} "
                        f"{m.n_before}->{m.n_after} {m.signal}").strip()))
        return True

    def _report_model_info(self, m: msgs.ModelInfoReport) -> bool:
        if self.metric_collector:
            # partial update: unset (zero/empty) fields must not clobber
            # values another reporter already provided
            self.metric_collector.set_job_meta(**{
                k: v
                for k, v in (
                    ("model_name", m.model_name),
                    ("num_params", m.num_params),
                    ("flops_per_token", m.flops_per_token),
                    ("global_batch_size", m.global_batch_size),
                    ("seq_len", m.seq_len),
                    ("strategy_json", m.strategy_json),
                )
                if v
            })
        return True

    def _report_tuning_plan(self, m: msgs.TuningPlanNotice) -> bool:
        """A Brain tuner reports one cold-start plan or revision: version
        it as a tuning directive (trainers pick it up through the
        ParallelConfig poll) and put it on the elastic event stream."""
        if self.job_manager is None:
            return False
        version = self.job_manager.plan_tuning(
            m.plan_json, reason=m.reason or m.signal
        )
        if self.telemetry_hub is not None and self.telemetry_hub.enabled:
            self.telemetry_hub.publish(telemetry.ElasticEvent(
                kind="tuning_plan_notice", node_id=m.node_id,
                detail=f"v{version} {m.signal} {m.reason}".strip()))
        return True

    def _report_ps_version(self, m: msgs.PsVersionReport) -> bool:
        if not self.ps_service:
            return False
        if m.version_type == "global":
            self.ps_service.bump_global_version()
        else:
            self.ps_service.set_node_version(m.node_id, m.version)
        return True

    _REPORT_HANDLERS = {
        "ModelInfoReport": _report_model_info,
        "PsVersionReport": _report_ps_version,
        "TuningPlanNotice": _report_tuning_plan,
        "HeartbeatReport": _report_heartbeat,
        "NodeStatusReport": _report_node_status,
        "WorkerRestartReport": _report_worker_restart,
        "NodeFailureReport": _report_node_failure,
        "ResourceStats": _report_resource,
        "TelemetryEventReport": _report_telemetry,
        "GlobalStepRecord": _report_global_step,
        "KeyValuePair": _report_kv,
        "SyncJoin": _report_sync_join,
        "CheckpointStepSync": _report_ckpt_step,
        "TaskResult": _report_task_result,
        "DatasetShardParams": _report_dataset,
        "ShardCheckpoint": _report_shard_ckpt,
        "EvictionNotice": _report_eviction,
        "ServingEvictionNotice": _report_serving_eviction,
        "ServingScaleNotice": _report_serving_scale,
        "NetworkCheckResult": _report_network_check,
    }

    # ---- get: request → response ----------------------------------------

    def get(self, msg):
        handler = self._GET_HANDLERS.get(type(msg).__name__)
        if handler is None:
            logger.warning("no get handler for %s", type(msg).__name__)
            return None
        return handler(self, msg)

    def _get_register(self, m: msgs.NodeRegisterRequest):
        if self.job_manager and m.meta:
            node = self.job_manager.register_node(m.meta, m.restart_count)
            for mgr in self.rdzv_managers.values():
                mgr.add_alive_node(node.rank_index)
            return msgs.NodeRegisterResponse(
                success=True,
                node_rank=node.rank_index,
                node_num=self.job_manager.worker_num,
            )
        return msgs.NodeRegisterResponse(success=False)

    def _get_join_rdzv(self, m: msgs.JoinRendezvousRequest):
        mgr = self.rdzv_managers.get(m.rdzv_name)
        if mgr is None:
            return None
        node = (
            self.job_manager.get_node(m.node_id) if self.job_manager else None
        )
        host = node.host_addr if node else ""
        rdzv_round = mgr.join_rendezvous(
            m.node_id, m.node_rank, m.local_world_size, host_addr=host,
            coordinator_port=m.coordinator_port,
        )
        return msgs.JoinRendezvousResponse(round=rdzv_round)

    def _get_comm_world(self, m: msgs.CommWorldRequest):
        mgr = self.rdzv_managers.get(m.rdzv_name)
        if mgr is None:
            return None
        rdzv_round, group, world, coord = mgr.get_comm_world(m.node_id)
        return msgs.CommWorldResponse(
            rdzv_round=rdzv_round,
            group=group,
            world={str(k): v for k, v in world.items()},
            coordinator=coord,
        )

    def _get_serving_reshard(self, m: msgs.ServingReshardRequest):
        if self.job_manager is None:
            return msgs.ServingReshardDirective()
        plan = self.job_manager.get_serving_reshard()
        if not plan.get("version"):
            return msgs.ServingReshardDirective()
        return msgs.ServingReshardDirective(
            version=plan["version"], victim=plan["victim"],
            survivors=list(plan["survivors"]),
            deadline_s=plan["deadline_s"], reason=plan["reason"])

    def _get_serving_scale(self, m: msgs.ServingScaleRequest):
        if self.job_manager is None:
            return msgs.ServingScaleDirective()
        plan = self.job_manager.get_serving_scale(m.role)
        if not plan.get("version"):
            return msgs.ServingScaleDirective()
        return msgs.ServingScaleDirective(
            version=plan["version"], role=plan["role"],
            target=plan["target"], reason=plan["reason"])

    def _get_reshard_plan(self, m: msgs.ReshardPlanRequest):
        mgr = self.rdzv_managers.get(m.rdzv_name)
        if mgr is None:
            return msgs.ReshardPlanResponse()
        plan = mgr.get_reshard_plan()
        if not plan.get("version"):
            return msgs.ReshardPlanResponse()
        return msgs.ReshardPlanResponse(
            version=plan["version"],
            rdzv_round=plan["rdzv_round"],
            dp_old=plan["dp_old"],
            dp_new=plan["dp_new"],
            lost_ranks=list(plan["lost_ranks"]),
            deadline_s=plan["deadline_s"],
            reason=plan["reason"],
        )

    def _get_task(self, m: msgs.TaskRequest):
        if self.task_manager is None:
            return msgs.Task()
        task = self.task_manager.get_task(m.dataset_name, m.worker_id)
        return msgs.Task(
            task_id=task.task_id,
            task_type=task.task_type,
            dataset_name=m.dataset_name,
            shard_start=task.shard.start,
            shard_end=task.shard.end,
            epoch=task.epoch,
            record_indices=list(task.shard.record_indices),
        )

    def _get_shard_ckpt(self, m: msgs.ShardCheckpointRequest):
        if self.task_manager is None:
            return msgs.ShardCheckpoint()
        return msgs.ShardCheckpoint(
            dataset_name=m.dataset_name,
            content=self.task_manager.checkpoint(m.dataset_name),
        )

    def _get_epoch(self, m: msgs.DatasetEpochRequest):
        epoch = (
            self.task_manager.get_epoch(m.dataset_name)
            if self.task_manager
            else 0
        )
        return msgs.DatasetEpochResponse(epoch=epoch)

    def _get_network_status(self, m: msgs.NetworkCheckStatusRequest):
        mgr = self.rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if mgr is None:
            return msgs.NetworkCheckStatusResponse()
        fault, _ = mgr.check_fault_node()
        stragglers, _ = mgr.get_stragglers()
        return msgs.NetworkCheckStatusResponse(
            normal=m.node_id not in fault,
            fault_nodes=fault,
            stragglers=stragglers,
        )

    def _get_num_nodes_waiting(self, m: msgs.NumNodesWaitingRequest):
        mgr = self.rdzv_managers.get(m.rdzv_name)
        n = mgr.num_nodes_waiting() if mgr else 0
        return msgs.NumNodesWaitingResponse(waiting_num=n)

    def _get_kv(self, m: msgs.KeyRequest):
        value = self.kv_store.get(m.key) if self.kv_store else ""
        return msgs.KeyValuePair(key=m.key, value=value)

    def _get_sync(self, m: msgs.SyncRequest):
        ok = (
            self.sync_service.sync_finished(m.sync_name)
            if self.sync_service
            else False
        )
        return msgs.SyncResponse(success=ok)

    def _get_ckpt_step(self, m: msgs.CheckpointStepRequest):
        if not self._ckpt_steps:
            return msgs.CheckpointStepResponse(step=0)
        return msgs.CheckpointStepResponse(
            step=min(self._ckpt_steps.values())
        )

    def _get_running_nodes(self, m: msgs.RunningNodesRequest):
        if not self.job_manager:
            return msgs.RunningNodesResponse()
        return msgs.RunningNodesResponse(
            nodes=[
                msgs.NodeInfo(
                    id=n.id,
                    type=n.type,
                    name=n.name,
                    status=n.status,
                    host_addr=n.host_addr or "",
                    rank_index=n.rank_index,
                )
                for n in self.job_manager.running_nodes()
            ]
        )

    def _get_paral_config(self, m: msgs.ParallelConfigRequest):
        node = (
            self.job_manager.get_node(m.node_id) if self.job_manager else None
        )
        cfg = node.paral_config if node else {}
        out = msgs.ParallelConfig(**cfg) if cfg else msgs.ParallelConfig()
        # the job-level tuning directive rides the per-node config, so one
        # poll carries both (the tuner gates on the version pair)
        if self.job_manager is not None:
            plan = self.job_manager.get_tuning()
            if plan.get("version"):
                out.tuning_version = plan["version"]
                out.tuning_json = plan["plan_json"]
        return out

    def _get_tuning(self, m: msgs.TuningPlanRequest):
        if self.job_manager is None:
            return msgs.TuningPlanDirective()
        plan = self.job_manager.get_tuning()
        if not plan.get("version"):
            return msgs.TuningPlanDirective()
        return msgs.TuningPlanDirective(
            version=plan["version"],
            plan_json=plan["plan_json"],
            reason=plan["reason"],
        )

    def _get_ps_version(self, m: msgs.PsVersionRequest):
        if not self.ps_service:
            return msgs.PsVersionResponse()
        if m.version_type == "global":
            version = self.ps_service.get_global_version()
        else:
            version = self.ps_service.get_node_version(m.node_id)
        return msgs.PsVersionResponse(
            version=version,
            servers=list(self.ps_service.get_servers()),
            weights=self.ps_service.get_weights(),
        )

    _GET_HANDLERS = {
        "RunningNodesRequest": _get_running_nodes,
        "PsVersionRequest": _get_ps_version,
        "TuningPlanRequest": _get_tuning,
        "ParallelConfigRequest": _get_paral_config,
        "HeartbeatReport": _get_heartbeat,
        "NodeRegisterRequest": _get_register,
        "JoinRendezvousRequest": _get_join_rdzv,
        "CommWorldRequest": _get_comm_world,
        "NumNodesWaitingRequest": _get_num_nodes_waiting,
        "NetworkCheckStatusRequest": _get_network_status,
        "KeyRequest": _get_kv,
        "SyncRequest": _get_sync,
        "CheckpointStepRequest": _get_ckpt_step,
        "ReshardPlanRequest": _get_reshard_plan,
        "ServingReshardRequest": _get_serving_reshard,
        "ServingScaleRequest": _get_serving_scale,
        "TaskRequest": _get_task,
        "ShardCheckpointRequest": _get_shard_ckpt,
        "DatasetEpochRequest": _get_epoch,
    }
