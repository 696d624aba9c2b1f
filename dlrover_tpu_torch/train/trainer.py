"""High-level trainer: the loop with its cadences around the train step.

Port of ``dlrover_tpu/train/trainer.py`` (``TrainerArgs``, ``Trainer``)
for one process on one device: ``TrainStepBuilder``'s step (or its fused
K-step block) over the batches, Flash Checkpoint resume (shared memory,
then storage) and cadenced saves (``memory_save_interval`` stages to
shared memory, ``save_interval`` also persists on the engine's thread),
evaluation, loss-spike detection, step timing on CUDA events, callbacks
and telemetry. Every cadence stays exact for any ``block_k``: blocks
shrink to land on each boundary (``_next_block_k``).

Not ported yet, and refused with the ROADMAP item that ports them: a
mesh or several processes and master reporting (A8), update sharding
and the bucketed gradient exchange (A9), health sentinels and the
sampled runtime profile (A12), the gradient sanitizer (A17).
"""

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from dlrover_tpu_torch.checkpoint import Checkpointer, StorageType
from dlrover_tpu_torch.common.constants import GraftEnv
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.loss_spike import LossSpikeDetector
from dlrover_tpu_torch.observability.profiler import StepTimer
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.train.callbacks import (
    Callback,
    CallbackList,
    LossSpikeCallback,
    TrainerControl,
)
from dlrover_tpu_torch.train.data_utils import prefetch_to_device
from dlrover_tpu_torch.train.train_step import (
    TrainStepBuilder,
    build_eval_step,
    init_train_state,
)

logger = get_logger(__name__)


@dataclass
class TrainerArgs:
    """The JAX ``TrainerArgs``, field for field."""

    output_dir: str = "/tmp/dlrover_tpu_out"
    max_steps: int = 1000
    log_interval: int = 10
    save_interval: int = 100          # async disk persist cadence (steps)
    memory_save_interval: int = 0     # extra shm-only staging cadence; 0=off
    eval_interval: int = 0            # 0 = no eval during training
    eval_steps: int = 8
    seed: int = 0
    resume: bool = True
    # resume from this exact committed step instead of the latest
    resume_from_step: Optional[int] = None
    # leaves missing from the checkpoint keep their fresh values instead
    # of failing the restore; params still restore exactly or raise
    resume_partial: bool = False
    grad_accum: int = 1
    attn_impl: str = "auto"
    detect_loss_spikes: bool = True
    report_to_master: bool = True
    # run a final evaluation when the loop exits (even without cadence)
    eval_at_end: bool = False
    profile_interval: int = 0         # ROADMAP A12
    # keep N batches in flight to the device ahead of the step (pinned
    # host memory, copies on a side stream); 0 = a plain copy a batch
    prefetch: int = 0
    # dispatch K steps with no host read between them and read the
    # previous block's per-step metrics while the next one runs; 1 = the
    # per-step loop. Cadences and max_steps stay exact for any K; control
    # flags are honored at the next block boundary.
    block_k: int = 1
    update_sharding: Union[bool, str] = False   # ROADMAP A9
    comm_bucket_mb: float = 4.0                 # ROADMAP A9
    comm_wire_dtype: str = "float32"            # ROADMAP A9
    comm_wire_dtype_dcn: Optional[str] = None   # ROADMAP A9
    health_sentinels: bool = False              # ROADMAP A12
    sanitize_grads: Optional[str] = None        # ROADMAP A17


def _refuse_unported(args: TrainerArgs, mesh, master_client) -> None:
    if (args.update_sharding or args.comm_bucket_mb != 4.0
            or args.comm_wire_dtype != "float32"
            or args.comm_wire_dtype_dcn is not None):
        raise NotImplementedError(
            "update_sharding and the comm_* options (ZeRO update sharding, "
            "the bucketed gradient exchange) are not ported yet (ROADMAP A9)")
    if args.health_sentinels or args.profile_interval:
        raise NotImplementedError(
            "health_sentinels and profile_interval are not ported yet "
            "(ROADMAP A12)")
    if args.sanitize_grads:
        raise NotImplementedError(
            "sanitize_grads is not ported yet (ROADMAP A17)")
    dist = torch.distributed
    if mesh is not None or (dist.is_available() and dist.is_initialized()
                            and dist.get_world_size() > 1):
        raise NotImplementedError(
            "a mesh or a multi-process run is not ported yet (ROADMAP A8)")
    if master_client is not None:
        raise NotImplementedError(
            "reporting to the elastic master is not ported yet (ROADMAP A8)")


class Trainer:
    """Own the training loop for one model, optimizer and device.

    ``train_iter`` yields batch dicts ({"tokens", "targets", ...}) of the
    global batch size, as arrays or host tensors; the trainer moves them
    to the device (``args.prefetch`` ahead). The state is
    ``train_step.init_train_state``'s, updated in place by every step.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        args: TrainerArgs,
        train_iter: Iterable[Dict],
        optimizer,
        mesh=None,
        eval_iter_fn: Optional[Callable[[], Iterable[Dict]]] = None,
        master_client=None,
        callbacks: Optional[List[Callback]] = None,
        step_builder: Optional[TrainStepBuilder] = None,
        init_state_fn: Optional[Callable[[int], Dict]] = None,
        eval_step_fn: Optional[Callable] = None,
        device="cuda",
    ):
        """``step_builder``/``init_state_fn``/``eval_step_fn`` hand in the
        lowering instead of the one built here from ``args``;
        ``init_state_fn(seed)`` returns a train state."""
        _refuse_unported(args, mesh, master_client)
        self.cfg = cfg
        self.args = args
        self.device = resolve_device(device)
        self.optimizer = optimizer
        self.eval_iter_fn = eval_iter_fn
        self._init_state_fn = init_state_fn
        self._builder = step_builder or TrainStepBuilder(
            cfg, optimizer, grad_accum=args.grad_accum,
            attn_impl=args.attn_impl, device=self.device)
        self._step_fn = None
        self._block_fn = None
        self._eval_fn = eval_step_fn
        self.train_iter = prefetch_to_device(iter(train_iter), args.prefetch,
                                             self.device)
        self.state: Any = None
        self.timer = StepTimer(self.device)
        self.spike_detector = (
            LossSpikeDetector(
                save_dir=os.path.join(args.output_dir, "loss_spikes"))
            if args.detect_loss_spikes else None
        )
        self._ckpt = None
        self.control = TrainerControl()
        self.callbacks = CallbackList(callbacks)
        if self.spike_detector is not None:
            self.callbacks.add(LossSpikeCallback(self.spike_detector))
        # restart>0 means we are recovering: the first completed step
        # closes the failover timeline ("first-step-back")
        self._first_step_pending = (
            int(os.environ.get(GraftEnv.RESTART_COUNT, "0") or 0) > 0
        )

    def add_callback(self, cb: Callback):
        self.callbacks.add(cb)

    # ---- checkpointing ---------------------------------------------------

    @property
    def checkpointer(self) -> Checkpointer:
        if self._ckpt is None:
            self._ckpt = Checkpointer(
                os.path.join(self.args.output_dir, "checkpoints"))
        return self._ckpt

    def state_leaves(self):
        """The state as the JAX train state's leaves (what a checkpoint
        holds)."""
        return convert.train_state_leaves(self.state, self.cfg,
                                          self.optimizer)

    def _save(self, step: int, storage_type: str) -> bool:
        return self.checkpointer.save_checkpoint(step, self.state_leaves(),
                                                 storage_type=storage_type)

    def _init_state(self):
        if self._init_state_fn is not None:
            self.state = self._init_state_fn(self.args.seed)
        else:
            self.state = init_train_state(self.args.seed, self.cfg,
                                          self.optimizer, device=self.device)
        if not self.args.resume:
            return
        leaves = self.state_leaves()
        restored = self.checkpointer.load_checkpoint(
            leaves, step=self.args.resume_from_step,
            partial=self.args.resume_partial)
        if restored is not None:
            convert.load_scalars(self.state, leaves, self.optimizer)
            logger.info("resumed from step %d", self.state["step"])

    # ---- loops -----------------------------------------------------------

    def train(self) -> Any:
        args = self.args
        if self.state is None:
            self._init_state()
        if self._step_fn is None:
            self._step_fn = self._builder.build()
        control = self.control
        self.callbacks.fire("on_train_begin", self, control)
        if args.block_k > 1:
            if self._block_fn is None:
                self._block_fn = self._builder.build_block()
            last_saved, last_evaled = self._train_blockwise()
        else:
            last_saved, last_evaled = self._train_stepwise()
        if args.eval_at_end and self.state["step"] != last_evaled:
            eval_metrics = self.evaluate()
            if eval_metrics:
                self.callbacks.fire("on_eval", self, self.state["step"],
                                    eval_metrics, control)
        # final checkpoint so a clean exit is always resumable (skipped
        # when the loop's cadence already saved this exact step); any
        # save at all is awaited, or the process could exit mid-persist
        if args.save_interval:
            final_step = self.state["step"]
            if final_step != last_saved:
                self._save(final_step, StorageType.DISK)
                last_saved = final_step
        if last_saved >= 0:
            self.checkpointer.wait_for_persist()
        self.callbacks.fire("on_train_end", self, control)
        return self.state

    # ---- telemetry producers --------------------------------------------

    def _emit_step_telemetry(self, step: int, loss: float,
                             step_time_s: float, batch=None,
                             n_steps: int = 1):
        """Per-step StepRecord onto the hub; closes the failover timeline
        on the first step after a restart. A disabled hub costs two
        attribute reads."""
        if self._first_step_pending:
            self._first_step_pending = False
            get_tracer().instant("failover.first_step", step=step)
            hub = telemetry.get_hub()
            if hub.enabled:
                hub.publish(telemetry.ElasticEvent(
                    kind="first_step_back", detail=f"step={step}"))
        hub = telemetry.get_hub()
        if not hub.enabled:
            return
        tokens = 0
        if batch is not None and batch.get("tokens") is not None:
            tokens = batch["tokens"].numel() // max(n_steps, 1)
        hub.publish(telemetry.StepRecord(
            step=step, loss=loss, step_time_s=step_time_s,
            tokens_per_s=tokens / step_time_s if step_time_s > 0 else 0.0,
            accum=self.args.grad_accum))

    def _log(self, step, window, control):
        """Fire ``on_log`` with the window's mean loss and steps/s."""
        dt = time.perf_counter() - window["t_log"]
        window["t_log"] = time.perf_counter()
        logs = {"loss": window["loss"] / max(window["n"], 1),
                "steps_per_s": window["n"] / max(dt, 1e-9)}
        self.callbacks.fire("on_log", self, step, logs, control)
        logger.info(
            "step %d | loss %.4f | %.2f steps/s%s", step, logs["loss"],
            logs["steps_per_s"],
            " | lr %.3e" % logs["learning_rate"]
            if "learning_rate" in logs else "")
        window["loss"], window["n"] = 0.0, 0

    def _boundary(self, step: int) -> Tuple[bool, bool]:
        """The state-touching cadences after ``step``: memory save, save,
        eval. Returns (saved, evaled)."""
        args, control = self.args, self.control
        saved = evaled = False
        disk = control.should_save or (
            args.save_interval and step % args.save_interval == 0)
        # a disk save stages the same state first: one staging a step
        if (args.memory_save_interval and not disk
                and step % args.memory_save_interval == 0):
            self._save(step, StorageType.MEMORY)
        if disk:
            self._save(step, StorageType.DISK)
            saved = True
            self.callbacks.fire("on_save", self, step, control)
        if control.should_eval or (
                args.eval_interval and step % args.eval_interval == 0):
            evaled = True
            eval_metrics = self.evaluate()
            if eval_metrics:
                logger.info("eval @ step %d | loss %.4f", step,
                            eval_metrics["loss"])
                self.callbacks.fire("on_eval", self, step, eval_metrics,
                                    control)
        control.reset_step_flags()
        return saved, evaled

    def _train_stepwise(self) -> Tuple[int, int]:
        """The one-dispatch-a-step loop (block_k=1)."""
        args = self.args
        control = self.control
        window = {"loss": 0.0, "n": 0, "t_log": time.perf_counter()}
        last_saved = last_evaled = -1
        for step in range(self.state["step"] + 1, args.max_steps + 1):
            try:
                batch = next(self.train_iter)
            except StopIteration:
                logger.info("data exhausted at step %d", step - 1)
                break
            self.timer.start()
            self.state, metrics = self._step_fn(self.state, batch)
            timing = self.timer.stop()
            loss = float(metrics["loss"])  # the one device→host read a step
            self.timer.record(timing)
            self._emit_step_telemetry(step, loss, self.timer.last_s, batch)
            window["loss"] += loss
            window["n"] += 1
            self.callbacks.fire("on_step_end", self, step, {"loss": loss},
                                control)
            if control.should_log or (
                    args.log_interval and step % args.log_interval == 0):
                self._log(step, window, control)
            saved, evaled = self._boundary(step)
            last_saved = step if saved else last_saved
            last_evaled = step if evaled else last_evaled
            if control.should_stop:
                logger.info("training stopped by callback at step %d", step)
                break
        return last_saved, last_evaled

    # ---- fused multi-step loop ------------------------------------------

    def _next_block_k(self, step: int) -> int:
        """Largest block size from ``step`` that lands exactly on every
        state-touching cadence boundary (save/eval/memory-save) and on
        ``max_steps``: boundaries only ever coincide with block ends,
        never fall inside a block. The log cadence does not shrink
        blocks: logs need only the stacked metrics, which the drain
        replays per step."""
        args = self.args
        k = min(args.block_k, args.max_steps - step)
        for interval in (args.save_interval, args.eval_interval,
                         args.memory_save_interval):
            if interval:
                k = min(k, interval - step % interval)
        return max(int(k), 1)

    def _to_host_async(self, metrics: Dict[str, torch.Tensor]):
        """Start the copy of a block's stacked metrics to host memory;
        returns the host tensors and the event that marks them ready."""
        if self.device.type != "cuda":
            return metrics, None
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in metrics.items()}
        for k, v in metrics.items():
            host[k].copy_(v, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _train_blockwise(self) -> Tuple[int, int]:
        """K steps a dispatch, the previous block's metrics read while the
        next one runs.

        Per-step host work (loss windows, spike detection, on_step_end,
        exact-step logging) happens in the drain, against each step's own
        values. State-touching cadences run at block ends, which
        ``_next_block_k`` aligned to the boundaries; control flags raised
        during a drain are honored at the next boundary (one block at
        worst)."""
        args = self.args
        control = self.control
        step = self.state["step"]
        window = {"loss": 0.0, "n": 0, "t_log": time.perf_counter()}
        last_saved = last_evaled = -1
        pending = None  # (first_step, k, host metrics, ready event, timing)

        def drain(first, k, host, ready, timing):
            if ready is not None:
                ready.synchronize()  # that block only, not the running one
            self.timer.record(timing)
            per_step_s = self.timer.last_s
            for i, loss in enumerate(host["loss"].tolist()):
                s = first + i
                self._emit_step_telemetry(s, loss, per_step_s, n_steps=k)
                window["loss"] += loss
                window["n"] += 1
                self.callbacks.fire("on_step_end", self, s, {"loss": loss},
                                    control)
                if control.should_log or (
                        args.log_interval and s % args.log_interval == 0):
                    control.should_log = False
                    self._log(s, window, control)

        exhausted = False
        while (step < args.max_steps and not control.should_stop
               and not exhausted):
            batches = []
            for _ in range(self._next_block_k(step)):
                try:
                    batches.append(next(self.train_iter))
                except StopIteration:
                    exhausted = True
                    break
            if not batches:
                logger.info("data exhausted at step %d", step)
                break
            k = len(batches)
            self.timer.start()
            self.state, metrics = self._block_fn(self.state, batches)
            timing = self.timer.stop(k)
            host, ready = self._to_host_async(metrics)
            if pending is not None:
                drain(*pending)
            pending = (step + 1, k, host, ready, timing)
            step += k
            saved, evaled = self._boundary(step)
            last_saved = step if saved else last_saved
            last_evaled = step if evaled else last_evaled
        if pending is not None:
            drain(*pending)
        # flags raised by the final drain still get their boundary
        if control.should_save:
            self._save(step, StorageType.DISK)
            last_saved = step
            self.callbacks.fire("on_save", self, step, control)
        if control.should_eval:
            eval_metrics = self.evaluate()
            last_evaled = step
            if eval_metrics:
                self.callbacks.fire("on_eval", self, step, eval_metrics,
                                    control)
        control.reset_step_flags()
        if control.should_stop:
            logger.info("training stopped by callback at step %d", step)
        return last_saved, last_evaled

    def evaluate(self) -> Dict[str, float]:
        if self.eval_iter_fn is None:
            return {}
        if self._eval_fn is None:
            self._eval_fn = build_eval_step(self.cfg, self.args.attn_impl,
                                            self.device)
        total, n = 0.0, 0
        for i, batch in enumerate(self.eval_iter_fn()):
            if i >= self.args.eval_steps:
                break
            metrics = self._eval_fn(self.state["params"], batch)
            total += float(metrics["loss"])
            n += 1
        return {"loss": total / max(n, 1), "batches": float(n)}
