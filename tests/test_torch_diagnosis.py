"""Failure diagnosis and heartbeat actions in the port (``diagnosis/
manager.py``, ``master/servicer.py``, ``master/master.py``,
``agent/agent.py``, ``agent/monitor.py``, ``agent/collectors.py``)
against the JAX package's, on the CPU. Every comparison is exact.

- ``classify_failure``: the same class and action as JAX's on every JAX
  signature; each CUDA counterpart gets the class and action JAX gives
  the same failure; the port's table holds every JAX rule in its order.
- The manager: queue, take, the no-double-restart rule and the job-wide
  hang verdict equal JAX's under the same records, with a short window
  and a patched clock.
- The servicer over the real transport: actions come back on
  heartbeats, an abort fans out to every running node, a
  ``level="diagnosis"`` report is evidence only, resource stats reach
  the hang detector through the master's hub.
- The agent acts on each action: ``restart_worker`` respawns,
  ``abort_job`` exits 1 (FAILED ``fatal_error``), ``relaunch_node`` exits
  2 (FAILED ``killed``); a dead worker is reported and respawned before
  the relaunch its report prescribed.
- The monitor's ``/proc`` fields, and 0 card memory without a card; the
  collectors' log tail, proc state and a stack dump by SIGUSR2.
"""

import os
import subprocess
import sys
import threading
import time

import pytest

pytest.importorskip("jax")

from dlrover_tpu.common import messages as jmsgs  # noqa: E402
from dlrover_tpu.diagnosis import manager as jdiag  # noqa: E402
from dlrover_tpu_torch.agent import collectors, monitor  # noqa: E402
from dlrover_tpu_torch.agent.agent import (  # noqa: E402
    ElasticLaunchConfig,
    ElasticTrainingAgent,
)
from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa
from dlrover_tpu_torch.agent.rendezvous import RendezvousOutcome  # noqa
from dlrover_tpu_torch.common import messages as msgs  # noqa: E402
from dlrover_tpu_torch.common.constants import NodeStatus  # noqa: E402
from dlrover_tpu_torch.diagnosis import manager as diag  # noqa: E402
from dlrover_tpu_torch.master.master import JobMaster  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one report text a JAX rule alternative (and a few that match none)
JAX_SIGNATURES = [
    "RESOURCE_EXHAUSTED: Out of memory allocating 4.00G",
    "XlaRuntimeError: out of memory", "OOM while compiling",
    "ICI link failure on chip 3", "slice 0 health error",
    "interconnect went down", "DEADLINE_EXCEEDED: rpc timed out",
    "barrier timeout after 300s", "missed heartbeat from host 2",
    "UNAVAILABLE: connection reset", "coordination service lost task 1",
    "the VM was preempted", "SyntaxError: invalid syntax",
    "ImportError: cannot import name 'x'", "ModuleNotFoundError: No module",
    "TypeError: unsupported operand", "Segmentation fault (core dumped)",
    "", "worker exit code 17",
]

# the card's counterparts: (report text, the JAX signature of the same
# failure, whose class and action it must get)
CUDA_COUNTERPARTS = [
    ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate "
     "2.00 GiB", "RESOURCE_EXHAUSTED: Out of memory allocating 4.00G"),
    ("RuntimeError: CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
     "`cublasCreate(handle)`", "OOM while compiling"),
    ("RuntimeError: CUDA error: uncorrectable ECC error encountered",
     "ICI link failure on chip 3"),
    ("NVRM: Xid (PCI:0000:3b:00): 79, pid=1234, GPU has fallen off the bus.",
     "ICI link failure on chip 3"),
    ("NVLink: fatal error detected on link 4", "interconnect went down"),
    ("torch.distributed.DistBackendError: NCCL error in: ProcessGroupNCCL."
     "cpp:1970, unhandled system error (run with NCCL_DEBUG=INFO for "
     "details)", "slice 0 health error"),
    ("[Rank 0] Watchdog caught collective operation timeout: "
     "WorkNCCL(SeqNum=9, OpType=ALLREDUCE) ran for 600043 milliseconds "
     "before timing out.", "barrier timeout after 300s"),
    ("torch.distributed.elastic.multiprocessing.api.SignalException: "
     "Process 1234 got signal: 15", "the VM was preempted"),
    ("worker exit code -15", "the VM was preempted"),
    ("RuntimeError: CUDA error: no kernel image is available for execution "
     "on the device", "SyntaxError: invalid syntax"),
]


@pytest.mark.parametrize("text", JAX_SIGNATURES)
def test_classify_equals_jax_on_every_jax_signature(text):
    assert diag.classify_failure(text) == jdiag.classify_failure(text)


@pytest.mark.parametrize("text,same_as", CUDA_COUNTERPARTS)
def test_each_cuda_counterpart_gets_the_jax_class_and_action(text, same_as):
    want = jdiag.classify_failure(same_as)
    assert want[0] != "unknown"
    assert diag.classify_failure(text) == want


def test_the_port_table_holds_every_jax_rule_in_order():
    jax_rules = list(jdiag._FAILURE_RULES)
    assert [r for r in diag._FAILURE_RULES if r in jax_rules] == jax_rules
    # each added rule sits right after a JAX rule of its class and action
    for i, rule in enumerate(diag._FAILURE_RULES):
        if rule not in jax_rules:
            prev = diag._FAILURE_RULES[i - 1]
            assert prev in jax_rules and prev[1:] == rule[1:]


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _drive(mod, msg_mod, clock):
    """The same records into a manager of ``mod``; what it answers."""
    m = mod.DiagnosisManager(hang_cpu_percent=5.0)
    out = []

    def failure(node, text, alive=False):
        rec = m.collect_failure(msg_mod.NodeFailureReport(
            node_id=node, error_data=text, level="process_error"),
            worker_alive=alive)
        out.append((rec.classification, rec.action))

    failure(0, "ICI link failure")                # relaunch, queued
    failure(1, "worker exit code 3")              # restart: not queued
    failure(1, "barrier timeout", alive=True)     # a hang: queued
    failure(2, "SyntaxError")                     # abort, queued
    m.queue_action_for([0, 1, 2], "abort_job")    # fan-out, deduplicated
    out.append([m.take_actions(n) for n in (0, 1, 2, 3)])
    out.append([m.take_actions(n) for n in (0, 1, 2)])  # drained
    out.append(m.failure_summary())
    m.collect_diagnosis_data(1, "[training_log] x" * 3000)
    out.append(len(m.diagnosis_data[1][0]["content"]))
    window = 10.0
    out.append(m.all_nodes_hanged(window))        # no history
    for node in (0, 1):
        m.collect_resource(msg_mod.ResourceStats(
            node_id=node, cpu_percent=1.0, used_memory_mb=5.0))
    out.append(m.all_nodes_hanged(window))        # history shorter
    for step in range(12):
        clock.t += 1.0
        for node in (0, 1):
            m.collect_resource(msg_mod.ResourceStats(
                node_id=node, cpu_percent=2.0 if step < 11 or node else 50.0,
                used_memory_mb=5.0))
        out.append(m.all_nodes_hanged(window))
    clock.t += 11.0  # the busy sample leaves the window; idle ones stay
    for node in (0, 1):
        m.collect_resource(msg_mod.ResourceStats(
            node_id=node, cpu_percent=0.5, used_memory_mb=5.0))
    out.append(m.all_nodes_hanged(window))
    return out


def test_the_manager_equals_jax_under_the_same_records(monkeypatch):
    runs = []
    for mod, msg_mod in ((diag, msgs), (jdiag, jmsgs)):
        clock = _Clock()
        monkeypatch.setattr(time, "time", clock)
        runs.append(_drive(mod, msg_mod, clock))
    assert runs[0] == runs[1]
    acts = runs[0][4]
    assert acts == [["relaunch_node", "abort_job"],
                    ["restart_worker", "abort_job"], ["abort_job"], []]
    assert True in runs[0] and runs[0][-1] is True


# ---- the servicer and master over the wire ---------------------------------


@pytest.fixture
def master():
    m = JobMaster(port=0, num_workers=2)
    m.prepare()
    yield m
    m.stop()


def _client(master, node):
    c = MasterClient(master.addr, node_id=node)
    c.register_node(local_chips=1)
    return c


def test_heartbeats_carry_the_diagnosed_actions(master):
    c0, c1 = _client(master, 0), _client(master, 1)
    assert c0.heartbeat_with_actions() == []
    c1.report_failure("worker exit code 1\nRuntimeError: CUDA error: "
                      "uncorrectable ECC error encountered")
    assert c1.heartbeat_with_actions() == ["relaunch_node"]
    assert c1.heartbeat_with_actions() == []  # drained
    assert c0.heartbeat_with_actions() == []
    # a dead worker's unknown failure: the agent restarts it on its own
    c0.report_failure("worker exit code 9")
    assert c0.heartbeat_with_actions() == []
    assert master.diagnosis_manager.failure_summary() == {
        "hardware_error": 1, "unknown": 1}


def test_an_abort_fans_out_to_every_running_node(master):
    c0, c1 = _client(master, 0), _client(master, 1)
    c0.report_failure("worker exit code 1\nModuleNotFoundError: no x")
    assert c0.heartbeat_with_actions() == ["abort_job"]
    assert c1.heartbeat_with_actions() == ["abort_job"]


def test_a_diagnosis_report_is_evidence_only(master):
    c0 = _client(master, 0)
    c0.report_failure("[training_log] old line: CUDA out of memory",
                      level="diagnosis")
    assert c0.heartbeat_with_actions() == []
    assert master.diagnosis_manager.failures == type(
        master.diagnosis_manager.failures)(maxlen=512)
    assert "CUDA out of memory" in \
        master.diagnosis_manager.diagnosis_data[0][0]["content"]


def test_resource_stats_reach_the_hang_detector_through_the_hub(master):
    c1 = _client(master, 1)
    assert c1.report_resource_stats(cpu_percent=3.0, used_memory_mb=7.0,
                                    hbm_used_mb=11.0, hbm_peak_mb=13.0)
    hist = master.diagnosis_manager.resource_history[1]
    assert (hist[0]["cpu"], hist[0]["mem_mb"], hist[0]["hbm_mb"],
            hist[0]["hbm_peak_mb"]) == (3.0, 7.0, 11.0, 13.0)


def test_the_master_kicks_every_node_once_all_hang(master, monkeypatch):
    c0, c1 = _client(master, 0), _client(master, 1)
    monkeypatch.setattr(master.diagnosis_manager, "all_nodes_hanged",
                        lambda: True)
    assert master._kick_if_hanged(cooldown_s=60.0)
    assert not master._kick_if_hanged(cooldown_s=60.0)  # cooling down
    assert c0.heartbeat_with_actions() == ["restart_worker"]
    assert c1.heartbeat_with_actions() == ["restart_worker"]


def test_the_default_callbacks_prune_a_failed_node(master):
    from dlrover_tpu_torch.master.elastic_ps import PsClusterCallback
    from dlrover_tpu_torch.master.event_callback import (
        ChiefFailureCallback,
        RendezvousPruneCallback,
        TaskRescheduleCallback,
    )

    # the stock observers, then the sparse tier's server set (as the JAX
    # master registers them)
    kinds = [type(cb) for cb in master.job_manager.event_callbacks]
    assert kinds == [TaskRescheduleCallback, RendezvousPruneCallback,
                     ChiefFailureCallback, PsClusterCallback]
    _client(master, 0)
    _client(master, 1)
    rdzv = next(iter(master.rdzv_managers.values()))
    master.job_manager.handle_status_report(1, NodeStatus.FAILED, "killed")
    assert 1 not in rdzv._alive_nodes


# ---- the agent -------------------------------------------------------------


class _FakeClient:
    """The master calls the agent makes, recorded; a failure report is
    classified as the master would and its action handed to the next
    heartbeat."""

    addr = "localhost:1"
    node_rank = 0

    def __init__(self, actions=(), hold=None):
        self.pending = list(actions)
        self.calls = []
        self.lock = threading.Lock()
        self.hold = hold  # a file whose existence releases the actions

    def _log(self, *call):
        with self.lock:
            self.calls.append(call)

    def register_node(self, **kw):
        self._log("register")

    def heartbeat_with_actions(self):
        if self.hold is not None and not os.path.exists(self.hold):
            return []  # not before the worker started
        with self.lock:
            out, self.pending = self.pending, []
        return out

    def report_node_status(self, status, exit_reason="", retries=None):
        self._log("status", status, exit_reason)

    def report_failure(self, text, level="", restart_count=0, retries=None):
        cls, action = diag.classify_failure(text)
        self._log("failure", cls)
        if action != "restart_worker":
            with self.lock:
                self.pending.append(action)

    def report_worker_restart(self, reason="", retries=None):
        self._log("restart", reason)

    def num_nodes_waiting(self):
        return 0


def _agent(client, script, tmp_path, max_restarts=1):
    cfg = ElasticLaunchConfig(max_restarts=max_restarts,
                              monitor_interval_s=0.05,
                              heartbeat_interval_s=0.05,
                              entrypoint=[sys.executable, "-c", script,
                                          str(tmp_path / "marker")])
    agent = ElasticTrainingAgent(cfg, client)
    spawns = []

    def rendezvous():
        spawns.append(time.monotonic())
        client._log("spawn")
        return RendezvousOutcome(round=len(spawns), world={0: 1},
                                 coordinator="localhost:1", process_id=0,
                                 num_processes=1, global_chips=1)

    agent._rendezvous = rendezvous
    return agent


# first start sleeps, later ones exit 0 (a marker file tells them apart)
_SLEEP_ONCE = ("import os, sys, time; p = sys.argv[1]; "
               "first = not os.path.exists(p); open(p, 'a').close(); "
               "time.sleep(60 if first else 0)")
_DIE_ONCE = ("import os, sys, time; p = sys.argv[1]; "
             "first = not os.path.exists(p); open(p, 'a').close(); "
             "sys.stderr.write('RuntimeError: CUDA error: uncorrectable ECC "
             "error encountered\\n') if first else None; "
             "sys.exit(1) if first else time.sleep(60)")


@pytest.mark.parametrize("action,rc,reason", [
    ("abort_job", 1, "fatal_error"), ("relaunch_node", 2, "killed")])
def test_the_agent_stops_on_abort_and_relaunch(tmp_path, action, rc, reason):
    client = _FakeClient([action])
    agent = _agent(client, _SLEEP_ONCE, tmp_path)
    t0 = time.monotonic()
    assert agent.run() == rc
    assert time.monotonic() - t0 < 30  # the sleeping worker was stopped
    assert ("status", NodeStatus.FAILED, reason) in client.calls
    assert agent._workers[0].poll() is not None


def test_the_agent_restarts_its_worker_on_a_restart_action(tmp_path):
    client = _FakeClient(["restart_worker"], hold=tmp_path / "marker")
    agent = _agent(client, _SLEEP_ONCE, tmp_path)
    assert agent.run() == 0
    kinds = [c[0] for c in client.calls]
    assert kinds.count("spawn") == 2 and "restart" in kinds
    assert agent.restart_count == 0  # a prescription spends no budget
    assert ("status", NodeStatus.SUCCEEDED, "") in client.calls


def test_a_dead_worker_is_respawned_before_its_relaunch(tmp_path):
    """The JAX order: the failure is reported and the worker respawned;
    the relaunch the report prescribed is acted on at the next poll."""
    client = _FakeClient()
    agent = _agent(client, _DIE_ONCE, tmp_path)
    assert agent.run() == 2
    calls = [c for c in client.calls if c[0] != "register"]
    assert [c[0] for c in calls][:5] == ["spawn", "failure", "restart",
                                         "spawn", "status"]
    assert calls[1] == ("failure", "hardware_error")
    assert calls[4] == ("status", NodeStatus.FAILED, "killed")


# ---- the monitor and the collectors ----------------------------------------


class _Stats:
    def __init__(self):
        self.got = []

    def report_resource_stats(self, **kw):
        self.got.append(kw)
        return True


def test_the_monitor_reads_proc_and_no_card_reads_zero(monkeypatch):
    monkeypatch.setattr(monitor, "_nvml_tried", True)
    monkeypatch.setattr(monitor, "_nvml", None)
    monkeypatch.setattr(monitor, "_smi_used_bytes", lambda: None)
    client = _Stats()
    mon = monitor.ResourceMonitor(client)
    assert mon.report_once()
    sum(range(200000))  # some CPU between the two samples
    assert mon.report_once()
    first, second = client.got
    assert sorted(first) == ["cpu_percent", "hbm_peak_mb", "hbm_used_mb",
                             "used_memory_mb"]
    assert first["cpu_percent"] == 0.0 and 0.0 <= second["cpu_percent"] <= 100
    assert second["used_memory_mb"] > 0
    assert first["hbm_used_mb"] == first["hbm_peak_mb"] == 0.0
    assert monitor.peak_rss_bytes() > 1 << 20


def test_the_monitor_sums_the_cards_and_keeps_the_peak(monkeypatch):
    readings = iter([3 << 30, 5 << 30, 4 << 30])

    class _Fake:
        def used_bytes(self):
            return next(readings)

    monkeypatch.setattr(monitor, "_nvml_tried", True)
    monkeypatch.setattr(monitor, "_nvml", _Fake())
    mon = monitor.ResourceMonitor(_Stats())
    got = [mon.stats() for _ in range(3)]
    assert [g["hbm_used_mb"] for g in got] == [(3 << 30) / 1e6,
                                               (5 << 30) / 1e6,
                                               (4 << 30) / 1e6]
    assert got[-1]["hbm_peak_mb"] == (5 << 30) / 1e6


def test_the_collectors_tail_the_log_and_read_proc_state(tmp_path):
    log = tmp_path / "worker.log"
    log.write_text("\n".join(f"line {i}" for i in range(300)) + "\n")
    data = collectors.LogCollector(str(log)).collect()
    assert data.data_type == "training_log"
    lines = data.content.splitlines()
    assert len(lines) == 200 and lines[-1] == "line 299"
    state = collectors.ProcStateCollector(os.getpid()).collect()
    assert "State:" in state.content and "VmRSS:" in state.content
    assert collectors.LogCollector(str(tmp_path / "none")).collect() is None


def test_a_stack_dump_by_sigusr2_reaches_the_master_as_evidence(
        tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    env = dict(os.environ, DLROVER_TPU_STACK_DUMP="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import dlrover_tpu_torch, time\n"
         "def waiting_for_the_collector():\n"
         "    print('ready', flush=True); time.sleep(60)\n"
         "waiting_for_the_collector()"],
        env=env, stdout=subprocess.PIPE, text=True, cwd=ROOT)
    path = collectors.StackCollector.stack_path(proc.pid)
    assert path.startswith(str(tmp_path))
    try:
        assert proc.stdout.readline().strip() == "ready"
        client = _FakeClient()
        runner = collectors.CollectorRunner(client)
        runner.register(collectors.StackCollector(proc.pid))
        runner.register(collectors.ProcStateCollector(proc.pid))
        data = runner.collect_all()
        assert [d.data_type for d in data] == ["py_stack", "proc_state"]
        assert "waiting_for_the_collector" in data[0].content
        assert proc.poll() is None  # the dump did not stop the worker
        reports = []
        client.report_failure = lambda text, level="": reports.append(
            (level, text))
        assert runner.report() == 2
        assert [lvl for lvl, _ in reports] == ["diagnosis", "diagnosis"]
        assert reports[0][1].startswith("[py_stack] ")
    finally:
        proc.kill()
        proc.wait()
        collectors.StackCollector.remove(proc.pid)
    assert not os.path.exists(path)
