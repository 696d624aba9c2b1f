"""Agent-side diagnosis data collectors.

Port of ``dlrover_tpu/agent/collectors.py`` (reference:
dlrover/python/elastic_agent/diagnosis/datacollector/*.py): collectors
the agent runs to gather evidence about a worker (its log tail, its
kernel-side state, its Python stacks), and a runner that reports each
to the master at ``level="diagnosis"``, which the master files as
evidence and never treats as a failure.

Stack dumps: a worker the agent launches gets ``DLROVER_TPU_STACK_DUMP=1``
and, on importing ``dlrover_tpu_torch``, registers a ``faulthandler``
SIGUSR2 handler that writes every thread's Python stack to a file of
its pid, so the agent reads a hung worker's stack without ptrace. The
files live under the process's temporary directory
(``tempfile.gettempdir()``, i.e. ``TMPDIR``), and the agent removes a
worker's once it has exited.
"""

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


def stack_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "dlrover_tpu_torch_stacks")


@dataclass
class DiagnosisData:
    data_type: str
    content: str
    timestamp: float = field(default_factory=time.time)


class DataCollector:
    """Base: collect() returns DiagnosisData or None."""

    data_type = "base"

    def collect(self) -> Optional[DiagnosisData]:
        raise NotImplementedError

    def is_enabled(self) -> bool:
        return True


class LogCollector(DataCollector):
    """Tail of a worker's log file (reference: training_log_collector)."""

    data_type = "training_log"

    def __init__(self, log_path: str, max_lines: int = 200):
        self.log_path = log_path
        self.max_lines = max_lines

    def is_enabled(self) -> bool:
        return bool(self.log_path) and os.path.exists(self.log_path)

    def collect(self) -> Optional[DiagnosisData]:
        if not self.is_enabled():
            return None
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - (1 << 20)))
                lines = f.read().decode("utf-8", "replace").splitlines()
        except OSError:
            return None
        return DiagnosisData(
            self.data_type, "\n".join(lines[-self.max_lines :])
        )


class ProcStateCollector(DataCollector):
    """Kernel-side view of a worker process: state, wchan, threads, fds.

    A D-state worker with its wchan in a driver call against an S-state
    worker idle in a collective tells the master which branch to take.
    """

    data_type = "proc_state"

    def __init__(self, pid: int):
        self.pid = pid

    def is_enabled(self) -> bool:
        return os.path.exists(f"/proc/{self.pid}")

    def collect(self) -> Optional[DiagnosisData]:
        if not self.is_enabled():
            return None
        out: Dict[str, str] = {"pid": str(self.pid)}
        try:
            with open(f"/proc/{self.pid}/status") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    if k in ("State", "Threads", "VmRSS", "VmSwap"):
                        out[k] = v.strip()
            try:
                with open(f"/proc/{self.pid}/wchan") as f:
                    out["wchan"] = f.read().strip()
            except OSError:
                pass
            try:
                # fd dir is owner/root-only; its failure must not discard
                # the State/Threads/VmRSS already gathered above
                out["fds"] = str(len(os.listdir(f"/proc/{self.pid}/fd")))
            except OSError:
                pass
        except OSError:
            return None
        content = "\n".join(f"{k}: {v}" for k, v in out.items())
        return DiagnosisData(self.data_type, content)


class StackCollector(DataCollector):
    """Python thread stacks of a (hung) worker via the faulthandler
    protocol: SIGUSR2 → the worker dumps to ``stack_dir()/<pid>.stack``
    (reference analog: cuda_log_collector; a hang is almost always
    visible at the Python call site)."""

    data_type = "py_stack"

    def __init__(self, pid: int, timeout: float = 5.0):
        self.pid = pid
        self.timeout = timeout

    @staticmethod
    def stack_path(pid: int) -> str:
        return os.path.join(stack_dir(), f"{pid}.stack")

    @staticmethod
    def install_in_worker():
        """Call inside a worker process (the package's ``__init__`` does,
        under ``DLROVER_TPU_STACK_DUMP=1``): dump thread stacks to the
        per-pid file on SIGUSR2."""
        import faulthandler

        os.makedirs(stack_dir(), exist_ok=True)
        path = StackCollector.stack_path(os.getpid())
        f = open(path, "w")  # noqa: SIM115 — handle must outlive the call
        faulthandler.register(signal.SIGUSR2, file=f, all_threads=True)

    @staticmethod
    def remove(pid: int) -> None:
        """Drop an exited worker's stack file."""
        try:
            os.unlink(StackCollector.stack_path(pid))
        except OSError:
            pass

    def is_enabled(self) -> bool:
        return os.path.exists(f"/proc/{self.pid}")

    def collect(self) -> Optional[DiagnosisData]:
        path = self.stack_path(self.pid)
        try:
            before = os.path.getsize(path) if os.path.exists(path) else 0
            os.kill(self.pid, signal.SIGUSR2)
        except (ProcessLookupError, PermissionError):
            return None
        deadline = time.time() + self.timeout
        while time.time() < deadline:
            if os.path.exists(path) and os.path.getsize(path) > before:
                time.sleep(0.1)  # let the dump finish
                with open(path) as f:
                    f.seek(before)
                    return DiagnosisData(self.data_type, f.read())
            time.sleep(0.05)
        return None


class CollectorRunner:
    """Runs all enabled collectors, reports via the master client."""

    def __init__(self, master_client=None):
        self.collectors: List[DataCollector] = []
        self._client = master_client

    def register(self, collector: DataCollector):
        self.collectors.append(collector)

    def collect_all(self) -> List[DiagnosisData]:
        out = []
        for c in self.collectors:
            try:
                if not c.is_enabled():
                    continue
                data = c.collect()
                if data is not None:
                    out.append(data)
            except Exception:  # noqa: BLE001
                logger.warning(
                    "collector %s failed", c.data_type, exc_info=True
                )
        return out

    def report(self) -> int:
        data = self.collect_all()
        if self._client is None:
            return len(data)
        for d in data:
            try:
                self._client.report_failure(
                    f"[{d.data_type}] {d.content[:4000]}", level="diagnosis"
                )
            except Exception:  # noqa: BLE001
                logger.warning("diagnosis report failed", exc_info=True)
        return len(data)
