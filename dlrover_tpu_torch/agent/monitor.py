"""Agent-side resource monitor (reference: elastic_agent/monitor/resource.py:86).

Port of ``dlrover_tpu/agent/monitor.py``: the host's CPU and memory use
and the node's device memory, reported to the master on an interval
(``MasterClient.report_resource_stats``), where the diagnosis manager's
hang detector reads them.

The JAX monitor reads the host through ``psutil`` and the chips through
``jax``; this one reads ``/proc`` (``/proc/stat``, ``/proc/meminfo``:
the card's machine has no ``psutil``) and the
cards through NVML (``ctypes`` on ``libnvidia-ml.so.1``, else
``nvidia-smi``): the agent must not open a CUDA context, which would
take card memory on every node. The wire's ``hbm_used_mb`` and
``hbm_peak_mb`` keep their JAX names and carry the cards' used memory,
summed over the node's cards, and its highest reading so far. Without a
card both read 0, as the JAX monitor reads without a device.
"""

import ctypes
import subprocess
import threading
from typing import Dict, Optional, Tuple

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


def _cpu_times() -> Tuple[int, int]:
    """(busy, total) jiffies of all CPUs since boot (``/proc/stat``)."""
    with open("/proc/stat") as f:
        fields = [int(x) for x in f.readline().split()[1:]]
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0)  # idle+iowait
    # guest times are already counted in user and nice
    total = sum(fields[:8])
    return total - idle, total


def meminfo() -> Dict[str, int]:
    """``/proc/meminfo`` in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            parts = rest.split()
            if parts:
                out[key] = int(parts[0]) * (1024 if len(parts) > 1 else 1)
    return out


def used_memory_bytes() -> int:
    """The host's memory in use: MemTotal - MemAvailable."""
    m = meminfo()
    return m["MemTotal"] - m.get("MemAvailable", m.get("MemFree", 0))


def peak_rss_bytes() -> int:
    """This process's peak resident set (``getrusage``'s ``ru_maxrss``,
    which a sandbox's ``/proc`` may not carry as ``VmHWM``)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class _Nvml:
    """The used memory of every card through NVML, loaded once (None
    when the library is absent)."""

    class _Memory(ctypes.Structure):
        _fields_ = [("total", ctypes.c_ulonglong),
                    ("free", ctypes.c_ulonglong),
                    ("used", ctypes.c_ulonglong)]

    def __init__(self):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        ptr = ctypes.POINTER
        for name, args in (
                ("nvmlInit_v2", []),
                ("nvmlDeviceGetCount_v2", [ptr(ctypes.c_uint)]),
                ("nvmlDeviceGetHandleByIndex_v2",
                 [ctypes.c_uint, ptr(ctypes.c_void_p)]),
                ("nvmlDeviceGetMemoryInfo",
                 [ctypes.c_void_p, ptr(self._Memory)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        self.lib = lib
        if lib.nvmlInit_v2() != 0:
            raise OSError("nvmlInit_v2 failed")

    def used_bytes(self) -> int:
        count = ctypes.c_uint(0)
        if self.lib.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            raise OSError("nvmlDeviceGetCount_v2 failed")
        used = 0
        for i in range(count.value):
            handle = ctypes.c_void_p()
            mem = self._Memory()
            if (self.lib.nvmlDeviceGetHandleByIndex_v2(
                    i, ctypes.byref(handle)) != 0
                    or self.lib.nvmlDeviceGetMemoryInfo(
                        handle, ctypes.byref(mem)) != 0):
                raise OSError(f"NVML memory query of card {i} failed")
            used += mem.used
        return used


_nvml: Optional[_Nvml] = None
_nvml_tried = False


def _smi_used_bytes() -> Optional[int]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    try:
        return sum(int(x) for x in out.stdout.split()) * (1 << 20)  # MiB
    except ValueError:
        return None


def card_used_bytes() -> int:
    """The node's cards' used memory, summed (NVML, else ``nvidia-smi``;
    0 without a card)."""
    global _nvml, _nvml_tried
    if not _nvml_tried:
        _nvml_tried = True
        try:
            _nvml = _Nvml()
        except OSError:
            _nvml = None
    if _nvml is not None:
        try:
            return _nvml.used_bytes()
        except OSError:
            logger.warning("NVML memory query failed", exc_info=True)
    return _smi_used_bytes() or 0


class ResourceMonitor:
    def __init__(self, client, interval_s: float = 30.0):
        self._client = client
        self._interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_cpu: Optional[Tuple[int, int]] = None
        self.card_peak_bytes = 0

    def start(self):
        self._thread = threading.Thread(target=self._loop,
                                        name="resource-monitor", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self._interval_s):
            self.report_once()

    def cpu_percent(self) -> float:
        """The host's busy share since the previous call, in percent (0.0
        on the first, as ``psutil.cpu_percent(interval=None)``)."""
        now = _cpu_times()
        last, self._last_cpu = self._last_cpu, now
        if last is None or now[1] <= last[1]:
            return 0.0
        return 100.0 * (now[0] - last[0]) / (now[1] - last[1])

    def stats(self) -> Dict[str, float]:
        card = card_used_bytes()
        self.card_peak_bytes = max(self.card_peak_bytes, card)
        return {"cpu_percent": self.cpu_percent(),
                "used_memory_mb": used_memory_bytes() / 1e6,
                "hbm_used_mb": card / 1e6,
                "hbm_peak_mb": self.card_peak_bytes / 1e6}

    def report_once(self) -> bool:
        try:
            return self._client.report_resource_stats(**self.stats())
        except Exception:  # noqa: BLE001
            logger.warning("resource report failed", exc_info=True)
            return False
