"""Pre-flight node health check: matmul + collective micro-benchmark.

Port of ``dlrover_tpu/agent/node_check.py`` (reference:
NodeCheckElasticAgent, training.py:864, running
trainer/torch/node_check/utils.py:58,88,149 — matmul + 16M-element
allreduce — on each rank, with the master pairing nodes per round to
isolate faulty hosts). Here a chain of bf16 products on one GPU
(``torch.matmul``: the JAX check computes its product outside any Pallas
kernel) and an all-reduce over every local GPU of the process (NCCL's
in-process all-reduce, ``torch.cuda.nccl``) with the JAX check's byte
accounting. The chain multiplies a matrix of ones, whose products are
exact: a result other than ones fails the check.

The check runs on the card: every local GPU, or the ``device`` the
caller names (``"cpu"`` for the plain CPU run the tests make). A node
without a GPU fails it; nothing falls back to the CPU.
"""

import time
from typing import List, Tuple

import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


def local_devices(device=None) -> List[torch.device]:
    """``[device]`` when the caller names one, else every local GPU."""
    if device is not None:
        return [resolve_device(device)]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the node check runs on the node's GPUs and none is available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _sync(devices: List[torch.device]) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def matmul_bench(size: int = 4096, iters: int = 8, device=None) -> float:
    """Time a chain of bf16 matmuls on one device; returns seconds (the
    second of two runs: the first warms the library up, as JAX's
    compiles)."""
    dev = local_devices(device)[0]
    x = torch.ones((size, size), dtype=torch.bfloat16, device=dev)

    def chain(a):
        for _ in range(iters):
            a = (a @ a) * (1.0 / size)
        return a

    chain(x)
    _sync([dev])
    t0 = time.perf_counter()
    out = chain(x)
    _sync([dev])
    secs = time.perf_counter() - t0
    if not bool((out == 1).all()):
        raise RuntimeError("the matmul chain over ones did not give ones")
    return secs


def collective_bench(n_elems: int = 1 << 24, iters: int = 4,
                     device=None) -> float:
    """Time an all-reduce over every local device: each holds an
    ``n_elems // n``-element bf16 buffer, summed and divided by ``n``
    ``iters`` times. 0.0 with one device, as the JAX check."""
    devices = local_devices(device)
    n = len(devices)
    if n == 1:
        return 0.0
    from torch.cuda import nccl

    bufs = [torch.ones(n_elems // n, dtype=torch.bfloat16, device=d)
            for d in devices]

    def allreduce():
        for _ in range(iters):
            nccl.all_reduce(bufs)
            for b in bufs:
                b.div_(n)

    allreduce()
    _sync(devices)
    t0 = time.perf_counter()
    allreduce()
    _sync(devices)
    return time.perf_counter() - t0


def run_comm_perf_test(sizes=(1 << 20, 1 << 24, 1 << 27),
                       device=None) -> dict:
    """Sweep allreduce sizes and report algorithmic bus bandwidth
    (reference: dlrover-run --comm-perf-test). Returns {n_elems: GB/s}
    keyed by the REQUESTED global element count — per-device derived
    sizes can collide (two requested sizes within a factor of
    device-count of each other) and would silently overwrite; logs a
    warning when the largest size runs below half the best observed
    bandwidth (a congested/degraded link). ``{}`` with one device."""
    n = len(local_devices(device))
    if n < 2:
        logger.info("comm perf: skipped — fewer than 2 devices")
        return {}
    iters = 4
    results = {}
    per_device_bytes = {}
    for n_elems in sizes:
        secs = collective_bench(n_elems=n_elems, iters=iters, device=device)
        # each device allreduces an n_elems/n-element bf16 buffer; a
        # ring moves 2(n-1)/n of that buffer per device
        nbytes = (n_elems // n) * 2
        per_device_bytes[n_elems] = nbytes
        algo_bytes = 2 * (n - 1) / n * nbytes * iters
        results[n_elems] = (algo_bytes / secs / 1e9) if secs > 0 else 0.0
    vals = [v for v in results.values() if v > 0]
    if vals and results[max(results)] < 0.5 * max(vals):
        logger.warning(
            "comm perf: largest allreduce at %.2f GB/s, well below the "
            "best observed %.2f GB/s — link may be degraded",
            results[max(results)],
            max(vals),
        )
    for n_elems, gbps in results.items():
        logger.info(
            "comm perf: allreduce %6.1f MB/device → %7.2f GB/s",
            per_device_bytes[n_elems] / 1e6,
            gbps,
        )
    return results


def run_node_check(mock_error: bool = False, device=None, size: int = 4096,
                   iters: int = 8) -> Tuple[bool, float]:
    """Returns (succeeded, elapsed_seconds); (False, 0.0) on any error."""
    try:
        if mock_error:
            raise RuntimeError("mock node-check error")
        t0 = time.perf_counter()
        mm = matmul_bench(size=size, iters=iters, device=device)
        coll = collective_bench(device=device)
        elapsed = time.perf_counter() - t0
        logger.info(
            "node check ok: matmul=%.6fs (%dx%d bf16, %d iterations) "
            "collective=%.6fs total=%.6fs",
            mm, size, size, iters, coll, elapsed,
        )
        return True, elapsed
    except Exception:  # noqa: BLE001
        logger.exception("node check failed")
        return False, 0.0
