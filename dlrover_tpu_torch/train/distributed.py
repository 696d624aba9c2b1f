"""Worker-side distributed bootstrap.

Port of ``dlrover_tpu/train/distributed.py``. The agent hands the
sealed rendezvous world to each worker through its environment;
``init_distributed()`` turns it into a ``torch.distributed`` process
group: NCCL on CUDA, gloo on the CPU, ``tcp://<coordinator>`` (the
store on the world's first node), ``RANK`` and ``WORLD_SIZE``. On CUDA
it first binds the process to its card (``LOCAL_RANK``) and ends with
one barrier, so the bootstrap has run on the card even at world 1.
A caller may name the backend and the card: several ranks sharing one
card (NCCL refuses two ranks on one GPU) ask for gloo and card 0, and
the sequence-parallel collectives then stage their CUDA tensors through
host memory (``parallel/collectives.py``). Nothing picks gloo by itself.
The JAX function skips a one-process world; here an agent-launched
worker always forms its group (the agent set the coordinator).
"""

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

COORDINATOR_ENV = "DLROVER_TPU_COORDINATOR"


def init_distributed(
    coordinator: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device="cuda",
    timeout_s: float = 600.0,
    backend: Optional[str] = None,
    device_index: Optional[int] = None,
) -> bool:
    """Form the process group from the agent's env. Idempotent.

    ``backend``: "nccl" or "gloo" (default: NCCL on CUDA, gloo on the
    CPU). ``device_index``: the card this rank runs on (default
    ``LOCAL_RANK``); ranks may share one under gloo. Returns True if a
    group was formed (or already was); False without a coordinator (a run
    outside the agent). Raises when ``device`` is CUDA and the process has
    no card, or when the group cannot form: there is no fallback to
    another backend.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get(COORDINATOR_ENV, "")
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if not coordinator:
        logger.info("no coordinator in the environment; not forming a "
                    "process group")
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): this "
                               "worker sees no CUDA device")
        if device_index is None:
            device_index = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(device_index)
        backend = backend or "nccl"
    else:
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo")
        backend = "gloo"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
    logger.info("torch.distributed up: %s, rank %d/%d, coordinator %s",
                backend, rank, world_size, coordinator)
    return True


def shutdown_distributed():
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def global_chip_count() -> int:
    """GPUs in the world: one a process."""
    return process_count()


def process_index(group=None) -> int:
    """This worker's rank in ``group``, the world by default (0 outside
    a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


def process_count(group=None) -> int:
    """The size of ``group``, the world by default (1 outside a process
    group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1
