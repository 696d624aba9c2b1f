"""Batches onto the device ahead of the step, and the lockstep shard feed.

Port of ``prefetch_to_device`` and ``iter_shards_spmd`` from
``dlrover_tpu/train/data_utils.py``.
``jax.device_put`` is asynchronous; here each batch is copied from
page-locked host memory (``pin_memory``) with ``non_blocking`` copies on
a side stream, ``size`` batches ahead of the one the step takes, and the
step's stream waits on the copy's event before it reads the batch.

The JAX module's ``form_global_batch`` assembles one global array from
every host's local rows. The port's replicated data parallelism needs
no assembly: each rank keeps its own rows (rows [rank·B/W,
(rank+1)·B/W) of the global batch), and the step all-reduces the
gradients (``train_step.py``). Under a mesh a rank's rows are those of
its dp and fsdp coordinates (``dp_rows``, for a caller that holds the
global batch) and it keeps its sp block of the sequence
(``sequence_block``): the block the JAX ``batch_sharding``
(``P(("dp", "fsdp"), "sp")``) puts on its device; its tp peers hold the
same block.
"""

import collections
from typing import Dict, Iterable, Iterator, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.parallel.mesh import data_axes


def _host(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def _block(x: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"a batch axis of {x.shape[dim]} does not split "
                         f"into {n} equal blocks")
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)


def dp_rows(batch: Dict, mesh) -> Dict:
    """This rank's rows of a global batch: the leading axis of every array
    cut in ``dp · fsdp`` equal blocks over ``data_axes()`` jointly, in the
    JAX mesh order (``batch_sharding``'s ``P(("dp", "fsdp"))``): block
    ``dp coordinate · fsdp + fsdp coordinate``. The ranks that differ
    only in sp or tp get the same rows."""
    n, i = 1, 0
    for axis in data_axes():
        n *= mesh.shape[axis]
        i = i * mesh.shape[axis] + mesh.coord(axis)
    return {k: _block(_host(v), 0, i, n) for k, v in batch.items()}


def sequence_block(batch: Dict, mesh) -> Dict:
    """This rank's sequence block of its rows: every per-token array
    (``[B, S, ...]``: tokens, targets, mask) cut to block ``sp
    coordinate`` of ``sp`` equal blocks of its second axis; per-row arrays
    (``[B]``: ``prefix_len``, in global positions) kept whole."""
    n, i = mesh.shape["sp"], mesh.coord("sp")
    if n == 1:
        return batch
    return {k: _block(_host(v), 1, i, n) if _host(v).dim() >= 2 else v
            for k, v in batch.items()}


def prefetch_to_device(it: Iterable[Dict], size: int = 2,
                       device="cuda") -> Iterator[Dict]:
    """Yield the batches of ``it`` (dicts of arrays or tensors) on
    ``device``, ``size`` copies in flight ahead of the consumer. ``size``
    0, or a CPU device, is a plain copy per batch."""
    device = torch.device(device)
    if size <= 0 or device.type != "cuda":
        for batch in it:
            yield {k: _host(v).to(device) for k, v in batch.items()}
        return
    side = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(side):
            out = {k: _host(v).pin_memory().to(device, non_blocking=True)
                   for k, v in batch.items()}
        done = torch.cuda.Event()
        done.record(side)
        return out, done

    def take(item):
        out, done = item
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for t in out.values():
            # made on the side stream, read on this one: the allocator
            # must not hand the memory out again before this stream is done
            t.record_stream(stream)
        return out

    queue: collections.deque = collections.deque()
    for batch in it:
        queue.append(put(batch))
        if len(queue) > size:
            yield take(queue.popleft())
    while queue:
        yield take(queue.popleft())


def iter_shards_spmd(sharding_client, poll_interval_s: float = 2.0,
                     group=None) -> Iterator[Tuple[int, int]]:
    """Lockstep shard iteration over the ranks of ``group`` (the world by
    default).

    Every rank must run the same number of (collective-bearing) train
    steps; a per-rank pull from the master's shard queue could leave one
    rank a shard short at the end of the dataset and hang the last
    collectives. Here only the group's first rank talks to the master and
    broadcasts each ``(start, end, done)``, so every rank sees the same
    shard sequence; each shard is one global step, from which a rank cuts
    its own rows. Outside a process group the client is read directly.

    The JAX generator reports a shard done when the next one is asked
    for. A loop that keeps batches in flight ahead of its step asks
    early, and a dataset checkpoint would then count shards as done that
    no step has trained. So here the caller reports: the group's first
    rank calls ``sharding_client.report_shard_done()`` once the step that
    trained the shard has run.
    """
    multi = dist.is_available() and dist.is_initialized() and (
        dist.get_world_size(group) > 1)
    first = not multi or dist.get_rank(group) == 0
    device = torch.device("cpu")
    if multi and dist.get_backend(group) == dist.Backend.NCCL:
        device = torch.device("cuda", torch.cuda.current_device())
    while True:
        if first:
            shard = sharding_client.fetch_shard(poll_interval_s)
            msg = [0, 0, 1] if shard is None else [shard[0], shard[1], 0]
        else:
            msg = [0, 0, 0]
        if multi:
            t = torch.tensor(msg, dtype=torch.int64, device=device)
            dist.broadcast(t, dist.get_global_rank(group, 0)
                           if group is not None else 0, group=group)
            msg = t.tolist()
        if msg[2]:
            return
        yield int(msg[0]), int(msg[1])
