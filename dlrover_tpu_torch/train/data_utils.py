"""Batches onto the device ahead of the step.

Port of ``prefetch_to_device`` from ``dlrover_tpu/train/data_utils.py``.
``jax.device_put`` is asynchronous; here each batch is copied from
page-locked host memory (``pin_memory``) with ``non_blocking`` copies on
a side stream, ``size`` batches ahead of the one the step takes, and the
step's stream waits on the copy's event before it reads the batch. The
multi-host batch formation of the JAX module waits for ROADMAP A8.
"""

import collections
from typing import Dict, Iterable, Iterator

import torch


def _host(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


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
