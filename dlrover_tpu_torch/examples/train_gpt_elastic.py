"""End-to-end elastic training worker.

Port of ``examples/train_gpt_elastic.py``. Run under the elastic
launcher (a single node starts its own master):

    python -m dlrover_tpu_torch.agent.launcher --nnodes 1 --nproc 1 \
        --max-restarts 1 -- python -m \
        dlrover_tpu_torch.examples.train_gpt_elastic --model llama-1.4b \
        --steps 10 --batch 8 --seq 1024 --ckpt-every 2 --crash-at 5

Exercises: the agent's rendezvous → ``torch.distributed`` (NCCL on the
card, gloo on the CPU) → ``Trainer`` (replicated data parallelism at
world > 1) → Flash Checkpoint under the agent (memory every
``--ckpt-every`` steps, disk every twice that, persisted by the agent)
→ a crash → the agent's persist and respawn → resume from the memory
tier.

``--batch`` is the global batch: each rank makes its ``batch / world``
rows, keyed by the global step and its rank (``synthetic_batch``), so a
resumed run sees the batches of an uninterrupted one. With
``--crash-at N`` the worker exits with code 17 right after step N when
``DLROVER_TPU_RESTART_COUNT`` is 0. It prints ``resumed from step N``
(with the restore's tier) and one loss line a step, with the step's
device ms and its kernel launches by kernel. The data-shard service,
hybrid slices and the live reshard of the JAX example wait for ROADMAP
A11.
"""

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.agent.master_client import build_master_client
from dlrover_tpu_torch.common.constants import GraftEnv
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.config import get_config
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.train import distributed
from dlrover_tpu_torch.train.optimizer import make_optimizer
from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

# the kernel sources a training step loads (flash attention, fused norm)
TRAIN_SOURCES = ("flash_attention", "fused_norm")
# the optimizer's schedule (AdamW, warmup then cosine) and the batches
# kept in flight to the card
LR, WARMUP, DECAY, PREFETCH = 1e-4, 10, 1000, 2


def say(line: str) -> None:
    """One line to stdout in one write: the workers of a node share the
    agent's stdout, and a line written in pieces can interleave."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (line + "\n").encode())


def synthetic_batch(seed: int, step: int, rank: int, rows: int, seq: int,
                    vocab: int, masked: bool = False) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows of global step ``step``'s batch. ``masked``
    adds a mask whose valid length varies by row (so ranks count
    different tokens)."""
    rng = np.random.default_rng([seed, step, rank])
    tok = rng.integers(0, vocab, size=(rows, seq + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if masked:
        valid = rng.integers(1, seq + 1, size=rows)
        batch["mask"] = (np.arange(seq)[None, :] < valid[:, None]).astype(
            np.float32)
    return batch


def launches() -> Dict[str, int]:
    """Every kernel's launch count so far (the training and paged ops)."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import norm as nm
    from dlrover_tpu_torch.ops import paged_attention as pa

    return {**fa.LAUNCHES, **nm.LAUNCHES,
            **{f"paged_{k}": v for k, v in pa.LAUNCHES.items()}}


def load_kernels() -> Dict[str, float]:
    """Build (if needed) and load the step's kernel libraries; the
    seconds of each phase."""
    from dlrover_tpu_torch.ops import _build

    t0 = time.perf_counter()
    compiled = sum(_build.build(name) for name in TRAIN_SOURCES)
    for name in TRAIN_SOURCES:
        _build.load(name)
    return {"seconds": time.perf_counter() - t0, "compiled_s": compiled}


def pack_equals_committed(ckpt_dir: str, step: int, rank: int,
                          threads: int = 8) -> Dict:
    """Compare this rank's staged segment with the committed
    ``step_N/host_<rank>.pack``, byte for byte (the file read in
    ``threads`` parallel slices: a disk serves parallel reads faster),
    and give the pack's payload offset and size (what follows the
    header; None for a file whose header length runs past its end)."""
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.checkpoint import core
    from dlrover_tpu_torch.checkpoint.engine import shm_name
    from dlrover_tpu_torch.common.multi_process import attach_shared_memory

    t0 = time.perf_counter()
    path = os.path.join(ckpt_dir, f"step_{step}", f"host_{rank}.pack")
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(core.HEADER_LEN_BYTES), "little")
        start = (core.payload_start(f.read(n))
                 if core.HEADER_LEN_BYTES + n <= size else None)
    shm = attach_shared_memory(shm_name(rank))
    chunk = 1 << 26
    span = -(-size // threads)
    try:
        staged = np.frombuffer(shm.buf, dtype=np.uint8)

        def same(lo):
            buf = bytearray(chunk)
            hi = min(lo + span, size)
            with open(path, "rb", buffering=0) as f:
                while lo < hi:
                    n = os.preadv(f.fileno(), [memoryview(buf)[:min(
                        chunk, hi - lo)]], lo)
                    if n <= 0 or not np.array_equal(
                            np.frombuffer(buf, dtype=np.uint8, count=n),
                            staged[lo: lo + n]):
                        return False
                    lo += n
            return True

        with ThreadPoolExecutor(threads) as ex:
            equal = size <= shm.size and all(
                ex.map(same, range(0, size, span)))
        del staged
    finally:
        shm.close()
    return {"equal": bool(equal), "nbytes": size, "payload_start": start,
            "payload_bytes": None if start is None else size - start,
            "seconds": time.perf_counter() - t0}


class StepPrinter:
    """Trainer callback: the resume line, one line a step (loss, device
    ms, launches), the optional check of the committed pack and the
    deliberate crash."""

    def __init__(self, args, rank: int, restart: int):
        self.args, self.rank, self.restart = args, rank, restart
        self.last = launches()
        self.resumed_from: Optional[int] = None
        self.resumed_tier = "none"

    def on_train_begin(self, trainer, control):
        rec = [t for t in trainer.checkpointer.engine.timings
               if t["kind"] == "restore"]
        step = trainer.state["step"]
        if rec and rec[-1]["tier"] != "none":
            self.resumed_from, self.resumed_tier = step, rec[-1]["tier"]
            say(f"[worker] resumed from step {step} (tier "
                f"{self.resumed_tier}, {rec[-1]['seconds']:.3f} s)")
        else:
            say(f"[worker] starting at step {step}")
        self.last = launches()

    def on_step_end(self, trainer, step, metrics, control):
        now = launches()
        diff = {k: now[k] - self.last[k] for k in now}
        self.last = now
        say(f"[worker] step={step} loss={metrics['loss']!r} "
            f"rank={self.rank} device_ms={trainer.timer.last_device_ms} "
            f"at={time.time():.6f} "
            f"launches={json.dumps(diff, sort_keys=True)}")
        if (self.args.check_committed and self.resumed_tier == "memory"
                and step == self.resumed_from + 1):
            # the segment still holds the restored pack: the next save
            # comes at the next cadence step
            res = pack_equals_committed(
                os.path.join(self.args.ckpt_dir, "checkpoints"),
                self.resumed_from, self.rank)
            say(f"[worker] committed pack check {json.dumps(res)}")
        if (self.args.crash_at >= 0 and step >= self.args.crash_at
                and self.restart == 0):
            say(f"[worker] simulating crash at step {step}")
            get_tracer().instant("worker.crash", step=step)
            os._exit(17)

    def __getattr__(self, hook):  # the other hooks: nothing to do
        if hook.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(hook)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="train_gpt_elastic")
    p.add_argument("--model", default="llama-1.4b")
    p.add_argument("--override", action="append", default=[],
                   metavar="FIELD=JSON",
                   help="a model config field, e.g. n_layer=2 (repeatable)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=8,
                   help="the global batch: each rank makes batch/world rows")
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--masked", action="store_true",
                   help="rows with a mask of varying valid length")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", required=True,
                   help="the trainer's output dir (checkpoints/ inside); "
                   "one a job, since a run resumes from what it holds")
    p.add_argument("--ckpt-every", type=int, default=2,
                   help="memory save every N steps, disk save every 2N")
    p.add_argument("--crash-at", type=int, default=-1,
                   help="exit with code 17 right after this step on the "
                   "first run (failover demo)")
    p.add_argument("--check-committed", action="store_true",
                   help="after a memory-tier resume, compare the staged "
                   "segment with the committed pack of its step")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    restart = int(os.environ.get(GraftEnv.RESTART_COUNT, "0") or 0)
    tracer = get_tracer()
    tracer.instant("worker.start")
    t0 = time.perf_counter()
    distributed.init_distributed(device=dev)
    tracer.instant("worker.group")
    rank, world = distributed.process_index(), distributed.process_count()
    backend = (torch.distributed.get_backend()
               if torch.distributed.is_initialized() else "none")
    say(f"[worker] process group {backend} world {world} rank {rank} "
        f"device {dev} ({time.perf_counter() - t0:.3f} s)")
    if dev.type == "cuda":
        say(f"[worker] kernels {json.dumps(load_kernels())}")
        tracer.instant("worker.kernels")
    client = (build_master_client()
              if os.environ.get(GraftEnv.MASTER_ADDR) else None)
    overrides = {}
    for item in args.override:
        key, _, value = item.partition("=")
        overrides[key] = json.loads(value)
    cfg = get_config(args.model, max_seq=args.seq, **overrides)
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{world} ranks")
    rows = args.batch // world
    opt = make_optimizer(learning_rate=LR, warmup_steps=WARMUP,
                         decay_steps=DECAY)
    targs = TrainerArgs(
        output_dir=args.ckpt_dir, max_steps=args.steps, log_interval=0,
        save_interval=2 * args.ckpt_every,
        memory_save_interval=args.ckpt_every, seed=args.seed,
        prefetch=PREFETCH if dev.type == "cuda" else 0)
    holder = {}

    def batches():
        # read at the first pull, after the trainer restored its state
        step = holder["trainer"].state["step"]
        while step < args.steps:
            step += 1
            yield synthetic_batch(args.seed, step, rank, rows, args.seq,
                                  cfg.vocab_size, args.masked)

    trainer = Trainer(cfg, targs, batches(), opt, master_client=client,
                      callbacks=[StepPrinter(args, rank, restart)],
                      device=dev)
    holder["trainer"] = trainer
    trainer.train()
    trainer.checkpointer.close()
    say(f"[worker] done at step {trainer.state['step']}")
    distributed.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
