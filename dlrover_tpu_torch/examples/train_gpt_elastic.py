"""End-to-end elastic training worker.

Port of ``examples/train_gpt_elastic.py``. Run under the elastic
launcher (a single node starts its own master):

    python -m dlrover_tpu_torch.agent.launcher --nnodes 1 --nproc 1 \
        --max-restarts 1 -- python -m \
        dlrover_tpu_torch.examples.train_gpt_elastic --model llama-1.4b \
        --steps 10 --batch 8 --seq 1024 --ckpt-every 2 --crash-at 5

Exercises: the agent's rendezvous → ``torch.distributed`` (NCCL on the
card, gloo on the CPU, or gloo with every rank on card 0 under
``--one-card``) → dynamic data sharding from the master's TaskManager
(``iter_shards_spmd``: rank 0 fetches, every rank gets the same shard
sequence) → ``Trainer`` (replicated data parallelism at world > 1) →
Flash Checkpoint under the agent (memory every ``--ckpt-every`` steps,
disk every twice that, persisted by the agent; each save carries the
master's dataset position, rank 0's) → a crash → the agent's persist
and respawn → resume from the memory tier, the dataset position
restored before the first fetch.

``--zero1`` runs the ZeRO update-sharded step (``CommConfig(
update_sharding=True)``, the zero2 mode, as the JAX example asks)
through ``ElasticTrainer``, and ``--evict-at N`` then evicts
``--evict-dp-ranks`` (default: the top half) before step N+1: the
master issues a reshard directive, the ranks live-migrate the flat
optimizer state onto the survivors (``elastic/resharding.py``: detect,
replan, migrate, rebuild, first_step), the departing ranks exit 0 after
donating, and the survivors go on over a new dp group with the
accumulation re-derived so the global batch stays. It prints
``[reshard] done {json}`` (the JAX example's line).

``--batch`` is the global batch, one shard of the master's dataset a
step: each rank makes its ``batch / dp`` rows, keyed by the step the
shard is and its dp rank (``synthetic_batch``), so a resumed run sees
the batches of an uninterrupted one. With ``--crash-at N`` the worker
exits with code 17 right after step N when ``DLROVER_TPU_RESTART_COUNT``
is 0. It prints ``resumed from step N`` (with the restore's tier), one
loss line a step, with the step's device ms and its kernel launches by
kernel, and (rank 0) the shard each step trained.

``--data sampler`` feeds the steps from ``ElasticDataLoader(sampler=
ElasticDistributedSampler(...))`` in place of the master's shards: one
epoch of ``steps × batch`` samples, each sample's tokens keyed by its
index (``sample_batch``), each rank its rows of every global batch; the
sampler's position rides in each checkpoint's header (``"sampler"``)
and a resumed run puts it back before its first batch. ``--replicate``
backs each staged pack up to the ring peer (``Checkpointer(replicate=
True)``; the agent holds the peers' packs). ``--lose-node-at S``: on
its first run (restart 0, nothing restored) the last rank, once step
S+1 has run, waits until every ring holder of its pack holds step S
(``replica.wait_peer_steps``), writes a CUDA hardware error to stderr
and exits 1, as a node whose card failed; S must be a saved step.
``--hash-restored`` prints the digest of a pack the replica tier
restored (``pack_digest``). Each run prints ``[worker] restore {json}``
(the restore's tier, holder, fetch bytes and seconds) and, at its end,
its process's peak resident set.

``--micro-batch M`` runs ``ElasticTrainer`` over the replicated step
(no update sharding unless ``--zero1``) at micro-batch M: the
accumulation keeps ``--batch`` global at every world size, and each
rank's rows of a step are its slice of the global batch's samples
(``sample_batch``, keyed by the sample index), so a step's batch is the
same at any world size. At every step boundary the ranks read the
agent's ``ParalConfigTuner`` document (``config_tuner.read_tuning``) and,
once every rank holds a newer tuning version, fold it into their step
arguments (``cluster.brain.apply_revision``: a remat policy the port
cannot run raises, ROADMAP A21) and hand it to
``ElasticTrainer.apply_tuning`` (one ``brain.tuning_replan`` span, the
step rebuilt, the optimizer state untouched); each prints ``[worker]
tuning v… applied``. ``--grow-at N`` (a drill): a run at world 1 holds
after step N (a memory-staged step, which its agent persists when the
membership changes) until its agent restarts it into a larger world.
Each step also prints ``[worker] elastic step=…`` with the world,
micro-batch, accumulation and tuning version.

``--hosts-per-slice N`` builds the JAX example's hybrid multi-slice
mesh: every N processes form one slice, ``num_slices = world // N``,
``MeshConfig(dp=num_slices, fsdp=-1, num_slices=num_slices)``: fsdp
inside a slice, dp across the slices (the mesh is built from the
current world at every start). With ``--zero1`` the update shards over
dp (the hybrid ZeRO step on the f32 wire). The worker prints ``[worker]
slice mesh: num_slices=… dp=… fsdp=…``.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.agent.config_tuner import read_tuning
from dlrover_tpu_torch.agent.master_client import build_master_client
from dlrover_tpu_torch.agent.sharding_client import ShardingClient
from dlrover_tpu_torch.checkpoint import core
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.cluster.brain import StepArgs, TuningPlan, apply_revision
from dlrover_tpu_torch.common.constants import GraftEnv
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.agent.monitor import peak_rss_bytes
from dlrover_tpu_torch.elastic.dataloader import ElasticDataLoader
from dlrover_tpu_torch.elastic.faults import get_injector
from dlrover_tpu_torch.elastic.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.elastic.resharding import (
    LiveResharder,
    PhaseBudgets,
    reshard_flat,
    reshard_train_state,
)
from dlrover_tpu_torch.elastic.trainer import ElasticTrainer
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models.config import get_config
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.profiler import StepTimer
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.parallel import sharding as shd
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.train import distributed
from dlrover_tpu_torch.train.data_utils import iter_shards_spmd
from dlrover_tpu_torch.train.optimizer import make_optimizer
from dlrover_tpu_torch.train.train_step import (
    TrainStepBuilder,
    init_train_state,
)
from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

# the kernel sources a training step loads (flash attention, fused norm)
TRAIN_SOURCES = ("flash_attention", "fused_norm")
# the optimizer's schedule (AdamW, warmup then cosine) and the batches
# kept in flight to the card
LR, WARMUP, DECAY, PREFETCH = 1e-4, 10, 1000, 2
# what a node whose card failed writes before it exits (--lose-node-at)
LOST_NODE_ERROR = ("RuntimeError: CUDA error: uncorrectable ECC error "
                   "encountered")
# how long a --grow-at run holds for its agent's restart
GROW_WAIT_S = 600.0


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


def sample_batch(seed: int, indices, seq: int,
                 vocab: int) -> Dict[str, np.ndarray]:
    """The rows of samples ``indices``: each sample's tokens drawn from a
    generator keyed by its index alone."""
    tok = np.stack([np.random.default_rng([seed, int(i)]).integers(
        0, vocab, size=seq + 1) for i in indices]).astype(np.int32)
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


DIGEST_CHUNK = 1 << 26


def chunk_digests(buf, threads: int = 8) -> List[bytes]:
    """The sha1 of each 64 MiB chunk of ``buf``, hashed on ``threads``
    threads."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    view = memoryview(buf).cast("B")
    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(
            lambda lo: hashlib.sha1(view[lo: lo + DIGEST_CHUNK]).digest(),
            range(0, len(view), DIGEST_CHUNK)))


def pack_digest(buf=None, parts: Optional[List[bytes]] = None,
                flip: Optional[int] = None) -> str:
    """A digest of a pack's bytes: the sha1 of its chunks' sha1s
    (``parts``, if already taken). ``flip``: the digest of a copy with
    that byte's low bit flipped (only its chunk hashed again)."""
    import hashlib

    parts = list(parts if parts is not None else chunk_digests(buf))
    if flip is not None:
        lo = flip // DIGEST_CHUNK * DIGEST_CHUNK
        part = bytearray(memoryview(buf).cast("B")[lo: lo + DIGEST_CHUNK])
        part[flip - lo] ^= 1
        parts[flip // DIGEST_CHUNK] = hashlib.sha1(part).digest()
    return hashlib.sha1(b"".join(parts)).hexdigest()


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


def shard_batches(sharding, args, rank: int, rows: int, vocab: int):
    """This rank's rows of each shard's step, in the master's order. It
    stops after the run's last step: the Trainer keeps batches in flight
    ahead of its step, and a fetch past the last shard would wait on the
    shards this loop fetched and has not trained yet (the master holds
    them in flight until the steps report them)."""
    for start, _ in iter_shards_spmd(sharding):
        step = start // args.batch + 1
        yield synthetic_batch(args.seed, step, rank, rows, args.seq, vocab,
                              args.masked)
        if step >= args.steps:
            return


def resume_dataset(engine, sharding, first: bool) -> None:
    """After a restore: put the master's dataset back to the position the
    restored pack recorded (the group's first rank; before any fetch)."""
    content = engine.restored_extra.get("dataset", "")
    if first and content:
        sharding.restore(content)
        say(f"[worker] dataset position restored {content}")


def resume_line(engine, step: int) -> Tuple[Optional[int], str]:
    """Print the restore record and the start or resume line; (resumed
    step or None, tier)."""
    rec = [t for t in engine.timings if t["kind"] == "restore"]
    if rec:
        say(f"[worker] restore {json.dumps(rec[-1])}")
    if rec and rec[-1]["tier"] != "none":
        say(f"[worker] resumed from step {step} (tier {rec[-1]['tier']}, "
            f"{rec[-1]['seconds']:.3f} s)")
        return step, rec[-1]["tier"]
    say(f"[worker] starting at step {step}")
    return None, "none"


def shard_done(sharding, first: bool, step: int) -> None:
    """The step has run: the group's first rank reports its shard (the
    oldest fetched) done and logs it."""
    if first:
        shard = sharding.report_shard_done()
        if shard is not None:
            say(f"[worker] shard step={step} [{shard[0]}, {shard[1]})")


def lose_node(trainer, args, rank: int, step: int) -> None:
    """The node-loss drill's failure: once every ring holder of this
    rank's pack holds step ``args.lose_node_at``, write a CUDA hardware
    error to stderr and exit 1."""
    from dlrover_tpu_torch.checkpoint.replica import wait_peer_steps

    mgr = trainer.checkpointer.engine.replica
    holders = mgr.holders(rank) if mgr is not None else []
    held = {h: wait_peer_steps(mgr, {rank: args.lose_node_at},
                               timeout=120.0, holder=h) for h in holders}
    say(f"[worker] losing the node after step {step}: holders of step "
        f"{args.lose_node_at} {json.dumps(held)} peak_rss_bytes="
        f"{peak_rss_bytes()}")
    get_tracer().instant("worker.crash", step=step)
    sys.stderr.write(LOST_NODE_ERROR + "\n")
    sys.stderr.flush()
    os._exit(1)


class StepPrinter:
    """Trainer callback: the resume line (and the dataset or sampler
    position put back), one line a step (loss, device ms, launches), the
    step's shard reported done, the optional check of the committed pack
    and the deliberate crash or node loss."""

    def __init__(self, args, rank: int, restart: int, sharding,
                 sampler=None, lose_rank: int = -1):
        self.args, self.rank, self.restart = args, rank, restart
        self.sharding = sharding
        self.sampler = sampler
        self.lose_rank = lose_rank
        self.last = launches()
        self.resumed_from: Optional[int] = None
        self.resumed_tier = "none"

    def on_train_begin(self, trainer, control):
        engine = trainer.checkpointer.engine
        self.resumed_from, self.resumed_tier = resume_line(
            engine, trainer.state["step"])
        if self.resumed_from is not None and self.sampler is not None:
            # before the loader's first batch (the prefetch starts there)
            self.sampler.load_state_dict(engine.restored_extra["sampler"])
            say("[worker] sampler position restored "
                f"{json.dumps(self.sampler.state_dict())}")
        elif self.resumed_from is not None:
            resume_dataset(engine, self.sharding, self.rank == 0)
        self.last = launches()

    def on_step_end(self, trainer, step, metrics, control):
        now = launches()
        diff = {k: now[k] - self.last[k] for k in now}
        self.last = now
        if self.sampler is None:
            shard_done(self.sharding, self.rank == 0, step)
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
        if (self.args.lose_node_at >= 0 and self.restart == 0
                and self.resumed_from is None and self.rank == self.lose_rank
                and step == self.args.lose_node_at + 1):
            lose_node(trainer, self.args, self.rank, step)
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
                   help="the global batch: each rank makes batch/dp rows")
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--masked", action="store_true",
                   help="rows with a mask of varying valid length")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", required=True,
                   help="the trainer's output dir (checkpoints/ inside); "
                   "one a job, since a run resumes from what it holds")
    p.add_argument("--ckpt-every", type=int, default=2,
                   help="memory save every N steps, disk save every 2N "
                   "(0: no saves)")
    p.add_argument("--crash-at", type=int, default=-1,
                   help="exit with code 17 right after this step on the "
                   "first run (failover demo)")
    p.add_argument("--check-committed", action="store_true",
                   help="after a memory-tier resume, compare the staged "
                   "segment with the committed pack of its step")
    p.add_argument("--data", choices=("shards", "sampler"),
                   default="shards",
                   help="the batches: the master's data shards, or an "
                   "ElasticDataLoader over an ElasticDistributedSampler")
    p.add_argument("--replicate", action="store_true",
                   help="back each staged pack up to the ring peer "
                   "(Checkpointer(replicate=True))")
    p.add_argument("--lose-node-at", type=int, default=-1,
                   help="node-loss drill: after step N+1 of the first run, "
                   "once the ring holders hold the saved step N, the last "
                   "rank writes a CUDA hardware error and exits 1")
    p.add_argument("--hash-restored", action="store_true",
                   help="print the digest of a pack the replica tier "
                   "restored")
    p.add_argument("--hosts-per-slice", type=int, default=0,
                   help="build a hybrid multi-slice mesh: every "
                   "hosts-per-slice processes form one slice, dp rides "
                   "across slices (num_slices = process_count // "
                   "hosts_per_slice)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO update sharding (the flat bucketed optimizer "
                   "state) through ElasticTrainer; required for --evict-at")
    p.add_argument("--bucket-mb", type=float, default=0.05,
                   help="the --zero1 comm bucket size (the JAX example's "
                   "0.05 by default)")
    p.add_argument("--evict-at", type=int, default=-1,
                   help="after this step, evict --evict-dp-ranks and "
                   "live-reshard onto the survivors (no restart, no disk "
                   "restore)")
    p.add_argument("--evict-dp-ranks", default="",
                   help="comma-separated dp ranks lost at --evict-at "
                   "(default: the top half)")
    p.add_argument("--check-migration", action="store_true",
                   help="gather the flat state before the eviction and "
                   "hold each survivor's migrated columns against its "
                   "reshard_flat repack, bit for bit")
    p.add_argument("--micro-batch", type=int, default=0,
                   help="run ElasticTrainer over the replicated step at this "
                   "micro-batch (the accumulation keeps --batch global), "
                   "applying the agent's tuning revisions at step "
                   "boundaries")
    p.add_argument("--grow-at", type=int, default=-1,
                   help="drill: a run at world 1 holds after this step until "
                   "its agent restarts it into a larger world")
    p.add_argument("--one-card", action="store_true",
                   help="every rank on card 0 over gloo (NCCL refuses two "
                   "ranks on one card)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.evict_at >= 0 and not args.zero1:
        p.error("--evict-at needs --zero1 (the live reshard moves ZeRO "
                "state)")
    if args.evict_at >= 0 and args.hosts_per_slice > 0:
        p.error("--evict-at with --hosts-per-slice: the live reshard "
                "refuses a hybrid plan (mesh_axes beyond dp)")
    if (args.data == "sampler" or args.replicate
            or args.lose_node_at >= 0) and (args.zero1 or args.micro_batch):
        p.error("--data sampler, --replicate and --lose-node-at run the "
                "Trainer loop, not --zero1's or --micro-batch's")
    if args.grow_at >= 0 and not args.micro_batch:
        p.error("--grow-at runs the --micro-batch loop")
    if args.grow_at >= 0 and not (args.ckpt_every
                                  and args.grow_at % args.ckpt_every == 0):
        p.error("--grow-at needs a staged step (a multiple of --ckpt-every)")
    if args.lose_node_at >= 0 and not (
            args.replicate and args.ckpt_every
            and args.lose_node_at % args.ckpt_every == 0):
        p.error("--lose-node-at needs --replicate and a saved step (a "
                "multiple of --ckpt-every)")
    return args


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _gather_flat(state, cfg, plan, group) -> Dict[str, torch.Tensor]:
    """The whole flat state before the eviction, on every rank: the
    moments' columns all-gathered, the parameters packed."""
    opt = state["opt_state"]
    params = dict(state["params"].named_parameters())
    return {"m": shd.all_gather_columns(opt["m"]["flat"], plan, group),
            "v": shd.all_gather_columns(opt["v"]["flat"], plan, group),
            "params": shd.pack_flat(cfg, params, plan)}


def _migration_check(before, state, cfg, old_plan, new_plan, rank):
    """Each migrated column block against the reshard_flat repack of the
    gathered state, bit for bit."""
    cols = new_plan.columns(rank)
    opt = state["opt_state"]
    now = {"m": opt["m"]["flat"], "v": opt["v"]["flat"],
           "params": shd.pack_flat(cfg, dict(state["params"]
                                             .named_parameters()),
                                   new_plan)[:, cols]}
    return {k: bool(torch.equal(_bits(now[k]), _bits(reshard_flat(
        before[k], old_plan, new_plan)[:, cols]))) for k in now}


class ZeroRun:
    """The ElasticTrainer loop (--zero1: over the update-sharded step;
    --micro-batch: at that micro-batch, replicated unless --zero1): the
    shard feed, the saves, the Brain's tuning revisions and the live
    reshard."""

    def __init__(self, args, cfg, opt, dev, client, sharding, rank, world,
                 restart, mesh=None):
        self.args, self.cfg, self.opt, self.dev = args, cfg, opt, dev
        self.mesh = mesh
        self.client, self.sharding = client, sharding
        self.rank, self.restart = rank, restart
        # the step-building arguments a tuning revision moves
        self.step_args = StepArgs(remat=cfg.remat,
                                  comm_bucket_mb=args.bucket_mb,
                                  update_sharding=bool(args.zero1))
        self.comm = self.step_args.comm_config()
        self.tuning_version = 0
        self.group, self.ranks = None, list(range(world))
        self.builder: Optional[TrainStepBuilder] = None
        self.trainer = ElasticTrainer(
            args.batch, args.micro_batch or max(1, args.batch // world),
            self._build_step, data_replicas_fn=lambda: len(self.ranks))
        self.state = init_train_state(args.seed, cfg, opt, device=dev,
                                      comm=self.comm, mesh=mesh)
        self.ckpt = Checkpointer(os.path.join(args.ckpt_dir, "checkpoints"),
                                 master_client=client)
        self.timer = StepTimer(dev)
        self.last = launches()
        self.grad_norm: Optional[float] = None  # the last step's

    def _build_step(self, accum: int):
        cfg = (self.cfg if self.step_args.remat == self.cfg.remat
               else dataclasses.replace(self.cfg, remat=self.step_args.remat))
        b = TrainStepBuilder(cfg, self.opt, grad_accum=accum,
                             device=self.dev, comm=self.comm,
                             group=self.group, mesh=self.mesh)
        if self.args.zero1 and not b.update_sharding:
            raise RuntimeError("--zero1: update sharding did not resolve: "
                               f"{b.update_sharding_reason}")
        self.builder = b
        return b.build()

    @property
    def first(self) -> bool:
        return distributed.process_index(self.group) == 0

    def leaves(self):
        return convert.train_state_leaves(self.state, self.cfg, self.opt,
                                          self.builder.shard)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        dp = len(self.ranks)
        if self.args.micro_batch:
            # this rank's slice of the step's global samples: the same
            # global batch at every world size
            rows = self.args.batch // dp
            lo = (step - 1) * self.args.batch + self.ranks.index(
                self.rank) * rows
            return sample_batch(self.args.seed, range(lo, lo + rows),
                                self.args.seq, self.cfg.vocab_size)
        return synthetic_batch(self.args.seed, step,
                               self.ranks.index(self.rank),
                               self.args.batch // dp, self.args.seq,
                               self.cfg.vocab_size, self.args.masked)

    def poll_tuning(self, step: int) -> None:
        """At a step boundary: the agent's tuning directive, applied once
        every rank of the group holds the same newer version (one small
        all-reduce a step at world > 1), so all ranks rebuild before the
        same step."""
        version, plan = read_tuning()
        if len(self.ranks) > 1:
            dev = (torch.device("cpu")
                   if dist.get_backend(self.group) == "gloo" else self.dev)
            seen = torch.tensor([version, -version], dtype=torch.int64,
                                device=dev)
            dist.all_reduce(seen, op=dist.ReduceOp.MAX, group=self.group)
            if int(seen[0]) != -int(seen[1]):
                return  # a rank's agent has not written it yet
        if version <= self.tuning_version:
            return
        tp = TuningPlan(**{k: v for k, v in plan.items()
                           if k in TuningPlan.__dataclass_fields__})
        step_args = apply_revision(self.step_args, tp)
        comm = step_args.comm_config()
        if self.args.zero1 and comm != self.comm:
            raise NotImplementedError(
                f"tuning v{version} changes the ZeRO exchange ({comm}): "
                "the flat state's layout would need a reshard")
        self.step_args, self.comm = step_args, comm
        self.trainer.apply_tuning(plan)
        self.tuning_version = version
        say(f"[worker] tuning v{version} applied before step {step}: "
            f"rank={self.rank} micro={self.trainer.micro_batch_size} "
            f"accum={self.trainer.grad_accum} remat={self.step_args.remat} "
            f"at={time.time():.6f}")

    def run_step(self, step: int):
        if self.args.micro_batch:
            self.poll_tuning(step)
        self.timer.start()
        self.state, metrics = self.trainer.step(self.state, self.batch(step))
        timing = self.timer.stop()
        loss = float(metrics["loss"])
        self.grad_norm = float(metrics["grad_norm"])
        self.timer.record(timing)
        return loss

    def after_step(self, step: int, loss: float) -> None:
        args = self.args
        now = launches()
        diff = {k: now[k] - self.last[k] for k in now}
        self.last = now
        shard_done(self.sharding, self.first, step)
        say(f"[worker] step={step} loss={loss!r} rank={self.rank} "
            f"grad_norm={self.grad_norm!r} "
            f"device_ms={self.timer.last_device_ms} at={time.time():.6f} "
            f"launches={json.dumps(diff, sort_keys=True)}")
        if args.micro_batch:
            say(f"[worker] elastic step={step} rank={self.rank} "
                f"world={len(self.ranks)} "
                f"micro={self.trainer.micro_batch_size} "
                f"accum={self.trainer.grad_accum} "
                f"tuning={self.tuning_version}")
        self.client.report_global_step(step, len(self.ranks))
        if args.ckpt_every and step % args.ckpt_every == 0:
            kind = (StorageType.DISK if step % (2 * args.ckpt_every) == 0
                    else StorageType.MEMORY)
            self.save(step, kind)
        if args.grow_at == step and len(self.ranks) == 1:
            self.hold_for_growth(step)
        if args.crash_at >= 0 and step >= args.crash_at and self.restart == 0:
            say(f"[worker] simulating crash at step {step}")
            get_tracer().instant("worker.crash", step=step)
            os._exit(17)

    def hold_for_growth(self, step: int) -> None:
        """The --grow-at drill: hold after ``step`` (staged) until the
        agent restarts this worker into a larger world."""
        say(f"[worker] holding after step {step} until the world grows "
            f"at={time.time():.6f}")
        time.sleep(GROW_WAIT_S)
        raise RuntimeError(f"the world did not grow within {GROW_WAIT_S} s")

    def save(self, step: int, kind: str) -> bool:
        extra = ({"dataset": self.sharding.checkpoint()} if self.first
                 else None)
        return self.ckpt.save_checkpoint(step, self.leaves(), kind, extra)

    def train(self) -> Optional[int]:
        """The loop; the last step, None on a rank evicted midway."""
        args = self.args
        leaves = self.leaves()
        if self.ckpt.load_checkpoint(
                leaves, bridge=convert.moment_bridge(self.cfg, self.opt)
        ) is not None:
            convert.load_scalars(self.state, leaves, self.opt)
        resumed, _ = resume_line(self.ckpt.engine, self.state["step"])
        if resumed is not None:
            resume_dataset(self.ckpt.engine, self.sharding, self.first)
        shards = iter_shards_spmd(self.sharding, group=self.group)
        evicted = False
        while True:
            shard = next(shards, None)
            if shard is None:
                break
            step = shard[0] // args.batch + 1
            if (args.evict_at >= 0 and not evicted
                    and self.state["step"] >= args.evict_at):
                evicted = True
                path, loss = self.live_reshard(step)
                if path == "left":
                    say(f"[worker] evicted after step {step - 1}: donated, "
                        "exiting")
                    return None
                shards = iter_shards_spmd(self.sharding, group=self.group)
                if path == "fallback":
                    continue  # fetch again from the restored position
            else:
                loss = self.run_step(step)
            self.after_step(step, loss)
        if args.ckpt_every:
            if not self.save(self.state["step"], StorageType.DISK):
                raise RuntimeError("the final checkpoint was not saved")
            if not self.ckpt.wait_for_persist():
                raise RuntimeError("the final checkpoint did not commit")
        self.ckpt.close()
        return self.state["step"]

    def live_reshard(self, step: int) -> Tuple[str, Optional[float]]:
        """Graceful host eviction before ``step``: survivors keep their
        in-device state, the master issues a reshard directive, and
        training resumes at the new dp size without a restart or a disk
        restore; ``step``'s batch is the first step's. Every phase runs
        under a deadline budget; a failure degrades to the checkpoint
        tiers: the last committed step's state and dataset position,
        repacked onto the survivors, and no first step. Returns ("live",
        the first step's loss), ("fallback", None) or ("left", None) on a
        departing rank (after it donated)."""
        args = self.args
        old_ranks, old_plan = list(self.ranks), self.builder.plan
        old_dp = len(old_ranks)
        lost = sorted(int(r) for r in args.evict_dp_ranks.split(",")
                      if r.strip()) or list(range(old_dp // 2, old_dp))
        leaving = old_ranks.index(self.rank) in lost
        before = (_gather_flat(self.state, self.cfg, old_plan, self.group)
                  if args.check_migration else None)
        if self.first:
            self.client.report_eviction(lost, dp_size=old_dp,
                                        reason="drill eviction")

        def detect(_):
            deadline = time.time() + 15.0
            while time.time() < deadline:
                directive = self.client.get_reshard_plan()
                if directive.version > 0:
                    return directive
                time.sleep(0.05)
            raise RuntimeError("reshard directive never arrived")

        def replan(directive):
            gone = set(directive.lost_ranks if directive else lost)
            ranks = [r for i, r in enumerate(old_ranks) if i not in gone]
            # every rank of the old group takes part in forming the new one
            group = dist.new_group(ranks)
            params = dict(self.state["params"].named_parameters())
            return {"ranks": ranks, "group": group,
                    "plan": shd.build_pack_plan(self.cfg, params, len(ranks),
                                                self.comm.bucket_bytes)}

        def migrate(rp):
            rp["state"] = reshard_train_state(
                self.state, old_plan, rp["plan"], old_ranks, rp["ranks"],
                faults=get_injector())
            if before is not None and rp["state"] is not None:
                check = _migration_check(
                    before, rp["state"], self.cfg, old_plan, rp["plan"],
                    rp["ranks"].index(self.rank))
                say(f"[reshard] migration check {json.dumps(check)}")
            return rp

        def rebuild(rp):
            self.ranks, self.group = rp["ranks"], rp["group"]
            self.ckpt.engine.group = self.group
            self.trainer.on_membership_change()
            return rp

        def first_step(rp):
            self.state = rp["state"]
            rp["loss"] = self.run_step(step)
            say(f"[reshard] first step loss={rp['loss']!r}")
            return rp

        def fallback(exc):
            if leaving:
                return None
            say(f"[reshard] live path failed ({exc!r}); falling back to "
                "the checkpoint tiers")
            rp = replan(None)
            self.state = self.restore_repacked(old_plan, rp)
            rp["loss"] = None
            return rebuild(rp)

        phases = [("detect", detect), ("replan", replan),
                  ("migrate", migrate)]
        if not leaving:
            phases += [("rebuild", rebuild), ("first_step", first_step)]
        out = LiveResharder(budgets=PhaseBudgets()).execute(
            phases, fallback=fallback)
        if leaving:
            return "left", None
        say("[reshard] done " + json.dumps({
            "path": out.path, "recovery_s": out.recovery_s,
            "dp": f"{old_dp}->{len(self.ranks)}",
            "grad_accum": self.trainer.grad_accum,
            "phases": out.phase_seconds, "reason": out.reason}))
        return out.path, out.result["loss"]

    def restore_repacked(self, old_plan, rp) -> Dict:
        """The checkpoint tiers' state at the survivor layout: the last
        committed step's packs (every old rank's, each its columns) read
        into the whole old flat state, repacked onto the new plan; the
        survivors' first rank puts the master's dataset back to that
        step's position. (A rank's memory tier holds only its own
        columns, so the storage tier answers.)"""
        step = self.ckpt.latest_committed_step()
        if step is None:
            raise RuntimeError("no checkpoint tier answered")
        mu_nu = convert.opt_state_paths(self.opt)[1:]
        full = {k: torch.zeros((old_plan.n_buckets, old_plan.bucket_elems),
                               dtype=self.state["opt_state"][k]["flat"].dtype,
                               device=self.dev) for k in ("m", "v")}
        leaves = [leaf for leaf in self.leaves()
                  if not leaf.path.endswith("/flat")]
        leaves += [core.Leaf(f"{path}/flat", core.dtype_name(full[k].dtype),
                             list(full[k].shape),
                             [core.Shard([[0, n] for n in full[k].shape],
                                         full[k])])
                   for k, path in zip(("m", "v"), mu_nu)]
        step_dir = os.path.join(self.ckpt.ckpt_dir, f"step_{step}")
        idx = core.PackIndex()
        try:
            for name in sorted(os.listdir(step_dir)):
                if name.endswith(".pack"):
                    idx.add_pack(self.ckpt.engine._storage.mmap(
                        os.path.join(step_dir, name)))
            core.restore_leaves(leaves, idx)
            dataset = idx.extra.get("dataset", "")
        finally:
            idx.close()
        convert.load_scalars(self.state, leaves, self.opt)
        if dataset and rp["ranks"][0] == self.rank:
            self.sharding.restore(dataset)
        say(f"[reshard] restored step {step} from storage")
        cols = rp["plan"].columns(rp["ranks"].index(self.rank))
        opt = dict(self.state["opt_state"])
        for k in ("m", "v"):
            opt[k] = {"flat": reshard_flat(full[k], old_plan, rp["plan"])[
                :, cols].contiguous()}
        return dict(self.state, opt_state=opt)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    restart = int(os.environ.get(GraftEnv.RESTART_COUNT, "0") or 0)
    tracer = get_tracer()
    tracer.instant("worker.start")
    t0 = time.perf_counter()
    if args.one_card and dev.type == "cuda":
        distributed.init_distributed(device=dev, backend="gloo",
                                     device_index=0)
    else:
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
        torch.cuda.reset_peak_memory_stats()
    client = build_master_client()
    overrides = {}
    for item in args.override:
        key, _, value = item.partition("=")
        overrides[key] = json.loads(value)
    cfg = get_config(args.model, max_seq=args.seq, **overrides)
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{world} ranks")
    rows = args.batch // world
    mesh = None
    if args.hosts_per_slice > 0:
        # the mesh is built from the world of this start: a world that
        # lost a whole slice re-meshes to fewer slices
        num_slices = max(1, world // args.hosts_per_slice)
        mesh = build_mesh(MeshConfig(dp=num_slices, fsdp=-1,
                                     num_slices=num_slices))
        say(f"[worker] slice mesh: num_slices={num_slices} "
            f"dp={mesh.shape['dp']} fsdp={mesh.shape['fsdp']}")
    opt = make_optimizer(learning_rate=LR, warmup_steps=WARMUP,
                         decay_steps=DECAY)
    sampler = None
    if args.data == "sampler":
        # one epoch of steps x batch samples, each rank its rows of a step
        sampler = ElasticDistributedSampler(args.steps * args.batch,
                                            num_replicas=world, rank=rank,
                                            shuffle=True, seed=args.seed)
        sharding = None
    else:
        # one shard of the master's dataset a global step
        sharding = ShardingClient(client, "train",
                                  dataset_size=args.steps * args.batch,
                                  shard_size=args.batch)
    if args.zero1 or args.micro_batch:
        telemetry.configure_hub().subscribe(
            lambda r: say(f"[event] {r.to_json()}"),
            types=("ElasticEvent", "NumericEvent"))
        last = ZeroRun(args, cfg, opt, dev, client, sharding, rank, world,
                       restart, mesh).train()
    else:
        targs = TrainerArgs(
            output_dir=args.ckpt_dir, max_steps=args.steps, log_interval=0,
            save_interval=2 * args.ckpt_every,
            memory_save_interval=args.ckpt_every, seed=args.seed,
            prefetch=PREFETCH if dev.type == "cuda" else 0)

        if sampler is not None:
            batches = iter(ElasticDataLoader(
                lambda idx: sample_batch(args.seed, idx, args.seq,
                                         cfg.vocab_size),
                sampler=sampler, batch_size=rows))

            def ckpt_extra():
                # the position after the trained steps (the loader runs
                # ahead of the step by the prefetch)
                done = trainer.state["step"] * args.batch
                return {"sampler": dict(sampler.state_dict(),
                                        completed=min(done,
                                                      sampler.dataset_size))}
        else:
            batches = shard_batches(sharding, args, rank, rows,
                                    cfg.vocab_size)

            def ckpt_extra():
                return {"dataset": sharding.checkpoint()} if rank == 0 else {}
        trainer = Trainer(
            cfg, targs, batches, opt, master_client=client,
            callbacks=[StepPrinter(args, rank, restart, sharding, sampler,
                                   lose_rank=world - 1)],
            device=dev, mesh=mesh, ckpt_extra=ckpt_extra,
            replicate_checkpoints=args.replicate)
        if args.hash_restored:
            trainer.checkpointer.engine.replica_digest = pack_digest
        trainer.train()
        trainer.checkpointer.close()
        last = trainer.state["step"]
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    rss = peak_rss_bytes()
    if last is not None:
        say(f"[worker] done at step {last} rank {rank} peak_bytes={peak} "
            f"peak_rss_bytes={rss}")
    else:
        say(f"[worker] evicted rank {rank} peak_bytes={peak} "
            f"peak_rss_bytes={rss}")
    distributed.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
