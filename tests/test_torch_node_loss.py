"""A lost node restores from a peer's memory: the port's launcher end to
end on the CPU, in ``tests/test_torch_elastic_drill.py``'s style, with a
test-size llama config (2 layers, d_model 64, f32).

A standalone master and two nodes' launchers (a run id, a socket
directory and a staging segment of their own each, as two hosts; one
wire token) run a 2-rank gloo world of the elastic example with its
batches from ``ElasticDataLoader(sampler=ElasticDistributedSampler)``
and ``--replicate``: each staged pack is backed up to the ring peer by
the node's agent. Node 1's worker, once node 0 holds its staged step,
runs one more step, writes a CUDA hardware error and exits 1. The
master classifies it ``hardware_error`` → ``relaunch_node``; node 1's
agent, after the JAX order (report, respawn, then the relaunch at the
next poll), exits 2. Acting as the platform, the test reads node 1's
staged pack, unlinks the segment (a fresh host has none) and starts a
replacement launcher. Gated: node 1's replacement restores through the
replica tier from holder 0 and node 0 through memory, at the same step;
the sampler resumes at the saved position; the losses of the re-run
steps equal the first run's bit for bit on both ranks; the pack the
replacement restored hashes equal to the one node 1 staged, and a copy
with one byte flipped does not.

Two planted variants (``tests/torch_node_loss_worker.py``): node 1
stages one step past the saved one before it goes, so holder 0 holds a
newer step of it than the cluster's minimum staged step. With the pin,
the replica tier declines it and the committed step comes from storage:
the same step on both ranks, the losses bit for bit. With the pin
skipped (the fault), the replacement restores the newer step and the
gate fails.

The three drills run at once; each launch has a time limit. Each
node's unix sockets live in a short directory of the drill's own
(``tempfile.mkdtemp`` in the temporary directory, removed after): under
pytest's per-test directory they passed the unix-socket path limit
(107 bytes) once the temporary directory's own path was longer than 31
to 37 characters (by the variant's name), and every agent then refused
to start.
"""

import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid

import pytest

from dlrover_tpu_torch.checkpoint import core
from dlrover_tpu_torch.checkpoint.saver import lock_name
from dlrover_tpu_torch.common import multi_process
from dlrover_tpu_torch.common.multi_process import attach_shared_memory
from dlrover_tpu_torch.examples.train_gpt_elastic import pack_digest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = dict(n_layer=2, d_model=64, n_head=2, n_kv_head=1, d_ff=128,
            vocab_size=256, dtype="float32")
SEQ, BATCH, SEED = 32, 4, 0
LAUNCH_TIMEOUT_S = 150
_STEP = re.compile(r"\[worker\] step=(\d+) loss=(\S+) rank=(\d+) ")

# (worker, steps, the saved step node 1 goes after, extra environment)
VARIANTS = {
    "plain": (["-m", "dlrover_tpu_torch.examples.train_gpt_elastic"], 4, 2,
              {}),
    "newer": (["tests/torch_node_loss_worker.py"], 6, 4,
              {"NODE_LOSS_STAGE_EXTRA": "1"}),
    "newer_no_pin": (["tests/torch_node_loss_worker.py"], 6, 4,
                     {"NODE_LOSS_STAGE_EXTRA": "1", "NODE_LOSS_NO_PIN": "1"}),
}


def _kill(p):
    """Kill ``p``'s process group (each drill process leads its own: a
    launcher's workers go with it, as with a lost host) and reap ``p``."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:  # the group is gone already
        pass
    p.wait()


def _wait(procs, timeout, until=None):
    """Wait for ``procs`` (or ``until()``) within ``timeout``; kill what
    is left."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(p.poll() is not None for p in procs):
            return True
        if until is not None and until():
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            _kill(p)
    return False


def _sock_root() -> str:
    """A directory for the nodes' unix sockets, as short as the temporary
    directory allows (the caller removes it)."""
    return tempfile.mkdtemp(prefix="nl")


def drill(tmp, variant):
    """One node-loss run; its logs and readings."""
    worker, steps, lose_at, extra = VARIANTS[variant]
    os.makedirs(tmp, exist_ok=True)
    run = "nl" + uuid.uuid4().hex[:8]
    socks = _sock_root()
    env = dict(os.environ, DLROVER_TPU_COORDINATOR_PORT="0",
               DLROVER_TPU_WIRE_TOKEN="tok" + run,
               DLROVER_TPU_REPLICA_HOST="127.0.0.1",
               DLROVER_TPU_CTX_HEARTBEAT_INTERVAL_S="0.5", TMPDIR=tmp,
               **extra)
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    # each node's agent writes its own parallel-config document; a path
    # that an in-process ParalConfigTuner of an earlier test exported
    # (the tuner sets it in os.environ, as the launcher's does for its
    # workers) would hand both nodes that test's batch size
    env.pop("DLROVER_TPU_PARAL_CONFIG", None)
    master_err = open(os.path.join(tmp, "master.log"), "w")
    master = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.master.main",
         "--num-workers", "2"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=master_err, text=True, start_new_session=True)
    procs = [master]
    logs = {}

    def launch(node, tag):
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.agent.launcher",
               "--nnodes", "2", "--node-id", str(node), "--nproc", "1",
               "--max-restarts", "3", "--monitor-interval", "0.1",
               "--master-addr", addr, "--", sys.executable, *worker,
               "--model", "tiny", "--batch", str(BATCH), "--seq", str(SEQ),
               "--seed", str(SEED), "--steps", str(steps), "--ckpt-every",
               "2", "--data", "sampler", "--replicate", "--lose-node-at",
               str(lose_at), "--hash-restored", "--ckpt-dir",
               os.path.join(tmp, "ckpt"), "--device", "cpu"]
        for k, v in _CFG.items():
            cmd += ["--override", f"{k}={json.dumps(v)}"]
        logs[tag] = os.path.join(tmp, f"{tag}.log")
        p = subprocess.Popen(
            cmd, cwd=ROOT, stdout=open(logs[tag], "w"),
            stderr=subprocess.STDOUT,
            env=dict(env, DLROVER_TPU_RUN_ID=f"{run}_n{node}",
                     DLROVER_TPU_SOCK_DIR=os.path.join(socks, str(node))),
            start_new_session=True)
        procs.append(p)
        return p

    out = {"variant": variant, "steps": steps, "lose_at": lose_at}
    try:
        addr = master.stdout.readline().strip().split("=", 1)[1]
        n0, n1 = launch(0, "n0"), launch(1, "n1")
        _wait([n1], LAUNCH_TIMEOUT_S)
        out["node1_rc"] = n1.returncode
        # the platform: read what node 1 staged, then the host is gone
        seg = glob.glob(f"/dev/shm/*{run}_n1_*")
        out["node1_segments"] = len(seg)
        for path in seg:
            shm = attach_shared_memory(os.path.basename(path))
            try:
                n = core.pack_length(shm.buf)
                doc = core.read_header(shm.buf)
                view = shm.buf[:n]
                out["staged"] = {"step": doc["step"], "nbytes": n,
                                 "digest": pack_digest(view)}
                # one byte in the middle of the first tensor
                hdr = int.from_bytes(bytes(view[:core.HEADER_LEN_BYTES]),
                                     "little")
                first = doc["leaves"][0]["shards"][0]
                flip = (core.payload_start(bytes(
                    view[core.HEADER_LEN_BYTES:core.HEADER_LEN_BYTES + hdr]))
                    + first["offset"] + first["nbytes"] // 2)
                out["flipped_digest"] = pack_digest(view, flip=flip)
                del view
            finally:
                shm.close()
            os.unlink(path)
        n1b = launch(1, "n1b")

        def trained_past_restore():
            text = open(logs["n1b"]).read()
            return "[worker] restore" in text and "[worker] step=" in text

        finished = _wait([n0, n1b], LAUNCH_TIMEOUT_S,
                         until=trained_past_restore if variant.endswith(
                             "no_pin") else None)
        out["finished"] = finished
        out["rcs"] = [n0.returncode, n1b.returncode]
        if finished:  # a finished job's master exits by itself
            _wait([master], 30)
    finally:
        for p in procs:  # a killed launcher's worker is still in its group
            _kill(p)
        master_err.close()
        shutil.rmtree(socks, ignore_errors=True)
        out["left_behind"] = glob.glob(f"/dev/shm/*{run}*")
        for path in out["left_behind"]:
            os.unlink(path)
    out["logs"] = {k: open(v).read() for k, v in logs.items()}
    out["master_log"] = open(os.path.join(tmp, "master.log")).read()
    return out


def _restores(log):
    return [json.loads(x) for x in re.findall(r"\[worker\] restore (\{.*\})",
                                              log)]


def verdict(out):
    """The drill's gates, by name."""
    logs = out["logs"]
    n0_last = (_restores(logs["n0"]) or [{}])[-1]
    n1_last = (_restores(logs.get("n1b", "")) or [{}])[-1]
    runs = {}  # (rank, step) -> losses of every run that printed it
    for text in logs.values():
        for step, loss, rank in _STEP.findall(text):
            runs.setdefault((int(rank), int(step)), []).append(loss)
    staged = out.get("staged", {})
    return {
        "diagnosed_relaunch": re.search(
            r"diagnosed node 1 failure as hardware_error → relaunch_node",
            out["master_log"]) is not None,
        "node1_agent_rc_2": out.get("node1_rc") == 2,
        "node1_segment_left_for_the_platform": out.get("node1_segments") == 1,
        "same_step": n0_last.get("step") is not None
        and n0_last.get("step") == n1_last.get("step"),
        "node0_memory": n0_last.get("tier") == "memory",
        "node1_replica_holder_0": n1_last.get("tier") == "replica"
        and n1_last.get("holder") == 0,
        "restored_digest_is_the_staged": n1_last.get("digest")
        == staged.get("digest") and staged.get("step") == n1_last.get("step"),
        "flipped_copy_differs": staged.get("digest") is not None
        and out.get("flipped_digest") != staged["digest"],
        "reruns_bit_for_bit": all(len(set(v)) == 1 for v in runs.values())
        and any(len(v) > 1 for v in runs.values()),
        "sampler_resumed": len(re.findall(
            r"sampler position restored \{\"epoch\": 0, \"completed\": "
            f"{n0_last.get('step', -1) * BATCH},", logs.get("n1b", ""))) == 1,
        "both_done": out.get("rcs") == [0, 0] and all(
            f"done at step {out['steps']} rank {r}" in "".join(logs.values())
            for r in (0, 1)),
        "nothing_left_behind": out.get("left_behind") == [],
    }


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    outs = {}
    # made before the threads: the factory is not thread-safe
    tmps = {v: str(tmp_path_factory.mktemp(v)) for v in VARIANTS}

    def one(variant):
        t0 = time.monotonic()
        outs[variant] = drill(tmps[variant], variant)
        outs[variant]["seconds"] = time.monotonic() - t0

    threads = [threading.Thread(target=one, args=(v,)) for v in VARIANTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def _fail_text(out):
    return "\n".join(f"--- {k}\n{v[-3000:]}" for k, v in out["logs"].items())


def test_a_lost_node_restores_from_its_peers_memory(drills):
    out = drills["plain"]
    checks = verdict(out)
    assert all(checks.values()), (checks, _fail_text(out))
    # the re-run step 3 is the first run's on both ranks
    assert out["staged"]["step"] == 2


def test_a_newer_step_on_the_holder_is_declined_for_the_pinned_one(drills):
    """Holder 0 holds node 1's step 5, the cluster's minimum staged step
    is 4: the pinned tier declines it and both resume step 4 (node 1 from
    the committed storage), their losses the first run's."""
    out = drills["newer"]
    checks = verdict(out)
    n1 = _restores(out["logs"]["n1b"])[-1]
    assert out["staged"]["step"] == 5
    assert (n1["tier"], n1["step"]) == ("storage", 4), _fail_text(out)
    for name in ("diagnosed_relaunch", "node1_agent_rc_2", "same_step",
                 "node0_memory", "reruns_bit_for_bit", "sampler_resumed",
                 "both_done", "nothing_left_behind"):
        assert checks[name], (name, checks, _fail_text(out))


def test_the_gate_catches_a_tier_that_skips_the_pin(drills):
    out = drills["newer_no_pin"]
    n1 = _restores(out["logs"]["n1b"])[-1]
    assert (n1["tier"], n1["step"]) == ("replica", 5), _fail_text(out)
    checks = verdict(out)
    assert not checks["same_step"]
    assert not all(checks.values())


def test_the_digest_of_a_flipped_copy_is_the_copys(monkeypatch):
    """``pack_digest(buf, flip=i)`` hashes only the flipped byte's chunk
    again: it equals the digest of a real copy with that bit flipped."""
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex

    monkeypatch.setattr(ex, "DIGEST_CHUNK", 1024)
    data = bytearray(os.urandom(5000))
    whole = ex.pack_digest(data)
    for i in (0, 1023, 1024, 2500, 4999):
        copy = bytearray(data)
        copy[i] ^= 1
        flipped = ex.pack_digest(data, flip=i)
        assert flipped == ex.pack_digest(copy) != whole
        assert ex.pack_digest(data, ex.chunk_digests(data), i) == flipped
    assert ex.pack_digest(parts=ex.chunk_digests(data)) == whole


def test_the_drills_socket_paths_fit_where_the_default_ones_fit(
        monkeypatch):
    """The drill's socket directory (``_sock_root``: a short directory in
    the temporary directory) takes the agent's sockets under the longest
    temporary directory whose default socket directory
    (``<tmp>/dlrover_tpu_sockets``) takes them, 55 characters; the old
    place, pytest's directory of one variant, passes the unix-socket path
    limit there, so every agent of the three drills refused to start."""
    root = _sock_root()
    try:
        assert os.path.dirname(root) == tempfile.gettempdir()
        assert os.path.basename(root).startswith("nl")
        shape = len(os.path.basename(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tmp = "/" + "t" * 54
    monkeypatch.setattr(multi_process.os, "makedirs", lambda *a, **k: None)
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "nl" + "f" * 8 + "_n1")
    places = {
        "default": (os.path.join(tmp, "dlrover_tpu_sockets"), True),
        "drill": (os.path.join(tmp, "n" * shape, "1"), True),
        "pytest": (os.path.join(tmp, "pytest-of-root", "pytest-0",
                                "newer_no_pin0", "sock1"), False),
    }
    for where, (sock_dir, fits) in places.items():
        monkeypatch.setenv("DLROVER_TPU_SOCK_DIR", sock_dir)
        for name in ("ckpt", "ckpt_meta", lock_name(0)):  # the saver's
            if fits:
                assert len(multi_process._socket_path(name).encode()) <= 107
            else:
                with pytest.raises(OSError, match="too long for a unix"):
                    multi_process._socket_path(name)
