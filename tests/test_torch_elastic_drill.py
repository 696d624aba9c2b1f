"""The port's launcher end to end on the CPU: master, agent, rendezvous,
gloo process groups, the ``Trainer`` and Flash Checkpoint under the
agent, with a test-size llama config (2 layers, d_model 64, f32).

- one node, the worker crashing right after step 3: the agent restarts
  it, it resumes from the agent-served memory tier (step 2, the last
  staged), and its losses equal the uninterrupted run's bit for bit;
- the uninterrupted run's losses equal the JAX ``TrainStepBuilder``'s on
  the same initial weights (carried across by ``models/convert.py``) and
  batches, within ``test_torch_trainer.py``'s stream tolerance: 1e-5
  relative;
- a 2-rank world (one agent, ``--nproc 2``) over gloo, with masks whose
  valid counts differ by rank: its losses equal the one-process step's
  on the global batch within 1e-6 relative, and its committed params
  (both ranks' packs) within 1e-7 absolute: f32, the all-reduce only
  reorders sums.

Each launch runs in a subprocess under a time limit.
"""

import json
import os
import re
import subprocess
import sys
import uuid

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel.mesh import single_device_mesh  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.checkpoint import core  # noqa: E402
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine  # noqa
from dlrover_tpu_torch.checkpoint.storage import (  # noqa: E402
    PosixStorage,
    read_tracker,
)
from dlrover_tpu_torch.examples import train_gpt_elastic as ex  # noqa
from dlrover_tpu_torch.examples.train_gpt_elastic import (  # noqa: E402
    synthetic_batch,
)
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402
from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = dict(n_layer=2, d_model=64, n_head=2, n_kv_head=1, d_ff=128,
            vocab_size=256, dtype="float32")
SEQ, BATCH, SEED = 32, 4, 0
# the example's optimizer
_OPT = dict(learning_rate=ex.LR, warmup_steps=ex.WARMUP,
            decay_steps=ex.DECAY)
_LINE = re.compile(r"\[worker\] step=(\d+) loss=(\S+) rank=(\d+) ")
LAUNCH_TIMEOUT_S = 150


def _launch(tmp, *worker_args, nproc=1):
    """One launcher run; returns (rc, log, runs): each worker start's
    line and the step losses printed after it (one worker a node), and
    last every step's losses from all workers."""
    env = dict(os.environ, DLROVER_TPU_RUN_ID="drl" + uuid.uuid4().hex[:10],
               DLROVER_TPU_COORDINATOR_PORT="0")
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.agent.launcher",
           "--nnodes", "1", "--nproc", str(nproc), "--max-restarts", "1",
           "--monitor-interval", "0.1", "--", sys.executable, "-m",
           "dlrover_tpu_torch.examples.train_gpt_elastic", "--model", "tiny",
           "--batch", str(BATCH), "--seq", str(SEQ), "--seed", str(SEED),
           "--ckpt-dir", str(tmp / "out"), "--device", "cpu"]
    for k, v in _CFG.items():
        cmd += ["--override", f"{k}={json.dumps(v)}"]
    proc = subprocess.run(cmd + list(worker_args), env=env, cwd=ROOT,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=LAUNCH_TIMEOUT_S)
    runs, every = [], {}
    for line in proc.stdout.splitlines():
        if "[worker] starting at step" in line or \
                "[worker] resumed from step" in line:
            runs.append({"head": line.split("[worker] ")[1], "losses": {}})
        m = _LINE.search(line)
        if m:
            step, loss = int(m.group(1)), float(m.group(2))
            runs[-1]["losses"].setdefault(step, []).append(loss)
            every.setdefault(step, {})[int(m.group(3))] = loss
    return proc.returncode, proc.stdout, runs + [every]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    rc, log, runs = _launch(tmp_path_factory.mktemp("plain"), "--steps", "6")
    runs = runs[:-1]
    assert rc == 0, log[-4000:]
    assert len(runs) == 1 and sorted(runs[0]["losses"]) == list(range(1, 7))
    return {s: v[0] for s, v in runs[0]["losses"].items()}


def test_a_crashed_worker_resumes_from_memory_with_equal_losses(
        tmp_path, uninterrupted):
    rc, log, runs = _launch(tmp_path, "--steps", "6", "--crash-at", "3",
                            "--check-committed")
    runs = runs[:-1]
    assert rc == 0, log[-4000:]
    assert "worker exited rc=17" in log and "worker succeeded" in log
    assert [r["head"].split(" (")[0] for r in runs] == [
        "starting at step 0", "resumed from step 2"]
    assert "(tier memory" in runs[1]["head"]
    got = {s: v[0] for r in runs for s, v in r["losses"].items()}
    assert sorted(runs[1]["losses"]) == [3, 4, 5, 6]
    assert got == uninterrupted  # bit for bit, step 3 twice included
    assert runs[0]["losses"][3] == runs[1]["losses"][3]
    assert '"equal": true' in log  # the committed step 2 is the staged pack
    # the final disk save is made and commits, under the agent too
    ck = str(tmp_path / "out" / "checkpoints")
    assert read_tracker(ck, PosixStorage()) == 6


def _port_init():
    cfg = get_config("tiny", max_seq=SEQ, **_CFG)
    tx = topt.make_optimizer(**_OPT)
    return cfg, tx, tts.init_train_state(SEED, cfg, tx, device="cpu")


def test_the_uninterrupted_losses_equal_the_jax_step(uninterrupted):
    cfg, _, state = _port_init()
    jcfg = jget("tiny", max_seq=SEQ, **_CFG)
    mesh = single_device_mesh()
    jtx = jopt.make_optimizer(**_OPT)
    jstate = jts.init_train_state(jax.random.key(0), jcfg, mesh, jtx)
    sd = {n: p.detach() for n, p in state["params"].named_parameters()}
    jstate["params"] = jax.tree.map(
        jnp.asarray, convert.jax_tree_from_state_dict(sd, cfg))
    jstep = jts.TrainStepBuilder(jcfg, mesh, jtx).build()
    for step in range(1, 7):
        batch = synthetic_batch(SEED, step, 0, BATCH, SEQ, cfg.vocab_size)
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        np.testing.assert_allclose(uninterrupted[step], float(m["loss"]),
                                   rtol=1e-5)


def test_a_two_rank_world_equals_the_global_batch_step(tmp_path,
                                                      monkeypatch):
    rc, log, runs = _launch(tmp_path, "--steps", "4", "--masked", nproc=2)
    assert rc == 0, log[-4000:]
    assert log.count("process group gloo world 2") == 2
    got = runs[-1]
    # one process on the global batch: rank 0's rows then rank 1's
    cfg, tx, _ = _port_init()
    batches = []
    for step in range(1, 5):
        parts = [synthetic_batch(SEED, step, r, BATCH // 2, SEQ,
                                 cfg.vocab_size, masked=True)
                 for r in range(2)]
        assert parts[0]["mask"].sum() != parts[1]["mask"].sum()
        batches.append({k: np.concatenate([p[k] for p in parts])
                        for k in parts[0]})
    losses = {}

    class Watch:
        def on_step_end(self, trainer, step, metrics, control):
            losses[step] = metrics["loss"]

        def __getattr__(self, hook):
            return lambda *a, **k: None

    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "drl" + uuid.uuid4().hex[:10])
    try:
        ref = Trainer(cfg, TrainerArgs(output_dir=str(tmp_path / "ref"),
                                       max_steps=4, save_interval=0,
                                       log_interval=0, seed=SEED),
                      batches, tx, callbacks=[Watch()], device="cpu")
        ref.train()
        want = convert.train_state_arrays(ref.state, cfg, tx)
    finally:
        CheckpointEngine.unlink_segment()
    for step in range(1, 5):
        assert sorted(got[step]) == [0, 1], (step, got)
        assert got[step][0] == got[step][1]  # both ranks log the global loss
        np.testing.assert_allclose(got[step][0], losses[step], rtol=1e-6)
    for rank in range(2):
        _, _, fresh = _port_init()
        leaves = convert.train_state_leaves(fresh, cfg, tx)
        idx = core.PackIndex()
        idx.add_pack(PosixStorage().mmap(str(
            tmp_path / "out" / "checkpoints" / "step_4" / f"host_{rank}.pack")))
        assert core.restore_leaves(leaves, idx) == [] and idx.step == 4
        idx.close()
        convert.load_scalars(fresh, leaves, tx)
        arrays = convert.train_state_arrays(fresh, cfg, tx)
        assert fresh["step"] == 4
        for path, a in want.items():
            np.testing.assert_allclose(arrays[path], a, rtol=0, atol=1e-7,
                                       err_msg=path)


@pytest.mark.slow
def test_world_shrink_resumes_the_survivor_at_world_1(tmp_path):
    """The port's counterpart of ``tests/test_multinode.py``'s world
    shrink (slow, as the JAX drills are): a standalone master, two
    nodes' launchers (each a run id of its own, as two hosts), a 2-rank
    gloo world; both workers crash after step 3, node 1 has no restart
    budget and leaves, the master re-seals a world of one and the
    survivor resumes from its memory tier (every rank's pack is the
    whole replicated state) at the cluster's minimum staged step, 2."""
    env = dict(os.environ, DLROVER_TPU_COORDINATOR_PORT="0",
               DLROVER_TPU_CTX_RDZV_WAIT_EXTRA_NODES_S="3")
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    master = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.master.main",
         "--num-workers", "1", "--max-workers", "2"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    agents = []
    try:
        addr = master.stdout.readline().strip().split("=", 1)[1]
        run = "shr" + uuid.uuid4().hex[:8]
        for node, budget in ((0, "2"), (1, "0")):
            cmd = [sys.executable, "-m", "dlrover_tpu_torch.agent.launcher",
                   "--nnodes", "1:2", "--node-id", str(node), "--nproc", "1",
                   "--max-restarts", budget, "--monitor-interval", "0.1",
                   "--master-addr", addr, "--", sys.executable, "-m",
                   "dlrover_tpu_torch.examples.train_gpt_elastic",
                   "--model", "tiny", "--batch", str(BATCH), "--seq",
                   str(SEQ), "--steps", "6", "--ckpt-every", "2",
                   "--crash-at", "3", "--ckpt-dir", str(tmp_path / "ckpt"),
                   "--device", "cpu"]
            for k, v in _CFG.items():
                cmd += ["--override", f"{k}={json.dumps(v)}"]
            agents.append(subprocess.Popen(
                cmd, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                env=dict(env, DLROVER_TPU_RUN_ID=f"{run}_n{node}")))
        out1 = agents[1].communicate(timeout=300)[0]
        out0 = agents[0].communicate(timeout=300)[0]
    finally:
        for p in agents + [master]:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert agents[1].returncode == 17, out1[-3000:]
    assert agents[0].returncode == 0, out0[-4000:]
    assert "process group gloo world 2 rank 0" in out0
    assert "process group gloo world 1 rank 0" in out0
    assert "resumed from step 2 (tier memory" in out0
    assert "done at step 6" in out0 and "worker succeeded" in out0


def test_the_committed_pack_check_catches_one_byte(tmp_path, monkeypatch):
    """The worker's ``--check-committed`` comparison: equal for equal
    bytes, and one byte flipped anywhere (here in its last slice) shows."""
    from dlrover_tpu_torch.checkpoint.engine import shm_name
    from dlrover_tpu_torch.common.multi_process import create_shared_memory

    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "drl" + uuid.uuid4().hex[:10])
    data = np.random.default_rng(0).integers(0, 256, 5_000_003,
                                             dtype=np.uint8)
    shm = create_shared_memory(shm_name(0), 6 << 20)
    try:
        np.frombuffer(shm.buf, np.uint8)[:data.size] = data
        (tmp_path / "step_2").mkdir()
        pack = tmp_path / "step_2" / "host_0.pack"
        pack.write_bytes(data.tobytes())
        res = ex.pack_equals_committed(str(tmp_path), 2, 0)
        # random bytes are no pack: their header length runs past the end
        assert res["equal"] and res["payload_start"] is None
        data[-2] ^= 1
        pack.write_bytes(data.tobytes())
        res = ex.pack_equals_committed(str(tmp_path), 2, 0)
        assert not res["equal"] and res["nbytes"] == data.size
    finally:
        shm.close()
        CheckpointEngine.unlink_segment()
