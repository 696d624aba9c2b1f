"""The live reshard end to end on the CPU: the port's launcher runs 4
gloo workers of the elastic example (``--zero1 --evict-at 6``, a
test-size llama, 12 steps of a global batch of 8); after step 6 ranks 2
and 3 are evicted, the survivors live-migrate the flat optimizer state
and train to the end at dp 2 with ``grad_accum`` 2. The port's
counterpart of ``tests/test_fullstack_drill.py``'s
``test_live_reshard_eviction_drill``, under a time limit.

Checked: ``[reshard] done`` with path live and dp 4->2 on both
survivors, each of its five phases, no checkpoint restore and no
fallback; the migrated columns equal the ``reshard_flat`` repack of the
gathered state bit for bit; the departing ranks exit 0 after donating;
the ``reshard_<phase>`` events; training to step 12; the first loss after
the eviction within 1.0 of the last before it; the shards rank 0 trained
cover the dataset once, and the master counts them all completed.

Then the same run with every donation torn (``DLROVER_TPU_FAULTS``) and
checkpoints every 2 steps (disk every 4): the migrate phase retries and
gives up, and the survivors fall back to the checkpoint tiers — step 4's
packs, every old rank's columns, repacked onto dp 2, with its dataset
position — and train steps 5 to 12 again from there.
"""

import json
import os
import re
import subprocess
import sys
import uuid

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = dict(n_layer=2, d_model=64, n_head=2, n_kv_head=1, d_ff=128,
            vocab_size=256, dtype="float32")
STEPS, BATCH, SEQ, EVICT_AT = 12, 8, 32, 6
LAUNCH_TIMEOUT_S = 150
_LOSS = re.compile(r"\[worker\] step=(\d+) loss=(\S+) rank=(\d+) ")
_SHARD = re.compile(r"\[worker\] shard step=(\d+) \[(\d+), (\d+)\)")


def _launch(tmp, ckpt_every=0, faults=""):
    run_id = "rsd" + uuid.uuid4().hex[:10]
    env = dict(os.environ, DLROVER_TPU_RUN_ID=run_id,
               DLROVER_TPU_COORDINATOR_PORT="0", OMP_NUM_THREADS="1",
               DLROVER_TPU_FAULTS=faults)
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.agent.launcher",
           "--nnodes", "1", "--nproc", "4", "--max-restarts", "0",
           "--monitor-interval", "0.1", "--", sys.executable, "-m",
           "dlrover_tpu_torch.examples.train_gpt_elastic", "--model", "tiny",
           "--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
           "--ckpt-dir", str(tmp / "out"), "--ckpt-every", str(ckpt_every),
           "--zero1",
           "--evict-at", str(EVICT_AT), "--check-migration", "--device",
           "cpu"]
    for k, v in _CFG.items():
        cmd += ["--override", f"{k}={json.dumps(v)}"]
    try:
        proc = subprocess.run(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=LAUNCH_TIMEOUT_S)
    finally:  # a launcher cut by the time limit leaves its segments
        for name in os.listdir("/dev/shm"):
            if run_id in name:
                os.unlink(os.path.join("/dev/shm", name))
    return proc.returncode, proc.stdout


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("reshard_drill"))


def _lines(log, tag):
    return [line.split(tag, 1)[1] for line in log.splitlines() if tag in line]


def test_the_survivors_reshard_live_and_train_to_the_end(drill):
    rc, log = drill
    assert rc == 0, log[-4000:]
    done = [json.loads(s) for s in _lines(log, "[reshard] done ")]
    assert len(done) == 2, log[-4000:]
    for d in done:
        assert d["path"] == "live" and d["dp"] == "4->2", d
        assert d["grad_accum"] == 2 and not d["reason"]
        assert set(d["phases"]) == {"detect", "replan", "migrate",
                                    "rebuild", "first_step"}
    assert "resumed from step" not in log and "falling back" not in log
    assert log.count("[worker] done at step 12") == 2
    assert sorted(re.findall(r"\[worker\] evicted rank (\d)", log)) == [
        "2", "3"]
    assert "worker succeeded" in log


def test_the_migrated_columns_equal_the_repack(drill):
    _, log = drill
    checks = [json.loads(s) for s in _lines(log, "[reshard] migration check ")]
    assert checks == [{"m": True, "v": True, "params": True}] * 2


def test_the_reshard_events(drill):
    _, log = drill
    kinds = [json.loads(s)["d"]["kind"] for s in _lines(log, "[event] ")]
    for phase in ("detect", "replan", "migrate"):
        assert kinds.count(f"reshard_{phase}") == 4, kinds
    for phase in ("rebuild", "first_step"):
        assert kinds.count(f"reshard_{phase}") == 2, kinds
    assert kinds.count("reshard_recovery") == 4
    # four ranks at dp 4, then the two survivors' rebuild at dp 2
    assert kinds.count("mesh_replan") == 6


def test_losses_continue_and_data_is_read_once(drill):
    _, log = drill
    losses = {}
    for m in _LOSS.finditer(log):
        losses.setdefault(int(m.group(1)), {})[int(m.group(3))] = float(
            m.group(2))
    assert sorted(losses) == list(range(1, STEPS + 1))
    for step, by_rank in losses.items():
        assert len(set(by_rank.values())) == 1, (step, by_rank)
        assert sorted(by_rank) == ([0, 1, 2, 3] if step <= EVICT_AT
                                   else [0, 1])
    assert abs(losses[EVICT_AT + 1][0] - losses[EVICT_AT][0]) < 1.0
    shards = sorted((int(a), int(b)) for _, a, b in _SHARD.findall(log))
    assert shards == [(s, s + BATCH) for s in range(0, STEPS * BATCH, BATCH)]
    assert f"dataset train: {STEPS} shards completed" in log


def test_a_torn_donation_falls_back_to_the_checkpoint_tiers(tmp_path):
    rc, log = _launch(tmp_path, ckpt_every=2,
                      faults="torn_donation:point=donation")
    assert rc == 0, log[-4000:]
    done = [json.loads(x) for x in _lines(log, "[reshard] done ")]
    assert len(done) == 2, log[-4000:]
    for d in done:
        assert d["path"] == "fallback" and "TornDonation" in d["reason"]
        assert d["dp"] == "4->2"
    assert log.count("[reshard] restored step 4 from storage") == 2
    assert log.count("[worker] done at step 12") == 2
    losses = {}
    for m in _LOSS.finditer(log):
        losses.setdefault(int(m.group(1)), []).append(float(m.group(2)))
    # steps 5 and 6 ran at dp 4, then again at dp 2 from step 4's state
    assert [len(losses[s]) for s in (5, 6, 7)] == [6, 6, 2]
    assert all(abs(x - losses[4][0]) < 1.0 for s in range(5, 13)
               for x in losses[s])
