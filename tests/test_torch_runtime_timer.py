"""The port's runtime kernel timer and the Trainer's health options
(``health_sentinels``, ``profile_interval``) against the JAX package's.

Mirrors ``tests/test_observability.py``'s runtime-timer cases and
``tests/test_sentinels.py``'s trainer cases:

- on the CPU, ``profiled_call`` profiles a tiny train step at the
  cadence (and when forced) and returns a breakdown whose names are the
  aten ops the step ran, with positive times; interval 0 samples only
  when forced;
- the trace parser reads a Chrome trace the test writes in the torch
  profiler's shape (kernels, copies, memsets, host ops, python frames,
  flow events) and returns the expected sums: the device events on the
  card, the host ops on the CPU, ``top_k``, gzip, the newest file;
- ``Trainer(health_sentinels=True, profile_interval=2)`` trains a tiny
  llama on the CPU: its watchdog sees the JAX ``Trainer``'s ``sent_*``
  every step (the counts exactly, the update ratio within 1e-5), the
  sampled steps publish ``KernelSample`` records, and the block loop
  (``block_k=3``) observes the same steps;
- a planted NaN step fires ``nan_grads`` from that step on and writes
  exactly one capture (the budget's interval refuses the next ones),
  whose breakdown is the forced sample of the following step;
- ``sanitize_grads`` still raises naming ROADMAP A17.
"""

import gzip
import json
import os
import uuid

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dlrover_tpu.checkpoint import core as jcore  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel.mesh import single_device_mesh  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu.train import trainer as jtrainer  # noqa: E402
from dlrover_tpu_torch.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
)
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.observability import runtime_timer as trt  # noqa
from dlrover_tpu_torch.observability import sentinels as snt  # noqa: E402
from dlrover_tpu_torch.observability import telemetry  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402
from dlrover_tpu_torch.train import trainer as ttrainer  # noqa: E402

# a tiny llama (test_torch_sentinels.py's): the sentinel counts are held
# exactly, and a gradient entry at a threshold would flip with the two
# frameworks' rounding
_CFG = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, d_ff=128,
            vocab_size=512, max_seq=64, tie_embeddings=False,
            dtype="float32")
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)
STEPS = 6


@pytest.fixture(autouse=True)
def _run_id(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "rt" + uuid.uuid4().hex[:12])
    monkeypatch.delenv("DLROVER_TPU_TRACE_DIR", raising=False)
    telemetry.reset_hub()
    yield
    telemetry.reset_hub()
    CheckpointEngine.unlink_segment()


def _batches(n=STEPS, seed=0, poison_at=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tok = rng.integers(0, 512, size=(4, 33)).astype(np.int32)
        b = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
        if poison_at is not None:
            b["poison"] = np.full((4, 32), int(i + 1 == poison_at), np.int32)
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# the timer
# ---------------------------------------------------------------------------


def _tiny_step():
    cfg = get_config("tiny", **_CFG)
    tx = topt.make_optimizer(**_OPT)
    state = tts.init_train_state(0, cfg, tx, device="cpu")
    step = tts.TrainStepBuilder(cfg, tx, device="cpu").build()
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    return step, state, batch


def test_profiled_call_samples_a_cpu_step_at_the_cadence():
    step, state, batch = _tiny_step()
    rt = trt.RuntimeKernelTimer(interval_steps=2, top_k=0)
    assert [rt.should_sample(s) for s in (1, 2, 3, 4)] == [
        False, True, False, True]
    state, m = rt.profiled_call(1, step, state, batch)
    assert rt.sampled_at == -1 and rt.breakdown == []
    state, m = rt.profiled_call(2, step, state, batch)
    assert np.isfinite(float(m["loss"])) and state["step"] == 2
    names = {o.name for o in rt.breakdown}
    assert {"aten::mm", "aten::add_"} <= names, sorted(names)[:20]
    assert all(o.total_us > 0 and o.count > 0 for o in rt.breakdown)
    assert rt.sampled_at == 2 and rt.sampled_block_k == 1
    assert sum(o.fraction for o in rt.breakdown) == pytest.approx(1.0)
    assert rt.summary()["aten::mm"] > 0
    text = rt.prometheus_text().splitlines()
    assert text[0] == "# TYPE dlrover_tpu_kernel_time_us gauge"
    assert text[-1] == "# sampled_at_step 2"
    assert any(line.startswith('dlrover_tpu_kernel_time_us{op="aten__mm"}')
               for line in text)


def test_interval_zero_samples_only_when_forced():
    step, state, batch = _tiny_step()
    rt = trt.RuntimeKernelTimer(interval_steps=0, top_k=5)
    assert not any(rt.should_sample(s) for s in range(1, 50))
    rt.force_next()
    assert rt.should_sample(7)
    state, _ = rt.profiled_call(7, step, state, batch, n_steps=3)
    assert rt.sampled_at == 7 and rt.sampled_block_k == 3
    assert 0 < len(rt.breakdown) <= 5
    assert not rt.should_sample(8)  # one shot
    with pytest.raises(ValueError):
        trt.RuntimeKernelTimer(interval_steps=-1)


def _trace_events():
    return [
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_wgmma_kernel",
         "dur": 90.5, "ts": 1},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_wgmma_kernel",
         "dur": 9.5, "ts": 2},
        {"ph": "X", "cat": "kernel", "name": "norm_fwd_kernel", "dur": 25,
         "ts": 3},
        {"ph": "X", "cat": "gpu_memcpy",
         "name": "Memcpy DtoH (Device -> Pinned)", "dur": 3, "ts": 4},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "dur": 1, "ts": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 40, "ts": 6},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 20, "ts": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 4, "ts": 8},
        {"ph": "X", "cat": "python_function",
         "name": "torch/nn/modules/module.py(1736): _call_impl", "dur": 99,
         "ts": 9},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#3",
         "dur": 500, "ts": 10},
        {"ph": "X", "cat": "cpu_op", "name": "ProfilerStep#3", "dur": 500,
         "ts": 10},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 11},
        {"ph": "X", "cat": "kernel", "name": "", "dur": 7, "ts": 12},
        {"ph": "i", "cat": "kernel", "name": "norm_bwd_kernel", "ts": 13},
    ]


def _rows(ops):
    return [(o.name, o.total_us, o.count, round(o.fraction, 6)) for o in ops]


def test_the_trace_parser_sums_a_torch_chrome_trace(tmp_path):
    old = tmp_path / "old" / "trace_step1.json"
    old.parent.mkdir()
    old.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "stale", "dur": 1}]}))
    os.utime(old, (1, 1))
    with gzip.open(tmp_path / "trace_step3.json.gz", "wt") as f:
        json.dump({"traceEvents": _trace_events(),
                   "deviceProperties": []}, f)
    dev = trt.parse_trace_dir(str(tmp_path))
    assert _rows(dev) == [
        ("flash_fwd_wgmma_kernel", 100.0, 2, round(100 / 129, 6)),
        ("norm_fwd_kernel", 25.0, 1, round(25 / 129, 6)),
        ("Memcpy DtoH (Device -> Pinned)", 3.0, 1, round(3 / 129, 6)),
        ("Memset (Device)", 1.0, 1, round(1 / 129, 6))]
    assert _rows(trt.parse_trace_dir(str(tmp_path), top_k=2)) == _rows(
        dev)[:2]
    host = trt.parse_trace_dir(str(tmp_path), device=False)
    assert _rows(host) == [("aten::mm", 60.0, 2, 1.0)]
    assert trt.parse_trace_dir(str(tmp_path / "none")) == []


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


class _Seen:
    """Wraps a trainer's ``watchdog.observe``: each step's host metrics."""

    def __init__(self, trainer):
        self.steps = {}
        real = trainer.watchdog.observe

        def observe(step, metrics, **kw):
            self.steps[step] = dict(metrics)
            return real(step, metrics, **kw)

        trainer.watchdog.observe = observe


def _jax_arrays(seed=0):
    """The JAX train state's arrays by path (the JAX Trainer's init)."""
    st = jts.init_train_state(jax.random.key(seed), jget("tiny", **_CFG),
                              single_device_mesh(),
                              jopt.make_optimizer(**_OPT))
    return {jcore._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(st)[0]}


def _port_init(arrays, cfg, tx):
    def init(seed):
        state = tts.init_train_state(seed, cfg, tx, device="cpu")
        convert.load_train_state_arrays(state, arrays, cfg, tx)
        return state
    return init


def _port_trainer(tmp_path, batches, step_builder=None, **kw):
    cfg = get_config("tiny", **_CFG)
    tx = topt.make_optimizer(**_OPT)
    arrays = _jax_arrays()
    args = ttrainer.TrainerArgs(
        output_dir=str(tmp_path), **dict(dict(
            max_steps=STEPS, save_interval=0, log_interval=0), **kw))
    builder = step_builder(cfg, tx) if step_builder else None
    return ttrainer.Trainer(cfg, args, batches, tx, step_builder=builder,
                            init_state_fn=_port_init(arrays, cfg, tx),
                            device="cpu")


def _sent(metrics):
    return {k: v for k, v in metrics.items() if k.startswith("sent_")}


def test_the_trainers_sentinels_match_the_jax_trainers(tmp_path):
    batches = _batches()
    jcfg = jget("tiny", **_CFG)
    jt = jtrainer.Trainer(
        jcfg, jtrainer.TrainerArgs(output_dir=str(tmp_path / "jax"),
                                   max_steps=STEPS, save_interval=0,
                                   log_interval=0, health_sentinels=True),
        batches, jopt.make_optimizer(**_OPT), mesh=single_device_mesh())
    jseen = _Seen(jt)
    jt.train()
    samples = []
    telemetry.configure_hub().subscribe(samples.append,
                                        types=("KernelSample",))
    pt = _port_trainer(tmp_path / "port", batches, health_sentinels=True,
                       profile_interval=2)
    assert pt.runtime_timer.interval_steps == 2
    seen = _Seen(pt)
    pt.train()
    assert sorted(seen.steps) == sorted(jseen.steps) == list(
        range(1, STEPS + 1))
    for s in range(1, STEPS + 1):
        mine, theirs = _sent(seen.steps[s]), _sent(jseen.steps[s])
        assert sorted(mine) == sorted(theirs)
        for k in snt.COUNT_KEYS + ("sent_loss_nonfinite",):
            assert mine[k] == theirs[k], (s, k)
        np.testing.assert_allclose(mine["sent_update_ratio"],
                                   theirs["sent_update_ratio"], rtol=1e-5,
                                   atol=1e-12)
        np.testing.assert_allclose(seen.steps[s]["loss"],
                                   jseen.steps[s]["loss"], rtol=1e-5)
    assert pt.watchdog.anomalies == [] and jt.watchdog.anomalies == []
    assert {r.step for r in samples} == {2, 4, 6}
    assert pt.runtime_timer.sampled_at == 6
    assert all(r.us > 0 and r.block == 1 for r in samples)


def test_the_block_loop_observes_the_stepwise_sentinels(tmp_path):
    batches = _batches()
    runs = []
    for k in (1, 3):
        t = _port_trainer(tmp_path / f"k{k}", batches, block_k=k,
                          health_sentinels=True, profile_interval=3)
        seen = _Seen(t)
        t.train()
        runs.append(seen.steps)
        assert t.runtime_timer.sampled_at == 6
        assert t.runtime_timer.sampled_block_k == k
    assert runs[0] == runs[1]


class _Poisoned(tts.TrainStepBuilder):
    """The loss times NaN where the batch's ``poison`` flag is set."""

    def __init__(self, cfg, tx):
        super().__init__(cfg, tx, device="cpu", health_sentinels=True)

    def _loss(self, model, batch, denom=None):
        batch = dict(batch)
        bad = batch.pop("poison").max() > 0
        loss, m = super()._loss(model, batch, denom)
        return loss * torch.where(bad, float("nan"), 1.0), m


def test_a_planted_nan_step_fires_nan_grads_and_one_capture(tmp_path):
    t = _port_trainer(tmp_path, _batches(poison_at=3), step_builder=_Poisoned,
                      health_sentinels=True, detect_loss_spikes=False)
    assert t.runtime_timer.interval_steps == 0  # forced samples only
    seen = _Seen(t)
    t.train()
    assert [seen.steps[s]["sent_loss_nonfinite"] for s in (1, 2, 3)] == [
        0.0, 0.0, 1.0]
    assert seen.steps[3]["sent_nonfinite"] > 0
    recs = t.watchdog.anomalies
    assert [(r.kind, r.step) for r in recs] == [
        ("nan_grads", s) for s in range(3, STEPS + 1)]
    want = os.path.join(str(tmp_path), "captures",
                        "capture_step3_nan_grads.json")
    assert recs[0].capture == want
    assert all(r.capture == "" for r in recs[1:])  # the interval refuses
    assert os.listdir(os.path.join(str(tmp_path), "captures")) == [
        "capture_step3_nan_grads.json"]
    doc = json.loads(open(want).read())
    assert doc["anomaly"] == {"kind": "nan_grads", "step": 3, "node_id": -1}
    assert doc["captured_step"] == 4 and doc["ops"]
    assert t.runtime_timer.sampled_at == 4


def test_captures_land_under_the_trace_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_TRACE_DIR", str(tmp_path / "trace"))
    t = _port_trainer(tmp_path / "out", _batches(), health_sentinels=True)
    assert t.watchdog.cfg.capture_dir == str(tmp_path / "trace")


def test_sanitize_grads_still_raises_naming_a17(tmp_path):
    cfg = get_config("tiny", **_CFG)
    with pytest.raises(NotImplementedError, match="ROADMAP A17"):
        ttrainer.Trainer(cfg, ttrainer.TrainerArgs(
            output_dir=str(tmp_path), health_sentinels=True,
            sanitize_grads="skip"), [], topt.make_optimizer(**_OPT),
            device="cpu")
