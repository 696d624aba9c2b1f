"""The port's ``Trainer`` against the JAX package's, on the CPU.

A llama-family config at 2 layers and narrow widths (the one of
``test_torch_train_step.py``, f32), batches from a numpy seed:

- the JAX ``Trainer`` and the port's from the same init (the JAX train
  state carried over by ``models.convert``) give the same losses over 6
  steps, within ``test_torch_train_step.py``'s stream tolerance (1e-5
  relative), and the same params after (1e-4 of their scale);
- a resume from the memory tier and from the storage tier equals the
  uninterrupted run bit for bit (losses and every leaf of the state);
- ``block_k=3`` equals ``block_k=1`` bit for bit, with its saves at the
  same steps;
- ``_next_block_k`` equals JAX's over a table of steps and cadences;
- the callbacks fire in JAX's order, with JAX's steps;
- a checkpoint the JAX ``Trainer`` wrote at step 2 resumes in the port,
  whose step-3 loss is JAX's within the same tolerance;
- the telemetry records read back through the JAX ``from_json``, and the
  loss-spike detector flags the steps JAX's flags;
- the ``TrainerArgs`` this slice does not carry raise, naming their
  ROADMAP item.
"""

import dataclasses
import types
import uuid

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from dlrover_tpu.checkpoint import core as jcore  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.observability import loss_spike as jspike  # noqa: E402
from dlrover_tpu.observability import telemetry as jtel  # noqa: E402
from dlrover_tpu.parallel.mesh import single_device_mesh  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu.train import trainer as jtrainer  # noqa: E402
from dlrover_tpu_torch.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
)
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.observability import loss_spike  # noqa: E402
from dlrover_tpu_torch.observability import telemetry  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402
from dlrover_tpu_torch.train import trainer as ttrainer  # noqa: E402

_CFG = dict(n_layer=2, d_model=128, n_head=4, n_kv_head=2, d_ff=256,
            vocab_size=512, max_seq=64, tie_embeddings=False,
            dtype="float32")
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)
STEPS = 6


@pytest.fixture(autouse=True)
def _run_id(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "trn" + uuid.uuid4().hex[:12])
    yield
    CheckpointEngine.unlink_segment()


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, 512, size=(4, 33)).astype(np.int32)
        out.append({"tokens": tok[:, :-1], "targets": tok[:, 1:]})
    return out


class Record:
    """Every hook as (hook, step) and each step's loss."""

    def __init__(self):
        self.calls, self.losses = [], {}

    def on_train_begin(self, trainer, control):
        self.calls.append(("train_begin",))

    def on_step_end(self, trainer, step, metrics, control):
        self.calls.append(("step_end", step))
        self.losses[step] = metrics["loss"]

    def on_log(self, trainer, step, logs, control):
        self.calls.append(("log", step, sorted(logs)))

    def on_eval(self, trainer, step, eval_metrics, control):
        self.calls.append(("eval", step, eval_metrics["batches"]))

    def on_save(self, trainer, step, control):
        self.calls.append(("save", step))

    def on_train_end(self, trainer, control):
        self.calls.append(("train_end",))


def _jax_init(seed=0):
    jcfg = jget("tiny", **_CFG)
    jtx = jopt.make_optimizer(**_OPT)
    st = jts.init_train_state(jax.random.key(seed), jcfg,
                              single_device_mesh(), jtx)
    arrays = {jcore._path_str(p): np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(st)[0]}
    return jcfg, jtx, arrays


def _port_init(arrays, cfg, tx):
    def init(seed):
        state = tts.init_train_state(seed, cfg, tx, device="cpu")
        convert.load_train_state_arrays(state, arrays, cfg, tx)
        return state
    return init


def _jax_trainer(tmp_path, batches, rec, **kw):
    jcfg, jtx, _ = _jax_init()
    args = jtrainer.TrainerArgs(output_dir=str(tmp_path),
                                **dict(dict(max_steps=STEPS, save_interval=0,
                                            log_interval=0), **kw))
    return jtrainer.Trainer(jcfg, args, batches, jtx,
                            mesh=single_device_mesh(), callbacks=[rec])


def _port_trainer(tmp_path, batches, rec, arrays=None, **kw):
    cfg = get_config("tiny", **_CFG)
    tx = topt.make_optimizer(**_OPT)
    if arrays is None:
        arrays = _jax_init()[2]
    args = ttrainer.TrainerArgs(output_dir=str(tmp_path),
                                **dict(dict(max_steps=STEPS, save_interval=0,
                                            log_interval=0), **kw))
    return ttrainer.Trainer(cfg, args, batches, tx, callbacks=[rec],
                            init_state_fn=_port_init(arrays, cfg, tx),
                            device="cpu")


def _arrays(trainer):
    return convert.train_state_arrays(trainer.state, trainer.cfg,
                                      trainer.optimizer)


def test_six_steps_match_the_jax_trainer(tmp_path):
    batches = _batches()
    jrec, trec = Record(), Record()
    jt = _jax_trainer(tmp_path / "jax", batches, jrec)
    jt.train()
    pt = _port_trainer(tmp_path / "port", batches, trec)
    pt.train()
    assert sorted(trec.losses) == list(range(1, STEPS + 1))
    for s in range(1, STEPS + 1):
        np.testing.assert_allclose(trec.losses[s], jrec.losses[s], rtol=1e-5)
    want = {jcore._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jt.state)[0]}
    got = _arrays(pt)
    assert list(got) == list(want)
    for path in want:
        scale = max(float(np.abs(want[path]).max()), 1e-12)
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-4 * scale, err_msg=path)


def _same_state(a, b):
    assert list(a) == list(b)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg=path)


@pytest.mark.parametrize("tier", ["memory", "storage"])
def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path, tier):
    batches = _batches()
    arrays = _jax_init()[2]
    full_rec = Record()
    full = _port_trainer(tmp_path / "full", batches, full_rec, arrays)
    full.train()
    first = _port_trainer(tmp_path / "run", batches, Record(), arrays,
                          max_steps=4, save_interval=4,
                          memory_save_interval=2)
    first.train()
    first.checkpointer.close()
    if tier == "storage":
        assert CheckpointEngine.unlink_segment()
    rec = Record()
    resumed = _port_trainer(tmp_path / "run", batches[4:], rec, arrays)
    resumed.train()
    assert resumed.checkpointer.engine.timings[0]["tier"] == tier
    assert [rec.losses[s] for s in (5, 6)] == [full_rec.losses[s]
                                               for s in (5, 6)]
    _same_state(_arrays(resumed), _arrays(full))


def test_block_k_3_equals_block_k_1_bit_for_bit(tmp_path):
    batches = _batches(8)
    arrays = _jax_init()[2]
    runs = []
    for k in (1, 3):
        rec = Record()
        t = _port_trainer(tmp_path / f"k{k}", batches, rec, arrays,
                          max_steps=8, block_k=k, save_interval=4,
                          memory_save_interval=3, log_interval=2)
        t.train()
        saves = [(x["kind"], x["step"]) for x in t.checkpointer.engine.timings
                 if x["kind"] != "restore" and x["kind"] != "persist"]
        runs.append((rec.losses, _arrays(t), saves))
        t.checkpointer.close()
    assert runs[0][0] == runs[1][0]
    _same_state(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2] == [
        ("save_memory", 3), ("save_storage", 4), ("save_memory", 6),
        ("save_storage", 8)]


@pytest.mark.parametrize("step,kw", [
    (0, dict(block_k=4, max_steps=10)),
    (8, dict(block_k=4, max_steps=10)),
    (0, dict(block_k=8, max_steps=20, save_interval=5)),
    (3, dict(block_k=8, max_steps=20, save_interval=5)),
    (4, dict(block_k=8, max_steps=20, save_interval=5, eval_interval=3)),
    (6, dict(block_k=3, max_steps=20, memory_save_interval=7)),
    (7, dict(block_k=16, max_steps=100, save_interval=10, eval_interval=4,
             memory_save_interval=6)),
    (19, dict(block_k=1, max_steps=20)),
])
def test_next_block_k_matches_jax(step, kw):
    base = dict(save_interval=0, eval_interval=0, memory_save_interval=0)
    jargs = jtrainer.TrainerArgs(**dict(base, **kw))
    targs = ttrainer.TrainerArgs(**dict(base, **kw))
    assert ttrainer.Trainer._next_block_k(
        types.SimpleNamespace(args=targs), step) == \
        jtrainer.Trainer._next_block_k(types.SimpleNamespace(args=jargs),
                                       step)


@pytest.mark.parametrize("block_k", [1, 3])
def test_callbacks_fire_as_in_jax(tmp_path, block_k):
    batches = _batches()
    evals = _batches(2, seed=9)
    kw = dict(log_interval=2, eval_interval=3, eval_steps=2, save_interval=4,
              block_k=block_k, eval_at_end=True)
    jrec, trec = Record(), Record()
    jt = _jax_trainer(tmp_path / "jax", batches, jrec, **kw)
    jt.eval_iter_fn = lambda: iter(evals)
    jt.train()
    pt = _port_trainer(tmp_path / "port", batches, trec, **kw)
    pt.eval_iter_fn = lambda: iter(evals)
    pt.train()
    pt.checkpointer.close()
    assert trec.calls == jrec.calls
    assert ("save", 4) in trec.calls and ("eval", 6, 2.0) in trec.calls


def test_a_jax_checkpoint_at_step_2_resumes_in_the_port(tmp_path):
    batches = _batches()
    run = tmp_path / "run"
    _jax_trainer(run, batches, Record(), max_steps=2, save_interval=2).train()
    ref = Record()
    _jax_trainer(tmp_path / "ref", batches, ref, max_steps=3).train()
    rec = Record()
    # another run id: the memory tier is the port's own segment, so this
    # restore reads the JAX package's committed storage
    pt = _port_trainer(run, batches[2:], rec, max_steps=3)
    pt.train()
    assert pt.checkpointer.engine.timings[0]["tier"] == "storage"
    assert pt.state["step"] == 3 and list(rec.losses) == [3]
    np.testing.assert_allclose(rec.losses[3], ref.losses[3], rtol=1e-5)


def test_records_read_back_through_jax_from_json(tmp_path):
    got = []
    hub = telemetry.configure_hub()
    hub.subscribe(got.append)
    try:
        t = _port_trainer(tmp_path, _batches(4), Record(), max_steps=4,
                          save_interval=2)
        t.train()
        t.checkpointer.close()
    finally:
        telemetry.reset_hub()
    kinds = {type(r).__name__ for r in got}
    assert {"StepRecord", "CheckpointRecord"} <= kinds
    for r in got:
        back = jtel.from_json(r.to_json())
        assert dataclasses.asdict(back) == dataclasses.asdict(r)


@pytest.mark.parametrize("zscore", [None, 2.0])
def test_loss_spike_detector_flags_what_jax_flags(zscore):
    rng = np.random.default_rng(5)
    losses = 5.0 + 0.05 * rng.standard_normal(80)
    losses[[30, 55, 56]] += 3.0
    kw = dict(save_dir=None, min_iter=10, min_loss=4.0, zscore=zscore,
              window=40, publish_events=False)
    mine, ref = loss_spike.LossSpikeDetector(**kw), \
        jspike.LossSpikeDetector(**kw)
    assert mine.update_block(0, losses) == ref.update_block(0, losses)
    assert mine.spikes == ref.spikes and mine.spikes


@pytest.mark.parametrize("kw,item", [
    (dict(update_sharding="zero1"), "A9"),
    (dict(comm_wire_dtype="int8"), "A9"),
    (dict(comm_bucket_mb=8.0), "A9"),
    (dict(health_sentinels=True), "A12"),
    (dict(profile_interval=5), "A12"),
    (dict(sanitize_grads="skip"), "A17"),
    (dict(mesh=object()), "A8"),
    (dict(master_client=object()), "A8"),
])
def test_unported_trainer_args_raise_naming_their_item(tmp_path, kw, item):
    cfg = get_config("tiny", **_CFG)
    tx = topt.make_optimizer(**_OPT)
    ctor = {k: kw.pop(k) for k in ("mesh", "master_client") if k in kw}
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ttrainer.Trainer(cfg, ttrainer.TrainerArgs(output_dir=str(tmp_path),
                                                   **kw), [], tx,
                         device="cpu", **ctor)


def test_prefetch_on_the_cpu_is_the_plain_copy(tmp_path):
    """``prefetch`` changes when batches move, not what a step sees."""
    batches = _batches(3)
    arrays = _jax_init()[2]
    recs = []
    for n in (0, 2):
        rec = Record()
        _port_trainer(tmp_path / str(n), batches, rec, arrays, max_steps=3,
                      prefetch=n).train()
        recs.append(rec.losses)
    assert recs[0] == recs[1]
