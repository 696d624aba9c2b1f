"""The Brain's tuning loop in the port, on the CPU: master → the agent's
config tuner document → the worker's step rebuilt at a step boundary.

- the servicer folds the master's tuning directive into the
  ``ParallelConfig`` poll as the JAX servicer does (the same reply bytes
  before and after a ``TuningPlanNotice``), and ``TuningPlanRequest``
  answers the same directive;
- the port's ``ParalConfigTuner`` writes the JAX tuner's document for the
  same polls (the version pair gates a rewrite; a malformed directive is
  dropped), logs a failing poll once per reason and backs off;
- ``ElasticTrainer.apply_tuning`` re-derives the accumulation as the JAX
  trainer does for the same global batch, micro-batch and replicas, and
  rebuilds once per versioned revision;
- the whole loop at a small size: a ``BrainTuner`` reporting to a port
  master over the wire (``brain.master_report``), the config tuner's
  document (``config_tuner.read_tuning``), ``apply_revision`` and
  ``apply_tuning`` rebuilding a real ``TrainStepBuilder`` step: the
  losses go on as the undisturbed run's, at the JAX trainer's
  accumulation;
- the autoscale drill of ``chip_smoke.py`` (``autoscale_check``) at a
  cut size on the CPU: a Brain process, the operator process over the
  HTTP API server double with the kubelet double, the master pod in
  cluster mode, the worker grown from one node to two through a
  ScalePlan and retuned, the job deleted and torn down; every gate but
  the kernel launches and the network check (the node check needs a
  GPU: on the CPU the nodes run without it) holds.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

from dlrover_tpu.common import messages as jmsgs
from dlrover_tpu_torch.agent import config_tuner as ct
from dlrover_tpu_torch.cluster import brain
from dlrover_tpu_torch.common import messages as msgs
from dlrover_tpu_torch.observability import telemetry as ttel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_hub(monkeypatch, tmp_path):
    # a ParalConfigTuner exports its document's path to the process
    # environment: keep it out of the other tests
    monkeypatch.setenv("DLROVER_TPU_PARAL_CONFIG", str(tmp_path / "doc.json"))
    ttel.reset_hub()
    yield
    ttel.reset_hub()


def test_the_parallel_config_carries_the_directive_as_jax():
    from dlrover_tpu.master.node_manager import JobManager as JManager
    from dlrover_tpu.master.servicer import MasterServicer as JServicer
    from dlrover_tpu_torch.master.node_manager import JobManager
    from dlrover_tpu_torch.master.servicer import MasterServicer

    plan_json = json.dumps({"version": 0, "remat": "full", "batch_size": 2})
    script = [
        ("g", jmsgs.ParallelConfigRequest(node_id=0)),
        ("g", jmsgs.TuningPlanRequest(node_id=0)),
        ("r", jmsgs.TuningPlanNotice(node_id=0, plan_json=plan_json,
                                     signal="oom")),
        ("g", jmsgs.ParallelConfigRequest(node_id=0)),
        ("g", jmsgs.ParallelConfigRequest(node_id=5)),
        ("g", jmsgs.TuningPlanRequest(node_id=0)),
        ("r", jmsgs.TuningPlanNotice(node_id=0, plan_json="{}",
                                     reason="why")),
        ("g", jmsgs.TuningPlanRequest(node_id=0)),
    ]
    replies = []
    for manager, servicer_cls, meta, codec in (
            (JobManager, MasterServicer, msgs.NodeMeta, msgs),
            (JManager, JServicer, jmsgs.NodeMeta, jmsgs)):
        jm = manager(num_workers=1)
        jm.register_node(meta(node_id=0, node_rank=0))
        jm.get_node(0).paral_config = {"batch_size": 16, "version": 3}
        servicer = servicer_cls(job_manager=jm)
        got = []
        for method, req in script:
            m = codec.deserialize(jmsgs.serialize(req))
            got.append(servicer.report(m) if method == "r"
                       else codec.serialize(servicer.get(m)))
        replies.append(got)
    assert replies[0] == replies[1]
    cfg = msgs.deserialize(replies[0][3])
    assert (cfg.batch_size, cfg.version, cfg.tuning_version) == (16, 3, 1)
    assert json.loads(cfg.tuning_json)["batch_size"] == 2


class FakeClient:
    def __init__(self, codec):
        self.codec = codec
        self.tuning_json = ""
        self.tuning_version = 0
        self.version = 2

    def get_parallel_config(self):
        return self.codec.ParallelConfig(
            batch_size=32, version=self.version,
            tuning_json=self.tuning_json,
            tuning_version=self.tuning_version)


def test_the_config_tuners_document_is_the_jax_document(tmp_path):
    from dlrover_tpu.agent import config_tuner as jct

    steps = [("", 0, 2), (json.dumps({"version": 5, "spec_k": 3}), 5, 2),
             (json.dumps({"version": 5, "spec_k": 3}), 5, 2),
             (json.dumps({"version": 5, "spec_k": 3}), 5, 4),
             ("{not json", 6, 4)]
    docs = []
    for mod, codec, name in ((ct, msgs, "port.json"),
                             (jct, jmsgs, "jax.json")):
        client = FakeClient(codec)
        tuner = mod.ParalConfigTuner(client,
                                     config_path=str(tmp_path / name))
        trail = []
        for tj, tv, v in steps:
            client.tuning_json, client.tuning_version = tj, tv
            client.version = v
            wrote = tuner.poll_once()
            trail.append((wrote, json.loads((tmp_path / name).read_text())))
        docs.append(trail)
    assert docs[0] == docs[1]
    assert [w for w, _ in docs[0]] == [True, True, False, True, True]
    # read_tuning: the directive with the master's version, or none
    assert ct.read_tuning(str(tmp_path / "port.json")) == (0, None)
    (tmp_path / "t.json").write_text(json.dumps(docs[0][1][1]))
    assert ct.read_tuning(str(tmp_path / "t.json")) == (
        5, {"version": 5, "spec_k": 3})
    (tmp_path / "torn.json").write_text('{"tuning_version": 5, "tun')
    assert ct.read_tuning(str(tmp_path / "torn.json")) == (0, None)
    assert ct.read_tuning(str(tmp_path / "missing.json")) == (0, None)


def test_the_config_tuner_logs_once_per_reason_and_backs_off(monkeypatch,
                                                             tmp_path):
    class Flaky:
        fail_with = OSError("master down")

        def get_parallel_config(self):
            if self.fail_with is None:
                return msgs.ParallelConfig(batch_size=8, version=1)
            raise self.fail_with

    warned = []
    monkeypatch.setattr(ct.logger, "warning",
                        lambda msg, *a, **kw: warned.append(msg % a))
    client = Flaky()
    tuner = ct.ParalConfigTuner(client,
                                config_path=str(tmp_path / "cfg.json"))
    for _ in range(4):
        assert not tuner.poll_once()
    client.fail_with = ValueError("bad frame")
    assert not tuner.poll_once()
    assert len(warned) == 2
    assert "OSError" in warned[0] and "ValueError" in warned[1]
    assert tuner._fail_streak == 5
    client.fail_with = None
    assert tuner.poll_once()
    assert tuner._fail_streak == 0


def test_the_default_document_path_is_in_the_temporary_directory(
        monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "r7")
    monkeypatch.delenv("DLROVER_TPU_PARAL_CONFIG", raising=False)
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    tuner = ct.ParalConfigTuner(FakeClient(msgs))
    assert tuner.config_path == str(tmp_path /
                                    "dlrover_tpu_paral_config_r7.json")
    assert os.environ["DLROVER_TPU_PARAL_CONFIG"] == tuner.config_path


@pytest.mark.parametrize("glob,micro,replicas,batch", [
    (32, 4, 2, 8), (8, 4, 1, 2), (8, 4, 2, 2), (30, 4, 3, 7), (8, 8, 4, 16),
    (8, 4, 2, 0),
])
def test_apply_tuning_accumulates_as_the_jax_trainer(glob, micro, replicas,
                                                     batch):
    from dlrover_tpu.elastic.trainer import ElasticTrainer as JTrainer
    from dlrover_tpu_torch.elastic.trainer import ElasticTrainer

    out = []
    for cls in (ElasticTrainer, JTrainer):
        built = []
        tr = cls(global_batch_size=glob, micro_batch_size=micro,
                 build_step=lambda ga, b=built: b.append(ga) or (
                     lambda state, x: (state, {"ga": ga})),
                 data_replicas_fn=lambda: replicas)
        ran = [tr.apply_tuning({"version": 0}),
               tr.apply_tuning(brain.TuningPlan(version=3,
                                                batch_size=batch)),
               tr.apply_tuning({"version": 4})]
        out.append((ran, tr.micro_batch_size, tr.grad_accum, built,
                    tr.step(None, None)[1]))
    assert out[0] == out[1]


def _sample_batch(seed, lo, rows, seq, vocab):
    from dlrover_tpu_torch.examples.train_gpt_elastic import sample_batch

    return sample_batch(seed, range(lo, lo + rows), seq, vocab)


def test_a_tuner_reports_to_the_master_and_takes_its_version():
    """``brain.master_report``: a BrainTuner held on the job's plan
    sends its revision to a port master over the wire; the master mints
    the version (its counter, not the tuner's), and a second revision
    gets the next one."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.master import JobMaster

    master = JobMaster(port=0, num_workers=1)
    master.prepare()
    try:
        master.job_manager.plan_tuning("{}", reason="cold start")
        client = MasterClient(master.addr, node_id=0)
        tuner = brain.BrainTuner(brain.TuningPlan(version=1, remat="full",
                                                  batch_size=4),
                                 report=brain.master_report(client),
                                 cooldown_s=0.0)
        revs = [tuner.on_failure("oom", "planted") for _ in range(2)]
        directive = client.get_tuning()
    finally:
        master.stop()
    assert [r.version for r in revs] == [2, 3]
    assert tuner.plan.version == directive.version == 3
    assert json.loads(directive.plan_json)["batch_size"] == 1
    assert directive.reason == "oom at remat=full; batch 2→1"


def test_master_to_document_to_rebuild(tmp_path):
    """The master's directive (the revision a tuner held on the job's
    plan makes at an OOM: the micro-batch halved) travels the loop and
    lands at a step boundary: the rebuilt step (the accumulation
    doubled) goes on from the same state, its losses those of the run
    that was not retuned."""
    from dlrover_tpu.elastic.trainer import ElasticTrainer as JTrainer
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.elastic.trainer import ElasticTrainer
    from dlrover_tpu_torch.master.master import JobMaster
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    cfg = get_config("tiny", n_layer=2, max_seq=16, dtype="float32",
                     remat="full")
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=2, decay_steps=50)
    glob, micro, steps = 8, 4, 4

    def run(tune_at=None, doc=None):
        state = init_train_state(0, cfg, opt, device="cpu")
        args = brain.StepArgs(remat=cfg.remat)

        def build(accum):
            return TrainStepBuilder(cfg, opt, grad_accum=accum,
                                    device="cpu").build()

        tr = ElasticTrainer(glob, micro, build, data_replicas_fn=lambda: 1)
        losses = []
        for s in range(1, steps + 1):
            if s == tune_at:
                version, plan = ct.read_tuning(doc)
                args = brain.apply_revision(args, brain.TuningPlan(**{
                    k: v for k, v in plan.items()
                    if k in brain.TuningPlan.__dataclass_fields__}))
                assert tr.apply_tuning(plan)
            batch = _sample_batch(0, (s - 1) * glob, glob, 16,
                                  cfg.vocab_size)
            state, m = tr.step(state, batch)
            losses.append(float(m["loss"]))
        return losses, tr, args

    rev = brain.TuningPlan(origin="revision", signal="oom",
                           knob="batch_size", batch_size=micro // 2)
    master = JobMaster(port=0, num_workers=1)
    master.prepare()
    try:
        client = MasterClient(master.addr, node_id=0)
        assert client.report_tuning_plan(json.dumps(
            dataclasses.asdict(rev)), signal=rev.signal)
        assert client.get_tuning().version == 1
        doc = str(tmp_path / "paral_config.json")
        assert ct.ParalConfigTuner(client, config_path=doc).poll_once()
        base, _, _ = run()
        tuned, tr, args = run(tune_at=3, doc=doc)
    finally:
        master.stop()
    assert (tr.micro_batch_size, tr.grad_accum) == (2, 4)
    assert args.remat == "full" and args.grad_accum == 1
    jtr = JTrainer(glob, micro, lambda ga: None, data_replicas_fn=lambda: 1)
    jtr.apply_tuning({"version": 1, "batch_size": 2})
    assert jtr.grad_accum == tr.grad_accum
    assert tuned[:2] == base[:2]
    assert np.allclose(tuned, base, rtol=1e-5, atol=0)
    assert all(math.isfinite(x) for x in tuned)


def test_the_autoscale_drill_on_the_cpu(monkeypatch):
    """``chip_smoke.autoscale_check`` at a cut size: every gate but the
    kernel launches and the network check holds on the CPU."""
    import importlib.util

    from dlrover_tpu_torch.models.config import get_config

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    monkeypatch.setattr(c, "TRAIN_SEQ", 32)
    monkeypatch.setattr(c, "nvidia_smi_line", lambda: "cpu")
    rec = c.autoscale_check(
        get_config("llama-1.4b", n_layer=2), 0, device="cpu",
        overrides=["d_model=64", "n_head=2", "n_kv_head=1", "d_ff=128",
                   "vocab_size=256", 'dtype="float32"'])
    failed = sorted(k for k, v in rec["checks"].items() if not v)
    assert failed == ["kernels_ran", "network_checks_ok"], (failed, rec)
    assert not rec["network_check"]
    assert rec["errors"]["loss"] < 1e-5
    assert tuple(rec["scaled"][0]) == (1, 2)
