"""The port's auto-tuner (``dlrover_tpu_torch/cluster/brain.py``:
``ColdStartPlanner``, ``estimate_hbm_bytes``, ``BrainTuner``,
``apply_revision``) against the JAX package's, on the CPU.

Mirrors ``tests/test_brain_tuner.py``: the same model shapes and budgets
give the same ``TuningPlan`` field for field (the parity calls use
``device_kind="cpu"``, whose link figure both tables hold, and an
explicit ``hbm_bytes``); the same record streams and failure verdicts
through every ladder (overlap drift, fp8 saturation, OOM, the serving
curves, the cooldown, versions through ``report`` and onto the hub)
give the same revisions; ``apply_revision`` maps a plan onto the port's
step arguments as the JAX one maps it onto its ``AccelerationPlan``, and
refuses a remat policy the port cannot run with ROADMAP A21's error;
the healthcheck replays a tuning trail as the JAX one does.
"""

import dataclasses
import json

import pytest

from dlrover_tpu.cluster import brain as jbrain
from dlrover_tpu.models.config import get_config as jget_config
from dlrover_tpu.observability import healthcheck as jhc
from dlrover_tpu.observability import telemetry as jtel
from dlrover_tpu_torch.cluster import brain
from dlrover_tpu_torch.models.config import get_config
from dlrover_tpu_torch.observability import healthcheck as thc
from dlrover_tpu_torch.observability import telemetry as ttel

MODS = ((brain, ttel), (jbrain, jtel))


@pytest.fixture(autouse=True)
def _fresh_hubs():
    ttel.reset_hub()
    jtel.reset_hub()
    yield
    ttel.reset_hub()
    jtel.reset_hub()


def _fields(x):
    return dataclasses.asdict(x) if x is not None else None


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# the cold-start planner and its memory model
# ---------------------------------------------------------------------------


PLAN_CASES = [
    # the JAX package's flagship: b1 x s8192 → save_qkv on 16 GB
    ("llama-1.4b", dict(max_seq=8192), dict(n_devices=1, seq=8192,
                                            hbm_bytes=16e9)),
    # nothing fits: batch 1 at full remat
    ("llama-1.4b", dict(max_seq=8192), dict(n_devices=1, seq=8192,
                                            hbm_bytes=6e9)),
    # the card's size at the train phase's shape
    ("llama-1.4b", dict(max_seq=1024), dict(seq=1024, hbm_bytes=80e9)),
    ("llama-1.4b", dict(max_seq=1024), dict(mesh={"dp": 2, "fsdp": 2},
                                            seq=1024, hbm_bytes=80e9,
                                            grad_accum=4)),
    # a small model on a dp mesh across slices
    ("tiny", {}, dict(mesh={"dp": 4, "num_slices": 2}, seq=128,
                      hbm_bytes=16e9)),
    ("gpt2-1.5b", {}, dict(n_devices=8, seq=1024, hbm_bytes=40e9,
                           optimizer="sgd", state_dtype="float32")),
    ("glm-10b", {}, dict(mesh={"dp": 1, "tp": 4, "pp": 2}, seq=2048,
                         hbm_bytes=80e9)),
]


@pytest.mark.parametrize("name,fields,kw", PLAN_CASES)
def test_the_cold_start_plan_is_the_jax_plan(name, fields, kw):
    mine = brain.ColdStartPlanner().plan(get_config(name, **fields),
                                         device_kind="cpu", **kw)
    theirs = jbrain.ColdStartPlanner().plan(jget_config(name, **fields),
                                            device_kind="cpu", **kw)
    assert _fields(mine) == _fields(theirs)


def test_the_planner_at_the_cards_shape():
    """llama-1.4b at s1024 on 80 GB: batch 8 without remat, a 1 MB
    bucket; its OOM revision is the JAX one (none → save_dots)."""
    plans = [m.ColdStartPlanner().plan(g("llama-1.4b", max_seq=1024),
                                       seq=1024, hbm_bytes=80e9,
                                       device_kind="cpu")
             for m, g in ((brain, get_config), (jbrain, jget_config))]
    assert (plans[0].batch_size, plans[0].remat, plans[0].block_k,
            plans[0].comm_bucket_mb) == (8, "none", 1, 1.0)
    revs = [m.BrainTuner(p, cooldown_s=0.0).on_failure("oom")
            for m, p in zip((brain, jbrain), plans)]
    assert _fields(revs[0]) == _fields(revs[1])
    assert revs[0].remat == "save_dots"


@pytest.mark.parametrize("batch", [1, 4, 8])
@pytest.mark.parametrize("remat", brain.REMAT_LADDER)
def test_the_memory_estimate_is_the_jax_estimate(batch, remat):
    for name, fields in (("llama-1.4b", dict(max_seq=8192)),
                         ("gpt2-1.5b", {}), ("tiny", {})):
        kw = dict(param_shards=2, optimizer="adamw", state_dtype="float32")
        assert brain.estimate_hbm_bytes(
            get_config(name, **fields), batch, 1024, remat, **kw) == \
            jbrain.estimate_hbm_bytes(jget_config(name, **fields), batch,
                                      1024, remat, **kw)


def test_the_device_tables_carry_cuda_kinds():
    assert brain._link_gbps("cpu") == jbrain._ici_gbps("cpu") == 10.0
    assert brain._link_gbps("NVIDIA H100 80GB HBM3") == 450.0
    assert brain._device_hbm_bytes("NVIDIA H100 80GB HBM3") == 80e9
    for kind in ("v5e", "v4", "tpu v5 lite"):  # no TPU figure
        assert brain._link_gbps(kind) == 450.0
        assert brain._device_hbm_bytes(kind) == 80e9


def test_a_tuning_plan_round_trips_through_both_packages():
    plan = brain.TuningPlan(version=3, origin="revision", knob="spec_k",
                            signal="accept", spec_k=4, ts=1.0)
    assert dataclasses.asdict(jtel.from_json(plan.to_json())) == \
        dataclasses.asdict(plan)
    old = json.dumps({"r": "TuningPlan", "d": {"version": 1}})
    back = ttel.from_json(old)
    assert back.spec_k == -1 and back.page_bucketing == -1
    assert back.remat == "" and back.batch_size == 0


# ---------------------------------------------------------------------------
# the revision ladders: the same records into both tuners
# ---------------------------------------------------------------------------


def _drift(tel, frac=1.0):
    return tel.OverlapDriftRecord(planned_exposed_us=100.0,
                                  measured_collective_us=100.0 * (1 + frac),
                                  drift_us=100.0 * frac, drift_frac=frac)


def _both(plan_kw, feed, **kw):
    """Each package's tuner on ``TuningPlan(**plan_kw)``, ``feed(tuner,
    brain module, telemetry module)``; the revisions and the held plan,
    equal."""
    out = []
    for mod, tel in MODS:
        tuner = mod.BrainTuner(mod.TuningPlan(**plan_kw), **kw)
        feed(tuner, mod, tel)
        out.append(([_fields(r) for r in tuner.revisions],
                    _fields(tuner.plan)))
    assert out[0] == out[1]
    return out[0]


def test_the_drift_ladder():
    def feed(t, mod, tel):
        for frac in (1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.5, 0.9, 0.3):
            t.on_record(_drift(tel, frac))

    revs, plan = _both(dict(comm_bucket_mb=4.0), feed, cooldown_s=0.0)
    assert [r["comm_bucket_mb"] for r in revs] == [8.0, 16.0]
    assert plan["comm_bucket_mb"] == 16.0


@pytest.mark.parametrize("ici,dcn", [("float32", "int8"), ("int8", ""),
                                     ("bfloat16", ""), ("", "")])
def test_the_wire_ladder(ici, dcn):
    def feed(t, mod, tel):
        for _ in range(4):
            t.on_record(tel.AnomalyRecord(kind="fp8_saturation",
                                          detail="amax"))

    _both(dict(comm_wire_dtype=ici, comm_wire_dtype_dcn=dcn), feed,
          cooldown_s=0.0)


@pytest.mark.parametrize("remat,batch", [("none", 8), ("save_qkv", 4),
                                         ("full", 4), ("full", 1),
                                         ("bogus", 2), ("", 3)])
def test_the_oom_ladder(remat, batch):
    def feed(t, mod, tel):
        for _ in range(3):
            t.on_failure("oom", "detail")
        t.on_record(tel.AnomalyRecord(kind="oom", detail="via the hub"))
        for _ in range(4):
            t.on_failure("oom")
        assert t.on_failure("timeout") is None

    _both(dict(remat=remat, batch_size=batch), feed, cooldown_s=0.0)


def test_the_serving_ladders():
    def feed(t, mod, tel):
        t.on_record(tel.ServingRecord(replica="r", draft_tokens=10,
                                      spec_accept_rate=0.95, active_slots=3,
                                      queue_depth=1))
        t.on_record(tel.ServingRecord(replica="r", ttft_p99_ms=120.0,
                                      active_slots=3, queue_depth=1))
        for _ in range(2):
            t.on_record(tel.ServingRecord(replica="r", active_slots=4,
                                          queue_depth=3))
        for rate in (0.1, 0.1, 0.1):
            t.on_record(tel.ServingRecord(replica="r", draft_tokens=4,
                                          spec_accept_rate=rate,
                                          active_slots=1, queue_depth=0))
        t.observe_serving_stats({"table_ships": 0})
        t.observe_serving_stats({"table_ships": 20})

    revs, plan = _both(dict(spec_k=2, prefill_chunk=128, n_slots=4,
                            page_bucketing=0), feed, cooldown_s=0.0,
                       ttft_target_ms=50.0, occupancy_patience=2)
    assert [r["knob"] for r in revs][:3] == ["spec_k", "prefill_chunk",
                                             "n_slots"]
    assert plan["page_bucketing"] == 1


def test_the_cooldown():
    clocks = []

    def feed(t, mod, tel):
        clk = t._clock
        for at in (0.0, 0.0, 0.0, 10.0, 10.0, 10.0, 31.0, 31.0, 31.0):
            clk.t = at
            t.on_record(_drift(tel))
        clocks.append(clk.t)

    out = []
    for mod, tel in MODS:
        t = mod.BrainTuner(mod.TuningPlan(comm_bucket_mb=4.0),
                           cooldown_s=30.0, clock=FakeClock())
        feed(t, mod, tel)
        out.append([_fields(r) for r in t.revisions])
    assert out[0] == out[1]
    assert [r["comm_bucket_mb"] for r in out[0]] == [8.0, 16.0]


def test_versions_go_through_report_and_onto_the_hub():
    out = []
    for mod, tel in MODS:
        hub = tel.configure_hub()
        seen = []
        hub.subscribe(seen.append, types=("TuningPlan",))
        t = mod.BrainTuner(mod.TuningPlan(version=7, comm_bucket_mb=4.0),
                           report=lambda rev: 41, cooldown_s=0.0)
        for _ in range(3):
            t.on_record(_drift(tel))

        def boom(rev):
            raise OSError("master unreachable")

        t._report = boom
        for _ in range(3):
            t.on_record(_drift(tel))
        out.append(([r.version for r in seen], t.plan.version))
    assert out[0] == out[1] == ([41, 42], 42)


# ---------------------------------------------------------------------------
# apply_revision: the port's step arguments
# ---------------------------------------------------------------------------


REVISIONS = [
    dict(remat="full", comm_bucket_mb=8.0, comm_wire_dtype_dcn="bfloat16",
         update_sharding="zero2", grad_accum_steps=2),
    dict(update_sharding="off"),
    dict(comm_wire_dtype="int8", batch_size=2),
    dict(remat="none", update_sharding="zero1"),
    dict(),
]
_MAPPED = ("remat", "comm_bucket_mb", "comm_wire_dtype",
           "comm_wire_dtype_dcn", "update_sharding", "grad_accum")


@pytest.mark.parametrize("rev", REVISIONS)
def test_apply_revision_maps_as_jax_onto_its_plan(rev):
    from dlrover_tpu.accelerate.strategy import AccelerationPlan

    start = dict(remat="full", comm_bucket_mb=4.0, grad_accum=1)
    mine = brain.apply_revision(brain.StepArgs(**start),
                                brain.TuningPlan(**rev))
    theirs = jbrain.apply_revision(AccelerationPlan(**start),
                                   jbrain.TuningPlan(**rev))
    for name in _MAPPED:
        if name in ("comm_wire_dtype", "comm_wire_dtype_dcn"):
            want = getattr(theirs, name)
            assert getattr(mine, name) == want or (
                not rev.get(name) and want in (None, "", "float32"))
        else:
            assert getattr(mine, name) == getattr(theirs, name), name
    # pure: the input untouched, and the result builds a CommConfig
    assert brain.StepArgs(**start).comm_bucket_mb == 4.0
    mine.comm_config()


@pytest.mark.parametrize("policy", [r for r in brain.REMAT_LADDER
                                    if r not in ("none", "full")])
def test_a_revision_the_port_cannot_run_is_refused(policy):
    """A remat policy that saves named residuals (ROADMAP A21) raises
    A21's error in ``apply_revision`` and in ``apply_tuning``; it is
    never mapped to another policy, and the trainer is left as it was."""
    from dlrover_tpu_torch.elastic.trainer import ElasticTrainer

    args = brain.StepArgs(remat="full")
    with pytest.raises(NotImplementedError, match="ROADMAP A21"):
        brain.apply_revision(args, brain.TuningPlan(remat=policy))
    built = []
    tr = ElasticTrainer(8, 4, lambda ga: built.append(ga) or (lambda *a: a),
                        data_replicas_fn=lambda: 1)
    with pytest.raises(NotImplementedError, match="ROADMAP A21"):
        tr.apply_tuning({"version": 2, "remat": policy, "batch_size": 2})
    assert (tr.micro_batch_size, tr.grad_accum, built) == (4, 2, [2])
    # the OOM ladder from the cold-start plan names such a policy first
    rev = brain.BrainTuner(brain.TuningPlan(remat="none"),
                           cooldown_s=0.0).on_failure("oom")
    with pytest.raises(NotImplementedError, match="ROADMAP A21"):
        brain.apply_revision(args, rev)


# ---------------------------------------------------------------------------
# the healthcheck's tuning trail
# ---------------------------------------------------------------------------


def test_the_healthcheck_replays_the_tuning_trail_as_jax(tmp_path):
    path = tmp_path / "flight.jsonl"
    with open(path, "w") as f:
        f.write(brain.TuningPlan(version=1, origin="cold_start",
                                 reason="llama-1.4b b8", ts=1.0).to_json()
                + "\n")
        f.write(brain.TuningPlan(version=2, origin="revision",
                                 knob="batch_size", signal="oom",
                                 batch_size=2, ts=2.0).to_json() + "\n")
        f.write(brain.JobMetrics(job_name="j", worker_num=2,
                                 steps_per_sec=1.0, ts=3.0).to_json() + "\n")
        f.write('{"torn')
    mine = thc.diagnose(thc.load_records(str(path)))
    theirs = jhc.diagnose(jhc.load_records(str(path)))
    assert mine["tuning"] == theirs["tuning"]
    assert mine["tuning"]["knobs_moved"] == {"batch_size": 1}
    report = thc.format_report(mine)
    for line in ("brain tuning: 1 revision(s) after cold start",
                 "  knobs moved: batch_size×1", "  v2 batch_size: oom"):
        assert line in report and line in jhc.format_report(theirs)
    empty = tmp_path / "old.jsonl"
    empty.write_text(ttel.StepRecord(step=1, loss=2.0).to_json() + "\n")
    assert thc.diagnose(thc.load_records(str(empty)))["tuning"] == {}
