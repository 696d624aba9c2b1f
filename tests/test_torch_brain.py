"""The port's Brain service (``dlrover_tpu_torch/cluster/brain.py``, its
resource half) against the JAX package's, on the CPU.

Mirrors ``tests/test_cluster.py``'s Brain cases: the same metrics rows
and stats go to both ``BrainService``s and the plans are the same,
field for field — the algorithm registry and stage chains, the
first allocation from same-kind history (through a jsonl store too),
the OOM memory hints, the sparse tier's hot-shard weights and memory
hint, grow-then-shrink on poor scaling, the clamp after the unit snap,
no regrow into a known-bad size. Over the wire: a Brain in a separate
process (``python -m dlrover_tpu_torch.cluster.brain``) answers the
port's ``BrainClient`` as an in-process service answers; a JAX-encoded
request gets the JAX Brain's reply; the client degrades to an empty
plan when the Brain is unreachable; the port's master in cluster mode
plans through the Brain and refuses cluster mode without an address.
"""

import dataclasses
import json
import subprocess
import sys

import pytest

from dlrover_tpu.cluster import brain as jbrain
from dlrover_tpu.common import messages as jmsgs
from dlrover_tpu_torch.cluster import brain
from dlrover_tpu_torch.common import comm, messages as msgs


def _plan(p):
    return dataclasses.asdict(p)


def _rows(mod, specs):
    return [mod.JobMetrics(**s) for s in specs]


def _services(specs=(), **kw):
    """A port and a JAX BrainService over the same rows."""
    out = []
    for mod in (brain, jbrain):
        svc = mod.BrainService(**kw)
        for r in _rows(mod, specs):
            svc.persist_metrics(r)
        out.append(svc)
    return out


def _same_plans(specs, calls, job=("j", "k"), **kw):
    """Each (stage, stats) call to both services: the plans, equal."""
    mine, theirs = _services(specs, **kw)
    got = []
    for svc in (mine, theirs):
        svc.bind_job(*job)
        got.append([_plan(svc.generate_plan(stage, dict(stats)))
                    for stage, stats in calls])
    assert got[0] == got[1]
    return got[0]


HISTORY = [dict(job_name=f"old-{n}", job_kind="gpt-pretrain", worker_num=n,
                samples_per_sec=sps, finished=True, timestamp=1.0 + n)
           for n, sps in ((4, 40.0), (8, 96.0), (16, 128.0))]


def test_the_algorithm_registry_and_chains_merge_as_jax():
    for mod in (brain, jbrain):
        with pytest.raises(ValueError, match="unknown brain algorithm"):
            mod.get_algorithm("nope")

        @mod.register_algorithm("test_fixed_three")
        def fixed(svc, stats, mod=mod):
            p = mod.ResourcePlan()
            p.worker_num = 3
            return p

    stats = {"ps_mem_used_bytes": 9.0e9, "ps_mem_cap_bytes": 10.0e9,
             "ps_num": 2}
    plans = _same_plans([], [("running", stats)], stage_chains={
        "running": ["test_fixed_three", "job_ps_oom_resource"]})
    assert plans[0]["worker_num"] == 3
    assert plans[0]["node_resources"]["ps"]["num"] == 3
    assert brain.DEFAULT_STAGE_CHAINS == jbrain.DEFAULT_STAGE_CHAINS
    for chain in brain.DEFAULT_STAGE_CHAINS.values():
        for name in chain:  # every stock algorithm registered in both
            assert brain.get_algorithm(name) and jbrain.get_algorithm(name)


@pytest.mark.parametrize("kind,stats", [
    ("gpt-pretrain", {}),          # the best samples/sec/worker: 8
    ("other", {}),                 # no history: no plan
])
def test_first_allocation_from_history(kind, stats):
    plans = _same_plans(HISTORY, [("create", stats)], job=("new", kind),
                        min_workers=1, max_workers=64)
    assert plans[0]["worker_num"] == (8 if kind == "gpt-pretrain" else None)


def test_the_jsonl_store_reloads_and_plans_as_jax(tmp_path):
    for mod, name in ((brain, "port.jsonl"), (jbrain, "jax.jsonl")):
        store = mod.MetricsStore(str(tmp_path / name))
        for r in _rows(mod, HISTORY):
            store.append(r)
    with open(tmp_path / "port.jsonl", "a") as f:
        f.write("not json\n")
        f.write('{"job_name": "j", "unknown_field": 1}\n')
        f.write('{"job_name": "j", "worker_num": 9')
    # the port's file reads back in the JAX store, row for row
    mine = brain.MetricsStore(str(tmp_path / "port.jsonl"))
    theirs = jbrain.MetricsStore(str(tmp_path / "port.jsonl"))
    assert [_plan(r) for r in mine.kind_rows("gpt-pretrain")] == [
        _plan(r) for r in theirs.kind_rows("gpt-pretrain")]
    svc = [m.BrainService(store=m.MetricsStore(str(tmp_path / n)))
           for m, n in ((brain, "port.jsonl"), (jbrain, "jax.jsonl"))]
    for s in svc:
        s.bind_job("new", "gpt-pretrain")
    assert [_plan(s.generate_plan("create", {})) for s in svc] == [
        {"worker_num": 8, "node_resources": {}}] * 2


def test_a_kind_that_ooms_gets_the_memory_hint():
    specs = [dict(job_name=f"j{i}", job_kind="dlrm", worker_num=4,
                  samples_per_sec=100.0, finished=True, oom=i < 2,
                  timestamp=1.0) for i in range(4)]
    plans = _same_plans(specs, [("create", {})], job=("new", "dlrm"))
    assert plans[0]["node_resources"]["worker"]["memory_scale"] == 1.5


def test_a_running_oom_bumps_memory_not_count():
    plans = _same_plans([], [("running", {"oom": True, "worker_num": 4})])
    assert plans[0] == {"worker_num": None,
                        "node_resources": {"worker": {"memory_scale": 1.5}}}


@pytest.mark.parametrize("qps", [
    {"ps0": 1000.0, "ps1": 100.0, "ps2": 100.0},
    {"ps0": 100.0, "ps1": 110.0},
    {"ps0": 5.0},
])
def test_hot_shard_weights(qps):
    plans = _same_plans([], [("running", {"ps_shard_qps": qps})])
    w = plans[0]["node_resources"].get("ps", {}).get("weights")
    if w:
        assert w["ps0"] < w["ps1"] and w["ps0"] < w["ps2"]


def test_grows_then_shrinks_on_poor_scaling():
    mine, theirs = _services(node_unit=2, max_workers=16, min_workers=2)
    out = []
    for svc, mod in ((mine, brain), (theirs, jbrain)):
        svc.bind_job("j", "k")
        svc.persist_metrics(mod.JobMetrics(job_name="j", worker_num=4,
                                           steps_per_sec=10.0, timestamp=1.0))
        grow = svc.generate_plan("running", {"worker_num": 4,
                                             "steps_per_sec": 10.0})
        svc.persist_metrics(mod.JobMetrics(job_name="j", worker_num=8,
                                           steps_per_sec=11.0, timestamp=2.0))
        shrink = svc.generate_plan("running", {"worker_num": 8,
                                               "steps_per_sec": 11.0})
        out.append((grow.worker_num, shrink.worker_num))
    assert out[0] == out[1] == (6, 6)


def test_the_clamp_keeps_min_after_the_unit_snap():
    for mod in (brain, jbrain):
        svc = mod.BrainService(min_workers=3, node_unit=2, max_workers=16)
        assert [svc._clamp(n) for n in range(0, 20)] == [
            jbrain.BrainService(min_workers=3, node_unit=2,
                                max_workers=16)._clamp(n)
            for n in range(0, 20)]
        assert svc._clamp(3) == 4


def test_no_regrow_into_a_known_bad_size():
    specs = [dict(job_name="j", worker_num=4, steps_per_sec=10.0,
                  timestamp=1.0),
             dict(job_name="j", worker_num=8, steps_per_sec=9.0,
                  timestamp=2.0)]
    plans = _same_plans(specs, [
        ("running", {"worker_num": 6, "steps_per_sec": 10.5}),
        ("running", {"worker_num": 2, "steps_per_sec": 4.0}),
        ("running", {"worker_num": 0, "steps_per_sec": 4.0}),
    ], node_unit=2, max_workers=16, min_workers=2)
    assert plans[0]["worker_num"] is None


# ---------------------------------------------------------------------------
# the wire: a Brain of its own process
# ---------------------------------------------------------------------------


@pytest.fixture()
def brain_process(tmp_path):
    """``python -m dlrover_tpu_torch.cluster.brain`` on a free port, its
    store a jsonl file; its address from the line it prints."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.cluster.brain",
         "--port", str(comm.find_free_port()), "--store-path",
         str(tmp_path / "brain.jsonl"), "--max-workers", "8"],
        stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("DLROVER_TPU_BRAIN_ADDR="), line
        yield line.split("=", 1)[1]
    finally:
        proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_the_wire_round_trip_in_a_separate_process(brain_process):
    client = brain.BrainClient(brain_process)
    # two finished runs of kind "deepfm": 4 workers scaled best
    for n, sps in ((2, 100.0), (4, 360.0)):
        assert client.persist_metrics(brain.JobMetrics(
            job_name=f"old-{n}", job_kind="deepfm", worker_num=n,
            samples_per_sec=sps, finished=True))
    rows = client.get_job_metrics("old-4")
    assert len(rows) == 1 and rows[0].worker_num == 4
    client.bind_job("fresh-job", "deepfm")
    assert client.generate_plan("create", {}).worker_num == 4
    # the running-job algorithm over the wire: no history of this job
    # at 1 worker → grow by one
    client.bind_job("live", "deepfm")
    plan = client.generate_plan("running", {"worker_num": 1,
                                            "steps_per_sec": 2.0})
    assert plan.worker_num == 2
    client.close()


def test_a_jax_encoded_request_gets_the_jax_brains_reply():
    """The same requests, JAX-encoded, to the port's servicer and the
    JAX one over the same service state: the same reply bytes."""
    specs = [dict(job_name="old", job_kind="gpt", worker_num=2,
                  samples_per_sec=50.0, finished=True, timestamp=3.0)]
    mine, theirs = _services(specs)
    servicers = (brain._BrainServicer(mine), jbrain._BrainServicer(theirs))
    requests = [
        jmsgs.BrainOptimizeRequest(job_name="new", job_kind="gpt",
                                   stage="create", stats_json="{}"),
        jmsgs.BrainOptimizeRequest(job_name="old", stage="running",
                                   stats_json=json.dumps(
                                       {"worker_num": 2,
                                        "steps_per_sec": 1.0})),
        jmsgs.BrainJobMetricsRequest(job_name="old"),
        jmsgs.BrainJobMetricsRequest(job_name="none"),
    ]
    for req in requests:
        raw = jmsgs.serialize(req)
        got = msgs.serialize(servicers[0].get(msgs.deserialize(raw)))
        want = jmsgs.serialize(servicers[1].get(jmsgs.deserialize(raw)))
        assert got == want, req
    persist = jmsgs.BrainPersistMetricsRequest(metrics_json=json.dumps(
        dict(job_name="x", worker_num=3, timestamp=9.0)))
    bad = jmsgs.BrainPersistMetricsRequest(metrics_json="{not json")
    for req in (persist, bad):
        raw = jmsgs.serialize(req)
        assert servicers[0].report(msgs.deserialize(raw)) == \
            servicers[1].report(jmsgs.deserialize(raw))
    assert [_plan(r) for r in mine.get_job_metrics("x")] == [
        _plan(r) for r in theirs.get_job_metrics("x")]


def test_the_client_degrades_to_an_empty_plan_when_unreachable():
    client = brain.BrainClient(f"127.0.0.1:{comm.find_free_port()}",
                               timeout_s=0.5)
    client._t._retries = 1
    assert client.generate_plan("running", {"worker_num": 2}).empty()
    client.close()


def test_cluster_mode_plans_through_the_brain(brain_process):
    """optimize_mode="cluster": the auto-scaler's optimizer is a
    BrainClient to the Brain at ``brain_addr``, and its plans come from
    the Brain's shared store."""
    from dlrover_tpu_torch.master.master import DistributedJobMaster

    seeder = brain.BrainClient(brain_process)
    seeder.persist_metrics(brain.JobMetrics(
        job_name="prev", job_kind="gpt", worker_num=2,
        samples_per_sec=500.0, finished=True))
    seeder.close()
    master = DistributedJobMaster(
        num_workers=1, max_workers=4, optimize_mode="cluster",
        brain_addr=brain_process, job_name="this-job", job_kind="gpt")
    try:
        assert isinstance(master.auto_scaler.optimizer, brain.BrainClient)
        assert master.auto_scaler.optimizer.generate_plan(
            "create", {}).worker_num == 2
    finally:
        master.stop()
    with pytest.raises(ValueError, match="brain_addr"):
        DistributedJobMaster(num_workers=1, max_workers=4,
                             optimize_mode="cluster")
