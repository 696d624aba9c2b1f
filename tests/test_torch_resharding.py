"""Live resharding of the port (``elastic/resharding.py``,
``elastic/faults.py``, ``elastic/trainer.py``) against the JAX package.

- The interval math: ``shard_intervals``, ``donation_plan`` and
  ``reshard_flat`` equal the JAX functions' results on the same plans
  (synthetic ones and real ``PackPlan``s of a test-size llama).
- The migration over ``torch.distributed``: in 4 gloo processes
  (``tests/torch_zero_worker.py``) a zero2 run at dp 4 takes 3 steps,
  ranks 2 and 3 are evicted, and ``reshard_train_state`` moves the flat
  moments onto a dp 2 group: each survivor's columns (moments and
  packed parameters) equal the ``reshard_flat`` repack of the gathered
  state bit for bit; 3 more steps at ``grad_accum`` 2 (``ElasticTrainer``
  re-derives it from the shrunken dp) from the migrated state equal,
  loss for loss and bit for bit in every leaf, the same steps from the
  canonical repack (the port's twin of ``tests/test_resharding.py``'s
  ``test_bitwise_continuation_across_eviction``), and the first loss after
  the eviction lies within 1.0 of the last before it.
- The fault cases of ``tests/test_resharding.py``, each on every rank of
  that world: a transient torn donation retried to the live path, a
  persistent one falling back, a dead donor falling back without a retry,
  a blown deadline, a hybrid-mesh plan refused — with the
  ``reshard_<phase>`` events.
- ``ElasticTrainer`` in one process: the accumulation re-derived, the
  step rebuilt, its ``mesh_replan`` and ``effective_batch_drift`` events.
- ``parse_faults`` and the injector, as the JAX module's.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import torch_sp_worker  # noqa: E402
from dlrover_tpu.elastic import resharding as jrs  # noqa: E402
from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel import sharding as jshd  # noqa: E402
from dlrover_tpu_torch.elastic import faults  # noqa: E402
from dlrover_tpu_torch.elastic import resharding as trs  # noqa: E402
from dlrover_tpu_torch.elastic.trainer import ElasticTrainer  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.models import decoder as tdec  # noqa: E402
from dlrover_tpu_torch.observability import telemetry  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as shd  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_zero_worker.py")
_CFG = ("tiny", dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2,
                     d_ff=128, vocab_size=256, max_seq=32,
                     tie_embeddings=False, dtype="float32"))
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)
B, S = 8, 32


def _plans(dp, nb, e, total):
    """The same synthetic plan in both packages."""
    kw = dict(shapes=(), sizes=(), offsets=(), total=total, bucket_elems=e,
              n_buckets=nb, dp=dp, tie_size=0, n_tie_buckets=0)
    return shd.PackPlan(**kw), jshd.PackPlan(**kw)


_PAIRS = [((8, 3, 32, 90), (4, 2, 48, 90)), ((8, 2, 64, 100), (6, 3, 36, 100)),
          ((4, 2, 48, 90), (8, 3, 32, 90)), ((2, 1, 64, 64), (2, 1, 64, 64)),
          ((4, 3, 32, 90), (2, 2, 48, 90))]


def _fill(plan, seed):
    rng = np.random.RandomState(seed)
    out = np.zeros(plan.padded, np.float32)
    out[: plan.total] = rng.randn(plan.total).astype(np.float32)
    return out.reshape(plan.n_buckets, plan.bucket_elems)


@pytest.mark.parametrize("old,new", _PAIRS)
def test_interval_math_equals_jax(old, new):
    (t_old, j_old), (t_new, j_new) = _plans(*old), _plans(*new)
    for r in range(t_old.dp):
        assert trs.shard_intervals(t_old, r) == jrs.shard_intervals(j_old, r)
    assert trs.donation_plan(t_old, t_new) == jrs.donation_plan(j_old, j_new)
    flat = _fill(t_old, 3)
    want = jrs.reshard_flat(flat, j_old, j_new)
    np.testing.assert_array_equal(trs.reshard_flat(flat, t_old, t_new), want)
    got = trs.reshard_flat(torch.from_numpy(flat), t_old, t_new)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)


def test_interval_math_on_real_pack_plans_equals_jax():
    jcfg, cfg = jget(_CFG[0], **_CFG[1]), get_config(_CFG[0], **_CFG[1])
    abs_ = jax.eval_shape(lambda: jdec.init(jax.random.key(0), jcfg))
    params = dict(tdec.Decoder(cfg, device="meta",
                               trainable=True).named_parameters())
    for dp_old, dp_new in ((8, 4), (4, 2), (6, 4)):
        j_old = jshd.build_pack_plan(abs_, dp_old, 1 << 14)
        j_new = jshd.build_pack_plan(abs_, dp_new, 1 << 15)
        t_old = shd.build_pack_plan(cfg, params, dp_old, 1 << 14)
        t_new = shd.build_pack_plan(cfg, params, dp_new, 1 << 15)
        assert trs.donation_plan(t_old, t_new) == jrs.donation_plan(j_old,
                                                                    j_new)
        flat = _fill(t_old, 5)
        np.testing.assert_array_equal(trs.reshard_flat(flat, t_old, t_new),
                                      jrs.reshard_flat(flat, j_old, j_new))


def test_rank_bounds_and_stream_totals_raise():
    plan, _ = _plans(4, 2, 16, 17)
    with pytest.raises(ValueError):
        trs.shard_intervals(plan, 4)
    with pytest.raises(ValueError):
        trs.donation_plan(_plans(8, 1, 32, 30)[0], _plans(4, 1, 16, 16)[0])
    with pytest.raises(ValueError):
        trs.reshard_flat(np.zeros((1, 8), np.float32), plan, plan)


# ---- over torch.distributed ----------------------------------------------


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": t[:, :-1], "targets": t[:, 1:]} for t in (
        rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
        for _ in range(n))]


@pytest.fixture(scope="module")
def eviction(tmp_path_factory):
    jcfg, cfg = jget(_CFG[0], **_CFG[1]), get_config(_CFG[0], **_CFG[1])
    params = jax.tree.map(np.asarray, jdec.init(jax.random.key(0), jcfg))
    spec = {"cfg": _CFG, "opt": _OPT, "bucket_mb": 0.02,
            "weights": convert.state_dict_from_jax(params, cfg),
            "pre": _batches(3, 1), "post": _batches(3, 2),
            "global_batch": B}
    return torch_sp_worker.spawn("reshard", spec, 4,
                                 tmp_path_factory.mktemp("reshard"),
                                 script=WORKER)


def test_migration_equals_the_canonical_repack_bitwise(eviction):
    for rank in (0, 1):
        assert eviction[rank]["migrated_equal"] == {
            "m": True, "v": True, "params": True}
    # the departing ranks donated and got nothing back
    assert eviction[2]["live"] is None and eviction[3]["live"] is None


def test_continuation_is_bitwise_the_canonical_repacks(eviction):
    for rank in (0, 1):
        runs = eviction[rank]["runs"]
        live, canon = runs["live"], runs["canonical"]
        assert live["losses"] == canon["losses"]
        assert all(np.isfinite(live["losses"]))
        for n, t in live["params"].items():
            assert torch.equal(t, canon["params"][n]), n
        for k in ("m", "v"):
            assert torch.equal(live[k]["flat"], canon[k]["flat"]), k
        assert live["step"] == canon["step"] == 6
        # resumed from the exact in-memory step, not back at init
        assert abs(live["losses"][0] - eviction[rank]["pre"][-1]) < 1.0
    assert eviction[0]["runs"]["live"]["losses"] == \
        eviction[1]["runs"]["live"]["losses"]


def test_elastic_trainer_rederives_the_accumulation_at_dp_2(eviction):
    assert eviction[0]["accums"] == [1, 2]


def _fault(eviction, name):
    return [eviction[r]["faults"][name] for r in range(4)]


def test_live_migration_on_synthetic_plans(eviction):
    for rec in _fault(eviction, "live"):
        assert rec["path"] == "live" and rec["result"] is True
        assert [k for k, _ in rec["events"]] == [
            "reshard_replan", "reshard_migrate", "reshard_recovery"]


def test_transient_fault_retries_to_live(eviction):
    for rec in _fault(eviction, "transient"):
        assert rec["path"] == "live" and rec["result"] is True
        assert rec["calls"] == 2
        assert "retries=1" in dict(rec["events"])["reshard_migrate"]
        assert "path=live" in rec["events"][-1][1]


def test_persistent_fault_falls_back(eviction):
    for rec in _fault(eviction, "persistent"):
        assert rec["path"] == "fallback"
        assert rec["result"] == ("fallback", "TornDonation")
        assert rec["failed_phase"] == "migrate"
        assert [k for k, _ in rec["events"]][-2:] == [
            "reshard_fallback", "reshard_recovery"]


def test_dead_donor_falls_back_without_retry(eviction):
    for rec in _fault(eviction, "dead_donor"):
        assert rec["path"] == "fallback" and rec["calls"] == 1
        assert rec["result"] == ("fallback", "MigrationError")


def test_deadline_exceeded_falls_back(eviction):
    for rec in _fault(eviction, "deadline"):
        assert rec["path"] == "fallback"
        assert rec["result"] == ("fallback", "PhaseDeadlineExceeded")


def test_hybrid_mesh_plan_is_refused_to_fallback(eviction):
    for rec in _fault(eviction, "hybrid"):
        assert rec["path"] == "fallback" and "pure-dp" in rec["reason"]
        assert "path=fallback" in rec["events"][-1][1]


def test_resharder_without_fallback_raises():
    rs = trs.LiveResharder(retries=0)
    with pytest.raises(trs.MigrationError):
        rs.execute([("migrate", lambda _: (_ for _ in ()).throw(
            trs.MigrationError("x")))])


# ---- ElasticTrainer, faults ---------------------------------------------


@pytest.fixture
def hub_events():
    telemetry.reset_hub()
    events = []
    telemetry.configure_hub().subscribe(events.append)
    yield events
    telemetry.reset_hub()


@pytest.mark.parametrize("micro,replicas,accum,drift", [
    (2, (4, 2), (1, 2), 0), (2, (4, 3), (1, 2), 4), (1, (2, 1), (4, 8), 0)])
def test_elastic_trainer_rederives_accumulation(hub_events, micro, replicas,
                                                accum, drift):
    """``grad_accum = ceil(global / (micro × dp))``, the step rebuilt once
    a change; a global batch the new dp does not divide is a drift."""
    dp = [replicas[0]]
    built = []
    et = ElasticTrainer(8, micro,
                        lambda a: built.append(a) or (lambda s, b: (a, b)),
                        data_replicas_fn=lambda: dp[0])
    assert et.grad_accum == accum[0]
    assert et.step(None, "b") == (accum[0], "b")
    dp[0] = replicas[1]
    et.on_membership_change()
    assert et.grad_accum == accum[1] and built == list(accum)
    kinds = [e.kind for e in hub_events]
    assert kinds.count("mesh_replan") == 2
    drifts = [e for e in hub_events if e.kind == "effective_batch_drift"]
    assert [e.value for e in drifts] == ([float(drift)] if drift else [])


def test_parse_faults_and_the_injector():
    specs = faults.parse_faults(
        "torn_donation:point=donation:times=1;"
        "slow_peer:delay_s=0.5:rank=3;evict:rank=5")
    assert [s.kind for s in specs] == ["torn_donation", "slow_peer", "evict"]
    inj = faults.FaultInjector()
    for s in specs:
        inj.install(s)
    assert inj.evicted_ranks() == (5,)
    inj.at("other_point")
    with pytest.raises(faults.TornDonation):
        inj.at("donation")
    inj.at("donation")  # times=1: exhausted
    for bad in ("meteor_strike:rank=1", "kill:rank", "kill:rank=three",
                "kill:color=red"):
        with pytest.raises(ValueError) as ei:
            faults.parse_faults(f"evict:rank=1;{bad}")
        assert bad in str(ei.value)


def test_injector_env_seeding(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_FAULTS", "evict:rank=2;evict:rank=3")
    faults.reset_injector()
    try:
        assert faults.get_injector().evicted_ranks() == (2, 3)
    finally:
        faults.reset_injector()
