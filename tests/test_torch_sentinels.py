"""The port's health sentinels (``observability/sentinels.py`` and the
step's ``health_sentinels``) against the JAX package's.

Mirrors ``tests/test_sentinels.py``:

- ``grad_counts``, ``counts_to_metrics`` and ``loss_nonfinite`` equal
  the JAX functions' results exactly, on gradient trees with planted
  inf, nan, float16-overflow, bfloat16-overflow and underflow entries
  and zeros; a zero-padded flat stream counts as its tree;
  ``update_ratio`` within 1e-6 relative;
- a tiny llama (2 layers, d_model 64, f32) through the port's
  ``TrainStepBuilder(health_sentinels=True)`` and the JAX one, from the
  same weights: the same ``sent_*`` every step (the counts exactly, the
  update ratio within 1e-5 relative), a planted NaN step included (a
  loss multiplied by NaN, the JAX test's ``_poison_loss``); the losses
  bit for bit those of the port's own run with the sentinels off;
- the parity contract of ``tests/test_sentinels.py:260`` over processes:
  the port's replicated data-parallel step and its zero1 and zero2 steps
  (``grad_accum`` 1 and 2, two gloo ranks), and an fsdp 2 × tp 2 step
  (four gloo ranks), give the counts of the JAX REPLICATED step on the
  global batch (the JAX ZeRO step does not trace on this jax: ROADMAP
  C), the ratio within 1e-5;
- with the sentinels on the step makes no more host reads
  (``Tensor.item``, ``.cpu()``, ``.tolist()``, ``float()``) than with
  them off, and the Trainer reads each step once either way.

One divergence is expected and pinned: XLA:CPU flushes float32
subnormals to zero, so the JAX ``sent_und_bf16`` lane (below bfloat16's
min normal, which is float32's) counts none there, while torch keeps
them and the port counts them.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_sp_worker  # noqa: E402
from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.observability import sentinels as jsnt  # noqa: E402
from dlrover_tpu.parallel.mesh import single_device_mesh  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.observability import sentinels as snt  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402
from dlrover_tpu_torch.train import trainer as ttrainer  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_health_worker.py")
_CFG = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, d_ff=128,
            vocab_size=256, max_seq=32, tie_embeddings=False,
            dtype="float32")
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)
B, S, STEPS = 8, 32, 3
RATIO_RTOL = 1e-5


def _np_counts(t):
    return np.asarray(t, np.float32)


def _trees(seed):
    """Gradient trees with every planted class, f32 normals only."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((16, 8)) * 1e-3).astype(np.float32)
    a[0, :4] = [np.nan, np.inf, -np.inf, 7e4]   # nonfinite ×3, f16 ovf
    a[1, :4] = [1e-6, -3e-7, 2e-38, 0.0]        # f16 underflow ×3, zero
    b = (rng.standard_normal(33) * 10).astype(np.float32)
    b[:3] = [3.4e38, -3.3e38, 6e4]              # bf16+f16 ovf ×2, none
    c = np.zeros(5, np.float32)                 # zeros count nowhere
    return {"a": a, "b": b, "c": c}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_and_metrics_equal_jax_exactly(seed):
    tree = _trees(seed)
    jc = jsnt.grad_counts({k: jnp.asarray(v) for k, v in tree.items()})
    tc = snt.grad_counts({k: torch.from_numpy(v) for k, v in tree.items()})
    assert tc.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), _np_counts(jc))
    n = sum(v.size for v in tree.values())
    assert snt.static_size(torch.from_numpy(v) for v in tree.values()) == n
    jm = jsnt.counts_to_metrics(jc, n)
    tm = snt.counts_to_metrics(tc, n)
    assert list(tm) == list(jm)
    for k in jm:
        assert tm[k].numpy().tobytes() == np.asarray(jm[k]).tobytes(), k


def test_a_padded_flat_stream_counts_as_its_tree():
    tree = _trees(3)
    flat = np.concatenate([v.reshape(-1) for v in tree.values()]
                          + [np.zeros(11, np.float32)])
    np.testing.assert_array_equal(
        snt.grad_counts(torch.from_numpy(flat)).numpy(),
        snt.grad_counts([torch.from_numpy(v) for v in tree.values()]).numpy())


@pytest.mark.parametrize("loss", [1.5, np.nan, np.inf, -np.inf])
def test_loss_nonfinite_equals_jax(loss):
    j = jsnt.loss_nonfinite(jnp.float32(loss))
    t = snt.loss_nonfinite(torch.tensor(loss, dtype=torch.float32))
    assert float(t) == float(j)


def test_update_ratio_matches_jax():
    rng = np.random.default_rng(4)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in (("w", (32, 16)), ("b", (16,)))}
    upd = {k: (v * 1e-3 + 1e-4).astype(np.float32)
           for k, v in params.items()}
    j = float(jsnt.update_ratio({k: jnp.asarray(v) for k, v in upd.items()},
                                {k: jnp.asarray(v)
                                 for k, v in params.items()}))
    t = float(snt.update_ratio(
        {k: torch.from_numpy(v) for k, v in upd.items()},
        {k: torch.from_numpy(v) for k, v in params.items()}))
    np.testing.assert_allclose(t, j, rtol=1e-6)
    # zero params: the 1e-12 floor keeps the ratio finite
    zero = {"w": torch.zeros(2)}
    assert np.isfinite(float(snt.update_ratio({"w": torch.ones(2)}, zero)))


def test_a_subnormal_counts_in_the_port_and_not_on_xla_cpu():
    g = np.array([1e-40, 1.0], np.float32)  # a float32 subnormal
    assert snt.grad_counts(torch.from_numpy(g)).numpy()[4] == 1.0
    assert _np_counts(jsnt.grad_counts(jnp.asarray(g)))[4] == 0.0


def test_sanitizer_count_is_none_without_a_sanitizer():
    state = topt.make_optimizer().init({"w": torch.zeros(2)})
    assert snt.sanitizer_count(state) is None
    assert float(snt.sanitizer_count(
        {"inner": {"nonfinite_count": torch.tensor(2)}})) == 2.0


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _batches(n=STEPS, seed=7, poison_at=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tok = rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
        b = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
        if poison_at is not None:
            b["poison"] = np.full((B, S), int(i + 1 == poison_at), np.int32)
        out.append(b)
    return out


def _jax_run(batches, grad_accum=1, poison=False):
    """The JAX replicated step's per-step sentinel scalars and losses."""
    jcfg = jget("tiny", **_CFG)
    mesh = single_device_mesh()
    jtx = jopt.make_optimizer(**_OPT)
    st = jts.init_train_state(jax.random.key(3), jcfg, mesh, jtx)
    params = jax.tree.map(np.asarray, st["params"])
    loss_fn = None
    if poison:
        def loss_fn(p, batch, **kw):
            clean = {k: v for k, v in batch.items() if k != "poison"}
            loss, m = jdec.loss_fn(p, clean, cfg=jcfg, mesh=mesh)
            bad = jnp.max(batch["poison"]) > 0
            return loss * jnp.where(bad, jnp.float32(jnp.nan), 1.0), m
    step = jts.TrainStepBuilder(jcfg, mesh, jtx, grad_accum=grad_accum,
                                loss_fn=loss_fn,
                                health_sentinels=True).build()
    out = []
    for b in batches:
        st, m = step(st, jax.tree.map(jnp.asarray, b))
        out.append({k: float(v) for k, v in m.items()
                    if k == "loss" or k.startswith("sent_")})
    return params, out


class _Poisoned(tts.TrainStepBuilder):
    """The JAX test's ``_poison_loss``: the loss times NaN where the
    batch's ``poison`` flag is set."""

    def _loss(self, model, batch, denom=None):
        batch = dict(batch)
        bad = batch.pop("poison").max() > 0
        loss, m = super()._loss(model, batch, denom)
        return loss * torch.where(bad, float("nan"), 1.0), m


def _port_run(params, batches, sentinels=True, poison=False, grad_accum=1):
    cfg = get_config("tiny", **_CFG)
    tx = topt.make_optimizer(**_OPT)
    model = convert.load_jax_params(params, cfg, device="cpu",
                                    trainable=True)
    state = {"params": model,
             "opt_state": tx.init(dict(model.named_parameters())),
             "step": 0}
    cls = _Poisoned if poison else tts.TrainStepBuilder
    step = cls(cfg, tx, grad_accum=grad_accum, device="cpu",
               health_sentinels=sentinels).build()
    out = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()
                    if k == "loss" or k.startswith("sent_")})
    return out


def _same_sentinels(port, ref, exact_loss=False):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert sorted(p) == sorted(r), (sorted(p), sorted(r))
        for k in snt.COUNT_KEYS + ("sent_loss_nonfinite",):
            assert p[k] == r[k] or (np.isnan(p[k]) and np.isnan(r[k])), (
                k, p[k], r[k])
        if np.isfinite(r["sent_update_ratio"]):
            np.testing.assert_allclose(p["sent_update_ratio"],
                                       r["sent_update_ratio"],
                                       rtol=RATIO_RTOL, atol=1e-12)
        else:
            assert not np.isfinite(p["sent_update_ratio"])


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_step_sentinels_match_the_jax_step(grad_accum):
    batches = _batches()
    params, ref = _jax_run(batches, grad_accum=grad_accum)
    on = _port_run(params, batches, grad_accum=grad_accum)
    _same_sentinels(on, ref)
    assert on[0]["sent_update_ratio"] == 0.0  # warmup: step 1's lr is 0
    assert on[-1]["sent_update_ratio"] > 0.0
    off = _port_run(params, batches, sentinels=False, grad_accum=grad_accum)
    assert all(not any(k.startswith("sent_") for k in m) for m in off)
    # the sentinels change no bit of the step
    assert [m["loss"] for m in on] == [m["loss"] for m in off]


def test_a_planted_nan_step_is_counted_as_jax_counts_it():
    batches = _batches(poison_at=2)
    params, ref = _jax_run(batches, poison=True)
    got = _port_run(params, batches, poison=True)
    _same_sentinels(got, ref)
    assert got[0]["sent_nonfinite"] == 0.0
    assert got[0]["sent_loss_nonfinite"] == 0.0
    assert got[1]["sent_nonfinite"] > 0.0
    assert got[1]["sent_loss_nonfinite"] == 1.0


def _dist_ref():
    batches = _batches()
    params, ref = _jax_run(batches)
    _, ref2 = _jax_run(batches, grad_accum=2)
    return params, batches, {1: ref, 2: ref2}


def test_zero_and_replicated_ranks_count_as_the_jax_replicated_step(
        tmp_path):
    params, batches, refs = _dist_ref()
    cases = [dict(id=(zero, a), mesh=None, zero=zero, accum=a)
             for zero in (None, "zero1", "zero2") for a in (1, 2)]
    spec = {"cfg": ("tiny", _CFG), "opt": _OPT, "params": params,
            "batches": batches, "bucket_mb": 0.02, "cases": cases}
    outs = torch_sp_worker.spawn("sentinels", spec, 2, tmp_path,
                                 timeout_s=240, script=WORKER)
    for case in cases:
        ref = refs[case["accum"]]
        for rank in range(2):
            _same_sentinels(outs[rank][case["id"]], ref)
    # the parity contract: every path's counts are the replicated ones
    for a in (1, 2):
        base = outs[0][(None, a)]
        for zero in ("zero1", "zero2"):
            for p, r in zip(outs[0][(zero, a)], base):
                assert [p[k] for k in snt.COUNT_KEYS] == [
                    r[k] for k in snt.COUNT_KEYS]


def test_fsdp2_tp2_ranks_count_as_the_jax_replicated_step(tmp_path):
    params, batches, refs = _dist_ref()
    cases = [dict(id="fsdp2tp2", mesh={"fsdp": 2, "tp": 2}, zero=None,
                  accum=1)]
    spec = {"cfg": ("tiny", _CFG), "opt": _OPT, "params": params,
            "batches": batches, "bucket_mb": 0.02, "cases": cases}
    outs = torch_sp_worker.spawn("sentinels", spec, 4, tmp_path,
                                 timeout_s=240, script=WORKER)
    for rank in range(4):
        _same_sentinels(outs[rank]["fsdp2tp2"], refs[1])


# ---------------------------------------------------------------------------
# host reads
# ---------------------------------------------------------------------------


class _Reads:
    """Counts the host reads of tensors: ``item``, ``cpu``, ``tolist``
    and ``float()``."""

    NAMES = ("item", "cpu", "tolist", "__float__")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            real = getattr(torch.Tensor, name)

            def counting(t, *a, _real=real, **k):
                self.n += 1
                return _real(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counting)


@pytest.mark.parametrize("sentinels", [False, True])
def test_the_step_makes_no_host_read(monkeypatch, sentinels):
    params, _ = _jax_run(_batches(1))
    cfg = get_config("tiny", **_CFG)
    tx = topt.make_optimizer(**_OPT)
    model = convert.load_jax_params(params, cfg, device="cpu",
                                    trainable=True)
    state = {"params": model,
             "opt_state": tx.init(dict(model.named_parameters())),
             "step": 0}
    step = tts.TrainStepBuilder(cfg, tx, device="cpu",
                                health_sentinels=sentinels).build()
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    reads = _Reads(monkeypatch)
    step(state, batch)
    assert reads.n == 0


def test_the_trainer_reads_a_step_once_with_or_without_sentinels(
        tmp_path, monkeypatch):
    params, _ = _jax_run(_batches(1))
    cfg = get_config("tiny", **_CFG)

    def run(on):
        tx = topt.make_optimizer(**_OPT)

        def init(seed):
            model = convert.load_jax_params(params, cfg, device="cpu",
                                            trainable=True)
            return {"params": model,
                    "opt_state": tx.init(dict(model.named_parameters())),
                    "step": 0}

        args = ttrainer.TrainerArgs(
            output_dir=str(tmp_path / f"s{on}"), max_steps=STEPS,
            save_interval=0, log_interval=0, detect_loss_spikes=False,
            health_sentinels=on, resume=False)
        t = ttrainer.Trainer(cfg, args, _batches(), tx, init_state_fn=init,
                             device="cpu")
        t._init_state()
        t._step_fn = t._builder.build()
        with monkeypatch.context() as m:
            reads = _Reads(m)
            t.train()
        return reads.n

    assert run(False) == run(True) == STEPS


def test_the_fraction_denominator_is_the_global_parameter_count():
    """The static denominator is the whole model's count on every path
    (the JAX ``static_size`` of the params tree)."""
    jcfg = jget("tiny", **_CFG)
    jparams = jdec.init(jax.random.key(0), jcfg)
    b = tts.TrainStepBuilder(get_config("tiny", **_CFG),
                             topt.make_optimizer(), device="cpu",
                             health_sentinels=True)
    assert b.n_params == jsnt.static_size(jparams)
