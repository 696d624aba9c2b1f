"""The port's AdamW and schedules against the JAX package's optax ones.

A 3-step rollout: the same params and per-step gradients (numpy, from a
seed) through ``dlrover_tpu.train.optimizer.make_optimizer`` (optax) and
``dlrover_tpu_torch.train.optimizer.make_optimizer``, fused and unfused,
f32 and bf16 first moments, with a clip that fires and one that does
not. Checked after every step: params and both moments.

Tolerances: params and f32 moments 2e-6 relative + 1e-7 absolute — the
same f32 arithmetic term for term; the only differences are the order
of the global-norm sum and XLA rewriting a scalar division into a
reciprocal multiply (one ulp, then divided by sqrt(v)). bf16 first
moments: one bf16 ulp (2^-7) relative, since a one-ulp f32 difference
can round them across a bf16 step. Schedules: 1e-6 relative (both in
float32).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402

_SHAPES = {"w": (8, 16), "b": (16,), "emb": (32, 8)}


def _params(seed):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in _SHAPES.items()}


def _grads(seed, step, scale):
    rng = np.random.default_rng(1000 * seed + step)
    return {n: (scale * rng.standard_normal(s)).astype(np.float32)
            for n, s in _SHAPES.items()}


def _jax_moments(state):
    """(mu, nu) dicts of a JAX optimizer state, fused or chained."""
    if isinstance(state, dict):
        return state["m"], state["v"]
    for s in jax.tree.leaves(state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no adam state found")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("grad_scale,grad_clip", [(0.1, 1.0), (1.0, 0.5)])
def test_three_step_rollout_matches_optax(fused, state_dtype, grad_scale,
                                          grad_clip):
    kw = dict(learning_rate=1e-2, weight_decay=0.1, b1=0.9, b2=0.95,
              grad_clip=grad_clip, warmup_steps=2, decay_steps=10,
              state_dtype=state_dtype, fused=fused)
    jtx = jopt.make_optimizer(**kw)
    ttx = topt.make_optimizer(**kw)
    p0 = _params(0)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    jstate = jtx.init(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    tstate = ttx.init(tp)
    for step in range(3):
        g = _grads(1, step, grad_scale)
        upd, jstate = jtx.update({n: jnp.asarray(a) for n, a in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update_(tp, {n: torch.from_numpy(a) for n, a in g.items()},
                    tstate)
        jm, jv = _jax_moments(jstate)
        for n in _SHAPES:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=2e-6, atol=1e-7)
            np.testing.assert_allclose(tstate["v"][n].numpy(),
                                       np.asarray(jv[n]), rtol=2e-6,
                                       atol=1e-7)
            m_tol = 2.0 ** -7 if state_dtype else 2e-6
            assert tstate["m"][n].dtype == (
                torch.bfloat16 if state_dtype else torch.float32)
            np.testing.assert_allclose(
                tstate["m"][n].float().numpy(),
                np.asarray(jm[n].astype(jnp.float32)), rtol=m_tol,
                atol=1e-7)
    assert tstate["step"] == 3


def test_first_step_under_warmup_moves_only_the_moments():
    """The lr of update t reads the schedule at t - 1: step 1 of a warmup
    has lr 0, so params stay put while the moments fill."""
    tx = topt.make_optimizer(learning_rate=1e-3, warmup_steps=5)
    p = {n: torch.from_numpy(a) for n, a in _params(2).items()}
    before = {n: t.clone() for n, t in p.items()}
    state = tx.init(p)
    tx.update_(p, {n: torch.from_numpy(a) for n, a in
                   _grads(2, 0, 1.0).items()}, state)
    for n in p:
        assert torch.equal(p[n], before[n])
        assert state["m"][n].abs().sum() > 0


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear",
                                  "constant_with_warmup", "constant"])
def test_schedules_match_jax(name):
    js = jopt.build_schedule(name, 3e-4, warmup_steps=10, decay_steps=100)
    ts = topt.build_schedule(name, 3e-4, warmup_steps=10, decay_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(js(step)) if callable(js) else float(js)
        got = ts(step) if callable(ts) else ts
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_global_norm_matches_optax():
    g = _grads(3, 0, 2.0)
    want = float(optax.global_norm({n: jnp.asarray(a) for n, a in g.items()}))
    got = float(topt.global_norm([torch.from_numpy(a) for a in g.values()]))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unported_optimizers_raise():
    with pytest.raises(NotImplementedError, match="A17"):
        topt.make_optimizer("lion")
    with pytest.raises(NotImplementedError, match="A17"):
        topt.make_optimizer(state_dtype="int8")
    with pytest.raises(NotImplementedError, match="A17"):
        topt.build_schedule("inverse_sqrt", 1e-3)
