"""The port's fused norm against the JAX package's.

The JAX side runs as its own tests run it on the CPU:
``pallas_norm.norm(..., interpret=True)`` (the Pallas kernels in
interpret mode) with ``jax.grad`` for the backward. The port's side runs
``ops.norm.norm`` on CPU tensors: the plain forward ``_reference`` and
the plain backward ``norm_bwd_reference`` inside its autograd function.
Inputs come from numpy with a seed.

Tolerances:

- f32 forward and every gradient, 1e-5: the same formulas, row sums in
  another order (d ≤ 4096 terms of O(1), a few rows at the wide d).
- bf16 forward, one bf16 ulp relative (2^-7) + 1e-6: both add the
  residual in bf16 (bit-identical), take f32 statistics and round the
  output once, so they differ only where a sum-order difference moves
  a value across a rounding boundary. With a residual the JAX side is
  its plain path (``interpret=False``, ``_reference``): in interpret
  mode XLA:CPU fuses the kernel's bf16 add into the f32 statistics
  without rounding it (12% of a layernorm's outputs then sit beyond
  one rounding of the exact value, where ``_reference`` and the port
  sit within it).
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.ops import pallas_norm as jnorm  # noqa: E402
from dlrover_tpu_torch.models import decoder as tdec  # noqa: E402
from dlrover_tpu_torch.ops import norm as tnorm  # noqa: E402

# d 1600 and 4096: gpt2-1.5b's and glm-10b's widths, at few rows
_CASES = [(kind, residual, d) for kind in ("rmsnorm", "layernorm")
          for residual in (False, True) for d in (96, 256, 1600, 4096)]


def _inputs(seed, d, n=(4, 16)):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "x": rng.standard_normal(n + (d,)).astype(f),
        "res": rng.standard_normal(n + (d,)).astype(f),
        "scale": (1.0 + 0.1 * rng.standard_normal(d)).astype(f),
        "bias": (0.1 * rng.standard_normal(d)).astype(f),
        "g": rng.standard_normal(n + (d,)).astype(f),
        "gh": rng.standard_normal(n + (d,)).astype(f),
    }


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("kind,residual,d", _CASES)
def test_forward_and_grads_match_jax(kind, residual, d):
    a = _inputs(d + residual, d, n=(4, 16) if d <= 256 else (2, 3))
    bias = a["bias"] if kind == "layernorm" else None

    def jfn(x, scale, bias, res):
        out = jnorm.norm(x, scale, bias, kind,
                         residual=res if residual else None, interpret=True)
        if residual:
            out, h = out
            return (jnp.vdot(out, a["g"]) + jnp.vdot(h, a["gh"])), (out, h)
        return jnp.vdot(out, a["g"]), (out, None)

    argn = (0, 1, 2, 3) if bias is not None else (0, 1, 3)
    args = [jnp.asarray(a["x"]), jnp.asarray(a["scale"]),
            None if bias is None else jnp.asarray(bias),
            jnp.asarray(a["res"])]
    (_, (jout, jh)), jgrads = jax.value_and_grad(
        jfn, argnums=argn, has_aux=True)(*args)

    x, scale, res = _t(a["x"], True), _t(a["scale"], True), _t(a["res"], True)
    b = None if bias is None else _t(bias, True)
    out = tnorm.norm(x, scale, b, kind, residual=res if residual else None)
    if residual:
        out, h = out
        loss = (out * _t(a["g"])).sum() + (h * _t(a["gh"])).sum()
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                                   rtol=1e-6, atol=1e-6)
    else:
        loss = (out * _t(a["g"])).sum()
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    ports = {0: x.grad, 1: scale.grad, 2: None if b is None else b.grad,
             3: res.grad}
    for i, jg in zip(argn, jgrads):
        if i == 3 and not residual:
            assert ports[3] is None
            continue
        np.testing.assert_allclose(ports[i].numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("residual", [False, True])
def test_bf16_forward_matches_jax(kind, residual):
    a = _inputs(3, 256, n=(8, 32))
    bf = jnp.bfloat16
    jx, jr = jnp.asarray(a["x"], bf), jnp.asarray(a["res"], bf)
    bias = a["bias"] if kind == "layernorm" else None
    jout = jnorm.norm(jx, jnp.asarray(a["scale"]),
                      None if bias is None else jnp.asarray(bias), kind,
                      residual=jr if residual else None,
                      interpret=not residual)

    def tb(j):
        return torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)

    out = tnorm.norm(tb(jx), _t(a["scale"]),
                     None if bias is None else _t(bias), kind,
                     residual=tb(jr) if residual else None)
    if residual:
        (out, h), (jout, jh) = out, jout
        assert torch.equal(h, tb(jh))  # the bf16 add is exact on both sides
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_plain_forward_is_the_decoder_norm(kind):
    """``_reference`` without a residual is the decoder's ``_norm``,
    bit for bit (the JAX package pins the same)."""
    a = _inputs(4, 128)
    bias = _t(a["bias"]) if kind == "layernorm" else None
    eps = tnorm.RMS_EPS if kind == "rmsnorm" else tnorm.LN_EPS
    for dt in (torch.float32, torch.bfloat16):
        x = _t(a["x"]).to(dt)
        assert torch.equal(
            tnorm._reference(x, _t(a["scale"]), bias, kind, eps, None),
            tdec._norm(x, _t(a["scale"]), bias, kind))


def test_bwd_reference_matches_autograd_of_the_plain_forward():
    a = _inputs(5, 64, n=(10,))
    h = _t(a["x"], True)
    scale = _t(a["scale"], True)
    bias = _t(a["bias"], True)
    out = tnorm._reference(h, scale, bias, "layernorm", tnorm.LN_EPS, None)
    g = _t(a["g"])
    dx, ds, db = torch.autograd.grad((out * g).sum(), (h, scale, bias))
    rdx, rds, rdb = tnorm.norm_bwd_reference(
        g, h.detach(), scale.detach(), None, "layernorm", tnorm.LN_EPS, True)
    for p, r in ((rdx, dx), (rds, ds), (rdb, db)):
        np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_rmsnorm_ignores_bias_and_checks_kind():
    a = _inputs(6, 32, n=(3,))
    x, s, b = _t(a["x"]), _t(a["scale"]), _t(a["bias"])
    assert torch.equal(tnorm.norm(x, s, b, "rmsnorm"),
                       tnorm.norm(x, s, None, "rmsnorm"))
    with pytest.raises(ValueError, match="unknown norm kind"):
        tnorm.norm(x, s, None, "batchnorm")


def test_launch_counters_untouched_on_cpu():
    tnorm.reset_launches()
    a = _inputs(7, 32, n=(3,))
    x = _t(a["x"], True)
    out, h = tnorm.norm(x, _t(a["scale"]), None, residual=_t(a["res"]))
    (out.sum() + h.sum()).backward()
    assert tnorm.LAUNCHES == {k: 0 for k in tnorm.KERNELS}


def _c_plans():
    """The forward plans ``csrc/fused_norm.cu`` instantiates: (warps a row,
    vectors a lane) from each ``case`` of its plan switch."""
    src = (Path(tnorm.__file__).resolve().parent.parent / "csrc"
           / "fused_norm.cu").read_text()
    plans = set()
    for case, nv, g in re.findall(
            r"case (\d+):\s*(?:if constexpr \([^)]*\)\s*)?return "
            r"launch_fwd<T, RMS, RES, BIAS, (\d+), (\d+)>", src):
        assert int(case) == 10 * int(g) + int(nv)
        plans.add((int(g), int(nv)))
    return plans


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fwd_plan_covers_every_width(dtype, residual):
    """For every d from 8 to 4096 in steps of 8: the plan's lanes hold
    the row's 16-byte vectors; it takes the fewest warps that keep a lane
    at ``FWD_LANE_VECTORS`` (8 warps past that) and the fewest vectors a
    lane, a power of two; and the kernel instantiates it."""
    planned = _c_plans()
    cap = tnorm.FWD_LANE_VECTORS[residual]
    vec = 16 // dtype.itemsize
    for d in range(8, 4097, 8):
        warps, nv = tnorm.fwd_plan(d, dtype, residual)
        n_vec = d // vec
        assert (warps, nv) in planned, (d, warps, nv)
        assert warps in tnorm.FWD_WARPS and nv & (nv - 1) == 0
        assert n_vec <= 32 * warps * nv, d
        assert nv == 1 or n_vec > 32 * warps * (nv // 2), d
        if warps > 1:
            assert n_vec > 32 * (warps // 2) * cap, d
        if n_vec <= 32 * tnorm.FWD_WARPS[-1] * cap:
            assert nv <= cap, d


class _Recorder:
    """Stands in for the C entry point: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("d", [8, 1600, 2048, 4096])
def test_fwd_launch_passes_the_plan(monkeypatch, d, residual):
    """The wrapper hands the C entry ``fwd_plan``'s warps and vectors
    (the arguments after the dtype) and counts one launch."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    rec = _Recorder()
    monkeypatch.setattr(tnorm, "_lib", lambda: {"fwd": rec})
    tnorm.reset_launches()
    x = torch.zeros(3, d, dtype=torch.bfloat16)
    res = torch.zeros_like(x) if residual else None
    tnorm.norm_fwd_cuda(x, torch.ones(d), torch.zeros(d), res, "layernorm",
                        tnorm.LN_EPS)
    assert rec.calls[-1][11:13] == tnorm.fwd_plan(d, torch.bfloat16,
                                                  residual)
    assert tnorm.LAUNCHES == {"norm_fwd": 1, "norm_bwd": 0}
    tnorm.reset_launches()


def _c_bwd_plans():
    """The backward plans ``csrc/fused_norm.cu`` instantiates, from each
    ``case`` of ``pick_bwd_plan``: ``{(warps a row, vectors a lane): f32
    only}``."""
    src = (Path(tnorm.__file__).resolve().parent.parent / "csrc"
           / "fused_norm.cu").read_text()
    body = src[src.index("cudaError_t pick_bwd_plan("):]
    body = body[:body.index("default:")]
    plans = {}
    for case, guard, nv, g in re.findall(
            r"case (\d+):[^\n]*\n\s*(if constexpr \(sizeof\(T\) == 4\)\s*)?"
            r"return launch_bwd<T, RMS, RES, BIAS, (\d+), (\d+)>", body):
        assert int(case) == 10 * int(g) + int(nv)
        plans[(int(g), int(nv))] = bool(guard)
    return plans


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_plan_covers_every_width(dtype, residual):
    """For every d from 8 to 4096 in steps of 8: the backward plan's lanes
    hold the row's 16-byte vectors; it takes the fewest warps that keep a
    lane at ``BWD_LANE_VECTORS`` (8 warps past that) and the fewest
    vectors a lane, a power of two; and the kernel instantiates it for
    this dtype."""
    planned = _c_bwd_plans()
    cap = tnorm.BWD_LANE_VECTORS[residual]
    vec = 16 // dtype.itemsize
    for d in range(8, 4097, 8):
        warps, nv = tnorm.bwd_plan(d, dtype, residual)
        n_vec = d // vec
        assert (warps, nv) in planned, (d, warps, nv)
        assert dtype == torch.float32 or not planned[(warps, nv)], d
        assert warps in tnorm.FWD_WARPS and nv & (nv - 1) == 0
        assert n_vec <= 32 * warps * nv, d
        assert nv == 1 or n_vec > 32 * warps * (nv // 2), d
        if warps > 1:
            assert n_vec > 32 * (warps // 2) * cap, d
        if n_vec <= 32 * tnorm.FWD_WARPS[-1] * cap:
            assert nv <= cap, d


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("d", [8, 1600, 2048, 4096])
def test_bwd_launch_passes_the_plan(monkeypatch, d, residual, kind):
    """The wrapper asks the C side for the grid at ``bwd_plan``'s warps and
    vectors, hands the C entry the plan, scratch of that many partial rows
    and the dscale (dbias) outputs, returns what the C call wrote there,
    and counts one launch."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    n_part = 5
    asked, calls = [], []

    def blocks(*args):
        asked.append(args)
        return n_part

    def bwd(*args):
        # the C call: the kernel's partial rows (row i of dscale holds
        # i + 1, of dbias 2 (i + 1)), then their column sums
        calls.append(args)
        for part, out, k in ((args[5], args[7], 1.0),
                             (args[6], args[8], 2.0)):
            assert (part is None) == (out is None)
            if part is None:
                continue
            rows = (ctypes.c_float * (n_part * d)).from_address(part)
            for i in range(n_part):
                rows[i * d:(i + 1) * d] = [k * (i + 1)] * d
            sums = (ctypes.c_float * d).from_address(out)
            for c in range(d):
                sums[c] = sum(rows[i * d + c] for i in range(n_part))
        return 0

    monkeypatch.setattr(tnorm, "_lib",
                        lambda: {"bwd": bwd, "bwd_blocks": blocks})
    tnorm.reset_launches()
    h = torch.zeros(3, d, dtype=torch.bfloat16)
    gh = torch.zeros_like(h) if residual else None
    bias = kind == "layernorm"
    dx, ds, db = tnorm.norm_bwd_cuda(h, h, torch.ones(d), gh, kind,
                                     tnorm.LN_EPS, bias)
    plan = tnorm.bwd_plan(d, torch.bfloat16, residual)
    rms = int(kind == "rmsnorm")
    assert asked == [(3, d, rms, int(residual), int(bias), 1) + plan]
    assert calls[-1][9:11] == (3, d)
    assert calls[-1][12:17] == (rms, 1) + plan + (n_part,)
    assert (calls[-1][3] is None) == (not residual)
    assert (calls[-1][6] is None) == (not bias)
    total = n_part * (n_part + 1) / 2
    assert torch.equal(ds, torch.full((d,), total))
    assert (db is None) == (not bias)
    if bias:
        assert torch.equal(db, torch.full((d,), 2 * total))
    assert dx.shape == h.shape and dx.dtype == h.dtype
    assert tnorm.LAUNCHES == {"norm_fwd": 0, "norm_bwd": 1}
    tnorm.reset_launches()
