"""The port's fused lm-head cross-entropy against the JAX package's.

Same numpy inputs through ``dlrover_tpu.ops.fused_ce.fused_linear_ce``
and ``dlrover_tpu_torch.ops.fused_ce.fused_linear_ce``: the three
outputs, and both gradients for random cotangents of logz and the
target logit. The vocab is not a multiple of the chunk, so the last
chunk is ragged (JAX pads it and masks the pad; the port cuts it short).

Tolerances (f32, where the point is the algorithm): outputs 1e-5 (the
same online logsumexp over the same chunks, f32 sums in another order);
argmax exact; gradients 1e-5 relative + 1e-6 absolute (each chunk's
products accumulate up to D or N terms in another order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.ops import fused_ce as jce  # noqa: E402
from dlrover_tpu_torch.ops import fused_ce as tce  # noqa: E402


def _inputs(seed, b=2, s=24, d=32, v=1000):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    t = rng.integers(0, v, size=(b, s)).astype(np.int32)
    t[0, 0], t[1, -1] = 0, v - 1  # the first and the last (ragged) chunk
    g_logz = rng.standard_normal((b, s)).astype(np.float32)
    g_tgt = rng.standard_normal((b, s)).astype(np.float32)
    return x, w, t, g_logz, g_tgt


@pytest.mark.parametrize("scale,block_v", [(1.0, 256), (0.25, 384),
                                           (1.0, 1024)])
def test_outputs_and_grads_match_jax(scale, block_v):
    x, w, t, gz, gt = _inputs(block_v)
    jx, jw, jt = jnp.asarray(x), jnp.asarray(w), jnp.asarray(t)
    (jz, jtl, jam), vjp = jax.vjp(
        lambda x, w: jce.fused_linear_ce(x, w, jt, scale, block_v), jx, jw)
    jdx, jdw = vjp((jnp.asarray(gz), jnp.asarray(gt),
                    np.zeros(t.shape, jax.dtypes.float0)))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    z, tl, am = tce.fused_linear_ce(tx, tw, torch.from_numpy(t), scale,
                                    block_v)
    ((z * torch.from_numpy(gz)).sum()
     + (tl * torch.from_numpy(gt)).sum()).backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jtl),
                               rtol=1e-5, atol=1e-5)
    assert am.dtype == torch.int32
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=1e-5, atol=1e-6)


def test_matches_the_full_logits_cross_entropy():
    """Against the unfused path in torch: logsumexp, the gathered target
    logit and argmax of the whole ``[N, V]`` logits, and the NLL's
    gradients through ``F.cross_entropy``."""
    x, w, t, _, _ = _inputs(3)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tt = torch.from_numpy(t).long()
    z, tl, am = tce.fused_linear_ce(tx, tw, tt, 1.0, 128)
    (z - tl).mean().backward()
    gx, gw = tx.grad.clone(), tw.grad.clone()
    tx.grad = tw.grad = None
    logits = tx @ tw
    torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tt.reshape(-1)).backward()
    np.testing.assert_allclose(z.detach().numpy(),
                               torch.logsumexp(logits, -1).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(am.numpy(), logits.argmax(-1).numpy())
    np.testing.assert_allclose(gx.numpy(), tx.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), tw.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_bf16_operands_round_dlog_like_jax():
    """bf16 x: both round the chunk products' operands (x, the weight
    chunk, and dlog in the backward) to bf16 and accumulate in f32.
    Tolerance: 1e-3 relative — the f32 sums of bf16 products match to
    sum order, but a different sum can round dlog across a bf16 step."""
    x, w, t, gz, gt = _inputs(4, d=64, v=600)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    jx = jnp.asarray(xb, jnp.bfloat16)
    (jz, jtl, _), vjp = jax.vjp(
        lambda x, w: jce.fused_linear_ce(x, w, jnp.asarray(t), 1.0, 256),
        jx, jnp.asarray(w))
    jdx, jdw = vjp((jnp.asarray(gz), jnp.asarray(gt),
                    np.zeros(t.shape, jax.dtypes.float0)))
    tx = torch.from_numpy(xb).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    z, tl, _ = tce.fused_linear_ce(tx, tw, torch.from_numpy(t), 1.0, 256)
    ((z * torch.from_numpy(gz)).sum()
     + (tl * torch.from_numpy(gt)).sum()).backward()
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=2e-2, atol=1e-3)
