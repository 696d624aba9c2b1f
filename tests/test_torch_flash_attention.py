"""The port's flash attention against the JAX package's.

The JAX kernels run as the JAX tests run them on the CPU: ``_flash_fwd``
and ``_pallas_backward`` in Pallas interpret mode at 128-row blocks. The
port's side runs its plain versions (``flash_fwd_reference``,
``flash_bwd_reference``), which is what its autograd function runs on a
CPU tensor. Inputs come from numpy with a seed.

Tolerances, f32 (the point is the algorithm):

- forward out and lse, 2e-5: the JAX kernel's online softmax over
  128-key blocks against one block holding every key; the two sum the
  same f32 terms in another order.
- backward, 1e-4 absolute and relative: dq/dk/dv sum up to 256 products
  of O(1) terms in another order (the JAX dkv kernel also sums the GQA
  group after its per-head partials, the port inside).
- autograd against ``jax.grad`` of the plain attention, 2e-4: the same
  sums, one more reassociation (softmax through the saved lse).
- bf16 forward, 2e-2: both round p to bf16 before P·V, the JAX kernel
  against each 128-key block's running max, the port against the row
  max, so single roundings differ; outputs are O(1), one bf16 ulp 2^-7.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.ops import attention as jattn  # noqa: E402
from dlrover_tpu.ops import pallas_attention as jpa  # noqa: E402
from dlrover_tpu_torch.ops import attention as tattn  # noqa: E402
from dlrover_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (causal, H, Hkv, D, window)
_CASES = [
    (True, 4, 4, 64, 0),
    (False, 4, 4, 64, 0),
    (True, 4, 2, 128, 0),
    (True, 2, 2, 128, 96),
    (True, 4, 1, 64, 0),
    (False, 2, 1, 128, 0),
]


def _inputs(seed, b=2, s=256, h=4, hkv=4, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    g = rng.standard_normal((b, s, h, d), dtype=np.float32)
    return q, k, v, g


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,h,hkv,d,window", _CASES)
def test_forward_matches_jax_kernel(causal, h, hkv, d, window):
    q, k, v, _ = _inputs(1, h=h, hkv=hkv, d=d)
    scale = d ** -0.5
    jout, jlse = jpa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        block_q=128, block_k=128, interpret=True, window=window)
    out, lse = fa.flash_fwd_reference(_t(q), _t(k), _t(v), causal=causal,
                                      scale=scale, window=window)
    assert lse.shape == (2, h, 256) and lse.dtype == torch.float32
    _close(out, jout, 2e-5)
    _close(lse, jlse, 2e-5)


@pytest.mark.parametrize("causal,h,hkv,d,window", _CASES)
def test_backward_matches_jax_kernels(causal, h, hkv, d, window):
    q, k, v, g = _inputs(2, h=h, hkv=hkv, d=d)
    scale = d ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jout, jlse = jpa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                block_k=128, interpret=True, window=window)
    jdq, jdk, jdv = jpa._pallas_backward(
        jq, jk, jv, jout, jlse, jnp.asarray(g), causal, scale, 128, 128,
        interpret=True, window=window)
    dq, dk, dv = fa.flash_bwd_reference(
        _t(q), _t(k), _t(v), _t(jout), _t(jlse), _t(g), causal=causal,
        scale=scale, window=window)
    for port, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(port, ref, 1e-4)


@pytest.mark.parametrize("causal,h,hkv,d,window", _CASES[:4])
def test_autograd_matches_jax_grad(causal, h, hkv, d, window):
    q, k, v, g = _inputs(3, s=192, h=h, hkv=hkv, d=d)

    def jloss(q, k, v):
        out = jattn.mha_reference(q, k, v, causal=causal, window=window)
        return jnp.vdot(out, jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    (out * _t(g)).sum().backward()
    for port, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(port, ref, 2e-4)


def test_lse_cotangent_folds_into_delta():
    """(out, lse) both carry gradient: against jax.grad of a plain
    attention that returns its logsumexp too."""
    q, k, v, g = _inputs(4, s=128, h=4, hkv=2, d=64)
    gl = np.random.default_rng(5).standard_normal((2, 4, 128)).astype(
        np.float32)
    scale = 64 ** -0.5

    def jloss(q, k, v):
        kr = jattn._repeat_kv(k, 2)
        vr = jattn._repeat_kv(v, 2)
        s = jnp.einsum("bqhd,bkhd->bhqk", q, kr) * scale
        mask = jnp.tril(jnp.ones((128, 128), bool))
        s = jnp.where(mask, s, -1e30)
        lse = jax.nn.logsumexp(s, axis=-1)
        out = jnp.einsum("bhqk,bkhd->bqhd", jnp.exp(s - lse[..., None]), vr)
        return jnp.vdot(out, jnp.asarray(g)) + jnp.vdot(lse, jnp.asarray(gl))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv)
    ((out * _t(g)).sum() + (lse * _t(gl)).sum()).backward()
    for port, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(port, ref, 2e-4)


def test_bf16_forward_matches_jax_kernel():
    q, k, v, _ = _inputs(6, h=4, hkv=2, d=128)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jout, jlse = jpa._flash_fwd(jq, jk, jv, True, 128 ** -0.5, block_q=128,
                                block_k=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (jq, jk, jv))
    out, lse = fa.flash_fwd_reference(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(jout.astype(jnp.float32)), 2e-2)
    _close(lse, jlse, 1e-4)


@pytest.mark.parametrize("sq,sk,window,prefix", [
    (64, 64, 0, False), (48, 80, 0, False), (64, 64, 9, False),
    (40, 72, 13, False), (64, 64, 0, True)])
def test_mha_reference_matches_jax(sq, sk, window, prefix):
    """Causal aligned bottom-right for sq != sk, window and prefix-LM,
    GQA: op for op the JAX reference."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, sq, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, sk, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, sk, 2, 32), dtype=np.float32)
    pl = np.array([5, 30], np.int32) if prefix else None
    ref = jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, prefix_len=None if pl is None else jnp.asarray(pl))
    out = tattn.mha_reference(
        _t(q), _t(k), _t(v), causal=True, window=window,
        prefix_len=None if pl is None else torch.from_numpy(pl))
    _close(out, ref, 1e-5)


def test_prefix_forward_matches_jax_kernel():
    """The plain versions serve prefix-LM, as the kernels do on the card
    (tests/test_torch_flash_packed.py holds the packed twins)."""
    q, k, v, g = _inputs(8, h=4, hkv=2, d=64)
    prefix = np.array([37, 150], np.int32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jout, jlse = jpa._flash_fwd(jq, jk, jv, True, 0.125, block_q=128,
                                block_k=128, interpret=True,
                                prefix=jnp.asarray(prefix))
    out, lse = fa.flash_fwd_reference(_t(q), _t(k), _t(v), scale=0.125,
                                      prefix=torch.from_numpy(prefix))
    _close(out, jout, 2e-5)
    _close(lse, jlse, 2e-5)


def test_top_left_and_bottom_right_agree_when_sq_equals_sk():
    q, k, v, _ = _inputs(9, s=96, h=4, hkv=2, d=64)
    a = fa.flash_attention(_t(q), _t(k), _t(v), window=20)
    b = tattn.mha_reference(_t(q), _t(k), _t(v), window=20)
    _close(a, b, 1e-5)


def test_argument_errors():
    q, k, v, _ = _inputs(10, s=16)
    tq, tk, tv = _t(q), _t(k), _t(v)
    with pytest.raises(ValueError, match="window requires causal"):
        fa.flash_attention(tq, tk, tv, causal=False, window=4)
    with pytest.raises(ValueError, match="prefix_len requires causal"):
        fa.flash_attention(tq, tk, tv, causal=False,
                           prefix_len=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(tq, tk[:, :, :3], tv[:, :, :3])


def test_launch_counters_untouched_on_cpu():
    fa.reset_launches()
    q, k, v, g = _inputs(11, s=32)
    tq = _t(q).requires_grad_()
    fa.flash_attention(tq, _t(k), _t(v)).sum().backward()
    assert fa.LAUNCHES == {k: 0 for k in fa.KERNELS}
