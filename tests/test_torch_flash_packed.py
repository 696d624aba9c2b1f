"""Head-packed flash attention and the prefix-LM mask, against the JAX package.

The JAX packed kernels (``_fwd_kernel_packed``, ``_bwd_dq_kernel_packed``,
``_bwd_dkv_kernel_packed``) run as ``tests/test_ops.py`` runs them on the
CPU: ``_flash_fwd`` / ``_pallas_backward`` with ``head_pack=2`` in Pallas
interpret mode at 128-row blocks, and the public ``flash_attention``
with ``INTERPRET`` set. The port's side runs what its autograd function
runs on a CPU tensor: the plain versions, whatever the pack. Inputs come
from numpy with a seed.

Tolerances, f32 (test_torch_flash_attention.py's; the point is the
algorithm): forward out and lse 2e-5 (the JAX kernels' online softmax
over 128-key blocks against one block holding every key: the same f32
terms summed in another order); backward 1e-4 (dq/dk/dv sum up to 256 products of O(1) terms in
another order); the public op's value and gradients against ``jax.grad``
through the padded packed kernels, 2e-4 (one more reassociation, the
softmax through the saved lse).
"""

import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.ops import pallas_attention as jpa  # noqa: E402
from dlrover_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (causal, per-batch prefix or None)
_CASES = [(True, None), (False, None), (True, (37, 150)), (True, (0, 300))]


def _inputs(seed, b=2, s=256, h=4, hkv=None, d=64):
    rng = np.random.default_rng(seed)
    hkv = h if hkv is None else hkv
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


def _prefix(pref):
    if pref is None:
        return None, None
    p = np.asarray(pref, np.int32)
    return jnp.asarray(p), torch.from_numpy(p)


@pytest.mark.parametrize("causal,pref", _CASES)
def test_packed_forward_matches_jax_packed_kernel(causal, pref):
    q, k, v, _ = _inputs(1)
    jp, tp = _prefix(pref)
    scale = 64 ** -0.5
    jout, jlse = jpa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        block_q=128, block_k=128, interpret=True, prefix=jp, head_pack=2)
    out, lse = fa.flash_fwd_reference(_t(q), _t(k), _t(v), causal=causal,
                                      scale=scale, prefix=tp)
    _close(out, jout, 2e-5)
    _close(lse, jlse, 2e-5)


@pytest.mark.parametrize("causal,pref", _CASES)
def test_packed_backward_matches_jax_packed_kernels(causal, pref):
    q, k, v, g = _inputs(2)
    jp, tp = _prefix(pref)
    scale = 64 ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jout, jlse = jpa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                block_k=128, interpret=True, prefix=jp,
                                head_pack=2)
    jdq, jdk, jdv = jpa._pallas_backward(
        jq, jk, jv, jout, jlse, jnp.asarray(g), causal, scale, 128, 128,
        prefix=jp, interpret=True, head_pack=2)
    dq, dk, dv = fa.flash_bwd_reference(
        _t(q), _t(k), _t(v), _t(jout), _t(jlse), _t(g), causal=causal,
        scale=scale, prefix=tp)
    for port, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(port, ref, 1e-4)


@pytest.mark.parametrize("pref", [None, (40, 90)])
def test_public_op_at_odd_heads_matches_jax_padded_packing(monkeypatch,
                                                            pref):
    """H = 5 at D = 64: JAX auto-packs 2 heads a program and zero-pads
    to 6 heads (gpt2-1.5b has 25); the port packs too (the kernels on
    the card leave the last block one head). Value and every gradient."""
    monkeypatch.setattr(jpa, "INTERPRET", True)
    q, k, v, g = _inputs(3, s=128, h=5)
    jp, tp = _prefix(pref)

    def jloss(q, k, v):
        out = jpa.flash_attention(q, k, v, causal=True, block_q=128,
                                  block_k=128, prefix_len=jp)
        return jnp.vdot(out, jnp.asarray(g))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, prefix_len=tp, head_pack=0)
    val = (out * _t(g)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=2e-4)
    for port, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(port, ref, 2e-4)


# (H, Hkv, D, head_pack): MHA and GQA, D 32/64/128, auto and forced packs
_PACKS = [(h, hkv, d, p)
          for h, hkv in ((4, 4), (5, 5), (4, 2), (8, 1))
          for d in (32, 64, 128)
          for p in (0, 1, 2, 4, 8)]


def test_pack_rule_matches_jax(monkeypatch):
    """The port's pack for every (H, Hkv, D, head_pack) of the table is
    the one JAX's ``flash_attention`` hands its kernels (caught by
    standing in for ``_flash_attention``, which receives it)."""
    seen = []

    def capture(q, k, v, prefix, offsets, causal, scale, bq, bk, window,
                pack):
        seen.append(pack)
        return jnp.zeros(q.shape, q.dtype)

    monkeypatch.setattr(jpa, "INTERPRET", True)
    monkeypatch.setattr(jpa, "_flash_attention", capture)
    rng = np.random.default_rng(4)
    for h, hkv, d, p in _PACKS:
        q = jnp.asarray(rng.standard_normal((1, 128, h, d)), jnp.float32)
        kv = jnp.asarray(rng.standard_normal((1, 128, hkv, d)), jnp.float32)
        jpa.flash_attention(q, kv, kv, head_pack=p)
        assert fa.head_pack_for(h, hkv, d, p) == seen[-1], (h, hkv, d, p)
    assert len(seen) == len(_PACKS)
    assert set(seen) == {1, 2, 4}  # 4 heads of 32 fill 128 lanes
    with pytest.raises(ValueError, match="head_pack"):
        fa.head_pack_for(4, 4, 64, -1)


def test_cuda_launchers_raise_for_packs_the_kernels_lack():
    """The packed kernels hold two MHA heads of 64: any other pack, GQA
    or head_dim raises before a kernel is built or launched."""
    q, k, v, g = (_t(a) for a in _inputs(5, s=16, h=4, d=64))
    kw = dict(causal=True, scale=0.125, window=0)
    with pytest.raises(ValueError, match="packs 4"):
        fa.flash_fwd_cuda(q, k, v, pack=4, **kw)
    with pytest.raises(ValueError, match="MHA heads of 64"):
        fa.flash_fwd_cuda(q, k[:, :, :2].contiguous(),
                          v[:, :, :2].contiguous(), pack=2, **kw)
    x = _t(_inputs(6, s=16, h=4, d=128)[0])
    with pytest.raises(ValueError, match="MHA heads of 64"):
        fa.flash_bwd_cuda(x, x, x, x, None, None, pack=2, **kw)
    with pytest.raises(ValueError, match="prefix"):
        fa.flash_fwd_cuda(q, k, v, prefix=torch.tensor([1, 2]), **kw)
    assert fa.LAUNCHES == {name: 0 for name in fa.KERNELS}


def test_cpu_path_takes_the_plain_versions_at_any_pack():
    """On the CPU the pack does not change a number: head_pack 0 (2 at
    D 64), 1 and 4 give the same output and gradients bit for bit."""
    q, k, v, g = _inputs(7, s=64, h=3)
    pref = torch.tensor([10, 0], dtype=torch.int32)
    runs = []
    for pack in (0, 1, 4):
        leaves = [_t(a).requires_grad_() for a in (q, k, v)]
        out = fa.flash_attention(*leaves, prefix_len=pref, head_pack=pack)
        (out * _t(g)).sum().backward()
        runs.append([out.detach()] + [x.grad for x in leaves])
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,pack,kernel", [
    (torch.bfloat16, 2, "flash_fwd_packed_wgmma_kernel"),
    (torch.float32, 2, "flash_fwd_packed_kernel"),
    (torch.bfloat16, 1, "flash_fwd_wgmma_kernel"),
    (torch.float32, 1, "flash_fwd_kernel")])
def test_forward_kernel_choice(dtype, pack, kernel):
    """bf16 packs run on the tensor-core core, f32 on the mma.sync
    bodies (the f32 model checks); one head a block likewise."""
    assert fa.fwd_cuda_kernel(dtype, pack) == kernel


def test_forward_kernel_ids_match_the_c_entry():
    """``FWD_CUDA_KERNELS[i]`` is the kernel the C entry launches for id
    i: the ids as ``csrc/flash_attention.cu`` declares them."""
    src = (Path(fa.__file__).resolve().parent.parent / "csrc"
           / "flash_attention.cu").read_text()
    ids = dict((int(i), name) for i, name in re.findall(
        r"constexpr int kFwd\w+ = (\d+);\s*// (\w+):", src))
    assert ids == dict(enumerate(fa.FWD_CUDA_KERNELS))


def test_smoke_names_the_forward_kernels_the_steps_launch():
    """chip_smoke's kernels line names the bf16 forwards the wrapper
    picks for the train steps (one head a block, two packed)."""
    import chip_smoke

    named = {k[0]: k[3] for k in chip_smoke.TRAIN_KERNELS}
    assert named["flash_fwd"] == fa.fwd_cuda_kernel(torch.bfloat16, 1)
    assert named["flash_fwd_packed"] == fa.fwd_cuda_kernel(torch.bfloat16, 2)
