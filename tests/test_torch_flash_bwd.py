"""The flash backward's kernel choice and the dkv kernel's mask, on the CPU.

The bf16 backward runs on the tensor cores, one head a block
(``flash_bwd_dq_wgmma_kernel``, ``flash_bwd_dkv_wgmma_kernel``) or two
packed heads of 64 (``flash_bwd_dq_packed_wgmma_kernel``,
``flash_bwd_dkv_packed_wgmma_kernel``, the same bodies); the
dkv kernel masks each key row by the range of queries that see it
(``q_range`` in ``csrc/flash_attention.cu``), whose plain twin is
``ops.flash_attention.dkv_q_range``. The masks here are compared
exactly (booleans): the range rule against the port's ``_allowed`` and
against the JAX package's ``_allowed_mask`` (``pallas_attention.py``,
the one place its kernels' mask geometry lives), over causal and
non-causal, windows, prefixes (none, mid-tile, past the end), Sq != Sk
and ragged lengths. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dlrover_tpu.ops import pallas_attention as jpa  # noqa: E402
from dlrover_tpu_torch.ops import flash_attention as fa  # noqa: E402

# the dkv kernel's tiles: keys a block, q rows a stage
_DKV_KEYS, _DKV_BQ = 128, 64


@pytest.mark.parametrize("dtype,pack,kernels", [
    (torch.bfloat16, 1, ("flash_bwd_dq_wgmma_kernel",
                         "flash_bwd_dkv_wgmma_kernel")),
    (torch.float32, 1, ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    (torch.bfloat16, 2, ("flash_bwd_dq_packed_wgmma_kernel",
                         "flash_bwd_dkv_packed_wgmma_kernel")),
    (torch.float32, 2, ("flash_bwd_dq_packed_kernel",
                        "flash_bwd_dkv_packed_kernel"))])
def test_backward_kernel_choice(dtype, pack, kernels):
    """bf16 runs on the tensor cores, one head or two packed heads of 64 a
    block; f32 (the f32 model checks) on the mma.sync bodies."""
    assert fa.bwd_cuda_kernel(dtype, pack) == kernels


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("dtype,pack,ids", [
    (torch.bfloat16, 2, (6, 7)), (torch.float32, 2, (2, 3)),
    (torch.bfloat16, 1, (4, 5)), (torch.float32, 1, (0, 1))])
def test_backward_launch_passes_the_kernel_ids(monkeypatch, dtype, pack,
                                               ids):
    """``flash_bwd_cuda`` hands the C entry the ids of ``bwd_cuda_kernel``'s
    pair, dq then dkv, and counts one launch of each under the pack's
    names (``flash_bwd_dq_packed`` / ``flash_bwd_dkv_packed`` at pack 2,
    whichever kernel runs them)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(fa, "_lib", lambda: {
        "bwd": lambda *args: calls.append(args) or 0})
    b, s, h, d = 1, 65, 3, 64
    q = torch.zeros(b, s, h, d, dtype=dtype)
    lse = torch.zeros(b, h, s)
    fa.reset_launches()
    fa.flash_bwd_cuda(q, q, q, q, lse, lse, causal=True, scale=0.125,
                      window=0, pack=pack)
    assert tuple(c[0] for c in calls) == ids
    assert tuple(fa.BWD_CUDA_KERNELS[i] for i in ids) == \
        fa.bwd_cuda_kernel(dtype, pack)
    assert all(c[11:17] == (b, s, s, h, h, d) for c in calls)
    suffix = "_packed" if pack == 2 else ""
    assert fa.LAUNCHES == {
        n: int(n in ("flash_bwd_dq" + suffix, "flash_bwd_dkv" + suffix))
        for n in fa.KERNELS}
    fa.reset_launches()


def test_backward_kernel_ids_match_the_c_entry():
    """``BWD_CUDA_KERNELS[i]`` is the kernel the C entry launches for id
    i: the ids as ``csrc/flash_attention.cu`` declares them."""
    src = (Path(fa.__file__).resolve().parent.parent / "csrc"
           / "flash_attention.cu").read_text()
    ids = dict((int(i), name) for i, name in re.findall(
        r"constexpr int kBwd\w+ = (\d+);\s*// (\w+):", src))
    assert ids == dict(enumerate(fa.BWD_CUDA_KERNELS))


def test_smoke_names_the_backward_kernels_the_llama_step_launches():
    """chip_smoke's kernels line names the bf16 backward pair the wrapper
    picks for the llama step (heads of 128, one a block), and the packed
    pair for the gpt2 step."""
    import chip_smoke

    named = {k[0]: k[3] for k in chip_smoke.TRAIN_KERNELS}
    dq, dkv = fa.bwd_cuda_kernel(torch.bfloat16, 1)
    assert (named["flash_bwd_dq"], named["flash_bwd_dkv"]) == (dq, dkv)
    dq, dkv = fa.bwd_cuda_kernel(torch.bfloat16, 2)
    assert (named["flash_bwd_dq_packed"],
            named["flash_bwd_dkv_packed"]) == (dq, dkv)


def _range_cases():
    cases = []
    for s in (1, 63, 65, 257, 1000, 1001):
        cases += [(s, s, False, 0, None), (s, s, True, 0, None)]
        cases += [(s, s, True, w, None) for w in (1, 100, 257)]
        # prefixes: none, mid-tile, past the end
        cases.append((s, s, True, 0, (0, s // 2 + 5, s + 7)))
    for sq, sk in ((63, 257), (257, 63), (1000, 1001), (1001, 65)):
        cases += [(sq, sk, False, 0, None), (sq, sk, True, 0, None),
                  (sq, sk, True, 100, None), (sq, sk, True, 0, (0, 40, 900))]
    return cases


def _range_mask(lo, hi, sq):
    q = torch.arange(sq)[None, :, None]
    return (q >= lo[:, None, :]) & (q < hi[:, None, :])  # [B or 1, Sq, Sk]


@pytest.mark.parametrize("sq,sk,causal,window,prefix", _range_cases())
def test_dkv_q_range_gives_the_flash_mask(sq, sk, causal, window, prefix):
    """A key row's query range [lo, hi) gives exactly the mask of
    ``_allowed`` and of JAX's ``_allowed_mask``, batch element by batch
    element; and the dkv kernel's q tiles (a block of 128 keys, q tiles of
    64 rows: ``q_tiles`` in the source) leave out no visible pair."""
    pref = None if prefix is None else torch.tensor(prefix, dtype=torch.int32)
    lo, hi = fa.dkv_q_range(sq, sk, causal, window, pref)
    got = _range_mask(lo, hi, sq)
    want = fa._allowed(sq, sk, causal, window, pref, None, "cpu")
    if want is None:
        want = torch.ones(1, sq, sk, dtype=torch.bool)
    assert torch.equal(got, want)
    for i in range(got.shape[0]):
        jmask = jpa._allowed_mask(0, 0, sq, sk, causal, prefix is not None,
                                  0 if prefix is None else prefix[i],
                                  window=window)
        jmask = (np.ones((sq, sk), bool) if jmask is None
                 else np.asarray(jmask))
        assert np.array_equal(got[i].numpy(), jmask)
    # the q tiles a dkv block walks: under causal from the diagonal on, to
    # the last key's window; every tile when the block reaches the prefix
    n = -(-sq // _DKV_BQ)
    for i in range(got.shape[0]):
        p = 0 if prefix is None else prefix[i]
        for k0 in range(0, sk, _DKV_KEYS):
            begin, end = 0, n
            if causal and k0 >= p:
                begin = min(k0 // _DKV_BQ, n)
                if window:
                    end = min(n, (k0 + _DKV_KEYS - 1 + window - 1)
                              // _DKV_BQ + 1)
            seen = got[i, :, k0:k0 + _DKV_KEYS].any(1)
            rows = torch.nonzero(seen).flatten()
            if len(rows):
                assert begin * _DKV_BQ <= int(rows.min())
                assert int(rows.max()) < end * _DKV_BQ


def test_cpu_backward_never_builds_a_kernel(monkeypatch):
    """On CPU tensors the backward runs the plain version at any dtype:
    the library of ``csrc/flash_attention.cu`` is never asked for."""
    def no_lib():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(fa, "_lib", no_lib)
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 65, h, 128), dtype=np.float32)).to(torch.bfloat16)
        .requires_grad_() for h in (4, 2, 2))
    fa.reset_launches()
    fa.flash_attention(q, k, v, window=40).float().sum().backward()
    assert all(x.grad is not None for x in (q, k, v))
    assert fa.LAUNCHES == {name: 0 for name in fa.KERNELS}
