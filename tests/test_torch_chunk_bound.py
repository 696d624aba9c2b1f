"""The bf16 chunk kernel's element-wise bound, and the kernel dispatch of
the two attention-forward kernels on the tensor-core core, on the CPU.

``chip_smoke.chunk_bound`` holds the bf16 prefill-chunk kernel
(``paged_chunk_wgmma_kernel``), which rounds each unnormalized
probability to bf16 before P·V, against the f32 plain version:
2^-8·|plain| + (2^-8 + 2^-12)·M + 1e-5, M the same attention over |V|.
Here the plain bf16 chunk version (which rounds the normalized
probabilities to bf16, then its output) stands in for the kernel: it must
lie within the bound, and the two planted faults of ``chip_smoke.py`` (a
held page dropped, the window edge one key late) must lie outside it.

The dispatch tests record the kernel id each wrapper hands its C entry
point (the launcher is replaced, so no card is needed): bf16 chunks over
bf16 and int8 pools go to the tensor-core chunk kernel, f32 and head_dim
32 to the CUDA-core one; the bf16 one-head flash forward to the
tensor-core kernel, f32 to the mma.sync-tile kernel's f32 instantiation,
two heads of 64 to the packed kernel.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dlrover_tpu_torch.models.config import get_config
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import paged_attention as pa
from dlrover_tpu_torch.ops import quant
from dlrover_tpu_torch.serving import kv_cache as kvc


def _chunk(mode, *, d=64, hkv=2, groups=4, ps=16, c=40, starts=(37, 0, 90),
           seed=0):
    """A chunk of C queries per slot over pools filled from numpy rows;
    slot 1 free (no pages). Returns (q bf16, one layer's pools, the f32
    pools the kernel reads, tables, positions, active slots)."""
    cfg = get_config("tiny", n_head=hkv * groups, n_kv_head=hkv,
                     d_model=hkv * groups * d, n_layer=1, dtype="bfloat16")
    b = len(starts)
    geom = kvc.make_geometry(cfg, n_slots=b, max_len=ps * 12, page_size=ps,
                             mode=mode)
    rng = np.random.default_rng(seed)
    pools = kvc.init_pools(geom, "cpu")
    shape = (1, geom.n_pages, ps, geom.row_elems)
    for name in ("k", "v"):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if mode == "bf16":
            pools[name].copy_(x.reshape(pools[name].shape))
        else:
            qv, sc = quant.kv_encode_rows(x, geom.kv_block)
            pools[name + "_q"].copy_(qv)
            pools[name + "_scale"].copy_(sc)
    layer = kvc.layer_pools(pools, 0)
    lens = [0 if i == 1 else s + c for i, s in enumerate(starts)]
    perm = list(rng.permutation(np.arange(1, geom.n_pages)))
    tab = np.full((b, geom.max_pages_per_slot), -1, np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // ps)):
            tab[i, j] = perm.pop()
    pos = torch.as_tensor(np.asarray(starts)[:, None] + np.arange(c),
                          dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal(
        (b, c, hkv * groups, d)).astype(np.float32)).to(torch.bfloat16)
    if mode == "bf16":
        f32 = {n: layer[n].float() for n in ("k", "v")}
    else:
        f32 = {n: quant.kv_decode_rows(layer[n + "_q"], layer[n + "_scale"],
                                       torch.bfloat16).float()
               .reshape(geom.n_pages, ps, hkv, d) for n in ("k", "v")}
    active = torch.as_tensor(np.asarray(lens) > 0)
    return q, layer, f32, torch.from_numpy(tab), pos, active


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_bf16_chunk_lies_within_the_bound(mode, window, d):
    q, layer, f32, tab, pos, active = _chunk(mode, d=d, seed=d + window)
    kw = dict(scale=d ** -0.5, window=window, kv_heads=2, variant="chunk")
    ref, bound = chip_smoke.chunk_bound(q, f32, tab, pos, **kw)
    plain = pa.paged_attention_reference(q, layer, tab, pos, **kw)
    err, over, ratio = chip_smoke._held(plain, ref, active, bound)
    assert over == 0 and ratio < 1.0, (err, over, ratio)
    # the bound is not vacuous: the rounding of P is a visible share of it
    assert ratio > 0.02


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_planted_faults_lie_outside_the_bound(mode):
    q, layer, f32, tab, pos, active = _chunk(mode, seed=3)
    kw = dict(scale=0.125, window=0, kv_heads=2, variant="chunk")
    ref, bound = chip_smoke.chunk_bound(q, f32, tab, pos, **kw)
    # slot 0's middle held page dropped (the plain version reads the
    # trash page in its place; the kernel skips it)
    bad_tab = tab.clone()
    bad_tab[0, int((tab[0] >= 0).sum()) // 2] = -1
    bad = pa.paged_attention_reference(q, layer, bad_tab, pos, **kw)
    assert chip_smoke._held(bad, ref, active, bound)[1] > 0
    # the window edge one key late
    kw = dict(kw, window=24)
    ref, bound = chip_smoke.chunk_bound(q, f32, tab, pos, **kw)
    bad = pa.paged_attention_reference(q, layer, tab, pos,
                                       **dict(kw, window=25))
    assert chip_smoke._held(bad, ref, active, bound)[1] > 0


class _Recorder:
    """Stands in for a C entry point: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _Stream:
    cuda_stream = 0


@pytest.fixture
def no_card(monkeypatch):
    """The wrappers' launch path without a card: the launcher records,
    the stream and the SM count are stand-ins."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(pa, "_sm_count", lambda dev: 132)  # an H100's
    rec = _Recorder()
    monkeypatch.setattr(pa, "_kernel", lambda: rec)
    monkeypatch.setattr(fa, "_lib", lambda: {"fwd": rec, "bwd": rec})
    yield rec
    pa.reset_launches()
    fa.reset_launches()


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 128, "paged_chunk_wgmma_kernel"),
    (torch.bfloat16, 64, "paged_chunk_wgmma_kernel"),
    (torch.bfloat16, 32, "paged_chunk_kernel"),
    (torch.float32, 128, "paged_chunk_kernel"),
    (torch.float32, 64, "paged_chunk_kernel")])
def test_chunk_dispatch_by_dtype(no_card, mode, dtype, d, kernel):
    q, layer, _, tab, pos, _ = _chunk(mode, d=d, c=3)
    if mode == "bf16":  # verbatim pools hold the compute type
        layer = {n: x.to(dtype) for n, x in layer.items()}
    pa.reset_launches()
    pa._paged_call(q.to(dtype), layer, tab, pos, scale=1.0, window=0,
                   kv_heads=2, max_pages=None, variant="chunk")
    assert pa.cuda_kernel("chunk", dtype, d) == kernel
    assert no_card.calls[-1][23] == pa.CUDA_KERNEL_IDS[kernel]
    # one launch, counted under "chunk" whichever kernel ran
    assert pa.LAUNCHES == {"decode": 0, "chunk": 1, "verify": 0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_and_verify_keep_their_kernels(no_card, dtype):
    q, layer, _, tab, pos, _ = _chunk("int8", d=128, c=2)
    pa._paged_call(q.to(dtype), layer, tab, pos, scale=1.0, window=0,
                   kv_heads=2, max_pages=None, variant="chunk")
    assert no_card.calls[-1][23] == pa.CUDA_KERNEL_IDS[
        "paged_decode_split_kernel"]
    ek = torch.zeros((3, 2, 2, 128), dtype=dtype)
    pa._paged_call(q.to(dtype), layer, tab, pos, scale=1.0, window=0,
                   kv_heads=2, max_pages=None, variant="verify",
                   extra_k=ek, extra_v=ek.clone())
    assert no_card.calls[-1][23] == pa.CUDA_KERNEL_IDS[
        "paged_decode_split_kernel<VERIFY>"]


@pytest.mark.parametrize("dtype,d,pack,kernel", [
    (torch.bfloat16, 128, 1, "flash_fwd_wgmma_kernel"),
    (torch.bfloat16, 64, 1, "flash_fwd_wgmma_kernel"),
    (torch.float32, 128, 1, "flash_fwd_kernel"),
    (torch.float32, 64, 1, "flash_fwd_kernel"),
    (torch.bfloat16, 64, 2, "flash_fwd_packed_wgmma_kernel"),
    (torch.float32, 64, 2, "flash_fwd_packed_kernel")])
def test_flash_forward_dispatch_by_dtype(no_card, dtype, d, pack, kernel):
    rng = np.random.default_rng(d + pack)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 80, h, d)).astype(np.float32)).to(dtype)
        for h in (4, 4 if pack == 2 else 2, 4 if pack == 2 else 2))
    fa.reset_launches()
    fa.flash_fwd_cuda(q, k, v, causal=True, scale=d ** -0.5, window=0,
                      pack=pack)
    assert fa.fwd_cuda_kernel(dtype, pack) == kernel
    # the kernel id follows the ring offsets (q_off, k_off) in the C entry
    assert no_card.calls[-1][15:17] == (0, 0)
    assert no_card.calls[-1][17] == fa.FWD_CUDA_KERNELS.index(kernel)
    # the launch counts under the forward's name, as train's checks expect
    name = "flash_fwd_packed" if pack == 2 else "flash_fwd"
    assert fa.LAUNCHES == {n: int(n == name) for n in fa.KERNELS}
