"""The port's CUDA kernel on the card, against its plain PyTorch version.

Marked ``cuda``: each test skips, with a reason, where no NVIDIA GPU is
present (the decision is made inside the fixture, never at import). On
a machine with a card (no JAX needed; ``tests/conftest.py`` imports
JAX, so skip it)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 queries 1e-4 (the kernel's online softmax reassociates
the f32 sums). bf16 queries are held against the plain version run in
f32 on the values the kernel reads (bf16 q and pools upcast, int8 pages
dequantized to bf16), at 1e-5 + 2^-8 relative: twice the kernel's one
rounding of its output to bf16.
"""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import decoder
from dlrover_tpu_torch.models.config import get_config
from dlrover_tpu_torch.ops import paged_attention as pa
from dlrover_tpu_torch.ops import quant
from dlrover_tpu_torch.serving import kv_cache as kvc

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -8, 1e-5)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA for sm_90a")
    return torch.device("cuda")


def _case(dev, *, mode, dtype, hkv, groups, d, ps, c, lens, window, seed):
    cfg = get_config("tiny", n_head=hkv * groups, n_kv_head=hkv,
                     d_model=hkv * groups * d, n_layer=1,
                     dtype=str(dtype).split(".")[-1])
    b = len(lens)
    geom = kvc.make_geometry(cfg, n_slots=b, max_len=ps * 12, page_size=ps,
                             mode=mode)
    g = torch.Generator(device=dev).manual_seed(seed)
    pools = kvc.init_pools(geom, dev)
    shape = (1, geom.n_pages, ps, geom.row_elems)
    for name in ("k", "v"):
        x = torch.randn(shape, generator=g, device=dev)
        if mode == "bf16":
            pools[name].copy_(x.reshape(pools[name].shape))
        else:
            qv, sc = quant.kv_encode_rows(x, geom.kv_block)
            pools[name + "_q"].copy_(qv)
            pools[name + "_scale"].copy_(sc)
    rng = np.random.default_rng(seed)
    perm = list(rng.permutation(np.arange(1, geom.n_pages)))
    tab = np.full((b, geom.max_pages_per_slot), -1, np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // ps)):
            tab[i, j] = perm.pop()
    last = np.maximum(np.asarray(lens) - 1, 0)
    pos = (last[:, None] - np.arange(c - 1, -1, -1)[None, :]).clip(0)
    q = torch.randn((b, c, hkv * groups, d), generator=g, device=dev)
    kw = dict(scale=d ** -0.5, window=window, kv_heads=hkv,
              variant="decode" if c == 1 else "chunk")
    posd = torch.as_tensor(pos[:, 0] if c == 1 else pos, dtype=torch.int32,
                           device=dev)
    return (q.to(dtype), kvc.layer_pools(pools, 0),
            torch.as_tensor(tab, device=dev), posd, kw,
            torch.as_tensor(np.asarray(lens) > 0, device=dev))


def _read_f32(pools, hkv, d):
    """One layer's pools as the kernel reads them for bf16 q, in f32."""
    if "k" in pools:
        return {n: pools[n].float() for n in ("k", "v")}
    p, ps = pools["k_q"].shape[:2]
    return {n: quant.kv_decode_rows(pools[n + "_q"], pools[n + "_scale"],
                                    torch.bfloat16).float()
            .reshape(p, ps, hkv, d) for n in ("k", "v")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize(
    "hkv,groups,d,ps,c,window",
    [(2, 4, 128, 16, 1, 0), (2, 4, 128, 16, 1, 20), (4, 1, 64, 8, 1, 0),
     (1, 8, 32, 32, 1, 0), (2, 4, 128, 16, 7, 0), (2, 2, 64, 16, 24, 13),
     (3, 4, 32, 4, 5, 0),
     # int8 rows of 3 × 128 get 192-wide scale blocks: a head spans two
     # (the llama3 shapes above are the other way round: 256-wide
     # blocks, one scale per two heads)
     (3, 2, 128, 16, 1, 0), (3, 2, 128, 16, 9, 0),
     # the kernel follows the rows per KV head, not the variant: a decode
     # of 16 query heads per KV head runs the chunk kernel, a chunk of 2
     # queries × 4 heads the decode kernel
     (1, 16, 64, 16, 1, 0), (2, 4, 64, 16, 2, 0)],
)
def test_kernel_matches_plain(dev, dtype, mode, hkv, groups, d, ps, c,
                              window):
    q, pools, tab, pos, kw, active = _case(
        dev, mode=mode, dtype=dtype, hkv=hkv, groups=groups, d=d, ps=ps,
        c=c, lens=[ps * 12, 5, 0, ps * 3 + 1], window=window, seed=c + d)
    pa.reset_launches()
    out = pa.paged_attention(q, pools, tab, pos, **kw)
    torch.cuda.synchronize()
    launched = pa.kernel_for(c, hkv * groups, hkv)
    assert pa.LAUNCHES == {k: int(k == launched) for k in pa.KERNELS}
    if dtype == torch.float32:
        ref = pa.paged_attention_reference(q, pools, tab, pos, **kw)
    else:
        ref = pa.paged_attention_reference(
            q.float(), _read_f32(pools, hkv, d), tab, pos, **kw)
    rtol, atol = _TOL[dtype]
    torch.testing.assert_close(out[active].float(), ref[active].float(),
                               rtol=rtol, atol=atol)
    assert torch.all(out[~active] == 0)  # a free slot: exact zeros


def test_cuda_tensor_never_reaches_the_plain_version(dev, monkeypatch):
    q, pools, tab, pos, kw, _ = _case(
        dev, mode="int8", dtype=torch.bfloat16, hkv=2, groups=4, d=128,
        ps=16, c=1, lens=[40, 9], window=0, seed=1)

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(pa, "paged_attention_reference", forbidden)
    out = pa.paged_attention(q, pools, tab, pos, **kw)
    assert out.is_cuda and torch.isfinite(out.float()).all()
    with pytest.raises(ValueError, match="kv_heads"):
        pa.paged_attention(q, pools, tab, pos, scale=1.0)


def test_engine_on_card_matches_cpu_streams(dev):
    """Greedy streams of the tiny f32 model: the card (kernel) and the
    CPU (plain version) agree token for token."""
    from dlrover_tpu_torch.serving.server import GenerationServer

    cfg = get_config("tiny", n_layer=2, d_model=128, n_head=4, n_kv_head=2,
                     d_ff=256, vocab_size=128, max_seq=64, dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 128, size=n)))
               for n in (3, 17, 9, 30)]
    outs = {}
    for where in ("cpu", "cuda"):
        model = decoder.init(cfg, seed=0, device="cpu").to(where)
        server = GenerationServer(model, cfg, device=where, n_slots=3,
                                  max_len=64, page_size=16, mode="int8",
                                  prefill_chunk=16).start()
        try:
            outs[where] = [server.generate(p, 8, timeout=120)
                           for p in prompts]
        finally:
            server.stop()
    assert outs["cuda"] == outs["cpu"]
