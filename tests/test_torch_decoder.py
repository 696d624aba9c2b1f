"""The port's paged decoder steps against the JAX decoder.

JAX params from ``decoder.init`` go through numpy and
``models/convert.py`` into the port's ``Decoder``; identical pools
(bf16/f32 payloads or the int8 codec's), block tables and tokens go
through ``prefill_chunk_paged`` then ``decode_step_paged`` in both.
Checked: logits and every updated pool (the trash page, which takes
duplicate writes in both, aside).

Tolerances:

- f32 (``dtype="float32"``), where the point is the algorithm: logits
  rtol/atol 1e-4 (same ops, different kernels' summation order);
  verbatim pools 1e-5; int8 payloads within one quantization step
  (an f32 difference in K/V can move a value across a rounding tie) and
  scales rtol 1e-5.
- bf16: logits within 5e-2 of the largest |logit| — each framework
  rounds activations to bf16 after every matmul and add, in different
  places, and the two roundings drift apart through the layers.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.serving import kv_cache as jkv  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models import decoder as tdec  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.serving import kv_cache as tkv  # noqa: E402

_BASE = dict(n_layer=3, d_model=32, d_ff=64, n_head=4, vocab_size=64,
             max_seq=64)
_FAMILIES = {
    # llama-style: rmsnorm, swiglu, rope, untied head, GQA
    "llama-gqa": dict(base="tiny", n_kv_head=2, tie_embeddings=False),
    # neox-style: layernorm, gelu, parallel residual, sliding window
    "neox-window": dict(base="tiny-neox", attn_window=6),
    # gpt2-style: learned positions, tied embeddings, muP scaling
    "learned-mup": dict(base="tiny", pos="learned", norm="layernorm",
                        act="gelu", mup_base_width=16),
}


def _configs(family, dtype):
    kw = dict(_FAMILIES[family])
    base = kw.pop("base")
    kw.update(_BASE, dtype=dtype)
    return jget(base, **kw), get_config(base, **kw)


def _pools_to_torch(jpools, dtype):
    out = {}
    for name, arr in jpools.items():
        a = np.asarray(arr.astype(jnp.float32) if arr.dtype == jnp.bfloat16
                       else arr).copy()
        t = torch.from_numpy(a)
        out[name] = t.to(getattr(torch, dtype)) if name in ("k", "v") else t
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _run_both(family, dtype, mode):
    jcfg, cfg = _configs(family, dtype)
    params = jdec.init(jax.random.key(1), jcfg)
    model = convert.load_jax_params(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    geom = tkv.make_geometry(cfg, n_slots=3, max_len=32, page_size=4,
                             mode=mode)
    jgeom = jkv.PageGeometry(*geom)
    alloc = tkv.PageAllocator(geom, 3)
    for i, n in enumerate((21, 13, 30)):
        assert alloc.admit(i, n)
    tables = alloc.block_tables()
    jpools = jkv.init_pools(jgeom)
    tpools = tkv.init_pools(geom, "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    start = np.asarray([8, 0, 16], np.int32)
    clen = np.asarray([8, 5, 8], np.int32)  # slot 1: a padded trailing chunk
    jl1, jpools = jdec.prefill_chunk_paged(
        params, jnp.asarray(toks), jpools, jnp.asarray(tables),
        jnp.asarray(start), jnp.asarray(clen), jcfg, max_pages=8)
    tl1, tpools = model.prefill_chunk_paged(
        torch.from_numpy(toks), tpools, torch.from_numpy(tables),
        torch.from_numpy(start), torch.from_numpy(clen), max_pages=8)
    tok2 = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    pos = np.asarray([16, 5, 24], np.int32)
    valid = np.asarray([True, True, False])  # lane 2 idle: writes trash
    jl2, jpools = jdec.decode_step_paged(
        params, jnp.asarray(tok2), jpools, jnp.asarray(tables),
        jnp.asarray(pos), jnp.asarray(valid), jcfg, max_pages=8)
    tl2, tpools = model.decode_step_paged(
        torch.from_numpy(tok2), tpools, torch.from_numpy(tables),
        torch.from_numpy(pos), torch.from_numpy(valid), max_pages=8)
    # logits of padded chunk rows are garbage in both; compare valid rows
    rows = np.arange(8)[None, :] < clen[:, None]
    return (_np(jl1)[rows], _np(tl1)[rows.astype(bool)],
            _np(jl2)[valid], _np(tl2)[valid], jpools, tpools)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_paged_steps_match_jax_f32(family, mode):
    jl1, tl1, jl2, tl2, jpools, tpools = _run_both(family, "float32", mode)
    np.testing.assert_allclose(tl1, jl1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl2, jl2, rtol=1e-4, atol=1e-4)
    for name in jpools:
        j, t = _np(jpools[name])[:, 1:], _np(tpools[name])[:, 1:]
        if name.endswith("_q"):
            assert np.abs(j - t).max() <= 1
            assert (j != t).mean() < 1e-3
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_paged_steps_match_jax_bf16(mode):
    jl1, tl1, jl2, tl2, _, _ = _run_both("llama-gqa", "bfloat16", mode)
    for j, t in ((jl1, tl1), (jl2, tl2)):
        assert np.isfinite(t).all()
        assert np.abs(t - j).max() <= 5e-2 * np.abs(j).max()


def test_decoder_raises_without_a_card_unless_cpu_is_asked():
    cfg = get_config("tiny", **_BASE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdec.Decoder(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            tdec.init(cfg)
    model = tdec.init(cfg, seed=3, device="cpu")
    again = tdec.init(cfg, seed=3, device="cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 again.state_dict().items()):
        assert torch.equal(a, b), name  # same seed, same weights
    assert model.embed.tokens.dtype == torch.bfloat16
    assert model.layers[0].ln1.scale.dtype == torch.float32
    w = model.layers[0].attn.wq.weight
    assert tuple(w.shape) == (cfg.n_head * cfg.head_dim, cfg.d_model)
    std = float(w.float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


def test_convert_layout_and_untied_head():
    jcfg, cfg = _configs("llama-gqa", "float32")
    params = jax.tree.map(np.asarray, jdec.init(jax.random.key(2), jcfg))
    sd = convert.state_dict_from_jax(params, cfg)
    np.testing.assert_array_equal(
        sd["layers.1.attn.wk.weight"].numpy(),
        params["layers"]["attn"]["wk"][1].T)
    np.testing.assert_array_equal(sd["lm_head.weight"].numpy(),
                                  params["lm_head"]["w"].T)
    assert set(sd) == set(tdec.Decoder(cfg, device="cpu").state_dict())
